"""Cost atoms of the flagship (counterpart of ilqgames_tpu/costs/atoms.py:
`quadratic` at :39 and `quadratic_polyline2` at :366).

Gradients and Hessians are the JAX package's sparse pairs, with the
reference's shipped branch semantics for the polyline cost: a vertex
branch (isotropic pull toward the vertex), an interior branch (quadratic
in the cross-track coordinate), and zero at the polyline's endpoints.
"""

from __future__ import annotations

from typing import Optional

import torch

from ilqgames_tpu_torch import geometry
from ilqgames_tpu_torch.costs.base import Cost


def quadratic(weight: float, dim: Optional[int], nominal: float = 0.0,
              name: str = "quadratic") -> Cost:
    """0.5*w*(v[dim]-nominal)^2."""
    if dim is None:
        raise NotImplementedError(
            "quadratic over all dimensions (dim=None) is not ported yet")

    def evaluate(t, v):
        d = v[..., dim] - nominal
        return 0.5 * weight * d * d

    def grad_pairs(t, v):
        return [(dim, weight * (v[..., dim] - nominal))]

    def quad_pairs(t, v):
        return ([((dim, dim), torch.full_like(v[..., 0], weight))],
                grad_pairs(t, v))

    return Cost(name, evaluate, grad_pairs, quad_pairs,
                device=("quadratic", {"dim": dim, "weight": weight,
                                      "nominal": nominal}))


def quadratic_polyline2(weight: float, points, xidx: int, yidx: int,
                        name: str = "quadratic_polyline2") -> Cost:
    """0.5*w*|signed sq distance to the polyline|, zeroed when the closest
    point is a polyline endpoint."""

    def evaluate(t, v):
        res = geometry.polyline_closest_point_xy(points, v[..., xidx],
                                                 v[..., yidx])
        ssd = torch.where(res.is_endpoint, 0.0, res.signed_sq_distance)
        return 0.5 * weight * torch.abs(ssd)

    def _scalars(v):
        qx, qy = v[..., xidx], v[..., yidx]
        res = geometry.polyline_closest_point_xy(points, qx, qy)

        dxv = weight * (qx - res.cpx)
        dyv = weight * (qy - res.cpy)

        ux, uy = res.ux, res.uy
        w_cross = weight * ((qx - res.p1x) * uy - (qy - res.p1y) * ux)
        dxi = w_cross * uy
        dyi = -w_cross * ux
        hi = (weight * uy * uy, weight * ux * ux, -weight * ux * uy)

        use_v = res.is_vertex
        gate = (~res.is_endpoint).to(torch.float32)
        dx = torch.where(use_v, dxv, dxi) * gate
        dy = torch.where(use_v, dyv, dyi) * gate
        ddx = torch.where(use_v, weight, hi[0]) * gate
        ddy = torch.where(use_v, weight, hi[1]) * gate
        dxdy = torch.where(use_v, 0.0, hi[2]) * gate
        return dx, dy, ddx, ddy, dxdy

    def grad_pairs(t, v):
        dx, dy, _, _, _ = _scalars(v)
        return [(xidx, dx), (yidx, dy)]

    def quad_pairs(t, v):
        dx, dy, ddx, ddy, dxdy = _scalars(v)
        return ([((xidx, xidx), ddx), ((yidx, yidx), ddy),
                 ((xidx, yidx), dxdy), ((yidx, xidx), dxdy)],
                [(xidx, dx), (yidx, dy)])

    return Cost(name, evaluate, grad_pairs, quad_pairs,
                device=("polyline", {"points": points, "xidx": xidx,
                                     "yidx": yidx, "weight": weight}))
