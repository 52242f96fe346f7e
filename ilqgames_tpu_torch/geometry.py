"""Polyline closest-point query (counterpart of ilqgames_tpu/geometry.py).

Only the sign-free query (`need_sign=False`) that the flagship's lane
cost consumes is ported. Queries are elementwise over tensors of any
shape; the polyline is a static (M, 2) array whose segment constants are
Python floats, computed in float32 as the JAX package computes them.

The winner is the first segment with the smallest |sq distance| (the
reference's strict-< scan), and an exactly collinear off-end candidate
has distance 0 (the reference's sgn(0) == 0), both as in the JAX query.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ilqgames_tpu_torch.types import SMALL_NUMBER

_EPS = 1e-12


class ClosestPointXY(NamedTuple):
    cpx: torch.Tensor
    cpy: torch.Tensor
    signed_sq_distance: torch.Tensor  # |ssd| under need_sign=False
    is_vertex: torch.Tensor
    is_endpoint: torch.Tensor
    p1x: torch.Tensor
    p1y: torch.Tensor
    ux: torch.Tensor
    uy: torch.Tensor


def _static_segments(points):
    """Per-segment Python-float constants: (p1, p2, unit, length)."""
    pts = np.asarray(points, np.float32)
    segs = []
    for s in range(pts.shape[0] - 1):
        p1 = pts[s]
        p2 = pts[s + 1]
        d = p2 - p1
        length = float(np.sqrt(np.float32(d @ d)))
        denom = np.float32(max(length, _EPS))
        ux, uy = (d / denom).tolist()
        segs.append(((float(p1[0]), float(p1[1])),
                     (float(p2[0]), float(p2[1])),
                     (float(ux), float(uy)),
                     length))
    return pts, segs


def polyline_closest_point_xy(points, qx: torch.Tensor, qy: torch.Tensor,
                              need_sign: bool = False) -> ClosestPointXY:
    """Closest point on the polyline to (qx, qy), elementwise."""
    if need_sign:
        raise NotImplementedError(
            "polyline_closest_point_xy(need_sign=True) is not ported yet")
    pts, segs = _static_segments(points)
    S = len(segs)

    cand = []
    for p1, p2, (ux, uy), length in segs:
        rx, ry = qx - p1[0], qy - p1[1]
        dot = rx * ux + ry * uy
        cross = rx * uy - ux * ry
        sq_p1 = rx * rx + ry * ry
        r2x, r2y = qx - p2[0], qy - p2[1]
        sq_p2 = r2x * r2x + r2y * r2y

        behind = dot < 0.0
        ahead = dot > length
        cpx = torch.where(behind, p1[0],
                          torch.where(ahead, p2[0], p1[0] + dot * ux))
        cpy = torch.where(behind, p1[1],
                          torch.where(ahead, p2[1], p1[1] + dot * uy))
        abs_raw = torch.where(behind, sq_p1,
                              torch.where(ahead, sq_p2, cross * cross))
        abs_ssd = torch.where(cross == 0.0, 0.0, abs_raw)
        cand.append((cpx, cpy, abs_ssd, behind | ahead, p1, (ux, uy)))

    # First-occurrence winner as exclusive masks.
    m = cand[0][2]
    for c in cand[1:]:
        m = torch.minimum(m, c[2])
    sel = []
    taken = torch.zeros_like(m, dtype=torch.bool)
    for c in cand:
        hit = (c[2] <= m) & ~taken
        sel.append(hit)
        taken = taken | hit

    def pick(vals):
        acc = vals[0]
        for s in range(1, S):
            acc = torch.where(sel[s], vals[s], acc)
        return acc

    def const(v):
        return torch.full_like(qx, v)

    cpx = pick([c[0] for c in cand])
    cpy = pick([c[1] for c in cand])
    chosen_ssd = pick([c[2] for c in cand])
    chosen_is_vertex = pick([c[3] for c in cand])
    p1x = pick([const(c[4][0]) for c in cand])
    p1y = pick([const(c[4][1]) for c in cand])
    unx = pick([const(c[5][0]) for c in cand])
    uny = pick([const(c[5][1]) for c in cand])

    fx, fy = float(pts[0][0]), float(pts[0][1])
    lx, ly = float(pts[-1][0]), float(pts[-1][1])
    d_first = (cpx - fx) ** 2 + (cpy - fy) ** 2
    d_last = (cpx - lx) ** 2 + (cpy - ly) ** 2
    is_endpoint = (d_first < SMALL_NUMBER) | (d_last < SMALL_NUMBER)

    return ClosestPointXY(cpx=cpx, cpy=cpy, signed_sq_distance=chosen_ssd,
                          is_vertex=chosen_is_vertex,
                          is_endpoint=is_endpoint, p1x=p1x, p1y=p1y,
                          ux=unx, uy=uny)
