"""Constraints (counterpart of ilqgames_tpu/costs/constraints.py:
`_mu_eff_ineq` at :24, `single_dimension` at :33 and `proximity` at
:103)."""

from __future__ import annotations

from typing import Tuple

import torch

from ilqgames_tpu_torch import fmath
from ilqgames_tpu_torch.costs.base import Constraint, mu_eff_ineq

_EPS = 1e-12


def single_dimension(dim: int, threshold: float, keep_below: bool,
                     name: str = "single_dimension") -> Constraint:
    """g = v[dim] - threshold (keep below) or threshold - v[dim]. Its AL
    gradient is ct = lam + mu_eff * g at dim (negated when keeping
    above), its Hessian mu_eff at (dim, dim)."""

    def g(t, v):
        return v[..., dim] - threshold if keep_below else threshold - v[..., dim]

    def al_grad_pairs(t, v, lam, mu):
        gval = g(t, v)
        ct = lam + mu_eff_ineq(gval, lam, mu) * gval
        return [(dim, ct if keep_below else -ct)]

    def al_quad_pairs(t, v, lam, mu):
        gval = g(t, v)
        mu_eff = mu_eff_ineq(gval, lam, mu)
        ct = lam + mu_eff * gval
        return [((dim, dim), mu_eff)], [(dim, ct if keep_below else -ct)]

    return Constraint(name, g, False, al_grad_pairs, al_quad_pairs,
                      device=("single_dimension", {
                          "dim": dim, "threshold": threshold,
                          "keep_below": keep_below}))


def proximity(dims1: Tuple[int, int], dims2: Tuple[int, int],
              threshold: float, keep_within: bool,
              name: str = "proximity_constraint") -> Constraint:
    """g = +/-(||p1 - p2|| - threshold). The derivatives are zero where
    the distance clamp is active (`live`), as autodiff through the clamp
    gives in the JAX package."""
    s = 1.0 if keep_within else -1.0
    x1, y1 = dims1
    x2, y2 = dims2

    def g(t, v):
        dx = v[..., x1] - v[..., x2]
        dy = v[..., y1] - v[..., y2]
        prox = fmath.sqrt(torch.clamp_min(dx * dx + dy * dy, _EPS))
        return s * (prox - threshold)

    def al_grad_pairs(t, v, lam, mu):
        dx = v[..., x1] - v[..., x2]
        dy = v[..., y1] - v[..., y2]
        ssq = dx * dx + dy * dy
        prox = fmath.sqrt(torch.clamp_min(ssq, _EPS))
        gval = s * (prox - threshold)
        live = (ssq >= _EPS).to(torch.float32)
        ct = (lam + mu_eff_ineq(gval, lam, mu) * gval) * s * live / prox
        px = ct * dx
        py = ct * dy
        return [(x1, px), (y1, py), (x2, -px), (y2, -py)]

    def al_quad_pairs(t, v, lam, mu):
        dx = v[..., x1] - v[..., x2]
        dy = v[..., y1] - v[..., y2]
        ssq = dx * dx + dy * dy
        prox = fmath.sqrt(torch.clamp_min(ssq, _EPS))
        gval = s * (prox - threshold)
        live = (ssq >= _EPS).to(torch.float32)
        mu_eff = mu_eff_ineq(gval, lam, mu)
        lam_t = lam + mu_eff * gval
        inv = 1.0 / prox
        gx = s * dx * inv
        gy = s * dy * inv
        ct = lam_t * live
        px = ct * gx
        py = ct * gy
        gp = [(x1, px), (y1, py), (x2, -px), (y2, -py)]
        nx = dx * inv
        ny = dy * inv
        hxx = (mu_eff * gx * gx + lam_t * s * (ny * ny) * inv) * live
        hyy = (mu_eff * gy * gy + lam_t * s * (nx * nx) * inv) * live
        hxy = (mu_eff * gx * gy - lam_t * s * (nx * ny) * inv) * live
        hp = [
            ((x1, x1), hxx), ((y1, y1), hyy),
            ((x1, y1), hxy), ((y1, x1), hxy),
            ((x2, x2), hxx), ((y2, y2), hyy),
            ((x2, y2), hxy), ((y2, x2), hxy),
            ((x1, x2), -hxx), ((x2, x1), -hxx),
            ((y1, y2), -hyy), ((y2, y1), -hyy),
            ((x1, y2), -hxy), ((y2, x1), -hxy),
            ((y1, x2), -hxy), ((x2, y1), -hxy),
        ]
        return hp, gp

    return Constraint(name, g, False, al_grad_pairs, al_quad_pairs,
                      device=("proximity", {"dims": (x1, y1, x2, y2),
                                            "threshold": threshold,
                                            "sign": s}))
