"""Cost and constraint primitives (counterpart of ilqgames_tpu/costs/base.py).

The port keeps only the sparse forms the JAX package's kernels use: a
cost gives its gradient and quadraticization as (index, value) pairs, a
constraint gives those of its augmented-Lagrangian term
lambda*g + mu_eff*g^2/2. Values are tensors over any batch shape (the
solver evaluates every lane and knot at once); inputs `v` carry the
state or control index on their last axis.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ilqgames_tpu_torch.types import SMALL_NUMBER


@dataclasses.dataclass(frozen=True, eq=False)
class Cost:
    """A scalar stage cost on one input vector (a state x or one player's u).

    evaluate: (t_rel, v) -> value.
    grad_pairs_fn: (t, v) -> [(dim, value)].
    quad_pairs_fn: (t, v) -> ([((i, j), value)], [(dim, value)]).
    device: the atom's form in the stage and merit kernels
    (csrc/costs.cuh), (kind, {parameter: value}); None when it has none.
    """

    name: str
    evaluate: Callable
    grad_pairs_fn: Callable
    quad_pairs_fn: Callable
    device: Optional[tuple] = None

    def gradient_pairs(self, t, v):
        return list(self.grad_pairs_fn(t, v))

    def quad_pairs(self, t, v):
        return self.quad_pairs_fn(t, v)


@dataclasses.dataclass(frozen=True, eq=False)
class Constraint:
    """A scalar constraint g(t, v) == 0 (equality) or g(t, v) <= 0."""

    name: str
    g: Callable
    is_equality: bool
    al_grad_pairs_fn: Callable
    al_quad_pairs_fn: Callable
    device: Optional[tuple] = None  # as Cost.device

    def gradient_al_pairs(self, t, v, lam, mu):
        return list(self.al_grad_pairs_fn(t, v, lam, mu))

    def quad_al_pairs(self, t, v, lam, mu):
        return self.al_quad_pairs_fn(t, v, lam, mu)


def increment_lambda(constraint: Constraint, lam, mu, g_val):
    """lambda <- lambda + mu*g, clamped at 0 for inequalities."""
    new_lam = lam + mu * g_val
    if constraint.is_equality:
        return new_lam
    return torch.clamp_min(new_lam, 0.0)


def mu_eff_ineq(gval, lam, mu):
    """Inequality effective mu: off for satisfied, inactive constraints."""
    inactive = (gval <= SMALL_NUMBER) & (torch.abs(lam) <= SMALL_NUMBER)
    return torch.where(inactive, 0.0, mu)
