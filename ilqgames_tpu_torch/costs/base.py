"""Cost and constraint primitives (counterpart of ilqgames_tpu/costs/base.py).

A cost gives its gradient and quadraticization as sparse (index, value)
pairs, the form the kernels use, or, where the JAX package has only a
dense `quad_fn`, as a dense Hessian and gradient over every index of its
input (the JAX package's rules, costs/base.py:97-165: such a cost has no
pairs). A constraint gives its augmented-Lagrangian term lambda*g +
mu_eff*g^2/2 the same two ways. Values are tensors over any batch shape (the
solver evaluates every lane and knot at once); inputs `v` carry the
state or control index on their last axis.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ilqgames_tpu_torch.types import SMALL_NUMBER


def _fold(pairs) -> dict:
    """Pairs accumulated per key in pair order: the first of a key sets
    it, later ones add to it."""
    acc = {}
    for key, v in pairs:
        acc[key] = acc[key] + v if key in acc else v
    return acc


def _like(value, like) -> torch.Tensor:
    """A pair's value (a tensor or a Python float) as a float32 tensor of
    `like`'s shape."""
    return torch.broadcast_to(torch.as_tensor(value, dtype=like.dtype,
                                              device=like.device),
                              like.shape)


def assemble_vector(d: int, pairs, like) -> torch.Tensor:
    """[..., d] from (index, value) pairs folded per index in pair order;
    the other entries +0 (the JAX package's assemble_vector)."""
    acc = _fold(pairs)
    zero = torch.zeros_like(like)
    return torch.stack([_like(acc.get(i, zero), like) for i in range(d)],
                       dim=-1)


def assemble_matrix(d: int, pairs, like) -> torch.Tensor:
    """[..., d, d] from ((i, j), value) pairs folded per key in pair
    order; the other entries +0 (the JAX package's assemble_matrix)."""
    acc = _fold(pairs)
    zero = torch.zeros_like(like)
    return torch.stack([torch.stack(
        [_like(acc.get((i, j), zero), like) for j in range(d)], dim=-1)
        for i in range(d)], dim=-2)


@dataclasses.dataclass(frozen=True, eq=False)
class Cost:
    """A scalar stage cost on one input vector (a state x or one player's u).

    evaluate: (t_rel, v) -> value.
    grad_pairs_fn: (t, v) -> [(dim, value)], or None.
    quad_pairs_fn: (t, v) -> ([((i, j), value)], [(dim, value)]), or None.
    device: the atom's form in the stage and merit kernels
    (csrc/costs.cuh), (kind, {parameter: value}); None when it has none.
    quad_fn: (t, v) -> (hess [..., d, d], grad [..., d]), the dense form
    over all d = v.shape[-1] indices, or None.
    grad_fn: (t, v) -> grad [..., d], quad_fn's gradient alone (so that
    the merit path builds no Hessian), or None.
    """

    name: str
    evaluate: Callable
    grad_pairs_fn: Optional[Callable] = None
    quad_pairs_fn: Optional[Callable] = None
    device: Optional[tuple] = None
    quad_fn: Optional[Callable] = None
    grad_fn: Optional[Callable] = None

    @property
    def has_pairs(self) -> bool:
        """Whether the cost has a sparse quadraticization (none when it
        has a dense `quad_fn`, as in the JAX package)."""
        return self.quad_fn is None and self.quad_pairs_fn is not None

    def gradient_pairs(self, t, v):
        """The sparse gradient, or None when the cost has only a dense
        form."""
        if self.grad_pairs_fn is None:
            return None
        return list(self.grad_pairs_fn(t, v))

    def quad_pairs(self, t, v):
        """The sparse quadraticization, or None when the cost has a dense
        `quad_fn` (or no pairs)."""
        if not self.has_pairs:
            return None
        return self.quad_pairs_fn(t, v)

    def gradient(self, t, v):
        """The dense gradient [..., d]: the pairs assembled, else the
        dense form's."""
        pairs = self.gradient_pairs(t, v)
        if pairs is not None:
            return assemble_vector(v.shape[-1], pairs, v[..., 0])
        if self.grad_fn is not None:
            return self.grad_fn(t, v)
        return self.quad_fn(t, v)[1]

    def quadraticize(self, t, v):
        """The dense (hess [..., d, d], grad [..., d]): `quad_fn`'s, else
        the pairs assembled."""
        if self.quad_fn is not None:
            return self.quad_fn(t, v)
        hp, gp = self.quad_pairs_fn(t, v)
        d = v.shape[-1]
        return (assemble_matrix(d, hp, v[..., 0]),
                assemble_vector(d, gp, v[..., 0]))


@dataclasses.dataclass(frozen=True, eq=False)
class Constraint:
    """A scalar constraint g(t, v) == 0 (equality) or g(t, v) <= 0.

    Its augmented-Lagrangian term lambda*g + mu_eff*g^2/2 comes as sparse
    pairs (al_grad_pairs_fn, al_quad_pairs_fn: (t, v, lam, mu) -> pairs,
    as Cost's), or, where the JAX package has no pairs for it, in a dense
    form over all d = v.shape[-1] indices: quad_fn (t, v, lam, mu) ->
    (hess [..., d, d], grad [..., d]) and grad_fn, its gradient alone.
    The JAX package's precedence holds (costs/base.py:213-285): pairs
    first (al_grad_pairs_fn may give None, then there are none), then the
    dense form. device: as Cost.device.
    """

    name: str
    g: Callable
    is_equality: bool
    al_grad_pairs_fn: Optional[Callable] = None
    al_quad_pairs_fn: Optional[Callable] = None
    device: Optional[tuple] = None  # as Cost.device
    quad_fn: Optional[Callable] = None
    grad_fn: Optional[Callable] = None

    def gradient_al_pairs(self, t, v, lam, mu):
        """The sparse AL gradient, or None where there are no pairs."""
        if self.al_grad_pairs_fn is None:
            return None
        pp = self.al_grad_pairs_fn(t, v, lam, mu)
        return None if pp is None else list(pp)

    def quad_al_pairs(self, t, v, lam, mu):
        """The sparse AL quadraticization, or None where there are no
        pairs."""
        if self.al_quad_pairs_fn is None:
            return None
        return self.al_quad_pairs_fn(t, v, lam, mu)

    def gradient_al(self, t, v, lam, mu):
        """The dense AL gradient [..., d]: the pairs assembled, else the
        dense form's."""
        pairs = self.gradient_al_pairs(t, v, lam, mu)
        if pairs is not None:
            return assemble_vector(v.shape[-1], pairs, v[..., 0])
        if self.grad_fn is not None:
            return self.grad_fn(t, v, lam, mu)
        return self.quad_fn(t, v, lam, mu)[1]

    def quadraticize_al(self, t, v, lam, mu):
        """The dense AL (hess [..., d, d], grad [..., d]): the pairs
        assembled, else the dense form's."""
        qp = self.quad_al_pairs(t, v, lam, mu)
        if qp is None:
            return self.quad_fn(t, v, lam, mu)
        d = v.shape[-1]
        return (assemble_matrix(d, qp[0], v[..., 0]),
                assemble_vector(d, qp[1], v[..., 0]))


def increment_lambda(constraint: Constraint, lam, mu, g_val):
    """lambda <- lambda + mu*g, clamped at 0 for inequalities."""
    new_lam = lam + mu * g_val
    if constraint.is_equality:
        return new_lam
    return torch.clamp_min(new_lam, 0.0)


def extreme_index(vals, is_min: bool):
    """The index of the extreme of `vals` along the last axis, as
    jnp.argmax / jnp.argmin choose it: the first extreme, and the first
    NaN where there is one. Only int8 argmax's first-maximum rule is
    relied upon, on every device."""
    m = vals.amin(-1, keepdim=True) if is_min else vals.amax(-1, keepdim=True)
    hit = (vals == m) | (torch.isnan(vals) & torch.isnan(m))
    return hit.to(torch.int8).argmax(-1)


def mu_eff_ineq(gval, lam, mu):
    """Inequality effective mu: off for satisfied, inactive constraints."""
    inactive = (gval <= SMALL_NUMBER) & (torch.abs(lam) <= SMALL_NUMBER)
    return torch.where(inactive, 0.0, mu)
