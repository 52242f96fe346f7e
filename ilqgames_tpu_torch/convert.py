"""Carry state between the JAX package and the port.

The `from_*` functions take a JAX package container (any object with the
same field names whose leaves convert with `numpy.asarray`) and return
the port's container with copied tensors on `device`; field names and
batched shapes are the same on both sides. `to_numpy` goes the other way:
the port's container with numpy leaves, for comparison. Nothing here
imports jax.
"""

from __future__ import annotations

import numpy as np
import torch

from ilqgames_tpu_torch.costs.player_cost import ALState
from ilqgames_tpu_torch.solver.al import ALResult
from ilqgames_tpu_torch.solver.fused import _FusedCarry
from ilqgames_tpu_torch.solver.ilq import _SolveCarry
from ilqgames_tpu_torch.types import OperatingPoint, QuadraticCosts, \
    Strategy, tree_map


def _t(a, device=None) -> torch.Tensor:
    return torch.tensor(np.asarray(a), device=device)


def from_operating_point(src, device=None) -> OperatingPoint:
    return OperatingPoint(xs=_t(src.xs, device), us=_t(src.us, device),
                          t0=_t(src.t0, device))


def from_strategy(src, device=None) -> Strategy:
    return Strategy(Ps=_t(src.Ps, device), alphas=_t(src.alphas, device))


def from_quadratic_costs(src, device=None) -> QuadraticCosts:
    return QuadraticCosts(Q=_t(src.Q, device), l=_t(src.l, device),
                          R=_t(src.R, device), r=_t(src.r, device))


def from_al_state(src, device=None) -> ALState:
    return ALState(
        state_lambdas=tuple(_t(l, device) for l in src.state_lambdas),
        control_lambdas=tuple(_t(l, device) for l in src.control_lambdas),
        mu=_t(src.mu, device))


def from_solve_carry(src, device=None) -> _SolveCarry:
    return _SolveCarry(
        op=from_operating_point(src.op, device),
        strategy=from_strategy(src.strategy, device),
        quad=from_quadratic_costs(src.quad, device),
        extreme_ks=_t(src.extreme_ks, device),
        last_merit=_t(src.last_merit, device),
        iteration=_t(src.iteration, device),
        converged=_t(src.converged, device),
        failed=_t(src.failed, device))


def from_fused_carry(src, device=None) -> _FusedCarry:
    return _FusedCarry(
        c=from_solve_carry(src.c, device),
        al=from_al_state(src.al, device),
        warm_op=from_operating_point(src.warm_op, device),
        warm_strategy=from_strategy(src.warm_strategy, device),
        inner_iters=_t(src.inner_iters, device),
        cum_iters=_t(src.cum_iters, device),
        violation=_t(src.violation, device),
        success=_t(src.success, device),
        done=_t(src.done, device))


def from_al_result(src, device=None) -> ALResult:
    return ALResult(
        op=from_operating_point(src.op, device),
        strategy=from_strategy(src.strategy, device),
        total_costs=_t(src.total_costs, device),
        converged=_t(src.converged, device),
        max_violation=_t(src.max_violation, device),
        cumulative_iterations=_t(src.cumulative_iterations, device),
        al_state=from_al_state(src.al_state, device))


def to_numpy(obj):
    """The same container with numpy leaves (copied to the host)."""
    return tree_map(lambda a: a.detach().cpu().numpy(), obj)
