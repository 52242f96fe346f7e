"""Per-lane iLQ pieces the batched machine needs (counterpart of
ilqgames_tpu/solver/ilq.py: `ILQResult` at :53, `_expected_decrease` at
:77, `_SolveCarry` at :141). All tensors carry a leading batch axis."""

from __future__ import annotations

import dataclasses

import torch

from ilqgames_tpu_torch.types import (GameSpec, OperatingPoint,
                                      QuadraticCosts, Strategy, _Replace)


def _fixed_order_sum(a: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis by halving it with elementwise adds (zero
    padded to a power of two): the same bits on every device, where
    torch.sum and einsum reduce in a device-specific order."""
    n = a.shape[-1]
    a = torch.nn.functional.pad(a, (0, (1 << (n - 1).bit_length()) - n))
    while a.shape[-1] > 1:
        h = a.shape[-1] // 2
        a = a[..., :h] + a[..., h:]
    return a[..., 0]


def _expected_decrease(spec: GameSpec, quad: QuadraticCosts,
                       alphas: torch.Tensor,
                       delta_xs: torch.Tensor) -> torch.Tensor:
    """ExpectedDecrease, shipped form (costate terms omitted), per lane
    [B]: uses the unscaled LQ alphas and delta_xs. The inner contractions
    are left folds and the outer sum is `_fixed_order_sum`, so the card
    and the CPU draw the same Armijo thresholds."""
    P = spec.num_players
    R_ii = torch.stack([quad.R[:, :, i, i] for i in range(P)], 2)
    r_ii = torch.stack([quad.r[:, :, i, i] for i in range(P)], 2)
    Rr = R_ii[..., 0] * r_ii[..., 0, None]            # [B, N, P, u]
    for v in range(1, spec.umax):
        Rr = Rr + R_ii[..., v] * r_ii[..., v, None]
    Ql = quad.Q[:, 1:, ..., 0] * quad.l[:, 1:, :, 0, None]   # [B, N-1, P, x]
    for y in range(1, spec.xdim):
        Ql = Ql + quad.Q[:, 1:, ..., y] * quad.l[:, 1:, :, y, None]
    control = _fixed_order_sum((alphas * Rr).flatten(1))
    state = _fixed_order_sum((delta_xs[:, 1:, None] * Ql).flatten(1))
    return -control - state


@dataclasses.dataclass(frozen=True)
class ILQResult(_Replace):
    """A bare iLQ solve's result, the fields of the JAX package's
    ILQResult that its callers read. `history` is () unless the solve
    recorded its trips: then (initial_op, ops, strategies, merits,
    converged, failed, active), lanes first and trips second (the JAX
    package's record, ilq.py:352-365, with the initial rollout, which its
    solve_logged makes apart)."""

    op: OperatingPoint
    strategy: Strategy
    total_costs: torch.Tensor
    converged: torch.Tensor
    failed: torch.Tensor
    num_iterations: torch.Tensor
    merit: torch.Tensor
    history: tuple = ()


@dataclasses.dataclass(frozen=True)
class _SolveCarry(_Replace):
    op: OperatingPoint
    strategy: Strategy
    quad: QuadraticCosts
    extreme_ks: torch.Tensor
    last_merit: torch.Tensor
    iteration: torch.Tensor
    converged: torch.Tensor
    failed: torch.Tensor
