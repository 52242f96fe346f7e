"""Augmented-Lagrangian pieces the batched machine needs (counterpart of
ilqgames_tpu/solver/al.py: `constraint_violations` at :35,
`max_constraint_violation` at :71, `ALResult` at :84). All tensors carry
a leading batch axis."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ilqgames_tpu_torch.costs import player_cost as pcost
from ilqgames_tpu_torch.costs.base import increment_lambda
from ilqgames_tpu_torch.types import GameSpec, OperatingPoint, Strategy, \
    _Replace


def constraint_violations(player_costs, spec: GameSpec, op: OperatingPoint,
                          al: pcost.ALState
                          ) -> Tuple[pcost.ALState, torch.Tensor]:
    """Evaluate every constraint along each lane's trajectory, increment
    the multipliers, and return the max raw constraint value [B]."""
    ts = spec.horizon_times(op.xs.device)
    max_violation = torch.full(op.xs.shape[:1], -torch.inf,
                               device=op.xs.device)
    new_state_lams, new_control_lams = [], []
    for i, pc in enumerate(player_costs):
        rows = []
        for ci, con in enumerate(pc.state_constraints):
            g = con.g(ts, op.xs)                                # [B, N]
            max_violation = torch.maximum(max_violation, g.amax(-1))
            rows.append(increment_lambda(con, al.state_lambdas[i][:, ci],
                                         al.mu[:, None], g))
        new_state_lams.append(torch.stack(rows, 1) if rows
                              else al.state_lambdas[i])
        rows = []
        for ci, (j, con) in enumerate(pc.control_constraints):
            g = con.g(ts, op.us[:, :, j])
            max_violation = torch.maximum(max_violation, g.amax(-1))
            rows.append(increment_lambda(con, al.control_lambdas[i][:, ci],
                                         al.mu[:, None], g))
        new_control_lams.append(torch.stack(rows, 1) if rows
                                else al.control_lambdas[i])
    return (al.replace(state_lambdas=tuple(new_state_lams),
                       control_lambdas=tuple(new_control_lams)),
            max_violation)


def max_constraint_violation(player_costs, spec: GameSpec,
                             op: OperatingPoint) -> torch.Tensor:
    """Max raw g over all constraints and knots, per lane [B]."""
    ts = spec.horizon_times(op.xs.device)
    v = torch.full(op.xs.shape[:1], -torch.inf, device=op.xs.device)
    for pc in player_costs:
        for con in pc.state_constraints:
            v = torch.maximum(v, con.g(ts, op.xs).amax(-1))
        for j, con in pc.control_constraints:
            v = torch.maximum(v, con.g(ts, op.us[:, :, j]).amax(-1))
    return v


@dataclasses.dataclass(frozen=True)
class ALResult(_Replace):
    op: OperatingPoint
    strategy: Strategy
    total_costs: torch.Tensor
    converged: torch.Tensor
    max_violation: torch.Tensor
    cumulative_iterations: torch.Tensor
    al_state: pcost.ALState
