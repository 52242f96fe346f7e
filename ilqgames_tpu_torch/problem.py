"""A minimal game description (counterpart of ilqgames_tpu/problem.py).

Only the data the batched solver and the receding-horizon runtime need:
the solve entry points live in solver/batched.py, which takes
(dynamics, player_costs, spec). An example may give its own initial
operating point (`op_initializer`, as the JAX package's: the reference
examples' InitializeAlongRoute, src/initialize_along_route.cpp:54-73);
else it is all zeros (solver/problem.h:139-148).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ilqgames_tpu_torch.costs.player_cost import ALState, PlayerCost
from ilqgames_tpu_torch.dynamics.base import MultiPlayerDynamics
from ilqgames_tpu_torch.types import GameSpec, OperatingPoint, Strategy


@dataclasses.dataclass(frozen=True, eq=False)
class Problem:
    name: str
    dynamics: MultiPlayerDynamics
    player_costs: Tuple[PlayerCost, ...]
    x0: torch.Tensor  # [xdim], on the CPU
    spec: GameSpec
    # (spec, op) -> op: one instance's operating point (xs [N, x]).
    op_initializer: Optional[Callable] = None

    def initial_operating_point(self, t0: float = 0.0,
                                device=None) -> OperatingPoint:
        op = OperatingPoint.zeros(self.spec, t0, device=device)
        if self.op_initializer is not None:
            op = self.op_initializer(self.spec, op)
        return op

    def initial_strategy(self, device=None) -> Strategy:
        return Strategy.zeros(self.spec, device=device)

    def initial_al_state(self, batch: int, device=None) -> ALState:
        """Fresh multipliers for `batch` lanes: every lambda 0, mu the
        default."""
        return ALState.init(self.player_costs, self.spec, batch,
                            device=device)
