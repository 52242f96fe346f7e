"""The flat AL + iLQ machine's carry (counterpart of
ilqgames_tpu/solver/fused.py:42 `_FusedCarry`). The batched trips that
advance it live in solver/batched.py."""

from __future__ import annotations

import dataclasses

import torch

from ilqgames_tpu_torch.costs import player_cost as pcost
from ilqgames_tpu_torch.solver import ilq
from ilqgames_tpu_torch.types import OperatingPoint, Strategy, _Replace


@dataclasses.dataclass(frozen=True)
class _FusedCarry(_Replace):
    c: ilq._SolveCarry  # inner iLQ iteration state
    al: pcost.ALState
    warm_op: OperatingPoint
    warm_strategy: Strategy
    inner_iters: torch.Tensor  # iterations inside the current inner solve
    cum_iters: torch.Tensor
    violation: torch.Tensor  # latest boundary violation (inf before first)
    success: torch.Tensor  # all inner solves so far succeeded
    done: torch.Tensor
