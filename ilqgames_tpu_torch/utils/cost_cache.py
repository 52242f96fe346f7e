"""Per-cost evaluation cache for inspection and plotting (counterpart of
ilqgames_tpu/utils/cost_cache.py; the reference's PlayerCostCache,
utils/player_cost_cache.h:60-100): every named cost of every player at
every knot of every iterate of a SolverLog, so that a cost inspector can
plot any one cost against time. Evaluated on the CPU from the log's numpy
arrays; values are numpy."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ilqgames_tpu_torch.utils.solver_log import SolverLog


def evaluate_costs(problem, op) -> List[Dict[str, np.ndarray]]:
    """{player -> {cost name -> [N] stage values}} at one operating point
    (xs [N, x], us [N, P, u], numpy or tensors), at the relative knot
    times k dt."""
    ts = problem.spec.horizon_times()
    xs, us = torch.as_tensor(op.xs), torch.as_tensor(op.us)
    out: List[Dict[str, np.ndarray]] = []
    for pc in problem.player_costs:
        per: Dict[str, np.ndarray] = {}
        for c in pc.state_costs:
            per[c.name] = c.evaluate(ts, xs).numpy()
        for j, c in pc.control_costs:
            per[c.name] = c.evaluate(ts, us[:, j]).numpy()
        out.append(per)
    return out


class PlayerCostCache:
    """Evaluates and stores every cost at every iterate of a SolverLog."""

    def __init__(self, problem, log: SolverLog):
        self.problem = problem
        self.log = log
        self._cache = [evaluate_costs(problem, op)
                       for op in log.operating_points]

    def evaluate(self, iterate: int, player: int, name: str) -> np.ndarray:
        return self._cache[iterate][player][name]

    def names(self, player: int) -> Tuple[str, ...]:
        return tuple(self._cache[0][player].keys()) if self._cache else ()
