"""Solver iterate history: the SolverLog (counterpart of
ilqgames_tpu/utils/solver_log.py; the reference's utils/solver_log.h:
58-140, src/solver_log.cpp).

A host-side accumulator of per-iterate operating points, strategies,
per-player total costs, runtimes and convergence flags, every array held
as numpy (the solve reads its record to the host once, at its end), with
the reference's interpolation accessors and its text layout
(`{t0,xs,us<i>,costs,cumulative_runtimes}.txt` per iterate under a
directory per experiment, src/solver_log.cpp:113-170): the same files
and values as the JAX package's log.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import List, Optional

import numpy as np

from ilqgames_tpu_torch.types import GameSpec, OperatingPoint, Strategy


def _numpy(tree):
    """A container's leaves as numpy arrays (tensors copied to the host)."""
    def leaf(a):
        return (a.detach().cpu().numpy() if hasattr(a, "detach")
                else np.asarray(a))

    return dataclasses.replace(tree, **{
        f.name: leaf(getattr(tree, f.name))
        for f in dataclasses.fields(tree)})


@dataclasses.dataclass
class SolverLog:
    spec: GameSpec
    operating_points: List[OperatingPoint] = dataclasses.field(
        default_factory=list)
    strategies: List[Strategy] = dataclasses.field(default_factory=list)
    total_costs: List[np.ndarray] = dataclasses.field(default_factory=list)
    cumulative_runtimes: List[float] = dataclasses.field(
        default_factory=list)
    was_converged: List[bool] = dataclasses.field(default_factory=list)

    # ------------------------------------------------------------------
    def add_iterate(self, op, strategy, costs, runtime=0.0,
                    converged=False):
        self.operating_points.append(_numpy(op))
        self.strategies.append(_numpy(strategy))
        self.total_costs.append(np.asarray(costs))
        self.cumulative_runtimes.append(float(runtime))
        self.was_converged.append(bool(converged))

    def add_log(self, other: "SolverLog"):
        """Concatenate (reference SolverLog::AddLog,
        utils/solver_log.h:75-83)."""
        offset = (self.cumulative_runtimes[-1] if self.cumulative_runtimes
                  else 0.0)
        for i in range(other.num_iterates):
            self.add_iterate(other.operating_points[i], other.strategies[i],
                             other.total_costs[i],
                             offset + other.cumulative_runtimes[i],
                             other.was_converged[i])

    @property
    def num_iterates(self) -> int:
        return len(self.operating_points)

    @property
    def final_operating_point(self) -> OperatingPoint:
        return self.operating_points[-1]

    @property
    def final_strategies(self) -> Strategy:
        return self.strategies[-1]

    def was_converged_overall(self) -> bool:
        return bool(self.was_converged and self.was_converged[-1])

    # ------------------------------------------------------------------
    # Time-interpolated accessors (src/solver_log.cpp:60-110).
    # ------------------------------------------------------------------
    def _bracket(self, iterate: int, t: float):
        op = self.operating_points[iterate]
        rel = t - float(op.t0)
        lo = int(np.clip(np.floor(rel / self.spec.dt), 0,
                         self.spec.num_time_steps - 1))
        hi = min(lo + 1, self.spec.num_time_steps - 1)
        frac = np.clip(rel / self.spec.dt - lo, 0.0, 1.0)
        return op, lo, hi, frac

    def interpolate_state(self, iterate: int, t: float) -> np.ndarray:
        op, lo, hi, frac = self._bracket(iterate, t)
        return (1.0 - frac) * op.xs[lo] + frac * op.xs[hi]

    def interpolate_control(self, iterate: int, t: float, player: int):
        op, lo, hi, frac = self._bracket(iterate, t)
        return (1.0 - frac) * op.us[lo, player] + frac * op.us[hi, player]

    def state(self, iterate: int, k: int) -> np.ndarray:
        return self.operating_points[iterate].xs[k]

    def control(self, iterate: int, k: int, player: int) -> np.ndarray:
        return self.operating_points[iterate].us[k, player]

    def P(self, iterate: int, k: int, player: int) -> np.ndarray:
        return self.strategies[iterate].Ps[k, player]

    def alpha(self, iterate: int, k: int, player: int) -> np.ndarray:
        return self.strategies[iterate].alphas[k, player]

    # ------------------------------------------------------------------
    # Persistence (the text layout of src/solver_log.cpp:113-170).
    # ------------------------------------------------------------------
    def save(self, experiment_name: Optional[str] = None,
             log_dir: str = "logs") -> str:
        name = experiment_name or default_experiment_name()
        base = os.path.join(log_dir, name)
        for ii in range(self.num_iterates):
            d = os.path.join(base, str(ii))
            os.makedirs(d, exist_ok=True)
            op = self.operating_points[ii]
            np.savetxt(os.path.join(d, "t0.txt"), np.asarray([float(op.t0)]))
            np.savetxt(os.path.join(d, "xs.txt"), op.xs)
            np.savetxt(os.path.join(d, "costs.txt"), self.total_costs[ii])
            np.savetxt(os.path.join(d, "cumulative_runtimes.txt"),
                       np.asarray([self.cumulative_runtimes[ii]]))
            for p in range(self.spec.num_players):
                np.savetxt(os.path.join(d, f"u{p}.txt"),
                           op.us[:, p, : self.spec.udims[p]])
        return base

    def to_npz(self, path: str):
        """Binary dump of the whole history (beyond the reference)."""
        np.savez_compressed(
            path,
            xs=np.stack([o.xs for o in self.operating_points]),
            us=np.stack([o.us for o in self.operating_points]),
            t0=np.asarray([float(o.t0) for o in self.operating_points]),
            Ps=np.stack([s.Ps for s in self.strategies]),
            alphas=np.stack([s.alphas for s in self.strategies]),
            costs=np.stack(self.total_costs),
            runtimes=np.asarray(self.cumulative_runtimes),
            converged=np.asarray(self.was_converged),
        )


def default_experiment_name() -> str:
    """Timestamp-derived name (src/solver_log.cpp:199-207)."""
    return datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
