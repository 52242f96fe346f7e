"""Problem layer: a game description and its per-instance solve entry
points (counterpart of ilqgames_tpu/problem.py).

A Problem bundles (dynamics, player costs, x0, spec) and an optional
initial operating point (`op_initializer`, as the JAX package's: the
reference examples' InitializeAlongRoute,
src/initialize_along_route.cpp:54-73; else all zeros,
solver/problem.h:139-148).

The JAX package solves one instance with its per-instance device loops
(`al.solve`, `ilq.solve`). Here one instance is a batch of one on the
batched machine (solver/batched.py): one lane padded to a block of
LANE_BLOCK lanes (copies of the lane), on the plain host-stepped driver.
That is the JAX package's own result on games without a MAX or MIN
player. On such games its two machines part: its per-instance iLQ
quadraticizes the accepted iterate with the previous iterate's extreme
knots (ilq.py:263), its batched machine with the accepted iterate's
(batched.py:202), and the port follows the batched machine.

Every entry point runs on `device`, "cuda" unless the caller asks for the
CPU: a missing CUDA device raises (`device_of`), and on the card the
game's kernels are built first (`ops/cuda/libraries.build_kernels`).
Inputs are one instance (x0 [xdim], an operating point, a strategy, an
ALState without the batch axis) on any device, and so are the results.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ilqgames_tpu_torch.costs import player_cost as pcost
from ilqgames_tpu_torch.costs.player_cost import ALState, PlayerCost
from ilqgames_tpu_torch.dynamics.base import MultiPlayerDynamics
from ilqgames_tpu_torch.ops.cuda import libraries
from ilqgames_tpu_torch.solver.params import SolverParams
from ilqgames_tpu_torch.types import GameSpec, OperatingPoint, Strategy, \
    tree_map

# One instance's lanes on the batched machine (bench.GOLDEN_BLOCK).
LANE_BLOCK = 8


def device_of(device) -> torch.device:
    """`device` as a torch.device. A CUDA device that is not present
    raises: no entry point falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r}: no CUDA device is present (pass "
            "device='cpu' to run on the CPU)")
    return dev


def _lane(tree, dev):
    """One instance's container as a batch of one on `dev`."""
    return tree_map(lambda a: torch.as_tensor(a).to(dev)[None], tree)


def _unbatch(tree):
    return tree_map(lambda a: a[0], tree)


@dataclasses.dataclass(frozen=True, eq=False)
class Problem:
    name: str
    dynamics: MultiPlayerDynamics
    player_costs: Tuple[PlayerCost, ...]
    x0: torch.Tensor  # [xdim], on the CPU
    spec: GameSpec
    # (spec, op) -> op: one instance's operating point (xs [N, x]).
    op_initializer: Optional[Callable] = None

    @property
    def is_constrained(self) -> bool:
        return pcost.is_constrained(self.player_costs)

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

    # ------------------------------------------------------------------
    # Solve entry points: one instance, a batch of one on the machine.
    # ------------------------------------------------------------------
    def prepare(self, params: SolverParams, device) -> torch.device:
        """The device of a solve (`device_of`); on the card, full float32
        precision and the game's kernels built (one nvcc per library not
        yet built, all at once)."""
        dev = device_of(device)
        if dev.type == "cuda":
            libraries.set_precision()
            libraries.build_kernels(self.dynamics, self.spec,
                                    self.player_costs, params.open_loop)
        return dev

    def _start(self, x0, warm_op, warm_strategy, dev):
        """(x0, warm_op, warm_strategy) as batches of one on `dev`, the
        defaults filled in."""
        x0 = self.x0 if x0 is None else x0
        op = self.initial_operating_point() if warm_op is None else warm_op
        st = self.initial_strategy() if warm_strategy is None \
            else warm_strategy
        return _lane(x0, dev), _lane(op, dev), _lane(st, dev)

    def solve(self, params: SolverParams = SolverParams(), x0=None,
              warm_op: Optional[OperatingPoint] = None,
              warm_strategy: Optional[Strategy] = None,
              al_state: Optional[ALState] = None, jit: bool = True,
              device="cuda"):
        """The full solve (AL-wrapped if constrained) from a warm start:
        the exec mains' AugmentedLagrangianSolver flow
        (exec/three_player_intersection/main.cpp:100-146), as the JAX
        package's Problem.solve. Returns one instance's ALResult. `jit` is
        accepted and ignored."""
        from ilqgames_tpu_torch.solver import batched

        dev = self.prepare(params, device)
        x0b, op, st = self._start(x0, warm_op, warm_strategy, dev)
        al = (self.initial_al_state(1, dev) if al_state is None
              else _lane(al_state, dev))
        run = batched.make_host_batched_warm_solver(
            self.dynamics, self.player_costs, self.spec, params,
            batch_block=LANE_BLOCK)
        return _unbatch(run(x0b, op, st, al))

    def solve_unconstrained(self, params: SolverParams = SolverParams(),
                            x0=None, warm_op: Optional[OperatingPoint] = None,
                            warm_strategy: Optional[Strategy] = None,
                            max_iterations: Optional[int] = None,
                            jit: bool = True, device="cuda"):
        """Bare iLQ solve, the reference's plain ILQSolver path:
        constraints enter only through their AL terms at the initial
        multipliers, which are never updated, and the budget is
        `max_iterations` (default params.max_solver_iters). Returns one
        instance's ilq.ILQResult. `jit` is accepted and ignored."""
        return self._bare(params, x0, warm_op, warm_strategy,
                          max_iterations, False, device)

    def solve_logged(self, params: SolverParams = SolverParams(), x0=None,
                     warm_op: Optional[OperatingPoint] = None,
                     warm_strategy: Optional[Strategy] = None,
                     max_iterations: Optional[int] = None, device="cuda"):
        """solve_unconstrained's run with its iterate history as a
        SolverLog (the reference ILQSolver::Solve filling its
        utils/solver_log.h): iterate 0 is the initial rollout
        (src/ilq_solver.cpp:107-112), then one iterate per iteration, a
        failed step's reverted iterate included, each with its players'
        total costs and its converged flag. The record stays on the device
        until the solve ends and is read once. Returns (ILQResult, log)."""
        from ilqgames_tpu_torch import convert
        from ilqgames_tpu_torch.utils.solver_log import SolverLog

        res = self._bare(params, x0, warm_op, warm_strategy, max_iterations,
                         True, device)
        init_op, ops, strats, _, conv, _, active = res.history
        n = int(active.sum())
        every = OperatingPoint(xs=torch.cat([init_op.xs[None], ops.xs[:n]]),
                               us=torch.cat([init_op.us[None], ops.us[:n]]),
                               t0=torch.cat([init_op.t0[None], ops.t0[:n]]))
        costs, _ = pcost.total_costs(self.player_costs, self.spec, every)
        every, strats, costs, conv = convert.to_numpy(
            (every, strats, costs, conv))
        warm = convert.to_numpy(self.initial_strategy() if warm_strategy
                                is None else warm_strategy)
        log = SolverLog(spec=self.spec)
        log.add_iterate(_unbatch(every), warm, costs[0])
        for i in range(n):
            log.add_iterate(tree_map(lambda a: a[i + 1], every),
                            tree_map(lambda a: a[i], strats), costs[i + 1],
                            converged=bool(conv[i]))
        return res, log

    def _bare(self, params, x0, warm_op, warm_strategy, max_iterations,
              record, device):
        from ilqgames_tpu_torch.solver import batched

        dev = self.prepare(params, device)
        x0b, op, st = self._start(x0, warm_op, warm_strategy, dev)
        run = batched.make_host_ilq_solver(
            self.dynamics, self.player_costs, self.spec, params,
            max_iterations=max_iterations, record_history=record,
            batch_block=LANE_BLOCK)
        return _unbatch(run(x0b, op, st, self.initial_al_state(1, dev)))
