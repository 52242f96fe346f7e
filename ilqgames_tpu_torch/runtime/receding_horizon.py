"""Receding-horizon runtime: warm-start shifting, solution splicing and
the batched fixed-cadence replanning simulator (counterpart of
ilqgames_tpu/runtime/receding_horizon.py).

The JAX package writes these as per-instance functions and vmaps them
over lanes; here every function takes batched containers (a leading
lane axis B on every tensor, t0 and times [B]) and indexes each lane's
own knot with a gather. Knot indices are gathered as the JAX package
gathers them: a negative index wraps once, then every index is clamped
to the horizon. The arithmetic on times and states follows the JAX
functions' float32 operations in their order, with IEEE division
(`dyn_base.true_div`), left folds and `fmath` trig, so that the card and
the CPU give the same bits. The reference's contract is a fixed planner
budget: each replan consumes exactly `planner_time` of simulated time
(src/receding_horizon_simulator.cpp:119).

The per-instance simulators `simulate` and `simulate_minimally_invasive`
are `simulate_batched`'s pieces at B=1: one agent's lane padded to a
block of `problem.LANE_BLOCK` lanes on the batched machine, as
Problem.solve runs one instance. They run on `device`, "cuda" unless the
caller asks for the CPU (`problem.device_of`).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ilqgames_tpu_torch import problem as problem_mod
from ilqgames_tpu_torch.costs import player_cost as pcost
from ilqgames_tpu_torch.dynamics import base as dyn_base
from ilqgames_tpu_torch.dynamics.base import true_div
from ilqgames_tpu_torch.ops.cuda.sweep import _umask_flat
from ilqgames_tpu_torch.solver import batched
from ilqgames_tpu_torch.types import SMALL_NUMBER, GameSpec, \
    OperatingPoint, Strategy, _Replace, const_tensor

# Past steps the splicer keeps for a low-level path follower
# (src/solution_splicer.cpp:71).
NUM_PREVIOUS_STEPS_TO_SAVE = 5


def _lanes(a: torch.Tensor) -> torch.Tensor:
    return torch.arange(a.shape[0], device=a.device)


def _lane_take(a: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """a[b, k[b]] for every lane b (a [B, N, ...], k [B] integer)."""
    N = a.shape[1]
    k = torch.where(k < 0, k + N, k).clamp(0, N - 1)
    return a[_lanes(a), k]


def _knot(spec: GameSpec, rel: torch.Tensor) -> torch.Tensor:
    """The knot that holds relative time `rel` [B], int32."""
    return torch.floor(true_div(rel + SMALL_NUMBER, spec.dt)).to(torch.int32)


def _controls_at(spec: GameSpec, op: OperatingPoint, strategy: Strategy, k,
                 x, x_ref) -> torch.Tensor:
    """u_i = (u_ref_i(k) - P_i[k](x - x_ref) - alpha_i[k]) * mask per lane:
    [B, P, umax], P·δx as a left fold over the state index."""
    mask = const_tensor(_umask_flat(spec), x.device)
    delta = x - x_ref                                   # [B, x]
    Pk = _lane_take(strategy.Ps, k)                     # [B, P, u, x]
    acc = Pk[..., 0] * delta[:, None, None, 0]
    for j in range(1, spec.xdim):
        acc = acc + Pk[..., j] * delta[:, None, None, j]
    u = (_lane_take(op.us, k) - acc) - _lane_take(strategy.alphas, k)
    return u * mask.reshape(spec.num_players, spec.umax)


def _rk4_span(dyn, t, span, x, us, num_substeps: int = 2) -> torch.Tensor:
    """RK4 with `num_substeps` substeps over each lane's own interval
    span [B] (the reference integrator's partial steps)."""
    hl = true_div(span, num_substeps)
    h = hl[:, None]
    for i in range(num_substeps):
        ts = t + i * hl
        k1 = h * dyn.ode(ts, x, us)
        k2 = h * dyn.ode(ts + 0.5 * hl, x + 0.5 * k1, us)
        k3 = h * dyn.ode(ts + 0.5 * hl, x + 0.5 * k2, us)
        k4 = h * dyn.ode(ts + hl, x + k3, us)
        x = x + true_div(k1 + 2.0 * (k2 + k3) + k4, 6.0)
    return x


def integrate_to_next_time_step(dyn, spec: GameSpec, op: OperatingPoint,
                                strategy: Strategy, t0, x0):
    """Each lane's partial step from absolute time t0 [B] to its next knot
    (src/multi_player_integrable_system.cpp:107-137): (x [B, x], t [B])."""
    N, dt = spec.num_time_steps, spec.dt
    rel = t0 - op.t0
    k = _knot(spec, rel)
    remaining = dt * (k + 1).to(torch.float32) - rel
    frac = true_div(remaining, dt)[:, None]
    x_next_ref = _lane_take(op.xs, torch.clamp(k + 1, max=N - 1))
    x_ref = torch.where((k + 1 < N)[:, None],
                        frac * _lane_take(op.xs, k)
                        + (1.0 - frac) * x_next_ref, op.xs[:, N - 1])
    us = _controls_at(spec, op, strategy, k, x0, x_ref)
    return _rk4_span(dyn, t0, remaining, x0, us), t0 + remaining


def integrate_span(dyn, spec: GameSpec, op: OperatingPoint,
                   strategy: Strategy, t_from, t_to, x, max_steps: int):
    """Play each lane's plan back from absolute t_from [B] to t_to [B]
    starting at x [B, x]: the partial step to the grid, at most
    `max_steps` full steps (masked per lane), then the partial step to
    t_to (the reference's MultiPlayerIntegrableSystem::Integrate)."""
    dt = spec.dt
    last = spec.num_time_steps - 1
    x, t = integrate_to_next_time_step(dyn, spec, op, strategy, t_from, x)
    t = torch.minimum(t, t_to)
    for _ in range(max_steps):
        k = torch.clamp(_knot(spec, t - op.t0), max=last)
        us = _controls_at(spec, op, strategy, k, x, _lane_take(op.xs, k))
        x_new = dyn_base.integrate(dyn, t, dt, x, us)
        take = t + dt <= t_to + SMALL_NUMBER
        x = torch.where(take[:, None], x_new, x)
        t = torch.where(take, t + dt, t)
    k = torch.clamp(_knot(spec, t - op.t0), max=last)
    us = _controls_at(spec, op, strategy, k, x, _lane_take(op.xs, k))
    return _rk4_span(dyn, t, torch.clamp(t_to - t, min=0.0), x, us)


def _propagate_tail(dyn, spec: GameSpec, xs_shift, valid, new_t0,
                    start: int) -> torch.Tensor:
    """The shifted plan's states [B, N, x]: knot k keeps xs_shift[:, k]
    where valid[:, k], else is one zero-control step from knot k - 1 (the
    JAX package's scan over every knot). Knots before `start` (>= 1) must
    be valid on every lane: the chain only matters from the first knot
    that some lane lacks, so it starts there with the same bits."""
    N, dt = spec.num_time_steps, spec.dt
    if start >= N:
        return xs_shift
    zero_u = xs_shift.new_zeros(
        (xs_shift.shape[0], spec.num_players, spec.umax))
    rows = [xs_shift[:, :start]]
    x_prev = xs_shift[:, start - 1]
    for k in range(start, N):
        x_int = dyn_base.integrate(
            dyn, new_t0 + float(np.float32(k - 1) * np.float32(dt)), dt,
            x_prev, zero_u)
        x_prev = torch.where(valid[:, k, None], xs_shift[:, k], x_int)
        rows.append(x_prev[:, None])
    return torch.cat(rows, 1)


def setup_next_receding_horizon(dyn, spec: GameSpec, op: OperatingPoint,
                                strategy: Strategy, x0, t0,
                                planner_time: float):
    """Each lane's Problem::SetUpNextRecedingHorizon
    (src/problem.cpp:64-186): integrate the true state x0 [B, x] from t0
    [B] along the plan for the planner's budget, find the nearest plan
    state by the ego's position, stitch (ego from the plan, the others
    from the integrated state), left-shift the plan and strategy by that
    many knots, zero the tail's controls and gains and propagate its
    states with zero controls. Returns (new_op, new_strategy, new_x0);
    new_op.t0 lands within one dt of t0 + planner_time. Reads one number
    to the host: the largest shift, where the tail starts."""
    N, dt = spec.num_time_steps, spec.dt

    # SyncToExistingProblem (:64-125).
    rel = t0 - op.t0
    k_cur = torch.floor(true_div(rel, dt)).to(torch.int32)
    remaining = dt * (k_cur + 1).to(torch.float32) - rel
    bump = remaining < 0.9 * dt
    k_cur = torch.where(bump, k_cur + 1, k_cur)
    remaining = torch.where(bump, dt - remaining, remaining)

    x, _ = integrate_to_next_time_step(dyn, spec, op, strategy, t0, x0)
    new_t0 = t0 + remaining
    n_full = torch.where(
        remaining <= planner_time,
        (true_div(planner_time - remaining, dt) + SMALL_NUMBER).to(
            torch.int32),
        torch.zeros_like(k_cur))
    k = k_cur + 1
    for i in range(int(planner_time / dt) + 1):
        kk = torch.clamp(k, max=N - 1)
        us = _controls_at(spec, op, strategy, kk, x, _lane_take(op.xs, kk))
        x_new = dyn_base.integrate(dyn, op.t0 + kk.to(torch.float32) * dt,
                                   dt, x, us)
        take = i < n_full
        x = torch.where(take[:, None], x_new, x)
        k = torch.where(take, k + 1, k)
    new_t0 = new_t0 + dt * n_full.to(torch.float32)

    # The nearest plan state by the ego's squared position distance (the
    # reference measures the ego subsystem only,
    # src/concatenated_dynamical_system.cpp:109-117); ties take the first.
    pos = (dyn.position_dims[0] if dyn.position_dims
           else tuple(range(min(2, spec.xdim))))
    d = None
    for p in pos:
        e = op.xs[:, :, p] - x[:, None, p]
        d = e * e if d is None else d + e * e
    shift = torch.argmin(d, dim=1)

    ego = spec.xdims[0]
    new_x0 = torch.cat([_lane_take(op.xs, shift)[:, :ego], x[:, ego:]], 1)

    # Left-shift by `shift`, zero the tail (:127-186).
    idx = torch.arange(N, device=x0.device)[None] + shift[:, None]
    valid = idx < N
    lanes = _lanes(x0)[:, None]
    take_c = lambda a: a[lanes, idx.clamp(max=N - 1)]
    zero_tail = lambda a: a * valid.to(a.dtype).reshape(
        valid.shape + (1,) * (a.ndim - 2))
    xs_shift = take_c(op.xs)
    xs_new = _propagate_tail(dyn, spec, xs_shift, valid, new_t0,
                             N - int(shift.max()))
    return (OperatingPoint(xs=xs_new, us=zero_tail(take_c(op.us)),
                           t0=new_t0),
            Strategy(Ps=zero_tail(take_c(strategy.Ps)),
                     alphas=zero_tail(take_c(strategy.alphas))),
            new_x0)


@dataclasses.dataclass(frozen=True)
class Splicer(_Replace):
    """Each lane's execution plan: the horizon plus at most
    NUM_PREVIOUS_STEPS_TO_SAVE past steps. op.xs [B, N + KEEP, x] and
    the other arrays likewise, op.t0 [B] the time of entry 0; `length`
    [B] int32 counts the valid entries."""

    op: OperatingPoint
    strategy: Strategy
    length: torch.Tensor

    @classmethod
    def create(cls, spec: GameSpec, op: OperatingPoint,
               strategy: Strategy) -> "Splicer":
        keep = NUM_PREVIOUS_STEPS_TO_SAVE
        pad = lambda a: torch.cat(
            [a, a.new_zeros((a.shape[0], keep) + a.shape[2:])], 1)
        return cls(op=OperatingPoint(xs=pad(op.xs), us=pad(op.us),
                                     t0=op.t0),
                   strategy=Strategy(Ps=pad(strategy.Ps),
                                     alphas=pad(strategy.alphas)),
                   length=torch.full(op.t0.shape, spec.num_time_steps,
                                     dtype=torch.int32, device=op.t0.device))

    def contains_time(self, t, spec: GameSpec) -> torch.Tensor:
        rel = t - self.op.t0
        return (rel >= 0.0) & (
            rel < spec.dt * (self.length.to(torch.float32) - 1.0))


def splice(spec: GameSpec, splicer: Splicer, new_op: OperatingPoint,
           new_strategy: Strategy) -> Splicer:
    """Merge each lane's new solution into its execution plan
    (SolutionSplicer::Splice, src/solution_splicer.cpp:60-130): keep up to
    NUM_PREVIOUS_STEPS_TO_SAVE steps before the new solution's start, then
    the new solution."""
    N, dt = spec.num_time_steps, spec.dt
    keep = NUM_PREVIOUS_STEPS_TO_SAVE
    M = N + keep

    # Truncated toward zero, as the JAX package's astype.
    cur = (1e-4 + true_div(new_op.t0 - splicer.op.t0, dt)).to(torch.int32)
    initial = torch.clamp(cur - keep, min=0)
    n_past = cur - initial

    # Slot j: the old plan at initial + j for j < n_past, then the new
    # plan at j - n_past, zero past n_past + N.
    j = torch.arange(M, device=cur.device)[None]
    lanes = _lanes(cur)[:, None]
    old_idx = torch.clamp(initial[:, None] + j, max=M - 1)
    new_idx = torch.clamp(j - n_past[:, None], 0, N - 1)
    is_past = j < n_past[:, None]
    valid = j < (n_past + N)[:, None]

    def sel(old_a, new_a):
        shaped = lambda m: m.reshape(m.shape + (1,) * (old_a.ndim - 2))
        return torch.where(shaped(is_past), old_a[lanes, old_idx],
                           new_a[lanes, new_idx]) * shaped(valid).to(
                               old_a.dtype)

    return Splicer(
        op=OperatingPoint(xs=sel(splicer.op.xs, new_op.xs),
                          us=sel(splicer.op.us, new_op.us),
                          t0=splicer.op.t0 + initial.to(torch.float32) * dt),
        strategy=Strategy(Ps=sel(splicer.strategy.Ps, new_strategy.Ps),
                          alphas=sel(splicer.strategy.alphas,
                                     new_strategy.alphas)),
        length=n_past + N)


def _splicer_spec(spec: GameSpec) -> GameSpec:
    """The shapes of splicer-sized (N + KEEP) plan playback."""
    return dataclasses.replace(
        spec, num_time_steps=spec.num_time_steps + NUM_PREVIOUS_STEPS_TO_SAVE)


@dataclasses.dataclass(frozen=True)
class SimState(_Replace):
    x: torch.Tensor             # [B, x] true joint state
    t: torch.Tensor             # [B] simulated time
    splicer: Splicer
    al_state: pcost.ALState
    converged: torch.Tensor     # [B] the last solve converged
    num_replans: torch.Tensor   # [B] int32


def _next_problem(dyn, spec: GameSpec, state: SimState,
                  replan_interval: float, planner_time: float):
    """One cycle's first half, per lane: advance the true state
    `replan_interval` along the execution plan, then set up the problem
    `planner_time` ahead from the plan cut to the horizon. Returns
    (t_next, x_next, new_op, new_strategy, new_x0)."""
    N = spec.num_time_steps
    plan = state.splicer
    t_next = state.t + replan_interval
    x_next = integrate_span(dyn, _splicer_spec(spec), plan.op, plan.strategy,
                            state.t, t_next, state.x,
                            int(replan_interval / spec.dt) + 2)
    warm_op = OperatingPoint(xs=plan.op.xs[:, :N], us=plan.op.us[:, :N],
                             t0=plan.op.t0)
    warm_strategy = Strategy(Ps=plan.strategy.Ps[:, :N],
                             alphas=plan.strategy.alphas[:, :N])
    return (t_next, x_next) + setup_next_receding_horizon(
        dyn, spec, warm_op, warm_strategy, x_next, t_next, planner_time)


def _simulate(problem, params, x0_batch, final_time, replan_interval,
              planner_time, solver_kw, safety=None, safety_threshold=-1.0):
    """The simulators' loop: a cold solve of `problem` from its initial
    operating point and strategy, then int(final_time / replan_interval)
    - 1 cycles. Each cycle sets up the next problem (`_next_problem`) and
    re-solves it warm-started from the initial multipliers. Without
    `safety`, the solution splices in on the lanes where it converged.
    With it, the safety problem is solved from the same start too, and
    its solution is taken where P1's safety total exceeds
    `safety_threshold` or only the safety solve converged (the reference's
    switch, src/minimally_invasive_receding_horizon_simulator.cpp:201-214);
    the original solution splices only where it converged, the safety
    solution always (:206-213). Returns (states [n + 1, B, x], the lanes'
    accumulated times [n + 1, B], the safety flags [n, B] (None without
    `safety`), SimState, stats as simulate_batched.last_stats)."""
    spec, dyn, costs = problem.spec, problem.dynamics, problem.player_costs
    B, dev = x0_batch.shape[0], x0_batch.device

    t_start = time.perf_counter()
    first_run = batched.make_host_batched_solver(
        dyn, costs, spec, params, warm_op=problem.initial_operating_point(),
        warm_strategy=problem.initial_strategy(), **solver_kw)
    first = first_run(x0_batch)
    stats = {"cold": first_run.last_stats,
             "cold_s": time.perf_counter() - t_start, "first": first,
             "cycles": []}
    problems = (problem,) if safety is None else (problem, safety)
    warm = [batched.make_host_batched_warm_solver(
        p.dynamics, p.player_costs, spec, params, **solver_kw)
        for p in problems]
    al0 = [p.initial_al_state(B, device=dev) for p in problems]

    state = SimState(
        x=x0_batch, t=torch.zeros((B,), device=dev),
        splicer=Splicer.create(spec, first.op, first.strategy),
        al_state=al0[0], converged=first.converged,
        num_replans=torch.zeros((B,), dtype=torch.int32, device=dev))
    n_cycles = int(final_time / replan_interval) - 1
    states, times, flags = [state.x], [state.t], []
    for _ in range(n_cycles):
        t_cycle = time.perf_counter()
        plan = state.splicer
        t_next, x_next, new_op, new_strategy, new_x0 = _next_problem(
            dyn, spec, state, replan_interval, planner_time)
        t_setup = time.perf_counter()
        res = [w(new_x0, new_op, new_strategy, al)
               for w, al in zip(warm, al0)]
        t_solved = time.perf_counter()
        spliced = [splice(spec, plan, r.op, r.strategy) for r in res]
        if safety is None:
            accept, new_plan, converged = (res[0].converged, spliced[0],
                                           res[0].converged)
        else:
            orig, safe = res
            use_safety = (safe.total_costs[:, 0] > safety_threshold) | (
                safe.converged & ~orig.converged)
            flags.append(use_safety)
            accept = use_safety | orig.converged
            new_plan = batched._bwhere(use_safety, spliced[1], spliced[0])
            converged = torch.where(use_safety, safe.converged,
                                    orig.converged)
        state = SimState(
            x=x_next, t=t_next,
            splicer=batched._bwhere(accept, new_plan, plan),
            al_state=state.al_state, converged=converged,
            num_replans=state.num_replans + 1)
        states.append(state.x)
        times.append(state.t)
        cycle = dict(warm[0].last_stats, converged=converged)
        for w in warm[1:]:
            for k in ("trips", "dispatches", "host_syncs", "deep_rounds"):
                cycle[k] += w.last_stats[k]
        cycle["host_syncs"] += 1
        cycle.update(setup_s=t_setup - t_cycle, solve_s=t_solved - t_setup,
                     wall_s=time.perf_counter() - t_cycle)
        stats["cycles"].append(cycle)
    return (torch.stack(states), torch.stack(times),
            torch.stack(flags) if flags else None, state, stats)


def simulate_batched(problem, params, x0_batch, final_time: float = 10.0,
                     replan_interval: float = 0.25,
                     planner_time: float = 0.25, batch_block: int = 128,
                     trips_per_call: int = 25, merit_backend: str = "xla",
                     fuse_stages=None):
    """Batched receding-horizon simulation (counterpart of the JAX
    package's simulate_batched with backend "pallas"): B independent
    agents, x0_batch [B, x], replan in lockstep on the batched machine.

    A cold solve from the problem's initial operating point and strategy
    makes each lane's execution plan. Then each of
    int(final_time / replan_interval) - 1 cycles advances the true state
    `replan_interval` along the plan, sets up a problem `planner_time`
    ahead, re-solves it warm-started (every lane starts from the initial
    multipliers, as the JAX package does) and splices the solution in on
    the lanes where it converged. Both solvers take `fuse_stages` (None:
    fused, the JAX package's default).

    Returns (states [n_cycles + 1, B, x], times [n_cycles + 1],
    SimState), on x0's device. After a call,
    `simulate_batched.last_stats` holds the cold solve's counters
    ("cold": trips, dispatches, host syncs, ...; "cold_s", host seconds
    to its last all-done read), the cold result ("first", an ALResult)
    and per cycle ("cycles") the warm solve's counters, with one more
    host sync for the tail's start in setup_next_receding_horizon, its
    `converged` [B] (on the device, not read) and host seconds: the
    cycle's ("wall_s"), its first half's (`_next_problem`, "setup_s") and
    its solves' ("solve_s", to their last all-done read). No clock read
    waits for the device; the solves' reads do."""
    solver_kw = dict(trips_per_call=trips_per_call, batch_block=batch_block,
                     merit_backend=merit_backend, fuse_stages=fuse_stages)
    states, _, _, state, stats = _simulate(
        problem, params, x0_batch, final_time, replan_interval,
        planner_time, solver_kw)
    simulate_batched.last_stats = stats
    times = [c * replan_interval for c in range(states.shape[0])]
    return (states, torch.tensor(np.float32(times), device=x0_batch.device),
            state)


simulate_batched.last_stats = None


def _one_agent(problem, params, x0, device):
    """x0 (the problem's by default) as a batch of one on the solve's
    device, the game's kernels built there."""
    dev = problem.prepare(params, device)
    x0 = problem.x0 if x0 is None else x0
    return torch.as_tensor(x0).to(dev)[None]


def simulate(problem, params, final_time: float = 10.0,
             replan_interval: float = 0.25, planner_time: float = 0.25,
             x0=None, jit: bool = True, device="cuda"):
    """Fixed-cadence receding-horizon simulation of one agent (the
    reference's RecedingHorizonSimulator,
    src/receding_horizon_simulator.cpp; counterpart of the JAX package's
    simulate): a cold Problem.solve, then per cycle the plan played back
    `replan_interval` (integrate_span), the warm-start shift
    (setup_next_receding_horizon), a warm solve from the initial
    multipliers and a splice where that solve converged. Returns (states
    [n_cycles + 1, xdim], times [n_cycles + 1], SimState of the agent),
    times the accumulated float32 sim time, as the JAX package's. After a
    call, `simulate.last_stats` holds simulate_batched.last_stats's
    counters of the run. `jit` is accepted and ignored."""
    states, times, _, state, stats = _simulate(
        problem, params, _one_agent(problem, params, x0, device),
        final_time, replan_interval, planner_time,
        dict(batch_block=problem_mod.LANE_BLOCK))
    simulate.last_stats = stats
    return states[:, 0], times[:, 0], problem_mod._unbatch(state)


simulate.last_stats = None


def simulate_minimally_invasive(original, safety, params,
                                final_time: float = 10.0,
                                replan_interval: float = 0.25,
                                planner_time: float = 0.25,
                                safety_threshold: float = -1.0, x0=None,
                                jit: bool = True, device="cuda"):
    """Dual-solver safety-filtered receding horizon of one agent (the
    reference's MinimallyInvasiveRecedingHorizonSimulator,
    src/minimally_invasive_receding_horizon_simulator.cpp:68-218;
    counterpart of the JAX package's simulate_minimally_invasive): each
    cycle warm-starts and solves both the original and the safety problem
    from the shared spliced plan, each from its initial multipliers. The
    safety plan is used when P1's safety total exceeds `safety_threshold`
    (metres, for reachability-style safety problems) or when only the
    safety solve converged, the original otherwise; the original plan
    splices only where its solve converged, the safety plan always.
    Returns (states [n_cycles + 1, xdim], times [n_cycles + 1],
    active_flags [n_cycles] bool, True where the safety controller was
    active, SimState of the shared plan). After a call,
    `simulate_minimally_invasive.last_stats` holds the run's counters,
    each cycle's summed over both solves. `jit` is accepted and
    ignored."""
    if original.spec.xdim != safety.spec.xdim:
        raise ValueError("the original and the safety problem must share "
                         "the state")
    x0b = _one_agent(original, params, x0, device)
    safety.prepare(params, x0b.device)
    states, times, flags, state, stats = _simulate(
        original, params, x0b, final_time, replan_interval, planner_time,
        dict(batch_block=problem_mod.LANE_BLOCK), safety=safety,
        safety_threshold=safety_threshold)
    simulate_minimally_invasive.last_stats = stats
    if flags is None:
        flags = torch.zeros((0, 1), dtype=torch.bool, device=x0b.device)
    return states[:, 0], times[:, 0], flags[:, 0], problem_mod._unbatch(state)


simulate_minimally_invasive.last_stats = None
