"""Benchmark of the port: batched three-player-intersection solves per
second on one CUDA device (counterpart of the repo's bench.py).

Same workload and defaults as bench.py: the flagship, the reference exec
main's solver parameters, bench.py's x0 draw (nominal x0 + 0.1 * N(0, 1)
from numpy RandomState(0), prefix-stable in the batch size) and its
baseline denominator (baselines/measured.json "perturbed_x0_batch"). By
default BENCH_TOTAL (4 x BENCH_BATCH) instances stream through
BENCH_BATCH (2048) device lanes on the wave-refill queue driver, with
harvest chunks of BENCH_HARVEST (32) lanes, BENCH_TPC (10) trips per
`done` read, fused stages (K1) and the plain-PyTorch merit fold;
BENCH_QUEUE=0 solves BENCH_BATCH instances on the plain host-stepped
driver instead. Prints ONE JSON line with bench.py's fields plus the
device, configuration, wall time, the driver's counters and the kernels'
launch counts. BENCH_LATENCY=1 measures the warm replan latency of one
instance instead (`run_latency`, the counterpart of bench_all.py's
`latency_single_solve`). BENCH_CONFIG=1, 2, 4 or 5 runs bench_all.py's
config 1 (the two-player point mass, 1024 instances drawn with sigma 0.5,
40 iterations), 2 (the two-player collision, 256 instances, sigma 0.1),
4 (the three-player flat intersection, 256 instances, sigma 0.1, unfused
stages) or 5 (receding-horizon reachability: 1000 agents of the
three-player collision-avoidance game drawn with sigma 0.25, replanning
every 0.25 s over 2 s) as bench_all.py runs it (`run_config`), and prints
its metric and fields; BENCH_FUSE=0 or 1 overrides the config's stages
(BENCH_ALL_r05 row 5 was taken unfused: BENCH_CONFIG=5 BENCH_FUSE=0).
BENCH_CONFIG=dubins_ol or dubins_fb runs the reference's open-loop
example, `dubins_origin` (two Dubins cars), in the open-loop (unfused
stages, K7) or the feedback information pattern (fused stages): 1024
instances of the x0 draw with sigma 0.1, bench_all.py's exec main
parameters, as `run_config` runs configs 1, 2 and 4. BENCH_CONFIG=roundabout
runs the four-car roundabout (`roundabout_merging`: 256 instances, sigma
0.1, fused stages) the same way, and BENCH_CONFIG=collision_reach the
reference's two-car collision-avoidance reachability game
(`two_player_collision_avoidance_reachability`: 1024 instances, sigma
0.1, fused stages), and BENCH_CONFIG=air3d the reference's Air3D
pursuit-evasion game (`air_3d`: 1024 instances, sigma 0.1, the exec main's
budgets with the reference air3d main's linesearch, fused stages), and
BENCH_CONFIG=flat_roundabout the four-car flat roundabout
(`flat_roundabout_merging`: 256 instances, sigma 0.1, the initial
operating point along each lane, fused stages). Needs a CUDA device: it
never measures on a CPU.

    python3 -m ilqgames_tpu_torch.bench
    BENCH_QUEUE=0 BENCH_BATCH=1024 python3 -m ilqgames_tpu_torch.bench
    BENCH_LATENCY=1 python3 -m ilqgames_tpu_torch.bench
    BENCH_CONFIG=1 python3 -m ilqgames_tpu_torch.bench
    BENCH_CONFIG=4 python3 -m ilqgames_tpu_torch.bench
    BENCH_CONFIG=5 python3 -m ilqgames_tpu_torch.bench
    BENCH_CONFIG=5 BENCH_FUSE=0 python3 -m ilqgames_tpu_torch.bench
    BENCH_CONFIG=dubins_ol python3 -m ilqgames_tpu_torch.bench
    BENCH_CONFIG=roundabout python3 -m ilqgames_tpu_torch.bench
    BENCH_CONFIG=collision_reach python3 -m ilqgames_tpu_torch.bench
    BENCH_CONFIG=air3d python3 -m ilqgames_tpu_torch.bench
    BENCH_CONFIG=flat_roundabout python3 -m ilqgames_tpu_torch.bench
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from ilqgames_tpu_torch.examples import air_3d, dubins_origin, \
    flat_roundabout_merging, more_reachability, reachability, \
    roundabout_merging, three_player_flat_intersection, \
    three_player_flat_overtaking, three_player_overtaking, \
    two_player_collision, two_player_point_mass
from ilqgames_tpu_torch.examples.three_player_intersection import \
    make_problem
from ilqgames_tpu_torch.ops.cuda import lq, lq_open_loop, stage, sweep
# kernel_libraries is read through this module by the smoke script and
# the tests.
from ilqgames_tpu_torch.ops.cuda.libraries import build_kernels, \
    kernel_libraries, set_precision
from ilqgames_tpu_torch.solver import batched
from ilqgames_tpu_torch.runtime import receding_horizon
from ilqgames_tpu_torch.solver.params import SolverParams

_BASELINE = Path(__file__).resolve().parents[1] / "baselines" / "measured.json"
# The reference's hard replan budget (src/receding_horizon_simulator.cpp:119).
REPLAN_BUDGET_S = 0.25
# bench_all.py's latency configuration: replans timed (the first dropped),
# lanes per block (one instance padded) and trips per dispatch.
LAT_REPS, LAT_BLOCK, LAT_TPC = 20, 8, 20


def exec_main_params() -> SolverParams:
    """The reference exec main's parameters (bench.py:83-90)."""
    return SolverParams(max_solver_iters=100,
                        unconstrained_solver_max_iters=10,
                        max_backtracking_steps=100, initial_alpha_scaling=0.1,
                        convergence_tolerance=1.0,
                        expected_decrease_fraction=0.001)


def perturbed_x0(problem, batch: int, sigma: float = 0.1) -> np.ndarray:
    """bench.py's and bench_all.py's x0 draw: [batch, xdim] float32,
    nominal x0 + sigma * N(0, 1) from RandomState(0)."""
    rng = np.random.RandomState(0)
    x0 = np.tile(problem.x0.numpy()[None], (batch, 1))
    x0 += sigma * rng.randn(*x0.shape).astype(np.float32)
    return x0


def reference_baseline():
    """(solves/s, tail fields) of the measured single-core reference on
    this x0 distribution, as bench.py reads them."""
    ref = json.loads(_BASELINE.read_text())["perturbed_x0_batch"]
    return float(ref["solves_per_sec_single_core"]), {
        "ref_cost_p50": ref["cost_p50"], "ref_cost_p95": ref["cost_p95"],
        "ref_diverged_frac": ref["diverged_frac_gt_1e6"]}


def summarize(res, batch: int, elapsed: float) -> dict:
    """bench.py's JSON fields from a batched ALResult. A lane whose
    trajectory overflowed has non-finite costs and violation; they count
    as the largest float32, so the lane is diverged and sorts last in the
    percentiles (np.percentile would give NaN for the whole batch)."""
    baseline, ref_tail = reference_baseline()
    raw_costs = res.total_costs.cpu().numpy()
    overflowed = ~np.isfinite(raw_costs).all(axis=1)
    big = np.finfo(np.float32).max
    unbounded = lambda a: np.where(np.isfinite(a), a, big)
    mv = unbounded(res.max_violation.cpu().numpy())
    costs = unbounded(raw_costs)
    rate = batch / elapsed
    return {
        "metric": "three_player_intersection_solves_per_sec_per_chip",
        "value": round(rate, 3),
        "unit": "solves/s/chip",
        "vs_baseline": round(rate / baseline, 3),
        "viol_p50": round(float(np.percentile(mv, 50)), 4),
        "viol_p95": round(float(np.percentile(mv, 95)), 4),
        "cost_p50": [round(float(c), 1)
                     for c in np.percentile(costs, 50, axis=0)],
        "cost_p95": [round(float(c), 1)
                     for c in np.percentile(costs, 95, axis=0)],
        "diverged_frac": round(float((costs.max(axis=1) > 1e6).mean()), 4),
        "overflowed_lanes": int(overflowed.sum()),
        **ref_tail,
    }


# The kernels' wrappers, by name (each keeps a launch count).
KERNELS = {"K1": stage.lin_quad, "K2": lq.lq_backward, "K3": lq.lq_forward,
           "K4": sweep.rollout_bm, "K5": sweep.rollout_merits,
           "K6": sweep.consumer_merits, "K7": lq_open_loop.lq_open_loop}


def launches() -> dict:
    return {k: fn.launches for k, fn in KERNELS.items()}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    sweep.rollout_bm.by_shape.clear()


def _cuda_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("the benchmark measures on a CUDA device only")
    return dev


def run_latency(device="cuda", reps: int = LAT_REPS):
    """Warm replan latency of one instance (counterpart of bench_all.py's
    latency_single_solve, :265-305): a cold solve of the flagship's x0
    with the exec main's parameters, then `reps` warm re-solves from
    its knot-2 state, warm-started on the cold solve's operating point,
    strategy and multipliers, with max_solver_iters=20; the first is
    dropped. One lane padded to LAT_BLOCK, the latency configuration.
    Then one more replan under torch.profiler: the CUDA kernels it
    launches and their device time. Returns (cold ALResult, JSON dict):
    p50/p95 seconds against the reference's budget, and per replan the
    trips, dispatches, host syncs and launches of K1-K6."""
    from torch.profiler import ProfilerActivity, profile

    from ilqgames_tpu_torch.tools import trip_profile

    set_precision()
    dev = _cuda_device(device)
    problem = make_problem()
    build_kernels(problem.dynamics, problem.spec)
    args = (problem.dynamics, problem.player_costs, problem.spec)
    kw = dict(trips_per_call=LAT_TPC, batch_block=LAT_BLOCK)
    cold = batched.make_host_batched_solver(
        *args, exec_main_params(), warm_op=problem.initial_operating_point(),
        warm_strategy=problem.initial_strategy(), **kw)
    warm = batched.make_host_batched_warm_solver(
        *args, dataclasses.replace(exec_main_params(), max_solver_iters=20),
        **kw)
    t0 = time.perf_counter()
    res0 = cold(problem.x0[None].to(dev))
    torch.cuda.synchronize(dev)
    cold_s = time.perf_counter() - t0
    x1 = res0.op.xs[:, 2]
    replan = lambda: warm(x1, res0.op, res0.strategy, res0.al_state)

    lat, per = [], []
    for _ in range(reps):
        before = launches()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        res = replan()
        torch.cuda.synchronize(dev)
        lat.append(time.perf_counter() - t0)
        per.append(dict(warm.last_stats, launches={
            k: v - before[k] for k, v in launches().items()}))
    lat = np.asarray(lat[1:])
    p50, p95 = float(np.percentile(lat, 50)), float(np.percentile(lat, 95))

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with prof:
        replan()
        torch.cuda.synchronize(dev)
    trips = warm.last_stats["trips"]
    traced = trip_profile.summarize(prof.events(), trips, p50)
    last = per[-1]
    out = {"metric": "warm_single_solve_latency_p50", "value": round(p50, 4),
           "unit": "s", "p95": round(p95, 4),
           "budget_s": REPLAN_BUDGET_S,
           "budget_source": "the reference's hard replan budget "
                            "(src/receding_horizon_simulator.cpp:119)",
           "device": torch.cuda.get_device_name(dev), "driver": "latency",
           "reps": reps, "batch_block": LAT_BLOCK,
           "trips_per_call": LAT_TPC, "cold_s": round(cold_s, 3),
           "cold_trips": cold.last_stats["trips"],
           "cold_converged": bool(res0.converged[0]),
           "converged": bool(res.converged[0]),
           "iterations": int(res.cumulative_iterations[0]),
           **{k: last[k] for k in ("trips", "dispatches", "host_syncs",
                                   "deep_rounds")},
           "launches": last["launches"],
           "same_counts_every_replan": all(
               p == per[0] for p in per),
           "profiled_replan": {
               "trips": trips,
               "cuda_launches": trips * traced["cudaLaunchKernel_per_trip"],
               "device_ms": trips * traced["device_ms_per_trip"],
               "busy_vs_p50": traced["busy"],
               "launches_per_trip": traced["launches"]}}
    return res0, out


def run_bench(batch: int = 2048, device="cuda", driver: str = "queue",
              total=None, harvest_block: int = 32, trips_per_call: int = 10,
              fuse_stages: bool = True):
    """Solve the flagship on `device`: (ALResult, JSON dict). `driver`
    "queue" streams `total` (default 4 * batch) instances through `batch`
    lanes; "plain" solves `batch` instances at once; "latency" is
    `run_latency` (its cold solve's result). The kernels are built before
    the clock starts."""
    if driver == "latency":
        return run_latency(device)
    set_precision()
    dev = _cuda_device(device)
    problem = make_problem()
    build_kernels(problem.dynamics, problem.spec)
    args = (problem.dynamics, problem.player_costs, problem.spec,
            exec_main_params())
    if driver == "queue":
        n = 4 * batch if total is None else total
        solver = batched.make_host_batched_queue_solver(
            *args, device_batch=batch, trips_per_call=trips_per_call,
            harvest_block=harvest_block, fuse_stages=fuse_stages)
    elif driver == "plain":
        n = batch
        solver = batched.make_host_batched_solver(*args,
                                                  fuse_stages=fuse_stages)
    else:
        raise ValueError(
            f"driver must be 'queue', 'plain' or 'latency', got {driver!r}")
    x0 = torch.tensor(perturbed_x0(problem, n), device=dev)
    before = launches()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    res = solver(x0)
    torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t0
    out = summarize(res, n, elapsed)
    stats = solver.last_stats
    out.update(device=torch.cuda.get_device_name(dev), driver=driver,
               B=batch, instances=n, fuse_stages=fuse_stages,
               wall_s=round(elapsed, 3),
               **{k: stats[k] for k in ("trips", "host_syncs", "deep_rounds",
                                        "collapse_exits")})
    if driver == "queue":
        out.update(harvest_block=harvest_block,
                   trips_per_call=trips_per_call,
                   **{k: stats[k] for k in ("dispatches", "harvests",
                                            "compactions")})
    out["launches"] = {k: v - before[k] for k, v in launches().items()}
    return res, out


# bench_all.py's configs 1, 2 and 4 (bench_all.py:129-170, 200-215): the
# game, its metric, the batch, the x0 draw's sigma, the iteration budgets
# and whether the stages are fused.
CONFIGS = {
    1: dict(make=two_player_point_mass.make_problem,
            metric="two_player_point_mass_solves_per_sec_per_chip",
            batch=1024, sigma=0.5,
            params=dict(max_solver_iters=40,
                        unconstrained_solver_max_iters=40),
            fuse_stages=True),
    2: dict(make=two_player_collision.make_problem,
            metric="two_player_collision_solves_per_sec_per_chip",
            batch=256, sigma=0.1, params={}, fuse_stages=True),
    # Unfused, as BENCH_ALL_r05.jsonl row 4 was taken
    # (tools/bench_queue_r5i.sh:27, ILQ_FUSE_STAGES=0): the JAX package's
    # fused stage refuses the game's dense MinV/MaxV atoms.
    4: dict(make=three_player_flat_intersection.make_problem,
            metric="three_player_flat_intersection_solves_per_sec_per_chip",
            batch=256, sigma=0.1, params={}, fuse_stages=False),
    # Receding horizon (bench_all.py:218-262): 1000 agents replan every
    # 0.25 s over 2 s with the JAX package's default, fused stages.
    5: dict(make=reachability.make_problem,
            metric="receding_horizon_reachability_replans_per_sec_per_chip",
            batch=1000, sigma=0.25,
            params=dict(max_solver_iters=20,
                        unconstrained_solver_max_iters=10),
            fuse_stages=True, final_time=2.0, replan_interval=0.25,
            planner_time=0.25),
    # The reference's open-loop example (src/dubins_origin_example.cpp) in
    # both information patterns, as a Monte-Carlo batch over x0 with
    # bench_all.py's exec main parameters: open loop on unfused stages
    # (the JAX package's only path for it), feedback fused.
    "dubins_ol": dict(make=dubins_origin.make_problem,
                      metric="dubins_origin_open_loop_solves_per_sec_per_chip",
                      batch=1024, sigma=0.1, params=dict(open_loop=True),
                      fuse_stages=False),
    "dubins_fb": dict(make=dubins_origin.make_problem,
                      metric="dubins_origin_feedback_solves_per_sec_per_chip",
                      batch=1024, sigma=0.1, params={}, fuse_stages=True),
    # The ICRA 2020 paper's four-car roundabout (the reference's
    # roundabout_merging_example.cpp: 4 car_6d, x = 24, 44 cost atoms),
    # as bench_all.py runs the collision and the flat intersection
    # (bench_all.py:161-212): 256 instances of the x0 draw with sigma 0.1,
    # the exec main's parameters, fused stages.
    "roundabout": dict(make=roundabout_merging.make_problem,
                       metric="roundabout_merging_solves_per_sec_per_chip",
                       batch=256, sigma=0.1, params={}, fuse_stages=True),
    # The reference's two-car reachability game (its
    # two_player_collision_avoidance_reachability_example.cpp: 2 car_5d,
    # x = 10, one signed distance shared by both MAX players) as a
    # Monte-Carlo batch over x0, as bench_all.py runs the collision
    # (bench_all.py:161-170): 1024 instances of the x0 draw with sigma
    # 0.1, the exec main's parameters, fused stages.
    "collision_reach": dict(
        make=more_reachability.make_two_player_collision_avoidance,
        metric="two_player_collision_avoidance_reachability_solves_per_sec"
               "_per_chip",
        batch=1024, sigma=0.1, params={}, fuse_stages=True),
    # Air3D, the classic Hamilton-Jacobi pursuit-evasion game (the
    # reference's air_3d_example.cpp: one coupled system of relative
    # coordinates, x = 3, an evader maximizing and a pursuer minimizing the
    # signed distance to a circle of radius 5 over time, turn rates in
    # [-1, 1] under the AL loop), solved over a batch of relative starts:
    # 1024 instances of the x0 draw with sigma 0.1 around (4, 3, pi/4),
    # the exec main's budgets with the reference air3d main's linesearch
    # (baselines/main_air3d.cpp:19-24), fused stages.
    "air3d": dict(make=air_3d.make_problem,
                  metric="air_3d_solves_per_sec_per_chip",
                  batch=1024, sigma=0.1,
                  params=dict(initial_alpha_scaling=0.75,
                              expected_decrease_fraction=0.1,
                              convergence_tolerance=0.01),
                  fuse_stages=True),
    # The reference's flat roundabout (flat_roundabout_merging_example.cpp:
    # 4 flat car_6d, x = 24, 32 cost atoms with the route-progress atoms,
    # the initial operating point along each lane) as the roundabout: 256
    # instances of the x0 draw with sigma 0.1, the exec main's parameters,
    # fused stages, as the JAX package's default machine runs it.
    "flat_roundabout": dict(
        make=flat_roundabout_merging.make_problem,
        metric="flat_roundabout_merging_solves_per_sec_per_chip",
        batch=256, sigma=0.1, params={}, fuse_stages=True),
}
# The exec main of the reference's dubins_origin example
# (exec/dubins_origin_example/main.cpp defaults, tests/test_golden_more.py:
# 36-40): no linesearch, the full step at alpha 0.1 for 1000 iterations.
GOLDEN_PARAMS = dict(linesearch=False, initial_alpha_scaling=0.1,
                     expected_decrease_fraction=0.1,
                     convergence_tolerance=0.1, max_backtracking_steps=100,
                     max_solver_iters=1000)
# The exec mains of the reference's overtaking and roundabout examples
# (their flag defaults, tests/test_golden_more.py:63-67 and :86-90): the
# linesearch from alpha 0.75, tolerance 0.01, 1000 iterations at most.
DRIVING_GOLDEN_PARAMS = dict(linesearch=True, initial_alpha_scaling=0.75,
                             expected_decrease_fraction=0.1,
                             convergence_tolerance=0.01,
                             max_backtracking_steps=100)
# The exec main of the reference's one-player reachability example at its
# default x0 (1.75, 1.75, 0), inside the target circle
# (tests/test_golden.py:48-64): the AL loop, the linesearch from alpha
# 0.1, tolerance 0.01.
REACH_GOLDEN_PARAMS = dict(max_solver_iters=100,
                           unconstrained_solver_max_iters=10,
                           max_backtracking_steps=100,
                           initial_alpha_scaling=0.1,
                           convergence_tolerance=0.01,
                           expected_decrease_fraction=0.1)
# The exec main of the reference's two-player reachability example at its
# default x0 (tests/test_golden_more.py:103-121, whose pin it is held to:
# the reference fails its linesearch as shipped): the linesearch from alpha
# 0.1, tolerance 0.01, 1000 iterations at most. Its state and control
# regularization of 1.0 are SolverParams fields that nothing reads, in the
# JAX package as here: only a PlayerCost's own fields regularize.
TWO_REACH_GOLDEN_PARAMS = dict(linesearch=True, initial_alpha_scaling=0.1,
                               expected_decrease_fraction=0.1,
                               convergence_tolerance=0.01,
                               max_backtracking_steps=100,
                               state_regularization=1.0,
                               control_regularization=1.0)
# The golden runs: the game and the exec main's parameters of each, the
# trajectories of the unmodified reference in tests/golden/ (the two-player
# reachability game's pin in tests/test_golden_more.py). "flat_overtaking"
# is a nominal run with the exec main's parameters
# (baselines/main_flat_overtaking.cpp:19-23, the overtaking's): no reference
# trajectory exists, since the reference's flat examples crash as shipped
# (baselines/measured.json "flat_examples"), so the JAX package's run is
# the only one it is held to.
GOLDEN_RUNS = {
    "dubins_ol": (dubins_origin.make_problem,
                  dict(GOLDEN_PARAMS, open_loop=True)),
    "dubins_fb": (dubins_origin.make_problem, GOLDEN_PARAMS),
    "overtaking": (three_player_overtaking.make_problem,
                   DRIVING_GOLDEN_PARAMS),
    "roundabout": (roundabout_merging.make_problem, DRIVING_GOLDEN_PARAMS),
    "flat_overtaking": (three_player_flat_overtaking.make_problem,
                        DRIVING_GOLDEN_PARAMS),
    "one_player_reach": (functools.partial(reachability.make_one_player,
                                           px0=1.75, py0=1.75, theta0=0.0),
                         REACH_GOLDEN_PARAMS),
    "two_player_reach": (reachability.make_two_player,
                         TWO_REACH_GOLDEN_PARAMS),
}
GOLDEN_BLOCK = 8
# The reference's replan contract that bench_all.py's config 5 divides by:
# one replan per instance within 0.25 s, 4 replans/s/instance on one core
# (src/receding_horizon_simulator.cpp:119).
REPLANS_BASELINE = 4.0


def config_fields(res, batch: int, elapsed: float) -> dict:
    """bench_all.py's `_throughput` fields of a batched ALResult: the
    outcome distribution, and the violations only where they are finite
    (a game without constraints has none). A lane whose costs overflowed
    counts as the largest float32, as in `summarize`."""
    big = np.finfo(np.float32).max
    raw = res.total_costs.cpu().numpy()
    costs = np.where(np.isfinite(raw), raw, big)
    mv = res.max_violation.cpu().numpy()
    out = dict(
        B=batch, wall_s=round(elapsed, 3),
        converged=round(float(res.converged.float().mean()), 4),
        mean_iters=round(float(res.cumulative_iterations.float().mean()), 1),
        cost_p50=[round(float(c), 1)
                  for c in np.percentile(costs, 50, axis=0)],
        cost_p95=[round(float(c), 1)
                  for c in np.percentile(costs, 95, axis=0)],
        diverged_frac=round(float((costs.max(axis=1) > 1e6).mean()), 4),
        overflowed_lanes=int((~np.isfinite(raw).all(axis=1)).sum()))
    if np.isfinite(mv).any():
        out.update(viol_p50=round(float(np.percentile(mv, 50)), 4),
                   viol_p95=round(float(np.percentile(mv, 95)), 4),
                   viol_max=round(float(mv.max()), 4))
    return out


def run_receding(config: int, device="cuda", fuse_stages=None,
                 warmup=True, final_time=None):
    """bench_all.py's config 5 (`config5_receding_horizon_1k`) on `device`:
    the config's agents from the x0 draw with its sigma, the exec main's
    parameters with its budgets, `receding_horizon.simulate_batched` over
    its final time, replanning every replan interval with its planner
    time, lane blocks of 128, the config's stages and the merit backend
    "xla". The kernels are built first, and with `warmup` an 8-lane,
    one-cycle run loads every library before the clock starts; then one
    timed run (bench_all.py times a second call after a compiling first
    one). Returns ((states,
    times, SimState), JSON dict): bench_all.py's metric and fields, the
    replans over the whole run's wall time (its cold solve included),
    `vs_baseline` against the reference's 4 replans/s/instance, and per
    cycle the converged fraction, trips and deep-ladder rounds.
    `fuse_stages` (None: the config's) as `run_config`'s; `final_time`
    (None: the config's) cuts the run's depth."""
    cfg = CONFIGS[config]
    fuse = cfg["fuse_stages"] if fuse_stages is None else fuse_stages
    set_precision()
    dev = _cuda_device(device)
    problem = cfg["make"]()
    params = dataclasses.replace(exec_main_params(), **cfg["params"])
    build_kernels(problem.dynamics, problem.spec, problem.player_costs)
    run = lambda x0, final_time: receding_horizon.simulate_batched(
        problem, params, x0, final_time=final_time,
        replan_interval=cfg["replan_interval"],
        planner_time=cfg["planner_time"], batch_block=128, fuse_stages=fuse)
    n = cfg["batch"]
    x0 = torch.tensor(perturbed_x0(problem, n, cfg["sigma"]), device=dev)
    if warmup:
        run(x0[:8], 2 * cfg["replan_interval"])
    before = launches()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    final_time = cfg["final_time"] if final_time is None else final_time
    states, times, state = run(x0, final_time)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    st = receding_horizon.simulate_batched.last_stats
    cycles = len(times) - 1
    rate = n * cycles / wall
    out = {"metric": cfg["metric"], "value": round(rate, 3),
           "unit": "replans/s/chip",
           "vs_baseline": round(rate / REPLANS_BASELINE, 3),
           "B": n, "cycles": cycles, "wall_s": round(wall, 3),
           "cold_s": round(st["cold_s"], 3),
           "device": torch.cuda.get_device_name(dev),
           "driver": "receding_horizon", "batch_block": 128,
           "fuse_stages": fuse,
           "final_time": final_time,
           "replan_interval": cfg["replan_interval"],
           "cold_trips": st["cold"]["trips"],
           "cold_converged": round(float(
               st["first"].converged.float().mean()), 4),
           "converged_per_cycle": [round(float(
               c["converged"].float().mean()), 4) for c in st["cycles"]],
           "trips_per_cycle": [c["trips"] for c in st["cycles"]],
           "deep_rounds_per_cycle": [c["deep_rounds"] for c in st["cycles"]],
           "host_syncs_per_cycle": [c["host_syncs"] for c in st["cycles"]],
           "launches": {k: v - before[k] for k, v in launches().items()}}
    return (states, times, state), out


def run_config(config, device="cuda", fuse_stages=None, warmup=True,
               final_time=None):
    """bench_all.py's config 1, 2, 4 or 5, or "dubins_ol" / "dubins_fb" /
    "roundabout" / "collision_reach" / "air3d" / "flat_roundabout", on
    `device`. Config 5, receding
    horizon, is `run_receding`'s. The others
    as bench_all.py's `_throughput` runs them: the exec main's parameters
    (with the config's budgets and information pattern), the x0 draw with
    the config's sigma, the plain host-stepped driver with lane blocks of
    128 and 20 trips per dispatch, the config's stages (fused but for
    config 4 and dubins_ol) and the merit backend "xla"; one
    warm-up solve (none without `warmup`: the timed solve then carries
    the first solve's one-time costs), then the timed one. Returns
    (ALResult, JSON dict) with
    bench_all.py's metric and fields. `fuse_stages` overrides the config's
    stages (BENCH_ALL_r05 row 5 was taken unfused); `final_time` cuts
    config 5's depth (None: the config's)."""
    cfg = CONFIGS[config]
    if "final_time" in cfg:
        return run_receding(config, device, fuse_stages, warmup, final_time)
    fuse = cfg["fuse_stages"] if fuse_stages is None else fuse_stages
    set_precision()
    dev = _cuda_device(device)
    problem = cfg["make"]()
    n = cfg["batch"]
    params = dataclasses.replace(exec_main_params(), **cfg["params"])
    build_kernels(problem.dynamics, problem.spec, problem.player_costs,
                  params.open_loop)
    solver = batched.make_host_batched_solver(
        problem.dynamics, problem.player_costs, problem.spec, params,
        warm_op=problem.initial_operating_point(),
        warm_strategy=problem.initial_strategy(), trips_per_call=20,
        batch_block=128, fuse_stages=fuse)
    x0 = torch.tensor(perturbed_x0(problem, n, cfg["sigma"]), device=dev)
    if warmup:
        solver(x0)
    before = launches()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    res = solver(x0)
    torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t0
    stats = solver.last_stats
    out = {"metric": cfg["metric"], "value": round(n / elapsed, 3),
           "unit": "solves/s/chip", "vs_baseline": None,
           **config_fields(res, n, elapsed),
           "device": torch.cuda.get_device_name(dev), "driver": "plain",
           "trips_per_call": 20, "batch_block": 128,
           "fuse_stages": fuse, "open_loop": params.open_loop,
           "warmup": warmup,
           **{k: stats[k] for k in ("trips", "dispatches", "host_syncs",
                                    "deep_rounds", "collapse_exits")},
           "launches": {k: v - before[k] for k, v in launches().items()}}
    return res, out


def run_golden(run: str, device="cuda"):
    """The exec main of a reference example on `device` (`GOLDEN_RUNS`:
    "dubins_ol" and "dubins_fb", dubins_origin in the open-loop (unfused
    stages, K7) and the feedback information pattern, no linesearch, 1000
    iterations; "overtaking", "roundabout" and "flat_overtaking", the
    driving games with their linesearch, fused stages; "one_player_reach", one-player
    reachability at the reference's x0 with the AL loop, fused stages;
    "two_player_reach", two-player reachability at its x0, fused stages):
    its nominal x0, one lane padded to
    GOLDEN_BLOCK, from the zero operating point and strategy, plain
    driver, 20 trips a dispatch. The kernels are built first. Returns
    (ALResult of the one lane, {"trips", "wall_s", "launches"})."""
    set_precision()
    dev = _cuda_device(device)
    make, prm = GOLDEN_RUNS[run]
    problem = make()
    params = SolverParams(**prm)
    build_kernels(problem.dynamics, problem.spec, problem.player_costs,
                  params.open_loop)
    solver = batched.make_host_batched_solver(
        problem.dynamics, problem.player_costs, problem.spec, params,
        warm_op=problem.initial_operating_point(),
        warm_strategy=problem.initial_strategy(), trips_per_call=20,
        batch_block=GOLDEN_BLOCK)
    before = launches()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    res = solver(problem.x0[None].to(dev))
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    return res, {"trips": solver.last_stats["trips"],
                 "wall_s": round(wall, 3),
                 "launches": {k: v - before[k]
                              for k, v in launches().items()}}


def _config_key(name: str):
    """A BENCH_CONFIG value as a CONFIGS key: a number, or a name."""
    return int(name) if name.isdigit() else name


def main():
    if not torch.cuda.is_available():
        raise SystemExit("ilqgames_tpu_torch.bench needs a CUDA device")
    env = os.environ.get
    batch = int(env("BENCH_BATCH", "2048"))
    if env("BENCH_CONFIG"):
        fuse = env("BENCH_FUSE")
        _, out = run_config(_config_key(env("BENCH_CONFIG")),
                            fuse_stages=None if fuse is None else fuse != "0")
    elif env("BENCH_LATENCY", "0") == "1":
        _, out = run_latency()
    elif env("BENCH_QUEUE", "1") == "1":
        _, out = run_bench(batch, driver="queue",
                           total=int(env("BENCH_TOTAL", str(4 * batch))),
                           harvest_block=int(env("BENCH_HARVEST", "32")),
                           trips_per_call=int(env("BENCH_TPC", "10")))
    else:
        _, out = run_bench(batch, driver="plain")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
