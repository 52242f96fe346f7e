#!/usr/bin/env python3
"""Smoke test of the PyTorch port (ilqgames_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ and drives its paths: the
flagship three-player intersection solved for perturbed x0 by the batched
AL + iLQ machine, and the two-player point mass and collision by its
unconstrained trip (and the three-player flat intersection with unfused
stages), and the two Dubins cars of the reference's open-loop example in
both information patterns, through kernels K1 (fused stage), K2 (LQ
Riccati sweep), K3 (δx forward pass), K4 (candidate rollout), K5 (rollout
with in-kernel merit), K6 (merit consumer) and K7 (open-loop LQ sweep).
Phases:

1. the card's name and power limit, and the kernels' build time (one
   nvcc per source, all at once);
2. each kernel against its plain PyTorch version on the card, on operands
   from a real flagship stage (the first rollout of bench.py's x0 draw;
   K1 with the multipliers of one AL update), at the main path's shapes,
   with both times and the count of bitwise-equal lanes; K2-K6 with
   their ptxas registers and stack (the script fails on a spill in any of
   them and on a stack frame in K2, K3, K4 or K6); K3 at B=1024 and at the
   queue's B=2048, K5 and K6 at C=8/B=128 and C=1/B=2048 with their us
   per knot (K6 also per launch replayed from a CUDA graph, the device's
   time without the wrapper's host steps), K5 against K4 + K6 bit for
   bit;
3. two trips on the card against two on the CPU (plain versions) from
   the same carry, without and with fused stages: decisions exactly
   equal; then six fused trips on the card with the K5 and the K6 merit
   backends against the plain fold: decisions and merits exactly equal
   (each backend's launches counted from zero over its trips);
4. the unfused path: the plain driver at B=1024 without fused stages, launch
   counters reset just before, and its outcome distribution against the
   JAX package's (BENCH_ALL_r05.jsonl row 3: same x0, same batch);
5. the bench's queue path: QUEUE_TOTAL (3072) instances through 2048 lanes on the
   wave-refill queue driver, harvest chunks of 32, fused stages, launch
   counters reset just before, against the JAX package's outcome on the
   same draw and configuration (BENCH_r05.json), with K4's launches per
   (C, B, emit_us);
6. the probes (ilqgames_tpu_torch/tools/, the counterparts of the JAX
   package's TPU probes under tools/): the probe kernels P1 (dependent
   multiply-add chain), P2 (every instantiated rung of the probe rollout:
   the top rung at N=100, the fifteen below it on the first 10 knots of
   the same operands) and P3 (x * 2 + 1, also at 1, 3, 5 and 32771
   elements) against their plain versions, the registers and stack frame of each rung and of K2-K6
   from ptxas; K4 and K5 beside the rungs prod_static (one
   thread per chain on a compile-time layout) and emit_xs_us (one thread
   per chain on the run-time table, K4's design before one warp per
   subsystem), timed in turns on the probes' bounded operands; every
   other distinct
   (kernel, cost table, shape) that the probe registry launches against
   its plain version on the registry's own operands; then the four probe
   modules with the launch counters reset just before, one JSON line per
   case;
7. the replanning path: (a) the cold solve of the flagship's nominal x0
   (exec main parameters, one lane in a block of 8, the latency
   configuration) against the reference solver's converged trajectory
   (tests/golden/three_player_intersection_exec_params.txt, with
   tests/test_golden.py's bounds per player); (b) the warm replan
   latency of that instance (bench.run_latency over LATENCY_REPS replans:
   p50, p95, trips, host syncs and launches per replan, one profiled
   replan); (c) the batched
   receding-horizon runtime at full width, 1024 instances of bench.py's
   draw replanned 2 times (final time 0.75 s, every 0.25 s, planner budget
   0.25 s, max_solver_iters 20, lane blocks of 128), launch counters
   reset just before; after (b) and after (c), each kernel at each shape
   that cell launched it (counted per shape; K4's also against
   sweep.rollout_bm.by_shape), on a copy of the arguments of its first
   launch at that shape, against its plain version and timed, one
   kernels-line entry each with the kernel's launches over the cell;
   (d) a short replanning run (4 lanes, 2 cycles) on the card and on the
   CPU (plain versions): decisions equal, states and the splicer's
   arrays bitwise equal;
8. the unconstrained games (the unconstrained trip and finalize): (a) the
   libraries of the two-player point mass (x=2, one linear subsystem
   reading both players' controls) and the two-player collision (x=12, two
   car_6d), one nvcc each, all at once, and their K2-K6 ptxas reports
   (failing on a spill, and on a stack frame outside K5); (b) bench_all.py's
   configs 1 and 2 at full size through `bench.run_config`, launch counters
   reset just before: pm 1024 (1024 instances drawn with sigma 0.5, 40
   iterations) and collision 256 (256 instances, sigma 0.1), one JSON line
   each; (c) their outcome against the JAX package's bands
   (BENCH_ALL_r05.jsonl rows 1-2: the point mass converged >= 0.99,
   mean_iters within 10% of 18.1, cost_p50 within 15% of [13.7, 1.4], none
   diverged; the collision, broken as shipped upstream, diverged_frac >=
   0.9 and converged in [0.1, 0.35]); (d) each kernel at each shape each
   cell launched it, on a copy of its first launch's arguments, against
   its plain version, and K5 and K6 at the cells' linesearch shapes, one
   kernels-line entry each; (e) two fused trips of 8 lanes of each game
   on the card against the CPU under each merit backend: decisions equal,
   every array of the carry bitwise equal;
9. the three-player flat intersection (bench_all.py's config 4: two flat
   cars and a flat unicycle, x=16 in feedback-linearized coordinates, one
   linear subsystem per player; the norm atoms, one of them dense only),
   solved with unfused stages as the JAX package solves it: (a) its K4,
   K5 and K6 libraries (K5's and K6's with the norm atoms), one nvcc each,
   all at once, and their ptxas reports; (b) flat 256 (256 instances,
   sigma 0.1, exec main parameters) through `bench.run_config(4)`, launch
   counters reset just before, one JSON line; (c) its outcome against the
   JAX package's row (BENCH_ALL_r05.jsonl row 4: converged and
   diverged_frac within 0.08 of 0.4062 and 0.3867, mean_iters within 10%
   of 59.2, cost_p50 within 15% of [14667.5, 4553.1, 1141.9]), and K1
   never launched; (d) each kernel at each shape the cell launched it
   against its plain version, and K5 and K6 at its linesearch shapes;
   (e) two unfused trips of 8 lanes on the card against the CPU under
   each merit backend: decisions equal, every array of the carry (the
   carried quadraticization too) bitwise equal;
10. receding-horizon reachability (bench_all.py's config 5: three car_5d
   players, x=15, each the maximum over time of its worse pairwise
   signed-distance margin, under box constraints on its controls; fused
   stages, as the JAX package's default): (a) its libraries (K1, K5 and
   K6 with CT_REACH=1: the signed-distance and extremal atoms, the
   control constraints and the extremal gates), one nvcc each, all at
   once, and their ptxas reports (failing on a spill, and on a stack frame
   outside K1 and K5); (b) reachability 1000 x 2 through
   `bench.run_config(5)` (1000 agents drawn with sigma 0.25, replanned
   every 0.25 s over 0.75 s, max_solver_iters 20: bench_all.py's 2 s cut
   in depth), one timed run with no
   8-lane load before it, launch counters reset just before, one JSON
   line, failing unless every lane replanned 2 times to t = 0.5,
   states are finite on every lane the cold solve did not leave diverged,
   and K1-K4 launched; (c) each kernel at each shape the cell launched it
   against its plain version, and K5 and K6 at the cell's linesearch
   shapes; (d) two trips of 8
   lanes on the card against the CPU, fused under each merit backend and
   unfused under "xla": decisions equal, every array of the carry
   (extreme_ks included) bitwise equal; (e) a 4-lane, 2-cycle replanning
   run on the card against the CPU, as 7d;
11. open-loop Nash on the reference's `dubins_origin` game (two Dubins
   cars, x=6, 2 players x 1 control, N=100), in both information
   patterns: open loop on unfused stages through K7, feedback fused:
   (a) its libraries (K1 with CT_DIFF and CT_DUBINS, K5 and K6 with
   CT_DIFF, K7, and K7 at the flagship's dims too), one nvcc each, all at
   once, and their ptxas reports (K7's two block sizes, G = 8 and 1);
   (b) the reference exec main's golden runs (`bench.run_golden`: the
   nominal x0 in a block of 8, no linesearch, 1000 iterations) in both
   patterns against tests/golden/dubins_origin_{open_loop,feedback}.txt
   with tests/test_golden_more.py's bounds (P1 within 0.5 m, P2 within
   2.0 m) and the two patterns more than 0.5 apart, K7 held at the golden
   shape; (c) the cells dubins_ol_1024 and dubins_fb_1024 through
   `bench.run_config` (1024 instances, sigma 0.1, bench_all.py's exec
   main parameters), launch counters reset just before, one JSON line
   each, their outcome against the JAX package's on the same draw
   (converged and diverged_frac within 0.08, mean_iters within 10%,
   cost_p50 within 15%), every (kernel, shape) each launched held against
   its plain version, and K5, K6 at their linesearch shapes; (d) two
   trips of 8 lanes of each pattern on the card against the CPU under
   each merit backend: decisions equal, every array of the carry bitwise
   equal;
12. the driving games (the four-car roundabout, the three-player
   overtaking, the modified intersection pair and the skeleton): their
   ptxas reports, the golden runs of the overtaking and the roundabout
   against tests/test_golden_more.py's bounds, the roundabout_256 cell
   (one timed solve, no warm-up, as every cell of phases 8-15) against
   the JAX package's outcome with
   its launches held, and trips of 8 lanes card vs CPU;
13. the first half of the reachability family: (a) the ptxas reports of
   one_player_reachability (a Dubins car, P = 1, the polyline
   signed-distance atom under CT_POLYSD, the AL loop with a MAX player),
   two_player_collision_avoidance_reachability (two car_5d, one signed
   distance shared by two MAX players) and modified_air_3d (two point
   masses as one linear system, quadratic differences at +-1e6); (b) the
   one-player golden run (`bench.run_golden("one_player_reach")`)
   within tests/test_golden.py's bounds (total cost within 0.09 of
   8.8074, positions within 0.35 m), every (kernel, shape) it launched
   held (K2 and K3 at P = 1); (c) the collision_reach_1024 cell through
   `bench.run_config("collision_reach")` (1024 instances, sigma 0.1, exec
   main parameters, fused; one timed solve) against the JAX package's
   outcome on the same draw (COLLISION_REACH_JAX) within phase 9's
   bands, its launches held, K5 and K6 at its linesearch shapes; (d) two
   trips of 8 lanes of each game on the card against the CPU under each
   merit backend, K5 and K6 held where they launched, K1-K4 of
   modified_air_3d held at the shapes its trips launched them;
14. the second half of the reachability family, the coupled systems:
   (a) the ptxas reports of two_player_reachability
   (two_player_unicycle_4d, x = 4, P = 2, u = 2, xdims (4, 0): a MAX and a
   MIN player) and air_3d (x = 3, P = 2, u = 1, xdims (3, 0): the AL loop,
   a Jacobian that reads the knot's controls), K1 under CT_COUPLED, and
   the flagship's K1 registers and stack, which the flag leaves as they
   were (FLAGSHIP_K1_PTXAS); (b) the two-player golden run
   (`bench.run_golden("two_player_reach")`) against
   tests/test_golden_more.py's pin (not converged, at most 4 iterations,
   total costs within 2e-3 of [10.5441, 4.7601]), every (kernel, shape)
   it launched held; (c) the air3d_1024 cell through
   `bench.run_config("air3d")` (1024 instances, sigma 0.1, the exec
   main's budgets with the reference air3d main's linesearch, fused; one
   timed solve) against the JAX package's batched machine on the same
   draw (AIR3D_JAX) within phase 9's bands, its launches held, K5 and K6
   at its linesearch shapes; (d) two trips of 8 lanes of each game on
   the card against the CPU under each merit backend, K5 and K6 held
   where they launched;
15. the flat driving games (three_player_flat_overtaking: three flat
   car_6d, x = 18, 36 constant Jacobian entries; flat_roundabout_merging:
   four, x = 24, 48 entries, 32 cost atoms, the initial operating point
   along each lane), fused, the route-progress atom under CT_ROUTE: (a)
   the ptxas reports of both games' K1-K6 and the flagship's K1 against
   FLAGSHIP_K1_PTXAS; (b) the flat overtaking's nominal run
   (`bench.run_golden("flat_overtaking")`: the exec main's parameters, its
   x0 in a block of 8; no reference trajectory exists) with its launches
   held: its first FLAT_TRIPS_HELD trips' merits within TRIP_TOL of the
   JAX package's batched machine (FLAT_OVERTAKING_JAX), and the whole
   run's iterations, convergence and costs as the port's on the CPU,
   beside the JAX package's (the two part at the fourth trip's LQ solve,
   whose float32 solutions of the same operands lie metres apart:
   tests/test_torch_flat_games.py holds the float64 witness); (c) the
   flat_roundabout_256 cell through `bench.run_config("flat_roundabout")`
   (256 instances, sigma 0.1, exec main parameters; one timed solve)
   against the JAX package's batched machine on the same draw
   (FLAT_ROUNDABOUT_JAX) within phase 9's bands, its launches held, K5
   and K6 at its linesearch shapes; (d) two trips of 8 lanes of each game
   on the card against the CPU under each merit backend, K5 and K6 held
   where they launched;
16. the per-instance entry point, `python -m ilqgames_tpu_torch`'s main
   in-process on the card at full width (the flagship, N=100, the exec
   main's parameters: the CLI's defaults), each of (a)-(d) a cell whose
   launches are counted from 0 and held at every (kernel, shape), B=8:
   (a) the flagship's solve with --check_nash --save --html (its
   trajectory against the reference's with tests/test_golden.py's bounds,
   the log's last iterate bitwise the result's and the saved xs.txt's,
   xs.txt [100, 16] and u*.txt [100, 2]); (b) --receding_horizon over
   CLI_FINAL_TIME (3 replans, finite, P1 progressing); (c) the
   minimally-invasive pair (modified_three_player_intersection with
   three_player_intersection_reachability, a MAX player) over
   CLI_FINAL_TIME (3 replans); (b) and (c) at 20 iterations a solve
   (CLI_REPLAN_ITERS, phase 7c's replanning budget), each cycle's host
   seconds printed (its first half, its solves); the first CLI_HELD_CYCLES
   (2) cycles of each held card against CPU (bitwise: the same command
   over 0.75 s on the CPU, a CPU job); (d) dubins_origin
   --open_loop alone and with --receding_horizon (K7 and K4; K1-K3 must
   not launch); (e) --batch 256 (its JSON line: some lanes converged, a
   finite violation);
17. the rest of the cost layer, on two games that exist only as checks
   (`zoo_player_costs`: the flagship with one of each new piece on dims
   where it reads what it was made for): (a) their libraries (K1, K5
   and K6 of the fused game with CT_ZOO; the unfused game's dense-only
   constraints leave it K2-K4 only) and ptxas reports; (b) zoo_fused_256
   (fused: relative_distance, nominal_path_length, curvature,
   orientation, a one-difference quadratic_difference, quadratic_norm and
   a final-time gate on a single_dimension state constraint, in K1) and
   zoo_unfused_256 (the two convex proximities, affine_scalar,
   affine_vector and the polyline signed-distance constraint; K1 never
   launched), ZOO_B instances of bench.py's draw each, the exec main's
   parameters at most ZOO_ITERS iterations, one timed solve, their
   outcome printed (converged, diverged_frac, mean_iters, cost_p50),
   every (kernel, shape) held, K5 and K6 at the linesearch shapes (the
   unfused game's on its atoms); (c) two trips of 8 lanes of each on the
   card against the CPU, the fused game under every merit backend.

The holds of phases 7-17 run K4 and K5 (and their plain versions) on
the first HOLD_DEPTH (5) knots of each launch's arguments, but for each
game's first K4 and K5 shape in one of its cells (reachability's timed
cell, dubins_ol_1024, each cell of phases 8-15 and 17, the CLI's
flagship solve), held at the cell's depth (the
flagship's K4 and K5 at N=100 in phase 2); every other kernel, K2
included, is held at the cell's depth. A plain version's float32
operations are counted on its
arguments' first 1, 2 and 3 knots and carried to the call's depth
(`_count_ops`: the count is linear in the knots), and the plain version
runs once at the call's depth, timed.

Every kernel's entry in the kernels line carries its bound: the larger of
the bytes it must move (each operand read once, each output written once)
over 3.35 TB/s and its float32 operations over 33.5e12 per second (the
H100 SXM's published 67 TFLOP/s counts an FMA as two; the kernels issue
separate multiplies and adds). The operations are counted by running the
kernel's plain version, which repeats them in order, under
tools/_probe.float_ops on this run's operands (adds, multiplies,
divides, roots, min/max and roundings, one per output element).

Two processes drive the card (`SECOND_PHASES`): after the build, phases
11-15 and 17 run in a second process (spawned, with its own CPU workers,
its lines printed when it is joined) beside phases 2-5, 7-10 and 16 in
the script's; phase 6 runs last, alone. Each process drives the card from
one Python thread and its holds and trips are bound by that thread, so
the halves overlap. Every timed run (each cell, golden run and CLI run,
phase 7's latency and receding-horizon cells, phases 4 and 5) has the
card alone (`_alone`): it waits until the other process stands at a
pause point (each hold's and trip's check, each wait for a CPU job, each
phase's end) and holds it there until the run ends, so that the cells'
seconds and phase 7's latencies are taken as in one process. The card
runs the two processes' kernels in turns, so each process takes its
kernels' times (`_timed`: every kernels-line ms, phase 2's per-knot
lines) once it has the card alone, after both halves. The plain
versions' times and the phases' seconds are taken beside the other
process.

Each phase prints, when it ends, the time since the build began, its own
duration and how much of it it waited for the other process's runs
alone. Prints
the kernels' JSON line and the card line, then, last,
{"ok": true, "device": {...}}. Exits nonzero, with no result line, when
there is no CUDA device or any phase fails.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import json
import os
import subprocess
import sys
import time

# Tolerances, |kernel - plain| <= tol + tol * |plain|, those of the JAX
# package's kernel tests. Each kernel repeats its plain version's float32
# operations in the same order, without FMA contraction, so the two are
# expected to agree bit for bit; the script prints how many lanes do. K2-K7
# are held to that (phase 3's card-vs-CPU decisions rest on it).
TOL = {"K1": 1e-5, "K2": 0.0, "K3": 0.0, "K4": 0.0, "K5": 0.0,
       "K6": 0.0, "K7": 0.0, "P1": 0.0, "P2": 1e-5, "P3": 0.0}
PEAK_BYTES = 3.35e12      # H100 SXM HBM3, bytes/s
# The H100 SXM's 67 TFLOP/s in float32 outside the tensor cores counts an
# FMA as two operations. The kernels build with --fmad=false, so each
# multiply and each add issues on its own: half that many per second.
PEAK_F32_OPS = 67e12 / 2
TRIP_TOL = 2e-3           # merits and trajectories, card vs CPU, per trip
DIVERGED_BAND = (0.02, 0.12)  # JAX: 0.0566 at B=1024, 0.058 queue (r05)
JAX_COST_P50 = (3057.4, 855.7, 78.2)        # plain driver, B=1024
JAX_QUEUE_COST_P50 = (3024.2, 837.1, 76.3)  # queue, 8192 through 2048
# Phase 5: the bench's queue path at its lanes (2048) and harvest chunks,
# QUEUE_TOTAL instances (the bench's default 4 x 2048 cut in depth to
# 1.5 x, for the script's time: 1024 refills; the same draw's prefix,
# held to the same bands).
QUEUE_TOTAL = 3072
COST_P50_REL = 0.15
# tests/test_golden.py: per player, the distance between the cold solve's
# and the reference solver's positions, max and mean over the horizon (m).
GOLDEN = os.path.join("tests", "golden",
                      "three_player_intersection_exec_params.txt")
GOLDEN_POSITIONS = ((0, 1), (6, 7), (12, 13))
GOLDEN_MAX_M, GOLDEN_MEAN_M = 2.0, 1.0
# Phase 7c: 1024 agents over 0.75 s, 2 replans (2 s and 7 replans until
# the script's time grew past its limit with phase 16; the depth is cut).
RH_B, RH_FINAL_TIME, RH_REPLANS = 1024, 0.75, 2
# Phase 7b: the latency cell's replans (bench.LAT_REPS is 20; cut to keep
# the script's time, the first dropped as there).
LATENCY_REPS = 3
# Phase 3: trips on the card against trips on the CPU (the CPU's plain
# versions take most of the phase's time; two since phase 11 came), of the
# flagship's first FLAGSHIP_TRIP_B instances.
CPU_TRIPS = 2
FLAGSHIP_TRIP_B = 64
# Phase 6: the knots on which P2's fifteen lower rungs are held (the top
# rung at all N).
P2_DEPTH = 10
# Phase 7d: a budget that keeps the CPU's run under a minute.
RH_SMALL = dict(max_solver_iters=2, unconstrained_solver_max_iters=2)
# Phase 8: the JAX package's outcome of bench_all.py's configs 1 and 2
# (BENCH_ALL_r05.jsonl rows 1-2). The point mass: converged 1.0, mean_iters
# 18.1, cost_p50 [13.7, 1.4], diverged 0. The collision is broken as
# shipped upstream (diverged_frac 1.0, converged 0.2188, mean_iters 16.4):
# it is judged by distribution.
PM_CONVERGED_MIN = 0.99
PM_MEAN_ITERS, PM_ITERS_REL = 18.1, 0.10
PM_COST_P50 = (13.7, 1.4)
COLL_DIVERGED_MIN = 0.9
COLL_CONVERGED_BAND = (0.1, 0.35)
COLL_JAX_MEAN_ITERS = 16.4
# Phase 9: the JAX package's outcome of bench_all.py's config 4, the flat
# intersection at 256 instances, unfused (BENCH_ALL_r05.jsonl row 4): lanes
# drift at Armijo knife edges, so the fractions are held within 0.08 (about
# 20 of the 256 lanes), mean_iters within 10%, cost_p50 within 15%.
FLAT_CONVERGED, FLAT_DIVERGED, FLAT_FRAC_TOL = 0.4062, 0.3867, 0.08
FLAT_MEAN_ITERS, FLAT_ITERS_REL = 59.2, 0.10
FLAT_COST_P50 = (14667.5, 4553.1, 1141.9)
# Phases 8e-11d: trips of each game on the card against the CPU, 8 lanes
# (two since phase 11 came).
SMALL_B, SMALL_TRIPS = 8, 2
# Phases 7-17: the knots on which the holds of the cells' K4 and K5
# launches run (a kernel and its plain version on the first HOLD_DEPTH
# knots of the same arguments: the plain versions on the card take seconds
# a call at N=100; 10 knots until phase 17 came). Each game's K4 and K5 are also held once at full depth
# (the flagship's in phase 2, the others' at their cell's first shape);
# every other kernel, K2 included, at the cell's depth.
HOLD_DEPTH = 5
PREFIX_KERNELS = ("K4", "K5")
# A hold times its kernel after HOLD_WARM_S of calls (phase 2's rows after
# 0.2 s): the card has just run the kernel and its plain version.
HOLD_WARM_S = 0.05
# Phase 10: bench_all.py's config 5, receding-horizon reachability.
# Config 5's cell over 0.75 s, 2 replans to t = 0.5 (bench_all.py's 2 s
# and 7 replans cut in depth, for the script's time).
RH5_FINAL_TIME, RH5_REPLANS, RH5_T_END = 0.75, 2, 0.5
# Phase 11: the golden runs' files and bounds (tests/test_golden_more.py:
# 27-56): P1's and P2's position error against the reference solver's
# trajectory, and how far apart the two patterns' trajectories must be.
DUBINS_GOLDEN = {True: os.path.join("tests", "golden",
                                    "dubins_origin_open_loop.txt"),
                 False: os.path.join("tests", "golden",
                                     "dubins_origin_feedback.txt")}
DUBINS_P1_M, DUBINS_P2_M, DUBINS_GAP_M = 0.5, 2.0, 0.5
# The JAX package's outcome of the two cells on the same draw (1024
# instances, N=100, bench_all.py's exec main parameters, sigma 0.1), by
# its per-instance machine, made on a CPU (~10 min) with
#   python -c "import jax; jax.config.update('jax_platforms', 'cpu')
#   import numpy as np, bench_all
#   from ilqgames_tpu.examples import dubins_origin as d
#   from ilqgames_tpu.solver import fused
#   p = d.make_problem()
#   for ol in (True, False):
#       r = fused.make_host_batched_solver(
#           p.dynamics, p.player_costs, p.spec,
#           bench_all._exec_params(open_loop=ol),
#           warm_op=p.initial_operating_point(),
#           warm_strategy=p.initial_strategy())(
#           bench_all._perturbed_x0(p, 1024, 0.1))
#       c = np.asarray(r.total_costs)
#       print(ol, float(r.converged.mean()),
#             float(r.cumulative_iterations.mean()),
#             np.percentile(c, 50, axis=0), float((c.max(1) > 1e6).mean()))"
# The bands are phase 9's: fractions within 0.08, mean_iters within 10%,
# cost_p50 within 15%.
DUBINS_JAX = {
    "dubins_ol": dict(converged=0.6943, mean_iters=5.9,
                      cost_p50=(18535.6, 127857.0), diverged_frac=0.0),
    "dubins_fb": dict(converged=0.9062, mean_iters=38.4,
                      cost_p50=(17363.9, 78824.4), diverged_frac=0.0)}
DUBINS_FRAC_TOL, DUBINS_ITERS_REL = 0.08, 0.10
# Phase 12: the driving games' golden runs (tests/test_golden_more.py:
# 59-104): the reference solver's trajectory, the players, each player's
# position error bound (m) and whether the reference converged; the
# overtaking's total costs within rtol 1e-3.
DRIVING_GOLDEN = {
    "overtaking": (os.path.join("tests", "golden",
                                "three_player_overtaking_exec_params.txt"),
                   3, 0.01, True),
    "roundabout": (os.path.join("tests", "golden",
                                "roundabout_merging_exec_params.txt"),
                   4, 0.3, False)}
OVERTAKING_COSTS, OVERTAKING_RTOL = (17954.3398, 2294.2961, 1984.0383), 1e-3
# The JAX package's outcome of the roundabout_256 cell on the same draw
# (256 instances, N=100, bench_all.py's exec main parameters, sigma 0.1),
# by its per-instance machine, made on a CPU with
#   python -c "import jax; jax.config.update('jax_platforms', 'cpu')
#   import numpy as np, bench_all
#   from ilqgames_tpu.examples import roundabout_merging as r
#   from ilqgames_tpu.solver import fused
#   p = r.make_problem()
#   res = fused.make_host_batched_solver(
#       p.dynamics, p.player_costs, p.spec, bench_all._exec_params(),
#       warm_op=p.initial_operating_point(),
#       warm_strategy=p.initial_strategy())(
#       bench_all._perturbed_x0(p, 256, 0.1))
#   c = np.asarray(res.total_costs)
#   print(float(res.converged.mean()),
#         float(res.cumulative_iterations.mean()),
#         np.percentile(c, 50, axis=0), float((c.max(1) > 1e6).mean()))"
# The bands are phase 9's (DUBINS_FRAC_TOL, DUBINS_ITERS_REL,
# COST_P50_REL).
ROUNDABOUT_JAX = dict(converged=0.75, mean_iters=29.6,
                      cost_p50=(24523.7, 30424.7, 24013.8, 29507.2),
                      diverged_frac=0.082)
# Phase 12: the games (the roundabout and the overtaking first, then the
# three whose trips alone run on the card) and, for the trips of the games
# that no bench config runs, the exec main's parameters and the x0 draw's
# sigma.
DRIVING_GAMES = ("roundabout_merging", "three_player_overtaking",
                 "three_player_intersection_reachability",
                 "modified_three_player_intersection", "skeleton")
SMALL_CONFIG = dict(params={}, sigma=0.1)
# Phase 13: the first half of the reachability family (the one-player
# game's golden run, the collision_reach cell; the air game's trips).
REACH_GAMES = ("one_player_reachability",
               "two_player_collision_avoidance_reachability",
               "modified_air_3d")
# tests/test_golden.py:48-71: the one-player golden run's total cost within
# 0.09 of the reference's 8.8074, its positions within 0.35 m of the
# reference solver's trajectory.
REACH_GOLDEN = os.path.join("tests", "golden",
                            "one_player_reachability_exec_params.txt")
REACH_GOLDEN_COST, REACH_COST_TOL, REACH_POS_M = 8.8074, 0.09, 0.35
# The JAX package's outcome of the collision_reach cell on the same draw
# (1024 instances, N=100, bench_all.py's exec main parameters, sigma 0.1),
# by its batched machine with fused stages (its Pallas kernels in
# interpret mode; lane blocks of 128, 20 trips a dispatch, as
# bench.run_config), made on a CPU (~12 min) with
#   python -c "import jax; jax.config.update('jax_platforms', 'cpu')
#   import numpy as np, bench_all
#   from ilqgames_tpu.examples import more_reachability as m
#   from ilqgames_tpu.solver import batched
#   p = m.make_two_player_collision_avoidance()
#   res = batched.make_host_batched_solver(
#       p.dynamics, p.player_costs, p.spec, bench_all._exec_params(),
#       warm_op=p.initial_operating_point(),
#       warm_strategy=p.initial_strategy(), trips_per_call=20,
#       batch_block=128, interpret=True, fuse_stages=True)(
#       bench_all._perturbed_x0(p, 1024, 0.1))
#   c = np.asarray(res.total_costs)
#   print(float(res.converged.mean()),
#         float(res.cumulative_iterations.mean()),
#         np.percentile(c, 50, axis=0), float((c.max(1) > 1e6).mean()))"
# Not the per-instance machine (`fused.make_host_batched_solver`) of the
# earlier cells: in a MAX game the two JAX machines decide apart. The
# per-instance iLQ solve quadraticizes the accepted iterate with the
# previous iterate's extreme knots (ilqgames_tpu/solver/ilq.py:263), the
# fused batched machine gates its stage with the accepted iterate's
# (batched.py:202), as the port does; on this draw the per-instance
# machine gives converged 0.8018, mean_iters 6.5, cost_p50 [3.0991,
# 3.0269], diverged_frac 0.0908. The bands are phase 9's
# (DUBINS_FRAC_TOL, DUBINS_ITERS_REL, COST_P50_REL).
COLLISION_REACH_JAX = dict(converged=0.8809, mean_iters=8.3,
                           cost_p50=(3.3816, 3.5301), diverged_frac=0.0781)
# Phase 14: the coupled reachability games (the two-player golden run, the
# air3d cell).
COUPLED_GAMES = ("two_player_reachability", "air_3d")
# tests/test_golden_more.py:103-121: the two-player game's shipped failure,
# which the JAX package's batched machine meets too (on a CPU: not
# converged, 2 iterations, total costs [10.544106, 4.760082], one lane
# padded to 8, bench.GOLDEN_RUNS' parameters, as its per-instance solve:
# 2 iterations, [10.544113, 4.760085]).
TWO_REACH_COSTS, TWO_REACH_COST_TOL, TWO_REACH_MAX_ITERS = (
    (10.5441, 4.7601), 2e-3, 4)
# The JAX package's outcome of the air3d_1024 cell on the same draw (1024
# instances, N=100, sigma 0.1 around (4, 3, pi/4), the exec main's budgets
# with the reference air3d main's linesearch), by its batched machine with
# fused stages (its Pallas kernels in interpret mode; lane blocks of 128,
# 20 trips a dispatch, as bench.run_config), made on a CPU (~7 min) with
#   python -c "import jax; jax.config.update('jax_platforms', 'cpu')
#   import numpy as np, bench_all
#   from ilqgames_tpu.examples import air_3d
#   from ilqgames_tpu.solver import batched
#   p = air_3d.make_problem()
#   res = batched.make_host_batched_solver(
#       p.dynamics, p.player_costs, p.spec, bench_all._exec_params(
#           initial_alpha_scaling=0.75, expected_decrease_fraction=0.1,
#           convergence_tolerance=0.01),
#       warm_op=p.initial_operating_point(),
#       warm_strategy=p.initial_strategy(), trips_per_call=20,
#       batch_block=128, interpret=True, fuse_stages=True)(
#       bench_all._perturbed_x0(p, 1024, 0.1))
#   c = np.asarray(res.total_costs)
#   print(float(res.converged.mean()),
#         float(res.cumulative_iterations.mean()),
#         np.percentile(c, 50, axis=0), float((c.max(1) > 1e6).mean()))"
# which printed 0.015625 28.552734375 [8.006075 -0.97225785] 0.0. The game
# has several local solutions (baselines/measured.json "air_3d") and no
# golden trajectory: it is judged by distribution. The bands are phase 9's
# (DUBINS_FRAC_TOL, DUBINS_ITERS_REL, COST_P50_REL).
AIR3D_JAX = dict(converged=0.0156, mean_iters=28.6,
                 cost_p50=(8.0061, -0.9723), diverged_frac=0.0)
# The flagship's K1 as ptxas reports it without CT_COUPLED, before and
# after the coupled systems' Jacobians came into costs.cuh.
FLAGSHIP_K1_PTXAS = dict(registers=80, stack=176)
# Phase 15: the flat driving games.
FLAT_GAMES = ("three_player_flat_overtaking", "flat_roundabout_merging")
# The JAX package's nominal run of the flat overtaking (the exec main's
# parameters, bench.GOLDEN_RUNS["flat_overtaking"]) by its batched machine
# with fused stages, one lane padded to 8, made on a CPU with
#   python -c "import jax; jax.config.update('jax_platforms', 'cpu')
#   import jax.numpy as jnp, numpy as np
#   from ilqgames_tpu.examples import three_player_flat_overtaking as fo
#   from ilqgames_tpu.costs import player_cost as pc
#   from ilqgames_tpu.solver import batched
#   from ilqgames_tpu.solver.params import SolverParams
#   from ilqgames_tpu.types import OperatingPoint as Op, Strategy as St
#   p = fo.make_problem(); s = p.spec
#   prm = SolverParams(linesearch=True, initial_alpha_scaling=0.75,
#       expected_decrease_fraction=0.1, convergence_tolerance=0.01,
#       max_backtracking_steps=100)
#   r = batched.make_host_batched_solver(p.dynamics, p.player_costs, s, prm,
#       warm_op=p.initial_operating_point(),
#       warm_strategy=p.initial_strategy(), trips_per_call=20,
#       batch_block=8, interpret=True, fuse_stages=True)(p.x0[None])
#   print(int(r.cumulative_iterations[0]), bool(r.converged[0]),
#         np.asarray(r.total_costs[0]).tolist())
#   trip = jax.jit(batched._driver_parts(p.dynamics, p.player_costs, s,
#       prm, 1, 8, True, fuse_stages=True)[0])
#   x0 = jnp.tile(p.x0[None], (8, 1))
#   bc = lambda t: jax.tree_util.tree_map(
#       lambda a: jnp.broadcast_to(a[None], (8,) + a.shape), t)
#   al = jax.vmap(lambda _: pc.ALState.init(p.player_costs, s))(
#       jnp.arange(8))
#   fc = batched._carry0(p.dynamics, p.player_costs, s, x0,
#       bc(Op.zeros(s)), bc(St.zeros(s)), al, 8, True, fuse_stages=True)
#   for i in range(4):
#       fc = trip(x0, fc); print(float(fc.c.last_merit[0]))"
# which printed 7 True [926990.9375, 752089.75, 38290.546875] and the
# merits 26844491415552.0, 1683047972864.0, 106569768960.0 and
# 106300940288.0. The fourth trip's LQ solve is ill-conditioned: on the
# same operands the float32 solutions (the JAX package's, the port's) lie
# far from the float64 one (tests/test_torch_flat_games.py), so the two
# machines part there. The first FLAT_TRIPS_HELD trips' merits are held to
# the JAX package's; the whole run to the port's on the CPU.
FLAT_OVERTAKING_JAX = dict(
    iterations=7, converged=True,
    total_costs=(926990.9375, 752089.75, 38290.546875),
    merits=(26844491415552.0, 1683047972864.0, 106569768960.0,
            106300940288.0))
FLAT_TRIPS_HELD = 3
# Phase 16: the CLI in-process at full width (the flagship, N=100, the
# exec main's parameters: the CLI's defaults); its simulators over 1 s of
# depth, 3 cycles of 0.25 s (2 s and 7 cycles until phase 17 came: cut in
# depth for the script's time). Each simulator's first CLI_HELD_CYCLES cycles
# are held card against CPU: the CPU runs the same command over
# CLI_HELD_TIME (a CPU job from phase 1 on; its plain versions take ~5 s a
# flagship trip at N=100, so these two jobs take minutes).
CLI_FINAL_TIME, CLI_REPLANS = "1.0", 3
CLI_HELD_TIME, CLI_HELD_CYCLES = "0.75", 2
# The simulators' budget: 20 iterations a solve, the replanning budget of
# phase 7c and bench_all.py's config 5 (at the CLI's 100 every warm solve
# ran its whole budget: 4.5-6.0 s a flagship cycle and 14.8-17.7 s a
# cycle of the minimally-invasive pair on an H100, past the script's
# time).
CLI_REPLAN_ITERS = ("--max_solver_iters", "20")
CLI_RH = ("--receding_horizon",) + CLI_REPLAN_ITERS
CLI_MI = ("--example", "modified_three_player_intersection",
          "--safety_example",
          "three_player_intersection_reachability") + CLI_REPLAN_ITERS
CLI_HELD_RH = CLI_RH + ("--final_time", CLI_HELD_TIME)
CLI_HELD_MI = CLI_MI + ("--final_time", CLI_HELD_TIME)
CLI_BATCH = 256
# The JAX package's outcome of the flat_roundabout_256 cell on the same
# draw (256 instances, N=100, bench_all.py's exec main parameters, sigma
# 0.1, the initial operating point along each lane), by its batched
# machine with fused stages (its Pallas kernels in interpret mode; lane
# blocks of 128, 20 trips a dispatch, as bench.run_config), made on a CPU
# with
#   python -c "import jax; jax.config.update('jax_platforms', 'cpu')
#   import numpy as np, bench_all
#   from ilqgames_tpu.examples import flat_roundabout_merging as fr
#   from ilqgames_tpu.solver import batched
#   p = fr.make_problem()
#   res = batched.make_host_batched_solver(
#       p.dynamics, p.player_costs, p.spec, bench_all._exec_params(),
#       warm_op=p.initial_operating_point(),
#       warm_strategy=p.initial_strategy(), trips_per_call=20,
#       batch_block=128, interpret=True, fuse_stages=True)(
#       bench_all._perturbed_x0(p, 256, 0.1))
#   c = np.asarray(res.total_costs)
#   print(float(res.converged.mean()),
#         float(res.cumulative_iterations.mean()),
#         np.percentile(c, 50, axis=0), float((c.max(1) > 1e6).mean()))"
# which printed 0.1875 13.53515625 [333274.56 576387.56 330939.7
# 573469.75] 0.0546875 (in 41 min). The bands are phase 9's
# (DUBINS_FRAC_TOL, DUBINS_ITERS_REL, COST_P50_REL).
FLAT_ROUNDABOUT_JAX = dict(converged=0.1875, mean_iters=13.5,
                           cost_p50=(333274.56, 576387.56, 330939.7,
                                     573469.75), diverged_frac=0.0547)

# Phase 17: the rest of the cost layer on the flagship's dynamics and costs
# (two games that exist only as checks): ZOO_B instances of bench.py's x0
# draw each, the exec main's parameters with at most ZOO_ITERS iterations.
ZOO_B = 256
ZOO_ITERS = 30
ZOO_GAMES = ("zoo_fused", "zoo_unfused")


def zoo_player_costs(problem, atoms, constraints, fused):
    """The flagship's player costs with one of each of the rest of the
    cost layer's pieces added, on dims where it reads what it was made for
    (P1's states 0-5 hold x, y, theta, phi, v, a; P2's 6-11; P3's 12-15 x,
    y, theta, v), built from the `atoms` and `constraints` modules given
    (the port's; the tests pass the JAX package's for its twin). Fused
    (the pieces that the fused stage takes): relative_distance between P1
    and P2, nominal_path_length on P1's y, curvature on (phi, v),
    orientation on theta, a one-difference quadratic_difference, a
    quadratic_norm on P3's position, and a final-time gate over half the
    horizon on single_dimension(v <= 7) for P1. Unfused: the two convex
    proximities between P1 and P2 (the weighted one on their speeds), a
    locally convex proximity between P3 and P1 behind a final-time gate
    over half the horizon (a dense atom's gate), affine_scalar on P2's y,
    affine_vector on P3's position and the polyline signed-distance
    constraint to P1's lane."""
    import dataclasses

    import numpy as np

    pc1, pc2, pc3 = problem.player_costs
    spec = problem.spec
    gate = 0.5 * spec.num_time_steps * spec.dt
    if fused:
        pc1 = dataclasses.replace(
            pc1, state_costs=pc1.state_costs + (
                atoms.relative_distance(0.05, (0, 1), (6, 7),
                                        name="ZooRelativeDistance"),
                atoms.nominal_path_length(0.01, 1, 6.0, name="ZooPath"),
                atoms.curvature(0.5, 3, 4, name="ZooCurvature"),
                atoms.orientation(0.5, 2, np.pi / 2, name="ZooHeading"),
                atoms.quadratic_difference(0.01, (0,), (6,),
                                           name="ZooLateral")),
            state_constraints=pc1.state_constraints + (
                constraints.final_time(
                    constraints.single_dimension(4, 7.0, True),
                    gate, name="ZooLateSpeed"),))
        pc3 = dataclasses.replace(
            pc3, state_costs=pc3.state_costs + (
                atoms.quadratic_norm(0.05, 12, 13, 19.0,
                                     name="ZooRadius"),))
        return pc1, pc2, pc3
    lane1 = np.array([[-2.0, -1000.0], [-2.0, 1000.0]], np.float32)
    a = np.zeros(spec.xdim, np.float32)
    a[7] = -1.0
    A = np.zeros((spec.xdim, spec.xdim), np.float32)
    A[0, 12], A[1, 13] = 1.0, 1.0
    b = np.zeros(spec.xdim, np.float32)
    b[:2] = (-6.0, 16.0)
    pc1 = dataclasses.replace(
        pc1, state_costs=pc1.state_costs + (
            atoms.locally_convex_proximity(1.0, (0, 1), (6, 7), 6.0,
                                           name="ZooConvex"),),
        state_constraints=pc1.state_constraints + (
            constraints.polyline2_signed_distance(lane1, 0, 1, 3.0, True,
                                                  name="ZooLane"),))
    pc2 = dataclasses.replace(
        pc2, state_costs=pc2.state_costs + (
            atoms.weighted_convex_proximity(0.05, (6, 7), (0, 1), 10, 4,
                                            6.0, name="ZooWeighted"),),
        state_constraints=pc2.state_constraints + (
            constraints.affine_scalar(a, 40.0, False, name="ZooFloor"),))
    pc3 = dataclasses.replace(
        pc3, state_costs=pc3.state_costs + (
            atoms.final_time(atoms.locally_convex_proximity(
                0.5, (12, 13), (0, 1), 30.0), gate, name="ZooLateConvex"),),
        state_constraints=pc3.state_constraints + (
            constraints.affine_vector(A, b, False, name="ZooGoal"),))
    return pc1, pc2, pc3


def zoo_problem(fused, num_time_steps=None):
    """The port's zoo game (`zoo_player_costs`) on the flagship."""
    import dataclasses

    from ilqgames_tpu_torch.costs import atoms, constraints
    from ilqgames_tpu_torch.examples.three_player_intersection import \
        make_problem

    p = make_problem(num_time_steps=num_time_steps)
    return dataclasses.replace(
        p, name=ZOO_GAMES[0 if fused else 1],
        player_costs=zoo_player_costs(p, atoms, constraints, fused))


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    _stop_children()
    sys.exit(1)


def _stop_children(*_) -> None:
    """Stop the second process and the CPU workers, if they run."""
    if _SECOND["proc"] is not None:
        _SECOND["proc"].terminate()
        _SECOND["proc"].join()
        _SECOND["proc"] = None
    if _CPU["pool"] is not None:
        _CPU["pool"].terminate()
        _CPU["pool"] = None


# Phases 3, 7d, 8e-17c hold trips on the card against the same trips on the
# CPU (the plain versions: minutes in all). The CPU's run in worker
# processes of CPU_THREADS threads each (spawned: they never touch the
# card), started after the build (phase 16's two CLI runs before it),
# while the card runs the phases before theirs: CPU_WORKERS for the
# script's own phases, SECOND_WORKERS for the second process's
# (SECOND_PHASES).
CPU_WORKERS, SECOND_WORKERS, CPU_THREADS, CPU_NICE = 3, 1, 2, 10
_CPU = {"pool": None, "jobs": {}}
# Phases 11-15 and 17 run in a second process on the card, beside phases
# 2-5, 7-10 and 16 in the script's own (phase 6 after both, alone). Each
# process drives the card from one Python thread, and the holds and trips
# are bound by that thread (the card idles most of a trip: PERF.md
# section 5), so they overlap. Every timed run (a cell, a golden run,
# phase 7's latency, a CLI run: each `_FirstLaunches` run but the trips',
# and phases 4 and 5) takes the card alone (`_alone`), the other process
# held at a pause point (`_pause`), so that its seconds are taken as in
# one process. Each process times its kernels once it has the card alone
# (`_timed`).
SECOND_PHASES = (11, 12, 13, 14, 15, 17)
_SECOND = {"proc": None, "out": None}
ALONE_WAIT_S = 600


class _Pair:
    """The locks by which the two processes on the card let each other
    run alone: `alone` (one timed run at a time), this process's `busy`
    (held while it works, let go at each pause point) and the other's
    `other`; `peer()` says whether the other process still runs."""

    def __init__(self, alone, busy, other, peer):
        self.locks = (alone, busy, other)
        self.peer, self.depth = peer, 0

    def _take(self, lock) -> None:
        """Acquire `lock`, failing if the other process ended meanwhile or
        after ALONE_WAIT_S (no run holds the card half as long)."""
        t0 = time.monotonic()
        while not lock.acquire(timeout=1.0):
            if not self.peer():
                _fail("the other process on the card ended")
            if time.monotonic() - t0 > ALONE_WAIT_S:
                _fail(f"waited {ALONE_WAIT_S} s for the card")
        _WAITED["total"] += time.monotonic() - t0

    @contextlib.contextmanager
    def alone(self):
        """Run the block with the other process held at a pause point
        (nested blocks: the outer one's)."""
        alone, busy, other = self.locks
        if self.depth:
            self.depth += 1
            try:
                yield
            finally:
                self.depth -= 1
            return
        busy.release()
        self._take(alone)
        self._take(other)
        self.depth = 1
        try:
            yield
        finally:
            self.depth = 0
            other.release()
            alone.release()
            self._take(busy)

    def pause(self, wait=None):
        """A pause point: where the other process waits to run alone, let
        it and wait until it has; `wait()` (a CPU job's result) is waited
        for with the card let go. Returns wait()'s result."""
        alone, busy, _ = self.locks
        if self.depth:
            return None if wait is None else wait()
        busy.release()
        try:
            return None if wait is None else wait()
        finally:
            self._take(alone)
            alone.release()
            self._take(busy)

    def done(self) -> None:
        """This process's phases have ended: let the other run alone from
        now on."""
        self.locks[1].release()


_PAIR = [None]
# Seconds this process waited for the other's runs alone: in all, and at
# the end of its last phase (`_phase_line`).
_WAITED = {"total": 0.0, "mark": 0.0}


def _alone():
    """`_Pair.alone` of this process's pair, if two processes drive the
    card."""
    pair = _PAIR[0]
    return contextlib.nullcontext() if pair is None else pair.alone()


def _pause(wait=None):
    """`_Pair.pause` of this process's pair (else wait() at once)."""
    pair = _PAIR[0]
    if pair is None:
        return None if wait is None else wait()
    return pair.pause(wait)


def _pair_done() -> None:
    """This process's phases have ended (`_Pair.done`)."""
    if _PAIR[0] is not None:
        _PAIR[0].done()
        _PAIR[0] = None


def _cpu_worker_init() -> None:
    import torch

    # Below the script's own process, which drives the card.
    os.nice(CPU_NICE)
    torch.set_num_threads(CPU_THREADS)


def _start_cpu_jobs(jobs, workers) -> None:
    """Start each (function, *arguments) of `jobs` in the process's pool
    of `workers` worker processes (made at its first call)."""
    import multiprocessing

    if _CPU["pool"] is None:
        _CPU["pool"] = multiprocessing.get_context("spawn").Pool(
            workers, initializer=_cpu_worker_init)
    for fn, *args in jobs:
        _CPU["jobs"][(fn.__name__, *args)] = _CPU["pool"].apply_async(
            fn, args)


def _stop_cpu_jobs() -> None:
    """Close the worker pool, once every job it was given has ended."""
    if _CPU["pool"] is not None:
        _CPU["pool"].close()
        _CPU["pool"].join()
        _CPU["pool"] = None


def _cpu_job(fn, *args):
    """fn(*args): the worker pool's result where it was started there,
    else computed here."""
    job = _CPU["jobs"].get((fn.__name__, *args))
    return _pause(job.get) if job is not None else fn(*args)


def _make_game(game):
    """The problem of a CPU job: ("config", a bench config key),
    ("example", a registry name) or ("zoo", fused: a zoo game)."""
    import ilqgames_tpu_torch.examples as ex
    from ilqgames_tpu_torch import bench

    kind, name = game
    if kind == "zoo":
        return zoo_problem(name)
    return (bench.CONFIGS[name]["make"]() if kind == "config"
            else ex.get(name)())


def _cpu_trips(game, config, fuse):
    """SMALL_TRIPS fused (or unfused) trips of SMALL_B lanes of `game` on
    the CPU under the merit backend "xla", from its fresh carry, with the
    x0 draw's sigma and the exec main's parameters of bench config
    `config` ("small": SMALL_CONFIG): (x0, [carries], seconds)."""
    import dataclasses

    import torch

    from ilqgames_tpu_torch import bench
    from ilqgames_tpu_torch.solver import batched

    p = _make_game(game)
    dyn, costs, spec = p.dynamics, p.player_costs, p.spec
    cfg = SMALL_CONFIG if config == "small" else bench.CONFIGS[config]
    params = dataclasses.replace(bench.exec_main_params(), **cfg["params"])
    x0c = torch.tensor(bench.perturbed_x0(p, SMALL_B, cfg["sigma"]))
    t0 = time.perf_counter()
    cpu = [batched._fresh_init(dyn, costs, spec, None, None, SMALL_B,
                               fuse)(x0c)]
    trip, _ = batched._driver_parts(dyn, costs, spec, params, SMALL_B, fuse,
                                    "xla")
    for _ in range(SMALL_TRIPS):
        cpu.append(trip(x0c, cpu[-1]))
    return x0c, cpu, time.perf_counter() - t0


def _cpu_flagship_trips(fuse):
    """Phase 3's CPU side: CPU_TRIPS trips of the flagship's first
    FLAGSHIP_TRIP_B instances of bench.py's draw (lane blocks of 128), from
    its fresh carry: [carries]."""
    import torch

    from ilqgames_tpu_torch import bench
    from ilqgames_tpu_torch.solver import batched

    p = _make_game(("example", "three_player_intersection"))
    dyn, costs, spec = p.dynamics, p.player_costs, p.spec
    x0c = torch.tensor(bench.perturbed_x0(p, FLAGSHIP_TRIP_B))
    trip, _ = batched._driver_parts(dyn, costs, spec,
                                    bench.exec_main_params(), 128, fuse)
    cpu = [batched._fresh_init(dyn, costs, spec, None, None, 128, fuse)(x0c)]
    for _ in range(CPU_TRIPS):
        cpu.append(trip(x0c, cpu[-1]))
    return cpu


def _cpu_replanning(game, sigma):
    """The CPU side of `_replanning_card_vs_cpu`: (arrays, trips per
    cycle, seconds)."""
    return _replanning_run(_make_game(game), sigma, "cpu")


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def _compare(name, got, ref, tol):
    """NaN-aware closeness over every lane: NaNs must sit in the same
    places (the JAX package gives the same NaN lanes on this draw), other
    entries bitwise equal or within tol; at tol 0, bitwise equal (-0.0
    and +0.0 differ). Returns the max abs error over the entries that
    differ."""
    import torch

    _pause()
    nan_g, nan_r = torch.isnan(got), torch.isnan(ref)
    if not torch.equal(nan_g, nan_r):
        _fail(f"{name}: NaN pattern differs from the plain version")
    if got.dtype == ref.dtype == torch.float32:
        diff = ~nan_r & (got.view(torch.int32) != ref.view(torch.int32))
    else:
        diff = ~nan_r & (got != ref)
    err = (got - ref).abs()[diff]
    bound = tol + tol * ref.abs()[diff]
    max_abs = float(err.max()) if err.numel() else 0.0
    rel = torch.where(err > 0, err / ref.abs()[diff], 0.0)  # -0 vs +0: 0
    max_rel = float(rel.max()) if err.numel() else 0.0
    lanes_equal = int((~diff).flatten(0, -2).all(0).sum())
    print(f"# {name}: max_abs_err {max_abs:.3e} max_rel_err {max_rel:.3e} "
          f"(tol {tol:g}); {lanes_equal} of {got.shape[-1]} lanes bitwise "
          f"equal; NaN entries {int(nan_r.sum())}", flush=True)
    if not bool((err <= bound).all()) or (tol == 0 and bool(diff.any())):
        _fail(f"{name}: disagrees with its plain version beyond {tol:g}")
    return max_abs


def _ptxas(label, lib, kernel, stack_ok=False):
    """The ptxas report of `kernel` (a substring of its mangled name) in
    the build of `lib`, printed; fails on a spill, and on a stack frame
    unless `stack_ok`."""
    from ilqgames_tpu_torch.ops.cuda import build

    info = next(i for m, i in build.ptxas_report(*lib).items()
                if kernel in m)
    print(f"# {label} ptxas " + json.dumps(info), flush=True)
    bad = ("spill_stores", "spill_loads") + (() if stack_ok else ("stack",))
    if any(info[f] for f in bad):
        _fail(f"{label}: ptxas reports a spill or a stack frame: {info}")
    return info


def _same_bits(a, b) -> bool:
    """NaN in the same places and every other entry bitwise equal."""
    import torch

    nan = torch.isnan(b)
    return bool(torch.equal(torch.isnan(a), nan) and torch.equal(
        a.view(torch.int32)[~nan], b.view(torch.int32)[~nan]))


def _nbytes(*objs) -> int:
    """Bytes of the tensors in `objs` (tensors, dicts and tuples of them,
    None skipped)."""
    import torch

    total = 0
    for o in objs:
        if isinstance(o, dict):
            total += _nbytes(*o.values())
        elif isinstance(o, (tuple, list)):
            total += _nbytes(*o)
        elif isinstance(o, torch.Tensor):
            total += o.numel() * o.element_size()
    return total


def _read(op: dict) -> dict:
    """An operating point's entries that K4 reads: its models are
    time-invariant, so it reads no t0 (K1 and K5 read every entry: the
    atoms see each lane's t0 + k dt)."""
    return {k: v for k, v in op.items() if k != "t0"}


def _bound(nbytes, ops):
    """(ms, "bytes" or "operations"): the least time the card could take
    for work that moves `nbytes` and does `ops` float32 operations."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _entry(name, source, replaces, err, ms, plain_ms, nbytes, ops,
           library_ms=None):
    """One kernel's record of the kernels line (its launches are added
    once the path that runs it has run)."""
    bound_ms, bound_by = _bound(nbytes, ops)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": err,
            "ms": ms if isinstance(ms, _Later) else round(ms, 4),
            "plain_ms": round(plain_ms, 4), "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": (None if library_ms is None
                           else round(library_ms, 4))}


def _time_ms(fn, reps, warm_s=0.2):
    """Mean ms per call over `reps` calls, after at least `warm_s` of
    calls: the card idles at a low clock and takes a while to raise it."""
    import torch

    warm_until = time.perf_counter() + warm_s
    fn()
    torch.cuda.synchronize()
    while time.perf_counter() < warm_until:
        fn()
        torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# While two processes drive the card, each process times its kernels
# later, once it has the card alone (`_time_later`): the card runs the
# kernels of two processes in turns, so a kernel timed beside the other
# process's launches would count some of them.
_LATER = {"defer": False, "queue": [], "lines": []}


class _Later:
    """A kernel's time (`measure()`, ms), taken by `_time_later` into
    `ms`."""

    def __init__(self, measure):
        self.measure, self.ms = measure, None


def _timed(measure):
    """measure() (a kernel's ms) now, or a `_Later` while the other
    process drives the card."""
    if not _LATER["defer"]:
        return measure()
    later = _Later(measure)
    _LATER["queue"].append(later)
    return later


def _ms(t) -> float:
    """A time from `_timed`, once taken."""
    return t.ms if isinstance(t, _Later) else t


def _hold_ms(fn):
    """Ms per call of a held kernel (`_time_ms` after HOLD_WARM_S of
    calls), now or later (`_timed`)."""
    return _timed(lambda: _time_ms(fn, 20, HOLD_WARM_S))


def _print_later(line) -> None:
    """Print line() (which reads times from `_timed`) once they are
    taken."""
    if _LATER["defer"]:
        _LATER["lines"].append(line)
    else:
        print(line(), flush=True)


def _kernel_line(what, ms, knots, ptxas, graph_ms=None) -> str:
    """Phase 2's line of a kernel's time (`_timed`'s, once taken) per
    call and per knot, its time from a CUDA graph if given, its registers
    and stack."""
    graph = ("" if graph_ms is None else f"{1e3 * _ms(graph_ms):.3f} us a "
             "launch from a CUDA graph; ")
    return (f"# {what}: {_ms(ms):.4f} ms ({1e3 * _ms(ms) / knots:.3f} us "
            f"per knot; {graph}registers {ptxas['registers']}, stack "
            f"{ptxas['stack']} B)")


def _time_later(entries) -> None:
    """Take every deferred time in the order asked for, now that this
    process has the card alone, put each into its entry, print the lines
    that wait for them, and stop deferring."""
    _LATER["defer"] = False
    for later in _LATER["queue"]:
        later.ms = later.measure()
        later.measure = None
    _LATER["queue"].clear()
    for e in entries:
        if isinstance(e["ms"], _Later):
            e["ms"] = round(e["ms"].ms, 4)
    for line in _LATER["lines"]:
        print(line(), flush=True)
    _LATER["lines"].clear()


def _graph_ms(fn, n):
    """Mean ms per call of `fn` replayed from a CUDA graph of n calls:
    the device's time for its launches, without the host's steps between
    them (which `_time_ms` counts when they outlast the kernel)."""
    import torch

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return _time_ms(graph.replay, 5) / n


def _same_decisions(what, a, b):
    """failed, converged, done and AL mu of two carries exactly equal."""
    import torch

    _pause()
    for name, x, y in (("failed", a.c.failed, b.c.failed),
                       ("converged", a.c.converged, b.c.converged),
                       ("done", a.done, b.done), ("AL mu", a.al.mu, b.al.mu)):
        x, y = x.cpu(), y.cpu()
        if not torch.equal(x, y):
            _fail(f"{what}: {name} differs on lanes "
                  f"{(x != y).nonzero().flatten().tolist()[:16]}")


def _check_outcome(what, res, out, shape, launches, kernels, jax_p50):
    """A bench run's launches, result shape, finiteness and outcome
    bands."""
    import torch

    if min(launches[k] for k in kernels) <= 0:
        _fail(f"{what}: a kernel of the path was not launched: {launches}")
    if tuple(res.op.xs.shape) != shape:
        _fail(f"{what}: result shape {tuple(res.op.xs.shape)}, want {shape}")
    conv = res.converged
    if not bool(torch.isfinite(res.op.xs[conv]).all()):
        _fail(f"{what}: non-finite trajectory on a converged lane")
    lo, hi = DIVERGED_BAND
    if not lo <= out["diverged_frac"] <= hi:
        _fail(f"{what}: diverged_frac {out['diverged_frac']} outside "
              f"[{lo}, {hi}]")
    for p, (got, ref) in enumerate(zip(out["cost_p50"], jax_p50)):
        if not abs(got - ref) <= COST_P50_REL * ref:
            _fail(f"{what}: player {p} cost_p50 {got} vs JAX {ref}")
    print(f"# {what}: launches {launches}; outcome within the JAX bands",
          flush=True)


PROBE_MODULES = (("kernel_floor", 10), ("sweep_floor", 10),
                 ("kernel_profile", 10), ("profile_components", 1))


# A kernel's name in the ptxas reports -> its label (first match wins).
PTXAS_LABELS = (("rollout_merit_warp_kernel", "K5"),
                ("rollout_warp_kernel", "K4"), ("merit_kernel", "K6"),
                ("lq_backward_kernel", "K2"), ("lq_forward_kernel", "K3"),
                ("fma_chain_kernel", "P1"), ("smoke_kernel", "P3"))


def _ptxas_lines(dyn, spec):
    """Registers and stack frame of every P2 rung (by name), of K2-K6 and
    of P1, P3 from the builds' ptxas reports."""
    import re

    from ilqgames_tpu_torch.ops.cuda import build, lq, probes, sweep

    by_args = {probes.template_args(r): name
               for name, r in probes.RUNGS.items()}
    for lib in (probes.library(spec), sweep.library(dyn, spec),
                sweep.merit_library(spec), lq.library(spec)):
        for mangled, info in sorted(build.ptxas_report(*lib).items()):
            m = re.search(r"probe_rollout_kernelI((?:L[ib]\d+E)+)E", mangled)
            if m:
                label = "P2 " + by_args.get(tuple(
                    int(v) for v in re.findall(r"L[ib](\d+)E", m.group(1))),
                    mangled)
            else:
                label = next((k for n, k in PTXAS_LABELS if n in mangled),
                             mangled)
            print("# ptxas " + json.dumps({"kernel": label, **info}),
                  flush=True)


def _outputs(result):
    """(name, tensor) pairs of a kernel's result: a tensor, a tuple or a
    dict of tensors."""
    if isinstance(result, dict):
        return list(result.items())
    if isinstance(result, (tuple, list)):
        return [(str(i), t) for i, t in enumerate(result)]
    return [("", result)]


def _knots_cut(_probe, dev, depth):
    """A probe context whose spec and operands end after `depth` knots:
    each drawn tensor whose first axis is the probes' horizon is cut to
    its first `depth` rows (the draws stay the TPU scripts')."""
    import dataclasses

    import torch

    class Cut(_probe.Context):
        def __init__(self):
            super().__init__(dev)
            self.spec = dataclasses.replace(self.spec,
                                            num_time_steps=depth)

        def tensors(self, key, draw):
            def cut(v):
                if isinstance(v, dict):
                    return {k: cut(a) for k, a in v.items()}
                t = torch.tensor(v, device=self.dev)
                if t.ndim >= 2 and t.shape[0] == _probe.N_KNOTS:
                    t = t[:depth].contiguous()
                return t

            return self.cached(key, lambda: cut(draw()))

    return Cut()


def phase6(dyn, spec, dev):
    """The probes: P1-P3 against their plain versions at the probes'
    shapes, the rungs' ptxas reports, every distinct launch of the probe
    registry against its plain version, then every probe module from
    zeroed launch counters. Returns the kernels-line entries of P1-P3."""
    import dataclasses
    import importlib

    import numpy as np
    import torch

    from ilqgames_tpu_torch.ops.cuda import probes, sweep
    from ilqgames_tpu_torch.tools import _probe, sweep_floor

    _ptxas_lines(dyn, spec)
    ctx = _probe.Context(dev)
    N = spec.num_time_steps
    out = []
    err = {"P1": 0.0, "P2": 0.0, "P3": 0.0}
    seen = set()          # the (kernel, cost table, shape) keys checked

    # P1 on kernel_floor's x0 [16, 128], 100 steps.
    x = ctx.tensors(("floor", 26, 128), lambda: _probe.floor_draws(
        spec, 26, 128))["x0"]
    want, n_ops = _probe.float_ops(lambda: probes.fma_chain_plain(x, N))
    err["P1"] = _compare("P1 fma_chain", probes.fma_chain(spec, x, N), want,
                         TOL["P1"])
    seen.add(("P1", x.numel()))
    p1 = (_time_ms(lambda: probes.fma_chain(spec, x, N), 20),
          _once_ms(lambda: probes.fma_chain_plain(x, N)),
          2 * _nbytes(x), n_ops)

    # P2, every rung, on sweep_floor5e.py's operands (C=8, B=128, drawn
    # lamS) with the full cost table and kernel_floor's fixed controls; a
    # gate in [0.5, 1.5), scal per (candidate, lane) and t0 per lane from
    # RandomState(1), so that a rung that reads a wrong entry of them
    # disagrees. The top rung, whose time and bound the kernels line
    # reports, is held at all N knots; the fifteen below it on the first
    # P2_DEPTH knots of the same operands (each plain rollout of N knots
    # takes seconds).
    d = sweep_floor._draws(ctx, "5e")
    C, B = d["scal"].shape
    ufix = ctx.tensors(("floor", C, B), lambda: _probe.floor_draws(
        spec, C, B))["ufix"]
    rng = np.random.RandomState(1)
    f32 = lambda a: torch.tensor(a.astype(np.float32), device=dev)
    gate = f32(0.5 + rng.rand(*d["gate"].shape))
    scal = f32(0.1 + 0.9 * rng.rand(C, B))
    op = {"xs": d["xs"], "us": d["us"], "t0": f32(rng.rand(1, B))}
    st = {"Ps": d["Ps"], "alphas": d["al"]}
    kw = dict(ufix=ufix, gate=gate, lamS=d["lamS"], mu=d["mu"])
    cut = lambda a: None if a is None else a[:P2_DEPTH].contiguous()
    spec_cut = dataclasses.replace(spec, num_time_steps=P2_DEPTH)
    op_cut = {"xs": cut(op["xs"]), "us": cut(op["us"]), "t0": op["t0"]}
    st_cut = {k: cut(v) for k, v in st.items()}
    kw_cut = dict(kw, gate=cut(gate), lamS=cut(d["lamS"]))
    for rung, r in probes.RUNGS.items():
        is_top = rung == "emit_xs_us"
        args = ((rung, ctx.dyn, ctx.costs, spec, d["x0c"], op, st, scal)
                if is_top else (rung, ctx.dyn, ctx.costs, spec_cut,
                                d["x0c"], op_cut, st_cut, scal))
        kw_r = kw if is_top else kw_cut
        got = probes.probe_rollout(*args, **kw_r)
        # Operations are counted for the top rung only (its entry's bound).
        if is_top:
            want, ops_r = _probe.float_ops(
                lambda: probes.probe_rollout_plain(*args, **kw_r))
        else:
            want = probes.probe_rollout_plain(*args, **kw_r)
        for key in want:
            err["P2"] = max(err["P2"], _compare(
                f"P2 {rung} {key}", got[key], want[key], TOL["P2"]))
        seen.add(("P2", rung, "full" if r.merit == "table" else None, C, B))
        if is_top:
            top, top_ops, top_out = args, ops_r, got
    static = ("prod_static", ctx.dyn, ctx.costs, spec, d["x0c"], op, st,
              scal)
    p2 = (_time_ms(lambda: probes.probe_rollout(*top), 20),
          _once_ms(lambda: probes.probe_rollout_plain(*top)),
          _nbytes(top[4:], top_out), top_ops)

    # The ladder's K4 and K5 rows on these bounded operands (no heading
    # beyond 8192 rad), in turns: K4 (one warp per subsystem, emitting xs
    # and us) and K5 (the same warps with the full table's merit) beside
    # one thread per chain on a compile-time layout (P2 prod_static, no
    # emission) and on the run-time table (P2 emit_xs_us, K4's design
    # before one warp per subsystem).
    k4_args = (ctx.dyn, spec, *sweep_floor._k4_operands(ctx, "5e", "x0c"))
    want = sweep.rollout_plain(*k4_args, emit_us=True)
    for nm, g, w in zip(("xs", "us"), sweep.rollout_bm(*k4_args,
                                                       emit_us=True), want):
        _compare(f"K4 {nm} (probes' operands)", g, w, TOL["K4"])
    k5_args = (ctx.dyn, ctx.costs, spec, *k4_args[2:], d["lamS"], None,
               d["mu"])
    _compare("K5 merits (probes' operands)", sweep.rollout_merits(*k5_args),
             sweep.rollout_merits_plain(*k5_args), TOL["K5"])
    designs = {
        "K4": lambda: sweep.rollout_bm(*k4_args, emit_us=True),
        "K5": lambda: sweep.rollout_merits(*k5_args),
        "P2 prod_static": lambda: probes.probe_rollout(*static, **kw),
        "P2 emit_xs_us": lambda: probes.probe_rollout(*top)}
    order = list(designs) + list(designs)[::-1]
    ms = {k: 0.0 for k in designs}
    for k in order:
        ms[k] += _time_ms(designs[k], 20) / 2
    print("# ladder (C=8, B=128, probes' operands), us per knot: "
          + json.dumps({k: round(1e3 * v / N, 3) for k, v in ms.items()}),
          flush=True)

    # P3 at sizes with a ragged tail, then on [128, 256].
    for n in (1, 3, 5, 32771):
        x = f32(np.random.RandomState(n).randn(n))
        err["P3"] = max(err["P3"], _compare(f"P3 smoke n={n}", probes.smoke(
            spec, x)[None], probes.smoke_plain(x)[None], TOL["P3"]))
    xs3 = f32(np.random.RandomState(0).randn(128, 256))
    want, n_ops = _probe.float_ops(lambda: probes.smoke_plain(xs3))
    err["P3"] = _compare("P3 smoke", probes.smoke(spec, xs3), want,
                         TOL["P3"])
    seen.add(("P3", xs3.numel()))
    one = torch.ones((), device=dev)
    p3 = (_time_ms(lambda: probes.smoke(spec, xs3), 20),
          _time_ms(lambda: probes.smoke_plain(xs3), 20), 2 * _nbytes(xs3),
          n_ops, _time_ms(lambda: torch.add(one, xs3, alpha=2.0), 20))

    # Every other distinct (kernel, cost table, shape) that the probe
    # modules launch, once, on the module's own operands cut to their
    # first P2_DEPTH knots (at N=100 the plain versions took 50 s).
    mods = [importlib.import_module(f"ilqgames_tpu_torch.tools.{name}")
            for name, _ in PROBE_MODULES]
    t0 = time.perf_counter()
    n_checked = 0
    cut_ctx = _knots_cut(_probe, dev, P2_DEPTH)
    for mod in mods:
        for call in _probe.checks(mod.CASES, cut_ctx, seen):
            kern = call.key[0]
            got, want = _outputs(call.fn()), _outputs(call.plain())
            for (name, g), (_, w) in zip(got, want):
                e = _compare(f"{kern} {call.key[1:]} {name}".rstrip(), g, w,
                             TOL[kern])
                if kern in err:
                    err[kern] = max(err[kern], e)
            n_checked += 1
    print(f"# phase 6: {n_checked} more distinct probe launches held "
          f"against their plain versions, first {P2_DEPTH} knots, in "
          f"{time.perf_counter() - t0:.1f} s; {len(seen)} in all",
          flush=True)

    src = "ilqgames_tpu_torch/csrc/probes.cu"
    out.append(_entry("P1 fma_chain (16 x 128, 100 x 50)", src,
                      "tools/kernel_floor.py:63", err["P1"], *p1))
    out.append(_entry(
        f"P2 probe_rollout (16 rungs; top rung emit_xs_us, C={C}, B={B})",
        src, "tools/sweep_floor5.py:73", err["P2"], *p2))
    out.append(_entry("P3 smoke (128 x 256)", src,
                      "tools/profile_components.py:101", err["P3"], *p3))

    # The probe modules, from zeroed counters.
    counted = {"P1": probes.fma_chain, "P2": probes.probe_rollout,
               "P3": probes.smoke, "K4": sweep.rollout_bm,
               "K5": sweep.rollout_merits, "K6": sweep.consumer_merits}
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    lines = 0
    for mod, (_, reps) in zip(mods, PROBE_MODULES):
        lines += sum(1 for _ in mod.run(reps=reps, ctx=ctx))
    launches = {k: fn.launches for k, fn in counted.items()}
    print(f"# phase 6: {lines} probe lines in "
          f"{time.perf_counter() - t0:.1f} s; launches {launches}",
          flush=True)
    if min(launches.values()) <= 0:
        _fail(f"phase 6: a kernel of the probe path was not launched: "
              f"{launches}")
    for e in out:
        e["launches"] = launches[e["name"][:2]]
    return out


# Each kernel's wrapper and plain version (module, wrapper, plain), its
# source, the TPU kernel it replaces and its label in the kernels line.
KERNEL_SITES = {
    "K1": ("stage", "lin_quad", "lin_quad_plain",
           "ilqgames_tpu_torch/csrc/stage.cu",
           "ilqgames_tpu/ops/pallas/stage.py:65", "lin_quad"),
    "K2": ("lq", "lq_backward", "lq_backward_plain",
           "ilqgames_tpu_torch/csrc/lq.cu", "ilqgames_tpu/ops/pallas/lq.py:82",
           "lq_backward"),
    "K3": ("lq", "lq_forward", "lq_forward_plain",
           "ilqgames_tpu_torch/csrc/lq.cu",
           "ilqgames_tpu/ops/pallas/lq.py:254", "lq_forward"),
    "K4": ("sweep", "rollout_bm", "rollout_plain",
           "ilqgames_tpu_torch/csrc/sweep.cu",
           "ilqgames_tpu/ops/pallas/sweep.py:176", "rollout"),
    "K5": ("sweep", "rollout_merits", "rollout_merits_plain",
           "ilqgames_tpu_torch/csrc/sweep.cu",
           "ilqgames_tpu/ops/pallas/sweep.py:176", "rollout+merit"),
    "K6": ("sweep", "consumer_merits", "merit_plain",
           "ilqgames_tpu_torch/csrc/merit.cu",
           "ilqgames_tpu/ops/pallas/sweep.py:395", "merit consumer"),
    # K7 replaces no pallas_call: the JAX package's open-loop LQ sweep is
    # XLA.
    "K7": ("lq_open_loop", "lq_open_loop", "lq_open_loop_plain",
           "ilqgames_tpu_torch/csrc/lq_open_loop.cu",
           "ilqgames_tpu/solver/lq_open_loop.py:44 (XLA)",
           "open-loop LQ sweep"),
}
OUTPUT_NAMES = {"K2": ("Ps", "alphas"), "K3": ("dxs",), "K4": ("xs", "us"),
                "K5": ("merits",), "K6": ("merits",),
                "K7": ("alphas", "dxs")}


def _k4_shape(C, B, emit_us) -> str:
    return f"C={C}, B={B}" + (", emit_us" if emit_us else "")


def _launch_shape(name, arg) -> str:
    """The shape of a launch of kernel `name`, from its arguments
    (`arg(parameter)`); K4's as `sweep.rollout_bm.by_shape` keys it."""
    if name == "K1":
        return f"B={arg('op_bm')['xs'].shape[-1]}"
    if name == "K2":
        return f"B={arg('ops')['A'].shape[-1]}" + (
            "" if arg("adaptive") else ", fixed regularization")
    if name in ("K3", "K7"):
        return f"B={arg('dx0').shape[-1]}"
    if name == "K6":
        _, _, C, B = arg("xs_cand").shape
        return f"C={C}, B={B}"
    C, B = arg("scal_cb").shape
    return _k4_shape(C, B, name == "K4" and arg("emit_us"))


def _launch_bytes(name, a, outs) -> int:
    """Bytes a launch must move: what the kernel reads of its arguments
    `a` (as phase 2 counts them) and its outputs."""
    if name == "K1":
        return _nbytes(a["op_bm"], a["lamS"], a["lamC"], a["mu"], a["gate"],
                       outs)
    if name in ("K2", "K7"):
        # Knot N-1 of A, Bf, Rf and rf is never read (K7 reads dx0 too).
        ops = a["ops"]
        return _nbytes({k: ops[k] for k in ("Qf", "lf")},
                       {k: ops[k][:-1] for k in ("A", "Bf", "Rf", "rf")},
                       a.get("dx0"), outs)
    if name == "K3":
        return _nbytes(a["A"][:-1], a["Bf"][:-1], a["alphas"], a["dx0"],
                       outs)
    if name == "K6":
        return _nbytes(a["xs_cand"], a["us_cand"], a["t0_bm"], a["lamS"],
                       a["lamC"], a["mu"], a["gate"], outs)
    if name == "K5":
        return _nbytes(a["x0m"], a["op_bm"], a["st_bm"], a["scal_cb"],
                       a["lamS"], a["lamC"], a["mu"], a["gate"], outs)
    return _nbytes(a["x0m"], _read(a["op_bm"]), a["st_bm"], a["scal_cb"],
                   outs)


def _clone(obj):
    """A copy of the tensors in `obj` (tensors, dicts and tuples of them);
    anything else as it is."""
    import torch

    if isinstance(obj, dict):
        return {k: _clone(v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(_clone(v) for v in obj)
    return obj.clone() if isinstance(obj, torch.Tensor) else obj


class _Spy:
    """Kernel wrapper `fn` (named `name`) seen through `_FirstLaunches`
    `owner`: each call that launches (the wrapper's own count goes up)
    is counted per shape in owner.tally, and the first at each shape
    leaves a copy of its arguments, by parameter name, in owner.seen. A
    wrapper counts on its module's name for itself (`rollout_bm.launches
    += 1`), which is this spy while it stands in that name, so the
    spy's attributes (`launches`, `by_shape`) are the wrapper's own,
    read and written there."""

    def __init__(self, owner, name, fn, sig):
        for attr, value in (("_owner", owner), ("_name", name), ("_fn", fn),
                            ("_sig", sig)):
            object.__setattr__(self, attr, value)
        object.__setattr__(self, "_index",
                           {p: i for i, p in enumerate(sig.parameters)})

    def __getattr__(self, attr):
        return getattr(self._fn, attr)

    def __setattr__(self, attr, value):
        setattr(self._fn, attr, value)

    def __call__(self, *args, **kwargs):
        before = self._fn.launches
        out = self._fn(*args, **kwargs)
        if self._fn.launches != before:
            params = self._sig.parameters

            def arg(p):
                i = self._index[p]
                return (args[i] if i < len(args)
                        else kwargs.get(p, params[p].default))

            key = (self._name, _launch_shape(self._name, arg))
            self._owner.tally[key] += 1
            if key not in self._owner.seen:
                bound = self._sig.bind(*args, **kwargs)
                bound.apply_defaults()
                self._owner.seen[key] = _clone(dict(bound.arguments))
        return out


class _FirstLaunches:
    """While active, each kernel wrapper stands behind a `_Spy` in its
    module: `seen[(name, shape)]` keeps a copy of the arguments of the
    wrapper's first launch at each shape and `tally` counts the launches
    per shape, to hold every (kernel, shape) that a run launched against
    its plain version afterwards. The spies add to no wrapper's count.
    With `alone` (a timed run), the run has the card alone (`_alone`)."""

    def __init__(self, alone=True):
        import collections

        self.seen, self.tally = {}, collections.Counter()
        self._saved = []
        self._alone = _alone() if alone else contextlib.nullcontext()

    def __enter__(self):
        import importlib
        import inspect

        self._alone.__enter__()
        for name, (mod, attr, *_) in KERNEL_SITES.items():
            module = importlib.import_module(f"ilqgames_tpu_torch.ops.cuda."
                                             f"{mod}")
            fn = getattr(module, attr)
            self._saved.append((module, attr, fn))
            setattr(module, attr, self._spy(name, fn, inspect.signature(fn)))
        return self

    def __exit__(self, *exc):
        for module, attr, fn in self._saved:
            setattr(module, attr, fn)
        self._saved.clear()
        self._alone.__exit__(*exc)

    def _spy(self, name, fn, sig):
        return _Spy(self, name, fn, sig)

    def split(self):
        """What was seen so far, as an object with `seen` and `tally`; the
        spy goes on from nothing."""
        import collections
        import types

        done = types.SimpleNamespace(seen=self.seen, tally=self.tally)
        self.seen, self.tally = {}, collections.Counter()
        return done


def _once_ms(fn):
    """Ms of one call of `fn`, on CUDA events (for a plain version that
    has just been run once: its times run from tens of us to seconds, and
    repeating the slow ones cost the script its margin)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


# The knots at which `_count_ops` counts a plain version's operations.
COUNT_DEPTHS = (1, 2, 3)


def _count_ops(plain, a: dict) -> int:
    """The float32 operations of plain(**a) (arguments by name, with its
    GameSpec as "spec"), counted under tools/_probe.float_ops on the
    arguments cut to the first COUNT_DEPTHS knots (`_prefix`) and carried
    to the call's depth N. A plain version repeats the same operations at
    every knot (its loops and folds run over the knots, and no branch
    reads the data), so its count is c + d N: the three depths give c and
    d, and fail the run unless they lie on one line. Counting at the
    call's depth ran the slowest plain versions (seconds a call at N=100)
    a second time; tests/test_torch_smoke_holds.py holds this count to the
    count at full depth for every kernel's plain version."""
    from ilqgames_tpu_torch.tools._probe import float_ops

    N = a["spec"].num_time_steps
    if N <= COUNT_DEPTHS[-1]:
        return float_ops(lambda: plain(**a))[1]
    c = [float_ops(lambda: plain(**_prefix(a, n)))[1] for n in COUNT_DEPTHS]
    (n0, n1, n2), step = COUNT_DEPTHS, c[1] - c[0]
    if (step % (n1 - n0) or (c[2] - c[1]) * (n1 - n0) != step * (n2 - n1)):
        _fail(f"{plain.__name__}: operation counts {c} at {COUNT_DEPTHS} "
              "knots are not linear in the knots")
    return c[0] + step // (n1 - n0) * (N - n0)


def _plain_run(plain, *args, **kwargs):
    """(result, ms, float32 operations) of a plain version on the card: its
    operations counted on a few knots (`_count_ops`), then one call at the
    arguments' depth timed (`_once_ms`), whose result is returned."""
    import inspect

    bound = inspect.signature(plain).bind(*args, **kwargs)
    bound.apply_defaults()
    a = dict(bound.arguments)
    n_ops = _count_ops(plain, a)
    out = []
    ms = _once_ms(lambda: out.append(plain(**a)))
    return out[0], ms, n_ops


def _prefix(a: dict, depth: int) -> dict:
    """A launch's arguments `a` on their first `depth` knots: the spec's
    horizon cut to `depth`, and every knot-major tensor (first axis the
    horizon, in dicts too) cut to its first `depth` rows."""
    import dataclasses

    import torch

    N = a["spec"].num_time_steps

    def cut(v):
        if isinstance(v, dict):
            return {k: cut(x) for k, x in v.items()}
        if isinstance(v, torch.Tensor) and v.ndim >= 2 and v.shape[0] == N:
            return v[:depth].contiguous()
        return v

    out = {k: cut(v) for k, v in a.items() if k not in ("x0m", "scal_cb")}
    out.update({k: a[k] for k in ("x0m", "scal_cb") if k in a})
    out["spec"] = dataclasses.replace(a["spec"], num_time_steps=depth)
    return out


def _hold_launches(cell, spy, launches, only=None, full=("K4",)):
    """Every (kernel, shape) that `cell`'s run launched (of the kernels
    `only`, if given), on the arguments of its first launch there,
    against its plain version (tolerance TOL), timed both ways; one
    kernels-line entry each, with the kernel's launches over the cell's
    run, or, where `launches` is None, its launches at that shape. K4
    and K5 run on the first HOLD_DEPTH knots of those arguments, but for
    the first shape of each kernel in `full`, held at the cell's depth;
    the other kernels at the cell's depth."""
    import importlib

    print(f"# {cell}: launches by (kernel, shape) " + json.dumps(
        [[*key, n] for key, n in sorted(spy.tally.items())]), flush=True)
    entries = []
    at_full = set()
    for (name, shape), a in sorted(spy.seen.items()):
        if only is not None and name not in only:
            continue
        depth = ""
        if name in full and name not in at_full:
            at_full.add(name)
        elif name in PREFIX_KERNELS:
            a = _prefix(a, HOLD_DEPTH)
            depth = f", first {HOLD_DEPTH} knots"
        mod, attr, plain_attr, source, replaces, label = KERNEL_SITES[name]
        module = importlib.import_module(f"ilqgames_tpu_torch.ops.cuda.{mod}")
        fn, plain = getattr(module, attr), getattr(module, plain_attr)
        got = _outputs(fn(**a))
        want, plain_ms, n_ops = _plain_run(plain, **a)
        names = OUTPUT_NAMES.get(name, [k for k, _ in got])
        err = max(_compare(f"{name} {nm} {shape}{depth} ({cell})", g, w,
                           TOL[name])
                  for nm, (_, g), (_, w) in zip(names, got, _outputs(want)))
        entries.append(dict(_entry(
            f"{name} {label} ({shape}{depth}; {cell})", source, replaces, err,
            _hold_ms(functools.partial(fn, **a)), plain_ms,
            _launch_bytes(name, a, [g for _, g in got]), n_ops),
            launches=(spy.tally[(name, shape)] if launches is None
                      else launches[name])))
    return entries


def _check_k4_held(cell, spy, by_shape):
    """Every K4 shape that `sweep.rollout_bm.by_shape` counted in the
    cell's run was held, with the same count of launches."""
    print(f"# {cell}: K4 launches by (C, B, emit_us): " + json.dumps(
        [[*key, n] for key, n in sorted(by_shape.items())]), flush=True)
    counted = {_k4_shape(*key): n for key, n in by_shape.items()}
    held = {shape: n for (name, shape), n in spy.tally.items()
            if name == "K4"}
    if counted != held:
        _fail(f"{cell}: K4's launches by shape {counted}, held {held}")


def _hold_golden(what, xs):
    """The flagship's trajectory xs [N, x] (numpy) against the reference
    solver's converged one (GOLDEN) within tests/test_golden.py's bounds
    on each player's position error."""
    import numpy as np

    ref = np.loadtxt(os.path.join(os.path.dirname(os.path.abspath(
        __file__)), GOLDEN))
    if xs.shape != ref.shape:
        _fail(f"{what}: trajectory shape {xs.shape}, reference {ref.shape}")
    for i, (xi, yi) in enumerate(GOLDEN_POSITIONS):
        err = np.hypot(xs[:, xi] - ref[:, xi], xs[:, yi] - ref[:, yi])
        print(f"# {what} P{i + 1}: max {err.max():.4f} m, mean "
              f"{err.mean():.4f} m (bounds {GOLDEN_MAX_M}, {GOLDEN_MEAN_M})",
              flush=True)
        if not (err.max() < GOLDEN_MAX_M and err.mean() < GOLDEN_MEAN_M):
            _fail(f"{what}: P{i + 1} beyond tests/test_golden.py's bounds")


def phase7(problem, dev):
    """The replanning path: the cold solve against the reference's
    trajectory, the warm replan latency, the receding-horizon runtime at
    full width, each kernel at each shape these two cells launched it
    against its plain version, and a short run on the card against the
    CPU. Returns the kernels-line entries of the two cells' launches."""
    import dataclasses

    import torch

    from ilqgames_tpu_torch import bench
    from ilqgames_tpu_torch.ops.cuda import sweep
    from ilqgames_tpu_torch.runtime import receding_horizon as rh

    # (a) + (b): the latency configuration's cold solve, then its replans.
    bench.reset_launches()
    with _FirstLaunches() as spy:
        res0, lat = bench.run_latency(dev, LATENCY_REPS)
    torch.cuda.synchronize()
    launches = bench.launches()
    _check_k4_held("latency", spy, sweep.rollout_bm.by_shape)
    print(json.dumps(lat), flush=True)
    kernels = _hold_launches("latency", spy, launches, full=())
    _hold_golden("golden", res0.op.xs[0].cpu().numpy())

    # (c) the receding-horizon runtime at full width.
    params = dataclasses.replace(bench.exec_main_params(),
                                 max_solver_iters=20)
    x0 = torch.tensor(bench.perturbed_x0(problem, RH_B), device=dev)
    bench.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _FirstLaunches() as spy:
        states, times, state = rh.simulate_batched(
            problem, params, x0, final_time=RH_FINAL_TIME,
            replan_interval=0.25, planner_time=0.25, batch_block=128)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = bench.launches()
    _check_k4_held("receding horizon", spy, sweep.rollout_bm.by_shape)
    st = rh.simulate_batched.last_stats
    cycles_s = wall - st["cold_s"]
    n = len(st["cycles"])
    out = {"cell": f"receding horizon {RH_B} x {n} replans",
           "wall_s": round(wall, 3), "cold_s": round(st["cold_s"], 3),
           "cycles_s": round(cycles_s, 3),
           "replans_per_s": round(RH_B * n / cycles_s, 3),
           "cold_trips": st["cold"]["trips"],
           "cold_converged": float(st["first"].converged.float().mean()),
           "converged_per_cycle": [float(c["converged"].float().mean())
                                   for c in st["cycles"]],
           "trips_per_cycle": [c["trips"] for c in st["cycles"]],
           "host_syncs_per_cycle": [c["host_syncs"] for c in st["cycles"]],
           "deep_rounds_per_cycle": [c["deep_rounds"] for c in st["cycles"]],
           "launches": launches}
    print(json.dumps(out), flush=True)
    if n != RH_REPLANS or not bool((state.num_replans == RH_REPLANS).all()):
        _fail(f"receding horizon: {n} cycles, num_replans "
              f"{state.num_replans.unique().tolist()}, want {RH_REPLANS}")
    t_end = 0.25 * RH_REPLANS
    if not (bool((state.t == t_end).all()) and float(times[-1]) == t_end):
        _fail(f"receding horizon: t {state.t.unique().tolist()}, times "
              f"{times.tolist()}, want {t_end}")
    if tuple(states.shape) != (n + 1, RH_B, problem.spec.xdim):
        _fail(f"receding horizon: states shape {tuple(states.shape)}")
    # A lane the cold solve left diverged (a player cost > 1e6, or not a
    # number) may go on to overflow; every other lane stays finite.
    calm = (st["first"].total_costs <= 1e6).all(1)
    bad = calm & ~torch.isfinite(states).all(-1).all(0)
    if bool(bad.any()):
        _fail(f"receding horizon: non-finite states on lanes "
              f"{bad.nonzero().flatten().tolist()[:16]} that the cold solve "
              "did not leave diverged")
    if min(launches[k] for k in ("K1", "K2", "K3", "K4")) <= 0:
        _fail(f"receding horizon: a kernel of the path was not launched: "
              f"{launches}")
    print(f"# receding horizon: {int(calm.sum())} of {RH_B} lanes not "
          "diverged by the cold solve, all finite; launches counted from 0 "
          "over the run", flush=True)
    kernels += _hold_launches("receding horizon", spy, launches, full=())

    # (d) the card against the CPU, 4 lanes, 2 cycles.
    _replanning_card_vs_cpu(
        "replanning", ("example", "three_player_intersection"), 0.1, dev)
    return kernels


def _replanning_run(problem, sigma, device):
    """A short replanning run (4 lanes of bench's draw with `sigma`, 2
    cycles, budgets RH_SMALL) on `device`: (its arrays on the CPU, trips
    per cycle, seconds)."""
    import dataclasses

    import torch

    from ilqgames_tpu_torch import bench
    from ilqgames_tpu_torch.runtime import receding_horizon as rh

    small = dataclasses.replace(bench.exec_main_params(), **RH_SMALL)
    x = torch.tensor(bench.perturbed_x0(problem, 4, sigma)).to(device)
    t0 = time.perf_counter()
    states, times, state = rh.simulate_batched(
        problem, small, x, final_time=0.75, batch_block=4)
    sp, st = state.splicer, rh.simulate_batched.last_stats
    arrays = {
        "states": states, "times": times, "x": state.x, "t": state.t,
        "converged": state.converged, "num_replans": state.num_replans,
        "cold converged": st["first"].converged,
        "splicer xs": sp.op.xs, "splicer us": sp.op.us,
        "splicer t0": sp.op.t0, "splicer Ps": sp.strategy.Ps,
        "splicer alphas": sp.strategy.alphas,
        "splicer length": sp.length}
    return ({k: v.cpu() for k, v in arrays.items()},
            [c["trips"] for c in st["cycles"]], time.perf_counter() - t0)


def _replanning_card_vs_cpu(name, game, sigma, dev):
    """A short replanning run of `game` (`_make_game`) on the card and on
    the CPU (`_replanning_run`): decisions equal, states and the
    splicer's arrays bitwise equal."""
    import torch

    with _alone():
        card, card_trips, card_s = _replanning_run(_make_game(game), sigma,
                                                   dev)
    cpu, cpu_trips, cpu_s = _cpu_job(_cpu_replanning, game, sigma)
    for what, c in cpu.items():
        g = card[what]
        if not (_same_bits(g, c) if c.dtype == torch.float32
                else torch.equal(g, c)):
            _fail(f"{name} card vs CPU: {what} differs")
    if card_trips != cpu_trips:
        _fail(f"{name} card vs CPU: trips per cycle {card_trips} vs "
              f"{cpu_trips}")
    print(f"# {name} card vs CPU (4 lanes, 2 cycles, {RH_SMALL}): "
          f"decisions equal, every array bitwise equal; trips per cycle "
          f"{cpu_trips}, cold converged {cpu['cold converged'].tolist()}, "
          f"converged {cpu['converged'].tolist()} ({card_s:.1f} s on the "
          f"card, {cpu_s:.1f} s on the CPU)", flush=True)


def _merit_state(problem, op_bm):
    """The merit kernels' multipliers, mu and extremal gate (batch-minor,
    `sweep._prep_al`) at the batch-minor operating point op_bm: those of
    one AL update from a fresh state (lamS and lamC None where the game
    has no such constraints) and the gate of its extreme knots (None for
    a game of SUM players)."""
    from ilqgames_tpu_torch.costs import player_cost as pcost
    from ilqgames_tpu_torch.ops.cuda import sweep
    from ilqgames_tpu_torch.ops.cuda.layout import mb
    from ilqgames_tpu_torch.solver.al import constraint_violations
    from ilqgames_tpu_torch.types import OperatingPoint

    costs, spec = problem.player_costs, problem.spec
    N, P, u = spec.num_time_steps, spec.num_players, spec.umax
    B = op_bm["xs"].shape[-1]
    op = OperatingPoint(xs=mb(op_bm["xs"], B),
                        us=mb(op_bm["us"], B).reshape(B, N, P, u),
                        t0=op_bm["t0"][0])
    al0 = pcost.ALState.init(costs, spec, B, device=op.xs.device)
    al1, _ = constraint_violations(costs, spec, op, al0)
    gate = (None if pcost.all_sum(costs) else pcost.extreme_gate(
        costs, spec, pcost.total_costs(costs, spec, op)[1]))
    return sweep._prep_al(spec, al1, gate, 1)


def _hold_merits(cell, spy, problem, full=True):
    """K5 and K6 at every shape at which `cell`'s run launched K4 without
    emitting controls (the linesearch's candidates), on the first such
    launch's arguments with the multipliers, mu and extremal gate of
    `_merit_state` there, against their plain versions: the merit backends
    "kernel" and "pallas" on the cell's shapes; K5 at the cell's depth at
    the first shape (unless not `full`: the game's K5 was held at full
    depth in another cell) and on the first HOLD_DEPTH knots at the others
    (K6 at the cell's depth, and at K5's for K5 == K4 + K6). One
    kernels-line entry each, with 0 launches: the cell's path (merit
    backend "xla") does not launch them, and these holds are not
    counted."""
    from ilqgames_tpu_torch.ops.cuda import sweep

    costs, spec = problem.player_costs, problem.spec
    entries = []
    first = full
    for (name, shape), a in sorted(spy.seen.items()):
        if name != "K4" or a["emit_us"]:
            continue
        lamS, lamC, mu, gate = _merit_state(problem, a["op_bm"])
        k5 = dict(dyn=a["dyn"], player_costs=costs, spec=spec,
                  x0m=a["x0m"], op_bm=a["op_bm"], st_bm=a["st_bm"],
                  scal_cb=a["scal_cb"], lamS=lamS, lamC=lamC, mu=mu,
                  gate=gate)
        xs_c = sweep.rollout_bm(a["dyn"], spec, a["x0m"], a["op_bm"],
                                a["st_bm"], a["scal_cb"])
        k6 = dict(player_costs=costs, spec=spec, xs_cand=xs_c,
                  us_cand=sweep._us_from_xs(spec, xs_c, a["op_bm"],
                                            a["st_bm"], a["scal_cb"]),
                  t0_bm=a["op_bm"]["t0"], lamS=lamS, lamC=lamC, mu=mu,
                  gate=gate)
        depth = ""
        if not first:
            k5 = _prefix(k5, HOLD_DEPTH)
            depth = f", first {HOLD_DEPTH} knots"
        first = False
        got = {}
        for kname, fn, plain, args, dep in (
                ("K5", sweep.rollout_merits, sweep.rollout_merits_plain, k5,
                 depth),
                ("K6", sweep.consumer_merits, sweep.merit_plain, k6, "")):
            _, _, _, source, replaces, label = KERNEL_SITES[kname]
            got[kname] = fn(**args)
            want, plain_ms, n_ops = _plain_run(plain, **args)
            err = _compare(f"{kname} merits {shape}{dep} ({cell})",
                           got[kname], want, TOL[kname])
            entries.append(dict(_entry(
                f"{kname} {label} ({shape}{dep}; {cell}, held only: its xla "
                "path does not launch it)", source, replaces, err,
                _hold_ms(functools.partial(fn, **args)), plain_ms,
                _launch_bytes(kname, args, [got[kname]]), n_ops),
                launches=0))
        k6_at = got["K6"] if not depth else sweep.consumer_merits(
            **_prefix(k6, HOLD_DEPTH))
        if not _same_bits(got["K5"], k6_at):
            _fail(f"{cell}: K5 and K4 + K6 disagree at {shape}{depth}")
    return entries


def _trips_card_vs_cpu(name, game, config, fuse, dev,
                       backends=("xla", "kernel", "pallas"), hold=(),
                       against_cpu=True):
    """SMALL_TRIPS trips of SMALL_B lanes of `game` (`_make_game`; stages
    fused or not) with the x0 draw's sigma and the exec main's parameters
    of bench config `config` ("small": SMALL_CONFIG) on the card against
    the CPU (`_cpu_trips`) under each merit backend of `backends`:
    decisions equal, every array of the carry bitwise equal. On the CPU
    the three backends are one computation (the plain versions). Without
    `against_cpu`, the card's trips alone, from the fresh carry made here.
    Returns the kernels-line entries of K5 and K6 at each shape these trips
    launched them, and of the kernels `hold` at each shape the "xla" trips
    launched them, with their launches there."""
    import dataclasses

    import torch

    from ilqgames_tpu_torch import bench
    from ilqgames_tpu_torch.solver import batched
    from ilqgames_tpu_torch.types import tree_leaves, tree_map

    p = _make_game(game)
    dyn, costs, spec = p.dynamics, p.player_costs, p.spec
    cfg = SMALL_CONFIG if config == "small" else bench.CONFIGS[config]
    params = dataclasses.replace(bench.exec_main_params(), **cfg["params"])
    if against_cpu:
        x0c, cpu, cpu_s = _cpu_job(_cpu_trips, game, config, fuse)
    else:
        x0c = torch.tensor(bench.perturbed_x0(p, SMALL_B, cfg["sigma"]))
        cpu = [batched._fresh_init(dyn, costs, spec, None, None, SMALL_B,
                                   fuse)(x0c)]
    kernels = []
    for backend, kname in (("xla", "K4"), ("kernel", "K5"),
                           ("pallas", "K6")):
        if backend not in backends:
            continue
        trip, _ = batched._driver_parts(dyn, costs, spec, params, SMALL_B,
                                        fuse, backend)
        fc = tree_map(lambda a: a.to(dev), cpu[0])
        bench.reset_launches()
        with _FirstLaunches(alone=False) as spy:
            for i in range(SMALL_TRIPS):
                fc = trip(x0c.to(dev), fc)
                if not against_cpu:
                    continue
                what = f"{name} card vs CPU, {backend!r}, trip {i}"
                _same_decisions(what, fc, cpu[i + 1])
                for g, w in zip(tree_leaves(fc), tree_leaves(cpu[i + 1])):
                    g = g.cpu()
                    same = (_same_bits(g, w) if w.dtype == torch.float32
                            else torch.equal(g, w))
                    if not same:
                        _fail(f"{what}: an array differs")
        torch.cuda.synchronize()
        if bench.launches()[kname] <= 0:
            _fail(f"{name}: merit_backend={backend!r} never launched "
                  f"{kname}")
        held = (kname,) if backend != "xla" else tuple(hold)
        if held:
            # The merit kernel of this backend (of "xla": the kernels
            # `hold`, K4 on the first HOLD_DEPTH knots) at each shape
            # these trips launched it, with its launches there.
            kernels += _hold_launches(
                f"{name} {'card vs CPU, ' if against_cpu else ''}"
                f"{SMALL_B} lanes, {backend!r}", spy, None, only=held,
                full=("K4",) if backend != "xla" else ())
    stages = "fused" if fuse else "unfused"
    if against_cpu:
        print(f"# {name} card vs CPU ({SMALL_B} lanes, {SMALL_TRIPS} {stages} "
              f"trips, merit backends {', '.join(backends)}): decisions "
              f"equal, every array bitwise equal; failed "
              f"{cpu[-1].c.failed.tolist()}, converged "
              f"{cpu[-1].c.converged.tolist()} ({cpu_s:.1f} s on the CPU)",
              flush=True)
    return kernels


def phase8(dev):
    """bench_all.py's two unconstrained games at full size through the
    bench's entry point (`bench.run_config`): their outcome against the
    JAX package's bands, every (kernel, shape) each cell launched against
    its plain version (and K5, K6 at its linesearch shapes), and a few
    trips of each on the card against the CPU under every merit backend,
    K5 and K6 held at every shape those trips launched them. Returns the
    kernels-line entries."""
    import torch

    from ilqgames_tpu_torch import bench
    from ilqgames_tpu_torch.ops.cuda import build, lq, stage, sweep

    games = {c: bench.CONFIGS[c]["make"]() for c in (1, 2)}
    names = {1: "pm 1024", 2: "collision 256"}

    # (a) the two games' libraries, one nvcc each, all at once.
    t0 = time.perf_counter()
    libs = []
    for p in games.values():
        libs += [stage.library(p.spec), lq.library(p.spec),
                 sweep.library(p.dynamics, p.spec),
                 sweep.merit_library(p.spec)]
    build.compile_all(libs)
    for p in games.values():
        bench.build_kernels(p.dynamics, p.spec)
    print(f"# phase 8 build: {time.perf_counter() - t0:.1f} s (concurrent "
          f"nvcc: {len(libs)} libraries of the two games)", flush=True)
    for c, p in games.items():
        for label, lib, kern, stack_ok in (
                ("K2", lq.library(p.spec), "lq_backward_kernel", False),
                ("K3", lq.library(p.spec), "lq_forward_kernel", False),
                ("K4", sweep.library(p.dynamics, p.spec),
                 "rollout_warp_kernel", False),
                ("K5", sweep.library(p.dynamics, p.spec),
                 "rollout_merit_warp_kernel", True),
                ("K6", sweep.merit_library(p.spec), "merit_kernel", False)):
            _ptxas(f"{label} ({names[c]})", lib, kern, stack_ok)

    # (b)-(d) each cell, its outcome, and its launches held.
    kernels, merit_held = [], []
    for c, p in games.items():
        cell = names[c]
        bench.reset_launches()
        with _FirstLaunches() as spy:
            res, out = bench.run_config(c, dev, warmup=False)
        torch.cuda.synchronize()
        launches = bench.launches()
        print(json.dumps(out), flush=True)
        if min(launches[k] for k in ("K1", "K2", "K3", "K4")) <= 0:
            _fail(f"{cell}: a kernel of the path was not launched: "
                  f"{launches}")
        shape = (out["B"], p.spec.num_time_steps, p.spec.xdim)
        if tuple(res.op.xs.shape) != shape:
            _fail(f"{cell}: result shape {tuple(res.op.xs.shape)}, want "
                  f"{shape}")
        if not bool(torch.isfinite(res.op.xs[res.converged]).all()):
            _fail(f"{cell}: non-finite trajectory on a converged lane")
        if c == 1:
            ok = (out["converged"] >= PM_CONVERGED_MIN
                  and abs(out["mean_iters"] - PM_MEAN_ITERS)
                  <= PM_ITERS_REL * PM_MEAN_ITERS
                  and all(abs(g - r) <= COST_P50_REL * r
                          for g, r in zip(out["cost_p50"], PM_COST_P50))
                  and out["diverged_frac"] == 0.0)
            band = (f"converged >= {PM_CONVERGED_MIN}, mean_iters "
                    f"{PM_MEAN_ITERS} +- {PM_ITERS_REL:.0%}, cost_p50 "
                    f"{list(PM_COST_P50)} +- {COST_P50_REL:.0%}, diverged 0")
        else:
            lo, hi = COLL_CONVERGED_BAND
            ok = (out["diverged_frac"] >= COLL_DIVERGED_MIN
                  and lo <= out["converged"] <= hi)
            band = (f"diverged_frac >= {COLL_DIVERGED_MIN}, converged in "
                    f"[{lo}, {hi}]; mean_iters {out['mean_iters']} (JAX "
                    f"{COLL_JAX_MEAN_ITERS})")
        if not ok:
            _fail(f"{cell}: outcome outside the JAX package's band ({band}): "
                  f"{out}")
        print(f"# {cell}: outcome within the JAX package's band ({band}); "
              f"launches counted from 0 over the timed solve (no warm-up): "
              f"{launches}", flush=True)
        _check_k4_held(cell, spy, sweep.rollout_bm.by_shape)
        kernels += _hold_launches(cell, spy, launches)
        merit_held.append((cell, spy, p))

    # (e) trips on the card against the CPU, every merit backend.
    for c, p in games.items():
        kernels += _trips_card_vs_cpu(names[c], ("config", c), c, True, dev)

    # K5 and K6 at the cells' linesearch shapes, held only.
    for cell, spy, p in merit_held:
        kernels += _hold_merits(cell, spy, p)
    return kernels


def phase9(dev):
    """bench_all.py's config 4, the three-player flat intersection, at full
    size through `bench.run_config` (unfused stages, as the JAX package
    runs it): its outcome against the JAX package's bands, K1 never
    launched, every (kernel, shape) the cell launched against its plain
    version (and K5, K6 at its linesearch shapes), and two unfused trips
    of 8 lanes on the card against the CPU under every merit backend.
    Returns the kernels-line entries."""
    import torch

    from ilqgames_tpu_torch import bench
    from ilqgames_tpu_torch.ops.cuda import build, sweep

    cell = "flat 256"
    p = bench.CONFIGS[4]["make"]()
    dyn, spec = p.dynamics, p.spec

    # (a) its libraries: K4's, and K5's and K6's with the norm atoms (its
    # K1-K3 are the flagship's, built in phase 1).
    t0 = time.perf_counter()
    libs = [sweep.library(dyn, spec), sweep.library(dyn, spec, True),
            sweep.merit_library(spec, True)]
    build.compile_all(libs)
    bench.build_kernels(dyn, spec, p.player_costs)
    print(f"# phase 9 build: {time.perf_counter() - t0:.1f} s (concurrent "
          f"nvcc: {len(libs)} libraries)", flush=True)
    for label, lib, kern, stack_ok in (
            ("K4", libs[0], "rollout_warp_kernel", False),
            ("K5", libs[1], "rollout_merit_warp_kernel", True),
            ("K6", libs[2], "merit_kernel", False)):
        _ptxas(f"{label} ({cell})", lib, kern, stack_ok)

    # (b)-(d) the cell, its outcome, and its launches held.
    bench.reset_launches()
    with _FirstLaunches() as spy:
        res, out = bench.run_config(4, dev, warmup=False)
    torch.cuda.synchronize()
    launches = bench.launches()
    print(json.dumps(out), flush=True)
    if min(launches[k] for k in ("K2", "K3", "K4")) <= 0:
        _fail(f"{cell}: a kernel of the path was not launched: {launches}")
    if launches["K1"] != 0 or out["fuse_stages"]:
        _fail(f"{cell}: the unfused path launched K1: {launches}")
    shape = (out["B"], spec.num_time_steps, spec.xdim)
    if tuple(res.op.xs.shape) != shape:
        _fail(f"{cell}: result shape {tuple(res.op.xs.shape)}, want {shape}")
    if not bool(torch.isfinite(res.op.xs[res.converged]).all()):
        _fail(f"{cell}: non-finite trajectory on a converged lane")
    band = (f"converged {FLAT_CONVERGED} +- {FLAT_FRAC_TOL}, diverged_frac "
            f"{FLAT_DIVERGED} +- {FLAT_FRAC_TOL}, mean_iters {FLAT_MEAN_ITERS}"
            f" +- {FLAT_ITERS_REL:.0%}, cost_p50 {list(FLAT_COST_P50)} +- "
            f"{COST_P50_REL:.0%}")
    ok = (abs(out["converged"] - FLAT_CONVERGED) <= FLAT_FRAC_TOL
          and abs(out["diverged_frac"] - FLAT_DIVERGED) <= FLAT_FRAC_TOL
          and abs(out["mean_iters"] - FLAT_MEAN_ITERS)
          <= FLAT_ITERS_REL * FLAT_MEAN_ITERS
          and all(abs(g - r) <= COST_P50_REL * r
                  for g, r in zip(out["cost_p50"], FLAT_COST_P50)))
    if not ok:
        _fail(f"{cell}: outcome outside the JAX package's band ({band}): "
              f"{out}")
    print(f"# {cell}: outcome within the JAX package's band ({band}); "
          f"launches counted from 0 over the timed solve (no warm-up): "
          f"{launches}", flush=True)
    _check_k4_held(cell, spy, sweep.rollout_bm.by_shape)
    kernels = _hold_launches(cell, spy, launches)

    # (e) unfused trips on the card against the CPU, every merit backend.
    kernels += _trips_card_vs_cpu(cell, ("config", 4), 4, False, dev)
    # K5 and K6 at the cell's linesearch shapes, held only.
    kernels += _hold_merits(cell, spy, p)
    return kernels


def phase10(dev):
    """bench_all.py's config 5, receding-horizon reachability (three car_5d
    players, MAX structures over extremal signed-distance atoms, control
    constraints), at full size through `bench.run_config(5)`: its libraries
    and their ptxas reports, the cell's replans and outcome, every
    (kernel, shape) it launched held against its plain version (and K5,
    K6 at its linesearch shapes), two trips of 8 lanes on the card
    against the CPU (fused under each merit backend, unfused under "xla")
    and a short replanning run on the card against the CPU. Returns the
    kernels-line entries."""
    import torch

    from ilqgames_tpu_torch import bench
    from ilqgames_tpu_torch.ops.cuda import build, sweep
    from ilqgames_tpu_torch.runtime import receding_horizon as rh

    cell = f"reachability 1000 x {RH5_REPLANS}"
    cfg = bench.CONFIGS[5]
    p = cfg["make"]()
    dyn, spec, costs = p.dynamics, p.spec, p.player_costs

    # (a) its libraries (K1, K5 and K6 with CT_REACH), one nvcc each.
    t0 = time.perf_counter()
    libs = bench.kernel_libraries(dyn, spec, costs)
    build.compile_all(libs)
    bench.build_kernels(dyn, spec, costs)
    print(f"# phase 10 build: {time.perf_counter() - t0:.1f} s (concurrent "
          f"nvcc: {len(libs)} libraries)", flush=True)
    stage_lib, lq_lib, merit_lib = libs[:3]
    k4_lib, k5_lib = libs[3], libs[-1]
    for label, lib, kern, stack_ok in (
            ("K1", stage_lib, "stage_kernel", True),
            ("K2", lq_lib, "lq_backward_kernel", False),
            ("K3", lq_lib, "lq_forward_kernel", False),
            ("K4", k4_lib, "rollout_warp_kernel", False),
            ("K5", k5_lib, "rollout_merit_warp_kernel", True),
            ("K6", merit_lib, "merit_kernel", False)):
        _ptxas(f"{label} ({cell})", lib, kern, stack_ok)

    # (b) the cell at full size, one timed run with no 8-lane load before
    # it (the time limit), launch counters reset just before.
    bench.reset_launches()
    with _FirstLaunches() as spy:
        (states, times, state), out = bench.run_config(
            5, dev, warmup=False, final_time=RH5_FINAL_TIME)
    torch.cuda.synchronize()
    launches = bench.launches()
    print(json.dumps(out), flush=True)
    st = rh.simulate_batched.last_stats
    n = out["B"]
    if out["cycles"] != RH5_REPLANS or not bool(
            (state.num_replans == RH5_REPLANS).all()):
        _fail(f"{cell}: {out['cycles']} cycles, num_replans "
              f"{state.num_replans.unique().tolist()}, want {RH5_REPLANS}")
    if not (bool((state.t == RH5_T_END).all())
            and float(times[-1]) == RH5_T_END):
        _fail(f"{cell}: t {state.t.unique().tolist()}, times "
              f"{times.tolist()}, want {RH5_T_END}")
    if tuple(states.shape) != (RH5_REPLANS + 1, n, spec.xdim):
        _fail(f"{cell}: states shape {tuple(states.shape)}")
    calm = torch.isfinite(st["first"].total_costs).all(1) & (
        st["first"].total_costs.abs() <= 1e6).all(1)
    bad = calm & ~torch.isfinite(states).all(-1).all(0)
    if bool(bad.any()):
        _fail(f"{cell}: non-finite states on lanes "
              f"{bad.nonzero().flatten().tolist()[:16]} that the cold solve "
              "did not leave diverged")
    if min(launches[k] for k in ("K1", "K2", "K3", "K4")) <= 0:
        _fail(f"{cell}: a kernel of the path was not launched: {launches}")
    if launches != out["launches"]:
        _fail(f"{cell}: launches {launches}, the timed run's "
              f"{out['launches']}")
    print(f"# {cell}: {int(calm.sum())} of {n} lanes not diverged by the "
          f"cold solve, all finite; {RH5_REPLANS} replans on every lane; "
          f"launches counted from 0 over the timed run: {launches}",
          flush=True)
    _check_k4_held(cell, spy, sweep.rollout_bm.by_shape)

    # (c) every (kernel, shape) of the cell, and K5, K6 at its linesearch
    # shapes.
    kernels = _hold_launches(cell, spy, launches)
    kernels += _hold_merits(cell, spy, p)

    # (d) trips on the card against the CPU: fused under every merit
    # backend, unfused under "xla".
    kernels += _trips_card_vs_cpu("reachability", ("config", 5), 5, True,
                                  dev)
    kernels += _trips_card_vs_cpu("reachability", ("config", 5), 5, False,
                                  dev,
                                  backends=("xla",))

    # (e) a short replanning run, the card against the CPU.
    _replanning_card_vs_cpu("reachability replanning", ("config", 5),
                            cfg["sigma"], dev)
    return kernels


def _dubins_outcome(cell, key, out):
    """A dubins cell's outcome against the JAX package's on the same
    draw, within the phase's bands."""
    return _outcome_band(cell, DUBINS_JAX[key], out)


def _outcome_band(cell, ref, out):
    """A cell's outcome against the JAX package's `ref` on the same draw,
    within phase 9's bands: converged and diverged_frac within
    DUBINS_FRAC_TOL, mean_iters within DUBINS_ITERS_REL, cost_p50 within
    COST_P50_REL of its magnitude (air_3d's pursuer's is negative)."""
    band = (f"converged {ref['converged']} +- {DUBINS_FRAC_TOL}, "
            f"diverged_frac {ref['diverged_frac']} +- {DUBINS_FRAC_TOL}, "
            f"mean_iters {ref['mean_iters']} +- {DUBINS_ITERS_REL:.0%}, "
            f"cost_p50 {list(ref['cost_p50'])} +- {COST_P50_REL:.0%}")
    ok = (abs(out["converged"] - ref["converged"]) <= DUBINS_FRAC_TOL
          and abs(out["diverged_frac"] - ref["diverged_frac"])
          <= DUBINS_FRAC_TOL
          and abs(out["mean_iters"] - ref["mean_iters"])
          <= DUBINS_ITERS_REL * ref["mean_iters"]
          and all(abs(g - r) <= COST_P50_REL * abs(r)
                  for g, r in zip(out["cost_p50"], ref["cost_p50"])))
    if not ok:
        _fail(f"{cell}: outcome outside the JAX package's band ({band}): "
              f"{out}")
    return band


def _dubins_launches(what, launches, open_loop):
    """Open loop runs K7 where feedback runs K2 and K3, on unfused stages
    (no K1); feedback runs K1-K4 and never K7."""
    ran = ("K4", "K7") if open_loop else ("K1", "K2", "K3", "K4")
    idle = ("K1", "K2", "K3") if open_loop else ("K7",)
    if min(launches[k] for k in ran) <= 0 or any(launches[k]
                                                  for k in idle):
        _fail(f"{what}: launches {launches}, want {ran} launched and "
              f"{idle} not")


def phase11(dev):
    """Open-loop Nash on dubins_origin in both information patterns: its
    libraries and their ptxas reports, the golden runs against the
    reference solver's trajectories, the cells dubins_ol_1024 and
    dubins_fb_1024 against the JAX package's outcome, every (kernel,
    shape) they launched held against its plain version (and K5, K6 at
    their linesearch shapes), and two trips of 8 lanes of each pattern
    on the card against the CPU. Returns the kernels-line entries."""
    import numpy as np
    import torch

    from ilqgames_tpu_torch import bench
    from ilqgames_tpu_torch.examples import three_player_intersection
    from ilqgames_tpu_torch.ops.cuda import build, lq_open_loop, sweep

    p = bench.CONFIGS["dubins_ol"]["make"]()
    dyn, spec, costs = p.dynamics, p.spec, p.player_costs

    # (a) its libraries (K1 with CT_DIFF and CT_DUBINS, K5 and K6 with
    # CT_DIFF, K7, and K7 at the flagship's dims), one nvcc each.
    t0 = time.perf_counter()
    libs = bench.kernel_libraries(dyn, spec, costs, open_loop=True)
    k7_flagship = lq_open_loop.library(
        three_player_intersection.make_problem().spec)
    build.compile_all(libs + [k7_flagship])
    bench.build_kernels(dyn, spec, costs, open_loop=True)
    print(f"# phase 11 build: {time.perf_counter() - t0:.1f} s (concurrent "
          f"nvcc: {len(libs) + 1} libraries)", flush=True)
    for label, lib, kern, stack_ok in (
            ("K1", libs[0], "stage_kernel", True),
            ("K2", libs[1], "lq_backward_kernel", False),
            ("K3", libs[1], "lq_forward_kernel", False),
            ("K6", libs[2], "merit_kernel", False),
            ("K4", libs[3], "rollout_warp_kernel", False),
            ("K5", libs[4], "rollout_merit_warp_kernel", True),
            ("K7 G=8", libs[5], "lq_open_loop_kernelILi8E", False),
            ("K7 G=1", libs[5], "lq_open_loop_kernelILi1E", False)):
        _ptxas(f"{label} (dubins_origin)", lib, kern, stack_ok)
    for g in (8, 1):
        _ptxas(f"K7 G={g} (the flagship's dims)", k7_flagship,
               f"lq_open_loop_kernelILi{g}E")

    # (b) the golden runs, K7 held at their shape.
    kernels, golden = [], {}
    root = os.path.dirname(os.path.abspath(__file__))
    for open_loop in (True, False):
        what = "golden " + ("open loop" if open_loop else "feedback")
        bench.reset_launches()
        with _FirstLaunches() as spy:
            res, info = bench.run_golden(
                "dubins_ol" if open_loop else "dubins_fb", dev)
        torch.cuda.synchronize()
        launches = bench.launches()
        _dubins_launches(what, launches, open_loop)
        xs = res.op.xs[0].cpu().numpy()
        ref = np.loadtxt(os.path.join(root, DUBINS_GOLDEN[open_loop]))
        if xs.shape != ref.shape:
            _fail(f"{what}: trajectory shape {xs.shape}, reference "
                  f"{ref.shape}")
        e1 = float(np.hypot(xs[:, 0] - ref[:, 0], xs[:, 1] - ref[:, 1]).max())
        e2 = float(np.hypot(xs[:, 3] - ref[:, 3], xs[:, 4] - ref[:, 4]).max())
        print(f"# {what}: P1 max {e1:.4f} m, P2 max {e2:.4f} m (bounds "
              f"{DUBINS_P1_M}, {DUBINS_P2_M}); {info['trips']} trips in "
              f"{info['wall_s']} s; launches {launches}", flush=True)
        if not (e1 < DUBINS_P1_M and e2 < DUBINS_P2_M):
            _fail(f"{what}: beyond tests/test_golden_more.py's bounds")
        golden[open_loop] = xs
        if open_loop:
            kernels += _hold_launches(f"{what} 1/{bench.GOLDEN_BLOCK}", spy,
                                      launches, only=("K7",))
    gap = float(np.abs(golden[True] - golden[False]).max())
    print(f"# golden: the patterns {gap:.4f} apart (more than "
          f"{DUBINS_GAP_M} wanted)", flush=True)
    if not gap > DUBINS_GAP_M:
        _fail("golden: open loop and feedback give the same play")

    # (c) the cells, their outcome and their launches held.
    merit_held = []
    for key, cell in (("dubins_ol", "dubins_ol_1024"),
                      ("dubins_fb", "dubins_fb_1024")):
        open_loop = key == "dubins_ol"
        bench.reset_launches()
        with _FirstLaunches() as spy:
            res, out = bench.run_config(key, dev, warmup=False)
        torch.cuda.synchronize()
        launches = bench.launches()
        print(json.dumps(out), flush=True)
        _dubins_launches(cell, launches, open_loop)
        shape = (out["B"], spec.num_time_steps, spec.xdim)
        if tuple(res.op.xs.shape) != shape:
            _fail(f"{cell}: result shape {tuple(res.op.xs.shape)}, want "
                  f"{shape}")
        if not bool(torch.isfinite(res.op.xs[res.converged]).all()):
            _fail(f"{cell}: non-finite trajectory on a converged lane")
        if open_loop and bool(res.strategy.Ps.any()):
            _fail(f"{cell}: an open-loop strategy with P != 0")
        band = _dubins_outcome(cell, key, out)
        print(f"# {cell}: outcome within the JAX package's band ({band}); "
              f"launches counted from 0 over the timed solve (no warm-up): "
              f"{launches}", flush=True)
        _check_k4_held(cell, spy, sweep.rollout_bm.by_shape)
        # The game's K4 and K5 at full depth once: in the open-loop cell.
        kernels += _hold_launches(cell, spy, launches,
                                  full=("K4",) if open_loop else ())
        merit_held.append((cell, spy, open_loop))

    # (d) trips on the card against the CPU, every merit backend.
    kernels += _trips_card_vs_cpu("dubins_origin open loop",
                                  ("config", "dubins_ol"), "dubins_ol",
                                  False, dev)
    kernels += _trips_card_vs_cpu("dubins_origin feedback",
                                  ("config", "dubins_fb"), "dubins_fb",
                                  True, dev)
    # K5 and K6 at the cells' linesearch shapes, held only.
    for cell, spy, full in merit_held:
        kernels += _hold_merits(cell, spy, p, full)
    return kernels


def _driving_golden(run, dev):
    """A driving game's golden run (`bench.run_golden`) against the
    reference solver's trajectory: each player's largest position error
    within the bound, converged as the reference (and the overtaking's
    total costs within OVERTAKING_RTOL of the reference's)."""
    import numpy as np
    import torch

    from ilqgames_tpu_torch import bench

    path, players, bound, converged = DRIVING_GOLDEN[run]
    what = f"golden {run}"
    bench.reset_launches()
    res, info = bench.run_golden(run, dev)
    torch.cuda.synchronize()
    launches = bench.launches()
    if min(launches[k] for k in ("K1", "K2", "K3", "K4")) <= 0:
        _fail(f"{what}: a kernel of the path was not launched: {launches}")
    root = os.path.dirname(os.path.abspath(__file__))
    ref = np.loadtxt(os.path.join(root, path))
    xs = res.op.xs[0].cpu().numpy()
    if xs.shape != ref.shape:
        _fail(f"{what}: trajectory shape {xs.shape}, reference {ref.shape}")
    errs = [float(np.hypot(xs[:, 6 * i] - ref[:, 6 * i],
                           xs[:, 6 * i + 1] - ref[:, 6 * i + 1]).max())
            for i in range(players)]
    costs = res.total_costs[0].tolist()
    conv = bool(res.converged[0])
    print(f"# {what}: max position error per player "
          f"{[round(e, 4) for e in errs]} m (bound {bound}); converged "
          f"{conv} (the reference: {converged}); total costs "
          f"{[round(c, 4) for c in costs]}; {info['trips']} trips in "
          f"{info['wall_s']} s; launches {launches}", flush=True)
    if max(errs) >= bound or conv != converged:
        _fail(f"{what}: beyond tests/test_golden_more.py's bounds")
    if run == "overtaking" and not np.allclose(costs, OVERTAKING_COSTS,
                                               rtol=OVERTAKING_RTOL, atol=0):
        _fail(f"{what}: total costs {costs}, the reference's "
              f"{OVERTAKING_COSTS} within rtol {OVERTAKING_RTOL}")


def _later_libraries():
    """Every kernel library that phases 8-17 load, so that phase 1 builds
    them with the flagship's, one nvcc each, all at once (a library named
    twice is built once: `build._compile`)."""
    import ilqgames_tpu_torch.examples as ex
    from ilqgames_tpu_torch import bench
    from ilqgames_tpu_torch.ops.cuda import lq_open_loop

    libs = []
    for key in (1, 2, 4, 5, "dubins_ol"):
        p = bench.CONFIGS[key]["make"]()
        game = bench.kernel_libraries(p.dynamics, p.spec, p.player_costs,
                                      open_loop=key == "dubins_ol")
        libs += game[1:] if key == 4 else game  # the flat game has no K1
    libs.append(lq_open_loop.library(ex.get(
        "three_player_intersection")().spec))
    for name in DRIVING_GAMES + REACH_GAMES + COUPLED_GAMES + FLAT_GAMES:
        g = ex.get(name)()
        libs += bench.kernel_libraries(g.dynamics, g.spec, g.player_costs)
    for fused in (True, False):
        g = zoo_problem(fused)
        libs += bench.kernel_libraries(g.dynamics, g.spec, g.player_costs)
    return libs


def phase12(dev):
    """The driving games: the four-car roundabout (4 car_6d, x = 24,
    W = 33, K2 at 4 lanes a block, 44 cost atoms) and the three-player
    overtaking, their golden runs against the reference solver's
    trajectories; the roundabout_256 cell through `bench.run_config`
    against the JAX package's outcome, every (kernel, shape) it launched
    held against its plain version (and K5, K6 at its linesearch shapes);
    two trips of 8 lanes of the roundabout and of
    three_player_intersection_reachability on the card against the CPU
    under every merit backend, and of modified_three_player_intersection
    (car_5d in K1 outside CT_REACH) and the skeleton (P = 1), with K1 and
    K4 held too. Returns the kernels-line entries."""
    import torch

    import ilqgames_tpu_torch.examples as ex
    from ilqgames_tpu_torch import bench
    from ilqgames_tpu_torch.ops.cuda import build, sweep

    cell = "roundabout_256"
    p = bench.CONFIGS["roundabout"]["make"]()
    dyn, spec, costs = p.dynamics, p.spec, p.player_costs

    # (a) the libraries of the five games (built in phase 1) and the
    # roundabout's ptxas reports: no spill anywhere, no stack in K2-K6.
    games = {n: ex.get(n)() for n in DRIVING_GAMES}
    t0 = time.perf_counter()
    for g in games.values():
        bench.build_kernels(g.dynamics, g.spec, g.player_costs)
    print(f"# phase 12 build: {time.perf_counter() - t0:.1f} s (loading the "
          f"{len(games)} games' libraries)", flush=True)
    for name, g in games.items():
        libs = bench.kernel_libraries(g.dynamics, g.spec, g.player_costs)
        what = cell if name == DRIVING_GAMES[0] else name
        for label, lib, kern, stack_ok in (
                ("K1", libs[0], "stage_kernel", True),
                ("K2", libs[1], "lq_backward_kernel", False),
                ("K3", libs[1], "lq_forward_kernel", False),
                ("K6", libs[2], "merit_kernel", False),
                ("K4", libs[3], "rollout_warp_kernel", False),
                ("K5", libs[-1], "rollout_merit_warp_kernel", False)):
            _ptxas(f"{label} ({what})", lib, kern, stack_ok)
    d = bench.kernel_libraries(dyn, spec, costs)[1][1]
    tab = sweep.cost_table(costs, spec, "cpu")[0]
    print(f"# {cell}: K2 at {d['LQ_G']} lanes a block, {d['LQ_SMEM']} B of "
          f"shared memory; {tab.n} cost atoms in a table for {tab.capacity} "
          f"({ctypes.sizeof(tab)} B, K5's and K6's parameter)", flush=True)

    # (b) the golden runs.
    for run in DRIVING_GOLDEN:
        _driving_golden(run, dev)

    # (c) the cell (one solve, timed: no warm-up), counters reset just
    # before, and its outcome.
    bench.reset_launches()
    with _FirstLaunches() as spy:
        res, out = bench.run_config("roundabout", dev, warmup=False)
    torch.cuda.synchronize()
    launches = bench.launches()
    print(json.dumps(out), flush=True)
    if min(launches[k] for k in ("K1", "K2", "K3", "K4")) <= 0:
        _fail(f"{cell}: a kernel of the path was not launched: {launches}")
    shape = (out["B"], spec.num_time_steps, spec.xdim)
    if tuple(res.op.xs.shape) != shape:
        _fail(f"{cell}: result shape {tuple(res.op.xs.shape)}, want {shape}")
    if not bool(torch.isfinite(res.op.xs[res.converged]).all()):
        _fail(f"{cell}: non-finite trajectory on a converged lane")
    band = _outcome_band(cell, ROUNDABOUT_JAX, out)
    print(f"# {cell}: {out['value']} solves/s, {out['trips']} trips, "
          f"{out['deep_rounds']} deep rounds; outcome within the JAX "
          f"package's band ({band}); launches counted from 0 over the "
          f"timed solve: {launches}", flush=True)
    _check_k4_held(cell, spy, sweep.rollout_bm.by_shape)
    kernels = _hold_launches(cell, spy, launches)
    kernels += _hold_merits(cell, spy, p)

    # (d) trips on the card against the CPU, every merit backend; K1 and
    # K4 of the two games that no cell runs held at their shapes.
    kernels += _trips_card_vs_cpu("roundabout", ("config", "roundabout"),
                                  "roundabout", True, dev)
    kernels += _trips_card_vs_cpu(
        DRIVING_GAMES[2], ("example", DRIVING_GAMES[2]), "small", True, dev)
    for name in DRIVING_GAMES[3:]:
        kernels += _trips_card_vs_cpu(name, ("example", name), "small", True,
                                      dev, hold=("K1", "K4"),
                                      against_cpu=False)
    return kernels


def _reach_golden(dev):
    """The one-player reachability golden run (`bench.run_golden`, the AL
    loop at the reference's x0) against the reference solver's trajectory
    and total cost, within tests/test_golden.py's bounds; every (kernel,
    shape) it launched held against its plain version (K2 and K3 at
    P = 1). Returns the kernels-line entries."""
    import numpy as np
    import torch

    from ilqgames_tpu_torch import bench
    from ilqgames_tpu_torch.ops.cuda import sweep

    what = "golden one_player_reach"
    bench.reset_launches()
    with _FirstLaunches() as spy:
        res, info = bench.run_golden("one_player_reach", dev)
    torch.cuda.synchronize()
    launches = bench.launches()
    if min(launches[k] for k in ("K1", "K2", "K3", "K4")) <= 0:
        _fail(f"{what}: a kernel of the path was not launched: {launches}")
    root = os.path.dirname(os.path.abspath(__file__))
    ref = np.loadtxt(os.path.join(root, REACH_GOLDEN))
    xs = res.op.xs[0].cpu().numpy()
    if xs.shape != ref.shape:
        _fail(f"{what}: trajectory shape {xs.shape}, reference {ref.shape}")
    err = float(np.hypot(xs[:, 0] - ref[:, 0], xs[:, 1] - ref[:, 1]).max())
    cost = float(res.total_costs[0, 0])
    print(f"# {what}: total cost {cost:.4f} (the reference's "
          f"{REACH_GOLDEN_COST} +- {REACH_COST_TOL}); max position error "
          f"{err:.4f} m (bound {REACH_POS_M}); iterations "
          f"{int(res.cumulative_iterations[0])}, converged "
          f"{bool(res.converged[0])}; {info['trips']} trips in "
          f"{info['wall_s']} s; launches {launches}", flush=True)
    if not (abs(cost - REACH_GOLDEN_COST) < REACH_COST_TOL
            and err < REACH_POS_M):
        _fail(f"{what}: beyond tests/test_golden.py's bounds")
    _check_k4_held(what, spy, sweep.rollout_bm.by_shape)
    return _hold_launches(what, spy, launches)


def phase13(dev):
    """The first half of the reachability family: one-player reachability
    (a Dubins car, P = 1, the polyline signed-distance atom, the AL loop
    with a MAX player), the two-car collision-avoidance game (two car_5d,
    one signed distance shared by both MAX players) and modified_air_3d
    (two point masses as one linear system, quadratic differences at
    +-1e6): the three games' ptxas reports; the one-player golden run
    against the reference solver's; the collision_reach cell through
    `bench.run_config` against the JAX package's outcome, its launches
    held (and K5, K6 at its linesearch shapes); two trips of 8 lanes of
    each game on the card against the CPU under every merit backend, with
    K5 and K6 held where they launched, and K1-K4 of the air game (which
    no cell runs). Returns the kernels-line entries."""
    import torch

    import ilqgames_tpu_torch.examples as ex
    from ilqgames_tpu_torch import bench
    from ilqgames_tpu_torch.ops.cuda import sweep

    cell = "collision_reach_1024"
    p = bench.CONFIGS["collision_reach"]["make"]()
    spec = p.spec

    # (a) the libraries of the three games (built in phase 1) and their
    # ptxas reports: no spill anywhere, no stack in K2-K6.
    games = {n: ex.get(n)() for n in REACH_GAMES}
    for g in games.values():
        bench.build_kernels(g.dynamics, g.spec, g.player_costs)
    for name, g in games.items():
        libs = bench.kernel_libraries(g.dynamics, g.spec, g.player_costs)
        for label, lib, kern, stack_ok in (
                ("K1", libs[0], "stage_kernel", True),
                ("K2", libs[1], "lq_backward_kernel", False),
                ("K3", libs[1], "lq_forward_kernel", False),
                ("K6", libs[2], "merit_kernel", False),
                ("K4", libs[3], "rollout_warp_kernel", False),
                ("K5", libs[-1], "rollout_merit_warp_kernel", False)):
            _ptxas(f"{label} ({name})", lib, kern, stack_ok)

    # (b) the one-player golden run.
    kernels = _reach_golden(dev)

    # (c) the cell (one solve, timed), counters reset just before, and its
    # outcome.
    bench.reset_launches()
    with _FirstLaunches() as spy:
        res, out = bench.run_config("collision_reach", dev, warmup=False)
    torch.cuda.synchronize()
    launches = bench.launches()
    print(json.dumps(out), flush=True)
    if min(launches[k] for k in ("K1", "K2", "K3", "K4")) <= 0:
        _fail(f"{cell}: a kernel of the path was not launched: {launches}")
    shape = (out["B"], spec.num_time_steps, spec.xdim)
    if tuple(res.op.xs.shape) != shape:
        _fail(f"{cell}: result shape {tuple(res.op.xs.shape)}, want {shape}")
    if not bool(torch.isfinite(res.op.xs[res.converged]).all()):
        _fail(f"{cell}: non-finite trajectory on a converged lane")
    band = _outcome_band(cell, COLLISION_REACH_JAX, out)
    print(f"# {cell}: {out['value']} solves/s, {out['trips']} trips, "
          f"{out['deep_rounds']} deep rounds; outcome within the JAX "
          f"package's band ({band}); launches counted from 0 over the "
          f"timed solve: {launches}", flush=True)
    _check_k4_held(cell, spy, sweep.rollout_bm.by_shape)
    kernels += _hold_launches(cell, spy, launches)
    kernels += _hold_merits(cell, spy, p)

    # (d) trips on the card against the CPU, every merit backend.
    kernels += _trips_card_vs_cpu(REACH_GAMES[0], ("example", REACH_GAMES[0]),
                                  "small", True, dev)
    kernels += _trips_card_vs_cpu(REACH_GAMES[1],
                                  ("config", "collision_reach"),
                                  "collision_reach", True, dev)
    kernels += _trips_card_vs_cpu(REACH_GAMES[2], ("example", REACH_GAMES[2]),
                                  "small", True, dev,
                                  hold=("K1", "K2", "K3", "K4"))
    return kernels


def _two_reach_golden(dev):
    """The two-player reachability golden run (`bench.run_golden`, fused
    stages, a MAX and a MIN player on one coupled system) against
    tests/test_golden_more.py's pin; every (kernel, shape) it launched
    held against its plain version. Returns the kernels-line entries."""
    import torch

    from ilqgames_tpu_torch import bench
    from ilqgames_tpu_torch.ops.cuda import sweep

    what = "golden two_player_reach"
    bench.reset_launches()
    with _FirstLaunches() as spy:
        res, info = bench.run_golden("two_player_reach", dev)
    torch.cuda.synchronize()
    launches = bench.launches()
    if min(launches[k] for k in ("K1", "K2", "K3", "K4")) <= 0:
        _fail(f"{what}: a kernel of the path was not launched: {launches}")
    costs = [float(c) for c in res.total_costs[0]]
    iters = int(res.cumulative_iterations[0])
    converged = bool(res.converged[0])
    print(f"# {what}: iterations {iters} (at most {TWO_REACH_MAX_ITERS}), "
          f"converged {converged} (the pin: False), total costs "
          f"{[round(c, 6) for c in costs]} (the pin's "
          f"{list(TWO_REACH_COSTS)} +- {TWO_REACH_COST_TOL}); "
          f"{info['trips']} trips in {info['wall_s']} s; launches "
          f"{launches}", flush=True)
    if (converged or iters > TWO_REACH_MAX_ITERS
            or any(not abs(c - r) <= TWO_REACH_COST_TOL
                   for c, r in zip(costs, TWO_REACH_COSTS))):
        _fail(f"{what}: beyond tests/test_golden_more.py's pin")
    _check_k4_held(what, spy, sweep.rollout_bm.by_shape)
    return _hold_launches(what, spy, launches)


def phase14(dev):
    """The second half of the reachability family, the coupled systems:
    two_player_reachability (two_player_unicycle_4d: P2 a velocity
    disturbance with no state, a MIN player beside a MAX one) and air_3d
    (relative coordinates, the AL loop, a Jacobian that reads the knot's
    controls): both games' ptxas reports and the flagship's K1 unchanged;
    the two-player golden run against its pin; the air3d_1024 cell through
    `bench.run_config` against the JAX package's outcome, its launches
    held (and K5, K6 at its linesearch shapes); two trips of 8 lanes of
    each game on the card against the CPU under every merit backend, with
    K5 and K6 held where they launched. Returns the kernels-line
    entries."""
    import torch

    import ilqgames_tpu_torch.examples as ex
    from ilqgames_tpu_torch import bench
    from ilqgames_tpu_torch.ops.cuda import stage, sweep

    cell = "air3d_1024"
    p = bench.CONFIGS["air3d"]["make"]()
    spec = p.spec

    # (a) the libraries of the two games (built in phase 1) and their
    # ptxas reports: no spill anywhere, no stack in K2-K6; the flagship's
    # K1 as it was.
    games = {n: ex.get(n)() for n in COUPLED_GAMES}
    for g in games.values():
        bench.build_kernels(g.dynamics, g.spec, g.player_costs)
    for name, g in games.items():
        libs = bench.kernel_libraries(g.dynamics, g.spec, g.player_costs)
        if libs[0][1].get("CT_COUPLED") != 1:
            _fail(f"{name}: K1 built without CT_COUPLED")
        for label, lib, kern, stack_ok in (
                ("K1", libs[0], "stage_kernel", True),
                ("K2", libs[1], "lq_backward_kernel", False),
                ("K3", libs[1], "lq_forward_kernel", False),
                ("K6", libs[2], "merit_kernel", False),
                ("K4", libs[3], "rollout_warp_kernel", False),
                ("K5", libs[-1], "rollout_merit_warp_kernel", False)):
            _ptxas(f"{label} ({name})", lib, kern, stack_ok)
    flagship = ex.get("three_player_intersection")()
    info = _ptxas("K1 (the flagship, without CT_COUPLED)",
                  stage.library(flagship.spec), "stage_kernel", True)
    if {k: info[k] for k in FLAGSHIP_K1_PTXAS} != FLAGSHIP_K1_PTXAS:
        _fail(f"the flagship's K1 moved: {info}, was {FLAGSHIP_K1_PTXAS}")

    # (b) the two-player golden run.
    kernels = _two_reach_golden(dev)

    # (c) the cell (one solve, timed), counters reset just before, and its
    # outcome.
    bench.reset_launches()
    with _FirstLaunches() as spy:
        res, out = bench.run_config("air3d", dev, warmup=False)
    torch.cuda.synchronize()
    launches = bench.launches()
    print(json.dumps(out), flush=True)
    if min(launches[k] for k in ("K1", "K2", "K3", "K4")) <= 0:
        _fail(f"{cell}: a kernel of the path was not launched: {launches}")
    shape = (out["B"], spec.num_time_steps, spec.xdim)
    if tuple(res.op.xs.shape) != shape:
        _fail(f"{cell}: result shape {tuple(res.op.xs.shape)}, want {shape}")
    if not bool(torch.isfinite(res.op.xs[res.converged]).all()):
        _fail(f"{cell}: non-finite trajectory on a converged lane")
    band = _outcome_band(cell, AIR3D_JAX, out)
    print(f"# {cell}: {out['value']} solves/s, {out['trips']} trips, "
          f"{out['deep_rounds']} deep rounds; outcome within the JAX "
          f"package's band ({band}); launches counted from 0 over the "
          f"timed solve: {launches}", flush=True)
    _check_k4_held(cell, spy, sweep.rollout_bm.by_shape)
    kernels += _hold_launches(cell, spy, launches)
    kernels += _hold_merits(cell, spy, p)

    # (d) trips on the card against the CPU, every merit backend.
    kernels += _trips_card_vs_cpu(COUPLED_GAMES[0],
                                  ("example", COUPLED_GAMES[0]), "small",
                                  True, dev)
    kernels += _trips_card_vs_cpu(COUPLED_GAMES[1], ("config", "air3d"),
                                  "air3d", True, dev)
    return kernels


def _cpu_golden(run):
    """The CPU side of a golden run: `bench.run_golden(run)`'s solve on the
    CPU (the plain versions): (iterations, converged, total costs, xs)."""
    from ilqgames_tpu_torch import bench
    from ilqgames_tpu_torch.solver import batched
    from ilqgames_tpu_torch.solver.params import SolverParams

    make, prm = bench.GOLDEN_RUNS[run]
    p = make()
    res = batched.make_host_batched_solver(
        p.dynamics, p.player_costs, p.spec, SolverParams(**prm),
        warm_op=p.initial_operating_point(),
        warm_strategy=p.initial_strategy(), trips_per_call=20,
        batch_block=bench.GOLDEN_BLOCK)(p.x0[None])
    return (int(res.cumulative_iterations[0]), bool(res.converged[0]),
            res.total_costs[0].tolist(), res.op.xs[0])


def _flat_golden(dev):
    """The flat overtaking's nominal run (`bench.run_golden`, the exec
    main's parameters, fused stages): its first FLAT_TRIPS_HELD trips'
    merits within TRIP_TOL of the JAX package's (FLAT_OVERTAKING_JAX), the
    whole run's iterations and convergence equal to the port's on the
    CPU and its costs within TRIP_TOL of them, beside the JAX package's
    outcome; every (kernel, shape) it launched held against its plain
    version. Returns the kernels-line entries."""
    import numpy as np
    import torch

    from ilqgames_tpu_torch import bench
    from ilqgames_tpu_torch.ops.cuda import sweep
    from ilqgames_tpu_torch.solver import batched
    from ilqgames_tpu_torch.solver.params import SolverParams

    what = "golden flat_overtaking"
    jax_run = FLAT_OVERTAKING_JAX
    bench.reset_launches()
    with _FirstLaunches() as spy:
        res, info = bench.run_golden("flat_overtaking", dev)
    torch.cuda.synchronize()
    launches = bench.launches()
    if min(launches[k] for k in ("K1", "K2", "K3", "K4")) <= 0:
        _fail(f"{what}: a kernel of the path was not launched: {launches}")
    iters = int(res.cumulative_iterations[0])
    conv = bool(res.converged[0])
    costs = res.total_costs[0].tolist()
    c_iters, c_conv, c_costs, c_xs = _cpu_job(_cpu_golden, "flat_overtaking")
    same = _same_bits(res.op.xs[0].cpu(), c_xs)
    print(f"# {what}: iterations {iters}, converged {conv}, total costs "
          f"{[round(c, 4) for c in costs]} (the port on the CPU: {c_iters}, "
          f"{c_conv}, {[round(c, 4) for c in c_costs]}; trajectory bitwise "
          f"equal: {same}); the JAX package's: {jax_run['iterations']}, "
          f"{jax_run['converged']}, {list(jax_run['total_costs'])}; "
          f"{info['trips']} trips in {info['wall_s']} s; launches "
          f"{launches}", flush=True)
    if (iters, conv) != (c_iters, c_conv) or not np.allclose(
            costs, c_costs, rtol=TRIP_TOL, atol=TRIP_TOL):
        _fail(f"{what}: the card's run differs from the CPU's")
    if not bool(torch.isfinite(res.op.xs).all()):
        _fail(f"{what}: a non-finite trajectory")
    _check_k4_held(what, spy, sweep.rollout_bm.by_shape)
    kernels = _hold_launches(what, spy, launches)

    # Its first trips, one at a time, against the JAX package's merits.
    make, prm = bench.GOLDEN_RUNS["flat_overtaking"]
    p = make()
    B = bench.GOLDEN_BLOCK
    trip, _ = batched._driver_parts(p.dynamics, p.player_costs, p.spec,
                                    SolverParams(**prm), B, True)
    x0 = p.x0[None].expand(B, -1).contiguous().to(dev)
    fc = batched._fresh_init(p.dynamics, p.player_costs, p.spec, None, None,
                             B, True)(x0)
    merits = []
    for _ in jax_run["merits"]:
        fc = trip(x0, fc)
        merits.append(float(fc.c.last_merit[0]))
    rel = [abs(m - j) / abs(j) for m, j in zip(merits, jax_run["merits"])]
    print(f"# {what}: merits of trips 0-{len(merits) - 1} {merits}, the JAX "
          f"package's {list(jax_run['merits'])}: relative gaps "
          f"{[f'{r:.2e}' for r in rel]} (held within {TRIP_TOL:g} on the "
          f"first {FLAT_TRIPS_HELD}; the next trip's LQ solve is "
          f"ill-conditioned)", flush=True)
    if any(not r <= TRIP_TOL for r in rel[:FLAT_TRIPS_HELD]):
        _fail(f"{what}: a trip's merit parts from the JAX package's")
    return kernels


def phase15(dev):
    """The flat driving games, fused: three_player_flat_overtaking (three
    flat car_6d, x = 18) and flat_roundabout_merging (four, x = 24, 32
    atoms, the route initializer), one linear subsystem per player with
    36 and 48 constant Jacobian entries, the route-progress atom in K1, K5
    and K6 (CT_ROUTE): both games' ptxas reports and the flagship's K1
    unchanged; the flat overtaking's nominal run; the flat_roundabout_256
    cell through `bench.run_config` against the JAX package's outcome,
    its launches held (and K5, K6 at its linesearch shapes); two trips of
    8 lanes of each game on the card against the CPU under every merit
    backend, with K5 and K6 held where they launched. Returns the
    kernels-line entries."""
    import torch

    import ilqgames_tpu_torch.examples as ex
    from ilqgames_tpu_torch import bench
    from ilqgames_tpu_torch.ops.cuda import stage, sweep

    cell = "flat_roundabout_256"
    p = bench.CONFIGS["flat_roundabout"]["make"]()
    spec = p.spec

    # (a) the libraries of the two games (built in phase 1) and their
    # ptxas reports: no spill anywhere, no stack in K2-K6; the flagship's
    # K1 as it was.
    games = {n: ex.get(n)() for n in FLAT_GAMES}
    for g in games.values():
        bench.build_kernels(g.dynamics, g.spec, g.player_costs)
    for name, g in games.items():
        libs = bench.kernel_libraries(g.dynamics, g.spec, g.player_costs)
        if libs[0][1].get("CT_ROUTE") != 1:
            _fail(f"{name}: K1 built without CT_ROUTE")
        for label, lib, kern, stack_ok in (
                ("K1", libs[0], "stage_kernel", True),
                ("K2", libs[1], "lq_backward_kernel", False),
                ("K3", libs[1], "lq_forward_kernel", False),
                ("K6", libs[2], "merit_kernel", False),
                ("K4", libs[3], "rollout_warp_kernel", False),
                ("K5", libs[-1], "rollout_merit_warp_kernel", False)):
            _ptxas(f"{label} ({name})", lib, kern, stack_ok)
        sub = sweep._device_table(g.dynamics, g.spec)
        tab = sweep.cost_table(g.player_costs, g.spec, "cpu")[0]
        print(f"# {name}: {sub.n} linear subsystems, {sub.nlin} constant "
              f"Jacobian entries (the table holds {sweep._MAX_LIN}, "
              f"{ctypes.sizeof(sub)} B); {tab.n} cost atoms in a table for "
              f"{tab.capacity}", flush=True)
    flagship = ex.get("three_player_intersection")()
    info = _ptxas("K1 (the flagship, without CT_ROUTE)",
                  stage.library(flagship.spec), "stage_kernel", True)
    if {k: info[k] for k in FLAGSHIP_K1_PTXAS} != FLAGSHIP_K1_PTXAS:
        _fail(f"the flagship's K1 moved: {info}, was {FLAGSHIP_K1_PTXAS}")

    # (b) the flat overtaking's nominal run.
    kernels = _flat_golden(dev)

    # (c) the cell (one solve, timed), counters reset just before, and its
    # outcome.
    bench.reset_launches()
    with _FirstLaunches() as spy:
        res, out = bench.run_config("flat_roundabout", dev, warmup=False)
    torch.cuda.synchronize()
    launches = bench.launches()
    print(json.dumps(out), flush=True)
    if min(launches[k] for k in ("K1", "K2", "K3", "K4")) <= 0:
        _fail(f"{cell}: a kernel of the path was not launched: {launches}")
    shape = (out["B"], spec.num_time_steps, spec.xdim)
    if tuple(res.op.xs.shape) != shape:
        _fail(f"{cell}: result shape {tuple(res.op.xs.shape)}, want {shape}")
    if not bool(torch.isfinite(res.op.xs[res.converged]).all()):
        _fail(f"{cell}: non-finite trajectory on a converged lane")
    band = _outcome_band(cell, FLAT_ROUNDABOUT_JAX, out)
    print(f"# {cell}: {out['value']} solves/s, {out['trips']} trips, "
          f"{out['deep_rounds']} deep rounds; outcome within the JAX "
          f"package's band ({band}); launches counted from 0 over the "
          f"timed solve: {launches}", flush=True)
    _check_k4_held(cell, spy, sweep.rollout_bm.by_shape)
    kernels += _hold_launches(cell, spy, launches)
    kernels += _hold_merits(cell, spy, p)

    # (d) trips on the card against the CPU, every merit backend.
    kernels += _trips_card_vs_cpu(FLAT_GAMES[0], ("example", FLAT_GAMES[0]),
                                  "small", True, dev)
    kernels += _trips_card_vs_cpu(FLAT_GAMES[1], ("config", "flat_roundabout"),
                                  "flat_roundabout", True, dev)
    return kernels


def _cli_run(argv, device):
    """`ilqgames_tpu_torch.cli.main(argv)` in-process on `device`, its
    lines printed as they come: (main.last_run, its lines, seconds, the
    counters of the simulator it ran, or None)."""
    import contextlib
    import io

    from ilqgames_tpu_torch import cli
    from ilqgames_tpu_torch.runtime import receding_horizon as rh

    buf = io.StringIO()
    rh.simulate.last_stats = rh.simulate_minimally_invasive.last_stats = None
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv) + ["--device", str(device)])
    secs = time.perf_counter() - t0
    if rc != 0:
        _fail(f"cli {argv}: exit code {rc}")
    lines = buf.getvalue().splitlines()
    for line in lines:
        print(line, flush=True)
    stats = (rh.simulate_minimally_invasive.last_stats
             or rh.simulate.last_stats)
    return cli.main.last_run, lines, secs, stats


def _cli_sim_arrays(run, stats):
    """A simulator run's arrays on the CPU (its states, times, replans,
    each cycle's converged flag and, with a safety problem, its flags) and
    its trips per solve."""
    import torch

    sim = run["simulation"]
    out = {"states": sim[0].cpu(), "times": sim[1].cpu(),
           "num_replans": sim[-1].num_replans.cpu(),
           "converged": torch.stack([c["converged"][0]
                                     for c in stats["cycles"]]).cpu()}
    if len(sim) == 4:
        out["flags"] = sim[2].cpu()
    return out, [stats["cold"]["trips"]] + [c["trips"]
                                            for c in stats["cycles"]]


def _cpu_cli(argv):
    """The CPU side of `_cli_card_vs_cpu`: the CLI's run on the CPU, its
    lines not printed: (arrays, trips, seconds). One thread: its tensors
    are one lane block, and the worker's spare threads would only spin
    beside the script's process."""
    import contextlib
    import io

    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            run, _, secs, stats = _cli_run(argv, "cpu")
    finally:
        torch.set_num_threads(threads)
    return (*_cli_sim_arrays(run, stats), secs)


def _cli_card_vs_cpu(what, run, stats, argv):
    """The first CLI_HELD_CYCLES cycles of a simulator's CLI run on the
    card (`run`, `stats`: `_cli_run`'s) against the same command over
    CLI_HELD_TIME on the CPU (argv; `_cpu_cli`, a CPU job): states, times,
    each cycle's converged flag and the safety flags bitwise equal, the
    same trips per solve."""
    import torch

    card, card_trips = _cli_sim_arrays(run, stats)
    cpu, cpu_trips, cpu_s = _cpu_job(_cpu_cli, argv)
    n = CLI_HELD_CYCLES
    if cpu["num_replans"].item() != n:
        _fail(f"{what}: the CPU run replanned {cpu['num_replans'].item()} "
              f"times, not {n}")
    for name, c in cpu.items():
        if name == "num_replans":
            continue
        g = card[name][:c.shape[0]]
        if not (_same_bits(g, c) if c.dtype == torch.float32
                else torch.equal(g, c)):
            _fail(f"{what} card vs CPU: {name} of the first {n} cycles "
                  f"differs: card {g.tolist()}, CPU {c.tolist()}")
    if card_trips[:n + 1] != cpu_trips:
        _fail(f"{what} card vs CPU: trips {card_trips[:n + 1]} vs "
              f"{cpu_trips}")
    print(f"# {what} card vs CPU, its first {n} cycles ({' '.join(argv)} "
          f"on the CPU): states, times, converged {cpu['converged'].tolist()}"
          + (f", safety flags {cpu['flags'].tolist()}" if "flags" in cpu
             else "")
          + f" bitwise equal; trips (cold, then per cycle) {cpu_trips} "
          f"({cpu_s:.1f} s on the CPU)", flush=True)


def _cycle_line(stats) -> str:
    """A simulator's cycles in host seconds (`_simulate`'s stats): the
    mean cycle, its first half (`_next_problem`) and its solves, and the
    seconds of each cycle."""
    import numpy as np

    cyc = stats["cycles"]
    mean = lambda k: float(np.mean([c[k] for c in cyc]))
    return (f"{mean('wall_s'):.4f} s a cycle (setup {mean('setup_s'):.4f} "
            f"s, solves {mean('solve_s'):.4f} s; each cycle "
            f"{[round(c['wall_s'], 4) for c in cyc]} s)")


def _cli_cell(what, argv, dev, kernels, full=()):
    """A CLI run on the card as a cell: launch counters reset just before,
    the kernels `kernels` launched, and every (kernel, shape) it launched
    held against its plain version (K4 and K5 on HOLD_DEPTH knots, but for
    the first shape of each kernel in `full`, at full depth).
    Returns (main.last_run, lines, seconds, the simulator's
    counters, kernels-line entries)."""
    import torch

    from ilqgames_tpu_torch import bench
    from ilqgames_tpu_torch.ops.cuda import sweep

    bench.reset_launches()
    with _FirstLaunches() as spy:
        run, lines, secs, stats = _cli_run(argv, dev)
    torch.cuda.synchronize()
    launches = bench.launches()
    if min(launches[k] for k in kernels) <= 0:
        _fail(f"{what}: a kernel of the path was not launched: {launches}")
    print(f"# {what}: {secs:.3f} s in cli.main; launches counted from 0 "
          f"over the run: {launches}", flush=True)
    _check_k4_held(what, spy, sweep.rollout_bm.by_shape)
    return (run, lines, secs, stats,
            _hold_launches(what, spy, launches, full=full))


def phase16(dev):
    """The per-instance entry point: `python -m ilqgames_tpu_torch`'s main
    in-process on the card, at full width (the flagship, N=100, the exec
    main's parameters: the CLI's defaults). (a) a solve with the Nash
    check, the saved log and the HTML page; (b) the receding-horizon
    simulator over CLI_FINAL_TIME; (c) the minimally-invasive pair over
    CLI_FINAL_TIME, both at CLI_REPLAN_ITERS; (d) dubins_origin's
    open-loop solve and its receding-horizon run (K7 per instance,
    warm-started); (e) --batch. (a)-(d) are cells: every (kernel, shape)
    each launched is held against its plain version (K4 at full depth in
    (a), the flagship's first shape). The first
    CLI_HELD_CYCLES cycles of (b) and (c) are held card against CPU.
    Returns the kernels-line entries."""
    import tempfile

    import numpy as np
    import torch

    kernels = []
    fb = ("K1", "K2", "K3", "K4")
    with tempfile.TemporaryDirectory() as tmp:
        # (a) a solve, the Nash check, the saved log and the HTML page.
        what = "cli flagship"
        exp, page = os.path.join(tmp, "flagship"), os.path.join(
            tmp, "flagship.html")
        run, _, secs, _, entries = _cli_cell(
            what, ("--example", "three_player_intersection", "--check_nash",
                   "--save", "--experiment_name", exp, "--html", page),
            dev, fb, full=("K4",))
        kernels += entries
        res, log, lres = run["result"], run["log"], run["log_result"]
        _hold_golden(f"{what} golden", res.op.xs.cpu().numpy())
        last = log.num_iterates - 1
        if not _same_bits(torch.from_numpy(log.final_operating_point.xs),
                          lres.op.xs.cpu()):
            _fail(f"{what}: the log's last iterate is not the result's")
        saved = os.path.join(exp, str(last))
        xs_txt = np.loadtxt(os.path.join(saved, "xs.txt"))
        if xs_txt.shape != (100, 16) or not np.array_equal(
                xs_txt.astype(np.float32), log.final_operating_point.xs):
            _fail(f"{what}: {saved}/xs.txt has shape {xs_txt.shape} or "
                  "other values than the log's")
        for p in range(3):
            shape = np.loadtxt(os.path.join(saved, f"u{p}.txt")).shape
            if shape != (100, 2):
                _fail(f"{what}: u{p}.txt has shape {shape}")
        page_bytes = os.path.getsize(page)
        if "const D = " not in open(page).read():
            _fail(f"{what}: {page} holds no data")
        print(f"# {what}: the solve converged {bool(res.converged)} in "
              f"{int(res.cumulative_iterations)} iterations (trips: one lane "
              f"in a block of 8), costs {res.total_costs.tolist()}; the log "
              f"{log.num_iterates} iterates ({int(lres.num_iterations)} "
              f"trips, converged {bool(lres.converged)}), its last bitwise "
              f"the result's and {last}/xs.txt's; u*.txt [100, 2]; the page "
              f"{page_bytes} B", flush=True)

        # (b) the receding-horizon simulator, CLI_REPLANS cycles.
        what = "cli receding horizon"
        run, _, secs, stats, entries = _cli_cell(
            what, CLI_RH + ("--final_time", CLI_FINAL_TIME), dev, fb)
        kernels += entries
        xs, ts, state = run["simulation"]
        if not (bool(torch.isfinite(xs).all())
                and int(state.num_replans) == CLI_REPLANS
                and tuple(xs.shape) == (CLI_REPLANS + 1, 16)
                and float(xs[-1, 1]) > float(xs[0, 1])):
            _fail(f"{what}: replans {int(state.num_replans)}, shape "
                  f"{tuple(xs.shape)}, finite {bool(torch.isfinite(xs).all())}"
                  f", P1's y {float(xs[0, 1])} -> {float(xs[-1, 1])}")
        print(f"# {what}: {CLI_REPLANS} replans, all states finite, P1 from "
              f"y {float(xs[0, 1]):.3f} to {float(xs[-1, 1]):.3f}; cold solve "
              f"{stats['cold']['trips']} trips in {stats['cold_s']:.3f} s, "
              f"then {_cycle_line(stats)}, trips per cycle "
              f"{[c['trips'] for c in stats['cycles']]}", flush=True)
        _cli_card_vs_cpu(what, run, stats, CLI_HELD_RH)

        # (c) the minimally-invasive pair, CLI_REPLANS cycles.
        what = "cli minimally invasive"
        run, _, secs, stats, entries = _cli_cell(
            what, CLI_MI + ("--final_time", CLI_FINAL_TIME), dev, fb)
        kernels += entries
        xs, ts, flags, state = run["simulation"]
        if not (bool(torch.isfinite(xs).all())
                and int(state.num_replans) == CLI_REPLANS
                and tuple(flags.shape) == (CLI_REPLANS,)):
            _fail(f"{what}: replans {int(state.num_replans)}, flags "
                  f"{flags.tolist()}, finite {bool(torch.isfinite(xs).all())}")
        print(f"# {what}: {CLI_REPLANS} replans, all states finite, "
              f"safety flags {flags.tolist()}; cold solve "
              f"{stats['cold']['trips']} trips in {stats['cold_s']:.3f} s, "
              f"then {_cycle_line(stats)}, trips per cycle (both solves) "
              f"{[c['trips'] for c in stats['cycles']]}", flush=True)
        _cli_card_vs_cpu(what, run, stats, CLI_HELD_MI)

        # (d) open loop, per instance and warm-started: K7, no K1-K3.
        for what, argv in (
                ("cli dubins_origin open loop",
                 ("--example", "dubins_origin", "--open_loop")),
                ("cli dubins_origin open loop, receding horizon",
                 ("--example", "dubins_origin", "--open_loop",
                  "--receding_horizon", "--final_time", CLI_FINAL_TIME))):
            run, _, secs, stats, entries = _cli_cell(what, argv, dev,
                                                     ("K4", "K7"))
            kernels += entries
            if any(e["name"].startswith(("K1", "K2", "K3"))
                   for e in entries):
                _fail(f"{what}: the feedback kernels launched")
            if stats is not None:
                xs, _, state = run["simulation"]
                if (int(state.num_replans) != CLI_REPLANS
                        or not bool(torch.isfinite(xs).all())):
                    _fail(f"{what}: replans {int(state.num_replans)}")
                print(f"# {what}: {CLI_REPLANS} replans, all states finite; "
                      f"cold solve {stats['cold']['trips']} trips, trips per "
                      f"cycle {[c['trips'] for c in stats['cycles']]}, "
                      f"{_cycle_line(stats)}", flush=True)

    # (e) --batch on the one card.
    _, lines, secs, _ = _cli_run(("--batch", str(CLI_BATCH)), dev)
    out = json.loads(lines[-1])
    if not (out["batch"] == CLI_BATCH and out["num_converged"] > 0
            and np.isfinite(out["max_violation"])):
        _fail(f"cli --batch: {out}")
    print(f"# cli --batch {CLI_BATCH}: wall_s {out['wall_s']}, "
          f"{out['num_converged']} converged, max violation "
          f"{out['max_violation']}", flush=True)
    return kernels


def _zoo_cell(cell, problem, fused, dev):
    """One solve of ZOO_B instances of bench.py's draw (sigma 0.1) of a zoo
    game on the plain host-stepped driver (lane blocks of 128, 20 trips a
    dispatch, merit "xla"), its stages fused or not, the exec main's
    parameters with at most ZOO_ITERS iterations; launch counters reset
    just before. Returns (result, JSON fields, launches, spy)."""
    import dataclasses

    import torch

    from ilqgames_tpu_torch import bench
    from ilqgames_tpu_torch.solver import batched

    params = dataclasses.replace(bench.exec_main_params(),
                                 max_solver_iters=ZOO_ITERS)
    solver = batched.make_host_batched_solver(
        problem.dynamics, problem.player_costs, problem.spec, params,
        warm_op=problem.initial_operating_point(),
        warm_strategy=problem.initial_strategy(), trips_per_call=20,
        batch_block=128, fuse_stages=fused)
    x0 = torch.tensor(bench.perturbed_x0(problem, ZOO_B), device=dev)
    bench.reset_launches()
    with _FirstLaunches() as spy:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        res = solver(x0)
        torch.cuda.synchronize(dev)
        elapsed = time.perf_counter() - t0
    launches = bench.launches()
    out = {"cell": cell, **bench.config_fields(res, ZOO_B, elapsed),
           "fuse_stages": fused, "max_solver_iters": ZOO_ITERS,
           **{k: solver.last_stats[k] for k in ("trips", "deep_rounds")},
           "launches": launches}
    print(json.dumps(out), flush=True)
    xs = res.op.xs
    if tuple(xs.shape) != (ZOO_B, problem.spec.num_time_steps,
                           problem.spec.xdim):
        _fail(f"{cell}: result shape {tuple(xs.shape)}")
    if not bool(torch.isfinite(xs[res.converged]).all()):
        _fail(f"{cell}: non-finite trajectory on a converged lane")
    finite = float(torch.isfinite(xs).flatten(1).all(1).float().mean())
    print(f"# {cell}: converged {out['converged']}, diverged_frac "
          f"{out['diverged_frac']}, mean_iters {out['mean_iters']}, cost_p50 "
          f"{out['cost_p50']}; {finite:.4f} of the lanes finite; "
          f"{elapsed:.3f} s, {out['trips']} trips", flush=True)
    return res, out, launches, spy


def phase17(dev):
    """The rest of the cost layer, on two games built from the flagship
    (`zoo_player_costs`; x = 16, 3 x 2, N = 100): (a) their libraries
    (built in phase 1: K1, K5 and K6 of the fused game with CT_ZOO, the
    unfused game's K2-K4 only, its dense-only constraints having no device
    form) and ptxas reports; (b) zoo_fused_256 (fused stages: K1 with the
    new sparse pieces) and zoo_unfused_256 (unfused: the convex
    proximities and the dense-only constraints in plain PyTorch; K1 never
    launched), each one timed solve, every (kernel, shape) it launched held
    against its plain version (each game's first K4 and the fused game's
    first K5 at full depth), K5 and K6 at the linesearch shapes (the
    unfused game's on its atoms, without the dense-only constraints); (c)
    two trips of 8 lanes of each on the card against the CPU (the fused
    game under every merit backend, the unfused one under "xla"),
    bitwise. Returns the kernels-line entries."""
    import dataclasses

    from ilqgames_tpu_torch import bench
    from ilqgames_tpu_torch.ops.cuda import sweep

    games = {fused: zoo_problem(fused) for fused in (True, False)}
    # (a) the libraries and their ptxas reports.
    for fused, g in games.items():
        bench.build_kernels(g.dynamics, g.spec, g.player_costs)
        libs = bench.kernel_libraries(g.dynamics, g.spec, g.player_costs)
        name = ZOO_GAMES[0 if fused else 1]
        if not fused:
            if [n for n, _ in libs] != ["lq", "sweep"]:
                _fail(f"{name}: libraries {libs}")
            continue
        if not all(d.get("CT_ZOO") == 1 for n, d in libs
                   if n in ("stage", "merit")) or libs[-1][1].get(
                       "CT_ZOO") != 1:
            _fail(f"{name}: K1, K5 or K6 built without CT_ZOO: {libs}")
        for label, lib, kern, stack_ok in (
                ("K1", libs[0], "stage_kernel", True),
                ("K6", libs[2], "merit_kernel", False),
                ("K5", libs[-1], "rollout_merit_warp_kernel", True)):
            _ptxas(f"{label} ({name})", lib, kern, stack_ok)

    kernels = []
    for fused, g in games.items():
        cell = f"{ZOO_GAMES[0 if fused else 1]}_{ZOO_B}"
        _, out, launches, spy = _zoo_cell(cell, g, fused, dev)
        if fused and launches["K1"] <= 0:
            _fail(f"{cell}: K1 was not launched: {launches}")
        if not fused and launches["K1"] != 0:
            _fail(f"{cell}: K1 launched on an unfused game: {launches}")
        if min(launches[k] for k in ("K2", "K3", "K4")) <= 0:
            _fail(f"{cell}: a kernel of the path was not launched: "
                  f"{launches}")
        _check_k4_held(cell, spy, sweep.rollout_bm.by_shape)
        kernels += _hold_launches(cell, spy, launches)
        if fused:
            kernels += _hold_merits(cell, spy, g)
        else:
            atoms = dataclasses.replace(g, player_costs=tuple(
                dataclasses.replace(p, state_constraints=tuple(
                    c for c in p.state_constraints
                    if c.al_quad_pairs_fn is not None))
                for p in g.player_costs))
            kernels += _hold_merits(f"{cell}'s atoms", spy, atoms,
                                    full=False)

    # (c) trips on the card against the CPU.
    kernels += _trips_card_vs_cpu(ZOO_GAMES[0], ("zoo", True), "small",
                                  True, dev)
    kernels += _trips_card_vs_cpu(ZOO_GAMES[1], ("zoo", False), "small",
                                  False, dev, backends=("xla",))
    return kernels


def _cpu_jobs(phases=None):
    """The CPU side of every card-vs-CPU check of `phases` (all of them if
    None): phase 3's two, phase 16's two CLI runs (minutes each: they take
    two of the workers from then on), then the others in the order that
    the phases ask for them."""
    jobs = [(3, _cpu_flagship_trips, False), (3, _cpu_flagship_trips, True),
            (16, _cpu_cli, CLI_HELD_MI), (16, _cpu_cli, CLI_HELD_RH),
            (7, _cpu_replanning, ("example", "three_player_intersection"),
             0.1)]
    jobs += [(8, _cpu_trips, ("config", c), c, True) for c in (1, 2)]
    jobs += [(9, _cpu_trips, ("config", 4), 4, False),
             (10, _cpu_trips, ("config", 5), 5, True),
             (10, _cpu_trips, ("config", 5), 5, False),
             (10, _cpu_replanning, ("config", 5), 0.25),
             (11, _cpu_trips, ("config", "dubins_ol"), "dubins_ol", False),
             (11, _cpu_trips, ("config", "dubins_fb"), "dubins_fb", True),
             (12, _cpu_trips, ("config", "roundabout"), "roundabout", True),
             (12, _cpu_trips, ("example", DRIVING_GAMES[2]), "small", True),
             (13, _cpu_trips, ("example", REACH_GAMES[0]), "small", True),
             (13, _cpu_trips, ("config", "collision_reach"),
              "collision_reach", True),
             (13, _cpu_trips, ("example", REACH_GAMES[2]), "small", True),
             (14, _cpu_trips, ("example", COUPLED_GAMES[0]), "small", True),
             (14, _cpu_trips, ("config", "air3d"), "air3d", True),
             (15, _cpu_golden, "flat_overtaking"),
             (15, _cpu_trips, ("example", FLAT_GAMES[0]), "small", True),
             (15, _cpu_trips, ("config", "flat_roundabout"),
              "flat_roundabout", True),
             (17, _cpu_trips, ("zoo", True), "small", True),
             (17, _cpu_trips, ("zoo", False), "small", False)]
    return [tuple(job) for n, *job in jobs if phases is None or n in phases]


def phase2(problem, dev):
    """Each kernel against its plain version on the card, on operands from
    a real flagship stage, at the main path's shapes (see the module's
    docstring). Returns the kernels-line entries (their launches are set
    once phases 3 and 5 have run the main path)."""
    import torch

    from ilqgames_tpu_torch import bench
    from ilqgames_tpu_torch.dynamics import base as dyn_base
    from ilqgames_tpu_torch.ops.cuda import lq, stage, sweep
    from ilqgames_tpu_torch.solver import batched
    from ilqgames_tpu_torch.solver.al import constraint_violations

    spec = problem.spec
    dyn, costs = problem.dynamics, problem.player_costs
    B = 1024
    params = bench.exec_main_params()
    x0 = torch.tensor(bench.perturbed_x0(problem, B), device=dev)

    def carry0(x, fuse):
        return batched._fresh_init(dyn, costs, spec, None, None, 128,
                                   fuse)(x)

    c0 = carry0(x0, False).c
    lin = dyn_base.linearize(dyn, spec, c0.op)
    ops = lq.lq_operands(spec, lin, c0.quad)
    kernels = []

    def entry(*args):
        kernels.append(_entry(*args))

    def timed(fn, reps=20):
        """fn's ms per call (`_time_ms`), now or later (`_timed`)."""
        return _timed(functools.partial(_time_ms, fn, reps))

    _ptxas("K2", lq.library(spec), "lq_backward_kernel")
    Ps_k, al_k = lq.lq_backward(spec, ops)
    (Ps_p, al_p), plain_ms, n_ops = _plain_run(lq.lq_backward_plain, spec,
                                                ops)
    err = max(_compare("K2 Ps", Ps_k, Ps_p, TOL["K2"]),
              _compare("K2 alphas", al_k, al_p, TOL["K2"]))
    entry("K2 lq_backward (B=1024)", "ilqgames_tpu_torch/csrc/lq.cu",
          "ilqgames_tpu/ops/pallas/lq.py:82", err,
          timed(lambda: lq.lq_backward(spec, ops), 10),
          plain_ms,
          # Knot N-1 of A, Bf, Rf and rf is never read: it is the
          # terminal condition, Qf and lf only.
          _nbytes({k: ops[k] for k in ("Qf", "lf")},
                  {k: ops[k][:-1] for k in ("A", "Bf", "Rf", "rf")}, Ps_k,
                  al_k), n_ops)

    k3_ptxas = _ptxas("K3", lq.library(spec), "lq_forward_kernel")

    def k3_row(Bk, A, Bf, al, dx0):
        """K3 against its plain version at Bk lanes, and its entry."""
        args = (spec, A, Bf, al, dx0)
        dxs_k = lq.lq_forward(*args)
        dxs_p, plain_ms, n_ops = _plain_run(lq.lq_forward_plain, *args)
        err = _compare(f"K3 dxs B={Bk}", dxs_k, dxs_p, TOL["K3"])
        ms = timed(lambda: lq.lq_forward(*args))
        _print_later(functools.partial(_kernel_line, f"K3 B={Bk}", ms,
                                       spec.num_time_steps - 1, k3_ptxas))
        entry(f"K3 lq_forward (B={Bk})", "ilqgames_tpu_torch/csrc/lq.cu",
              "ilqgames_tpu/ops/pallas/lq.py:254", err, ms,
              plain_ms,
              # knots 0 .. N-2 of A and Bf make dx_1 .. dx_{N-1}
              _nbytes(A[:-1], Bf[:-1], al, dx0, dxs_k), n_ops)

    k3_row(B, ops["A"], ops["Bf"], al_k,
           (x0 - c0.op.xs[:, 0]).T.contiguous())

    # K4 where the main path launches it: C=1, B=2048 with emit_us (phase
    # 1 of the linesearch and the reroll), C=8, B=128 (the deep rounds),
    # and C=1, B=1024 (earlier PRs' row), on the first rollout of bench's
    # draw at B=2048 and the LQ strategy there (lanes beyond 8192 rad
    # included).
    B1 = 2048
    x1 = torch.tensor(bench.perturbed_x0(problem, B1), device=dev)
    cw = carry0(x1, False).c
    sol = lq.solve_lq_feedback(spec, dyn_base.linearize(dyn, spec, cw.op),
                               cw.quad, x1 - cw.op.xs[:, 0])
    op_bm, st_bm, x0m = sweep._prep_common(spec, x1, cw.op, sol.strategy, 1)
    k4_ptxas = _ptxas("K4", sweep.library(dyn, spec), "rollout_warp_kernel")
    for C, Bk, emit in ((1, B1, True), (8, 128, False), (1, B, False)):
        scal = (0.1 * 0.5 ** torch.arange(1, C + 1, dtype=torch.float32,
                                          device=dev))[:, None]
        sub = lambda d: {k: v[..., :Bk].contiguous() for k, v in d.items()}
        args = (dyn, spec, x0m[:, :Bk].contiguous(), sub(op_bm), sub(st_bm),
                scal.expand(C, Bk).contiguous())
        shape = f"C={C}, B={Bk}" + (", emit_us" if emit else "")
        got = _outputs(sweep.rollout_bm(*args, emit_us=emit))
        want, plain_ms, n_ops = _plain_run(sweep.rollout_plain, *args,
                                           emit_us=emit)
        want = _outputs(want)
        names = ("xs", "us")
        err = max(_compare(f"K4 {nm} {shape}", g, w, TOL["K4"])
                  for nm, (_, g), (_, w) in zip(names, got, want))
        ms_k4 = timed(functools.partial(sweep.rollout_bm, *args,
                                        emit_us=emit))
        N = spec.num_time_steps
        _print_later(functools.partial(_kernel_line, f"K4 {shape}", ms_k4, N,
                                       k4_ptxas))
        entry(f"K4 rollout ({shape})", "ilqgames_tpu_torch/csrc/sweep.cu",
              "ilqgames_tpu/ops/pallas/sweep.py:176", err, ms_k4,
              plain_ms, _nbytes(args[2], _read(args[3]), args[4:],
                      [g for _, g in got]), n_ops)

    # K1 at B=2048, on the first rollout of bench's draw with the
    # multipliers and mu of one AL update.
    c1 = carry0(x1, True)
    al1, _ = constraint_violations(costs, spec, c1.c.op, c1.al)
    al1 = al1.replace(mu=al1.mu * params.geometric_mu_scaling)
    op1, x1m = sweep._prep_op(spec, x1, c1.c.op, 1)
    lamS, lamC, mu1, _ = sweep._prep_al(spec, al1, None, 1)
    k1_args = (dyn, costs, spec, op1, lamS, lamC, mu1)
    ops_k = stage.lin_quad(*k1_args)
    ops_p, plain_ms, n_ops = _plain_run(stage.lin_quad_plain, *k1_args)
    err = max(_compare(f"K1 {name}", ops_k[name], ops_p[name], TOL["K1"])
              for name in ops_p)
    entry(f"K1 lin_quad (B={B1})", "ilqgames_tpu_torch/csrc/stage.cu",
          "ilqgames_tpu/ops/pallas/stage.py:65", err,
          timed(lambda: stage.lin_quad(*k1_args)),
          plain_ms,
          _nbytes(op1, k1_args[4:], ops_k), n_ops)

    # K3 at the queue's lanes (B=2048) on K1's operands and K2's alphas
    # there; then K5 and K6 on that LQ strategy.
    Ps_r, al_r = lq.lq_backward(spec, ops_k)
    k3_row(B1, ops_k["A"], ops_k["Bf"], al_r,
           (x1m - op1["xs"][0]).contiguous())
    k5_ptxas = _ptxas("K5", sweep.library(dyn, spec),
                      "rollout_merit_warp_kernel")
    k6_ptxas = _ptxas("K6", sweep.merit_library(spec), "merit_kernel")
    zero = lambda a: a.new_zeros((1,) + a.shape[1:])
    st1 = {"Ps": torch.cat([Ps_r, zero(Ps_r)]),
           "alphas": torch.cat([al_r, zero(al_r)])}
    for C, Bk in ((1, B1), (8, 128)):
        scal = (0.1 * 0.5 ** torch.arange(C, dtype=torch.float32,
                                          device=dev))[:, None]
        sub = lambda d: {k: v[..., :Bk].contiguous() for k, v in d.items()}
        scal_cb = scal.expand(C, Bk).contiguous()
        lam_k, mu_k = lamS[..., :Bk].contiguous(), mu1[..., :Bk].contiguous()
        k5_args = (dyn, costs, spec, x1m[:, :Bk].contiguous(), sub(op1),
                   sub(st1), scal_cb, lam_k, None, mu_k)
        m5_k = sweep.rollout_merits(*k5_args)
        m5_p, plain_ms, n_ops = _plain_run(sweep.rollout_merits_plain,
                                           *k5_args)
        err = _compare(f"K5 merits C={C} B={Bk}", m5_k, m5_p, TOL["K5"])
        ms_k5 = timed(functools.partial(sweep.rollout_merits, *k5_args))
        _print_later(functools.partial(_kernel_line, f"K5 C={C}, B={Bk}",
                                       ms_k5, N, k5_ptxas))
        entry(f"K5 rollout+merit (C={C}, B={Bk})",
              "ilqgames_tpu_torch/csrc/sweep.cu",
              "ilqgames_tpu/ops/pallas/sweep.py:176", err, ms_k5,
              plain_ms,
              _nbytes(k5_args[3], k5_args[4], k5_args[5:], m5_k),
              n_ops)
        xs_c = sweep.rollout_bm(dyn, spec, x1m[:, :Bk].contiguous(), sub(op1),
                                sub(st1), scal_cb)
        us_c = sweep._us_from_xs(spec, xs_c, sub(op1), sub(st1), scal_cb)
        k6_args = (costs, spec, xs_c, us_c, sub(op1)["t0"], lam_k, None,
                   mu_k)
        m6_k = sweep.consumer_merits(*k6_args)
        m6_p, plain_ms, n_ops = _plain_run(sweep.merit_plain, *k6_args)
        err = _compare(f"K6 merits C={C} B={Bk}", m6_k, m6_p, TOL["K6"])
        k6 = functools.partial(sweep.consumer_merits, *k6_args)
        ms_k6 = timed(k6)
        graph_ms = _timed(functools.partial(_graph_ms, k6, 20))
        _print_later(functools.partial(_kernel_line, f"K6 C={C}, B={Bk}",
                                       ms_k6, N, k6_ptxas, graph_ms))
        entry(f"K6 merit consumer (C={C}, B={Bk})",
              "ilqgames_tpu_torch/csrc/merit.cu",
              "ilqgames_tpu/ops/pallas/sweep.py:395", err, ms_k6,
              plain_ms,
              _nbytes(k6_args[2:], m6_k), n_ops)
        same = _same_bits(m5_k, m6_k)
        print(f"# K5 == K4 + K6 bitwise (C={C}, B={Bk}): {same}", flush=True)
        if not same:
            _fail(f"K5 and K4 + K6 disagree at C={C}, B={Bk}")
    return kernels


def _phase_line(n, t_start, t0, who="") -> None:
    """Print when phase n ended (seconds since `t_start`, the script's
    start of phase 1, on the wall clock that both processes read), how
    long it took since t0 and how much of that it waited for the other
    process's runs alone."""
    _pause()
    now = time.time()
    waited = _WAITED["total"] - _WAITED["mark"]
    _WAITED["mark"] = _WAITED["total"]
    print(f"# phase {n} ended at {now - t_start:.1f} s, took "
          f"{now - t0:.1f} s{who}, {waited:.1f} s of it waiting for the "
          "other process's runs alone", flush=True)


def _second(conn, out_path, t_start, locks):
    """The second process (`_start_second`): SECOND_PHASES on the card,
    their CPU jobs in SECOND_WORKERS workers, its lines into `out_path`;
    `locks` (alone, its busy, the script's busy) make its `_Pair`. When
    its phases have ended it says "done", and once told the card is its
    alone it times its kernels (`_time_later`) and sends {phase:
    kernels-line entries}."""
    import multiprocessing
    import signal

    import torch

    from ilqgames_tpu_torch import bench

    signal.signal(signal.SIGTERM, lambda *_: (_stop_children(), os._exit(1)))
    sys.stdout = open(out_path, "w", buffering=1)
    parent = multiprocessing.parent_process()
    _PAIR[0] = _Pair(*locks, parent.is_alive)
    _PAIR[0]._take(locks[1])
    bench.set_precision()
    dev = torch.device("cuda")
    _start_cpu_jobs(_cpu_jobs(SECOND_PHASES), SECOND_WORKERS)
    _LATER["defer"] = True
    run = {11: phase11, 12: phase12, 13: phase13, 14: phase14, 15: phase15,
           17: phase17}
    out = {}
    for n in SECOND_PHASES:
        t0 = time.time()
        out[n] = run[n](dev)
        _phase_line(n, t_start, t0, " (second process)")
    _pair_done()
    _stop_cpu_jobs()
    conn.send("done")
    conn.recv()
    t0 = time.time()
    _time_later([e for es in out.values() for e in es])
    print(f"# second process: its kernels timed with the card alone in "
          f"{time.time() - t0:.1f} s", flush=True)
    conn.send(out)


def _start_second(t_start):
    """Start `_second` (spawned: it reaches the card on its own), make this
    process's `_Pair` with it, and return the script's end of their
    pipe."""
    import multiprocessing
    import tempfile

    ctx = multiprocessing.get_context("spawn")
    conn, child = ctx.Pipe()
    fd, out_path = tempfile.mkstemp(prefix="chip_smoke_second_",
                                    suffix=".log")
    os.close(fd)
    alone, busy, other = ctx.Lock(), ctx.Lock(), ctx.Lock()
    busy.acquire()
    _SECOND["proc"] = ctx.Process(target=_second, args=(
        child, out_path, t_start, (alone, other, busy)))
    _SECOND["proc"].start()
    child.close()
    _SECOND["out"] = out_path
    _PAIR[0] = _Pair(alone, busy, other, _SECOND["proc"].is_alive)
    return conn


def _join_second(conn) -> dict:
    """Wait for the second process's phases, let it time its holds' kernels
    with the card alone, print its lines and return its {phase:
    kernels-line entries}; fail if it failed."""
    proc, out_path = _SECOND["proc"], _SECOND["out"]
    try:
        conn.recv()
        conn.send("time")
        out = conn.recv()
    except (EOFError, OSError):
        out = None
    proc.join()
    _SECOND["proc"] = None
    with open(out_path) as f:
        sys.stdout.write(f.read())
    sys.stdout.flush()
    os.remove(out_path)
    if out is None or proc.exitcode != 0:
        _fail(f"the second process (phases {SECOND_PHASES}) failed: exit "
              f"code {proc.exitcode}")
    return out


def main():
    t_main = time.time()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; nothing was run",
              file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ilqgames_tpu_torch import bench
    from ilqgames_tpu_torch.dynamics import base as dyn_base
    from ilqgames_tpu_torch.examples.three_player_intersection import \
        make_problem
    from ilqgames_tpu_torch.ops.cuda import build, lq, probes, stage, sweep
    from ilqgames_tpu_torch.solver import batched
    from ilqgames_tpu_torch.solver.al import constraint_violations
    from ilqgames_tpu_torch.types import tree_map

    dev = torch.device("cuda")
    bench.set_precision()
    card = _card_line()
    print(f"# card: {card}", flush=True)

    t_start = time.time()
    ends = [t_start]

    def elapsed(n):
        """Print when phase n ended and how long it took."""
        ends.append(time.time())
        _phase_line(n, t_start, ends[-2])

    # ---- phase 1: build ----
    problem = make_problem()
    spec = problem.spec
    dyn, costs = problem.dynamics, problem.player_costs
    t0 = time.perf_counter()
    # Phase 16's two CLI runs on the CPU take minutes each (one thread
    # each): they start before the build, the other CPU jobs after it.
    own = _cpu_jobs(set(range(18)) - set(SECOND_PHASES))
    _start_cpu_jobs([j for j in own if j[0] is _cpu_cli], CPU_WORKERS)
    later = _later_libraries()
    build.compile_all([stage.library(spec), lq.library(spec),
                       sweep.library(dyn, spec), sweep.merit_library(spec),
                       probes.library(spec)] + later)
    bench.build_kernels(dyn, spec)
    probes.load_kernels(spec)
    print(f"# build: {time.perf_counter() - t0:.1f} s (concurrent nvcc: "
          f"csrc/stage.cu, lq.cu, sweep.cu, merit.cu, probes.cu at the "
          f"flagship's dims and {len(later)} libraries of phases 8-17)",
          flush=True)
    _start_cpu_jobs([j for j in own if j[0] is not _cpu_cli], CPU_WORKERS)
    conn = _start_second(t_start)
    _LATER["defer"] = True
    elapsed(1)

    # ---- phase 2: each kernel against its plain version ----
    kernels = phase2(problem, dev)
    B = 1024
    params = bench.exec_main_params()

    def carry0(x, fuse):
        return batched._fresh_init(dyn, costs, spec, None, None, 128,
                                   fuse)(x)

    elapsed(2)

    # ---- phase 3: trips on the card against trips on the CPU ----
    Bt = FLAGSHIP_TRIP_B
    x0g = torch.tensor(bench.perturbed_x0(problem, Bt)).to(dev)
    for fuse in (False, True):
        trip, _ = batched._driver_parts(dyn, costs, spec, params, 128, fuse)
        cpu = _cpu_job(_cpu_flagship_trips, fuse)
        fc_gpu = tree_map(lambda a: a.to(dev), cpu[0])
        for i in range(CPU_TRIPS):
            fc_cpu = cpu[i + 1]
            fc_gpu = trip(x0g, fc_gpu)
            _same_decisions(f"fuse_stages={fuse} trip {i}, card vs CPU",
                            fc_gpu, fc_cpu)
            for name, g, c in (("last_merit", fc_gpu.c.last_merit,
                                fc_cpu.c.last_merit),
                               ("op.xs", fc_gpu.c.op.xs, fc_cpu.c.op.xs)):
                g = g.cpu()
                if not torch.allclose(g, c, rtol=TRIP_TOL, atol=TRIP_TOL,
                                      equal_nan=True):
                    bad = ~torch.isclose(g, c, rtol=TRIP_TOL, atol=TRIP_TOL,
                                         equal_nan=True)
                    _fail(f"fuse_stages={fuse} trip {i}: {name} differs "
                          f"card vs CPU beyond {TRIP_TOL:g} on "
                          f"{int(bad.sum())} entries: card "
                          f"{g[bad][:4].tolist()} CPU {c[bad][:4].tolist()}")
            same = torch.equal(fc_gpu.c.op.xs.cpu().nan_to_num(),
                               fc_cpu.c.op.xs.nan_to_num())
            print(f"# fuse_stages={fuse} trip {i}: decisions equal card vs "
                  f"CPU on all {Bt} lanes; merits and xs within "
                  f"{TRIP_TOL:g} (xs bitwise equal: {same}); failed "
                  f"{int(fc_cpu.c.failed.sum())}", flush=True)

    # The in-kernel (K5) and consumer (K6) merit backends on the card
    # against the plain fold, six fused trips each.
    backend_launches = {}
    runs = {}
    for backend in ("xla", "kernel", "pallas"):
        trip, _ = batched._driver_parts(dyn, costs, spec, params, 128, True,
                                        backend)
        fc = carry0(x0g, True)
        bench.reset_launches()
        for _ in range(6):
            fc = trip(x0g, fc)
        torch.cuda.synchronize()
        backend_launches[backend] = bench.launches()
        runs[backend] = fc
    for backend, kname in (("kernel", "K5"), ("pallas", "K6")):
        fc, ref = runs[backend], runs["xla"]
        _same_decisions(f"merit_backend={backend!r} vs 'xla'", fc, ref)
        if not _same_bits(fc.c.last_merit, ref.c.last_merit):
            _fail(f"merit_backend={backend!r}: merits differ from 'xla'")
        n = backend_launches[backend][kname]
        print(f"# merit_backend={backend!r}: six fused trips on the card, "
              f"decisions and merits bitwise equal to 'xla'; {kname} "
              f"launched {n} times", flush=True)
        if n <= 0:
            _fail(f"merit_backend={backend!r} never launched {kname}")

    elapsed(3)

    # ---- phase 4: the plain driver at B=1024, unfused stages ----
    bench.reset_launches()
    with _alone():
        res, out = bench.run_bench(B, dev, driver="plain",
                                   fuse_stages=False)
    launches = bench.launches()
    print(json.dumps(out), flush=True)
    N, X = spec.num_time_steps, spec.xdim
    _check_outcome("plain B=1024", res, out, (B, N, X), launches,
                   ("K2", "K3", "K4"), JAX_COST_P50)

    elapsed(4)

    # ---- phase 5: the bench's queue path, QUEUE_TOTAL through 2048 ----
    bench.reset_launches()
    with _alone():
        t0 = time.perf_counter()
        res, out = bench.run_bench(2048, dev, driver="queue",
                                   total=QUEUE_TOTAL, harvest_block=32,
                                   trips_per_call=10, fuse_stages=True)
    launches = bench.launches()
    print(f"# queue: {out['dispatches']} dispatches, {out['harvests']} "
          f"harvests, {out['compactions']} compactions, {out['trips']} "
          f"trips, {out['host_syncs']} host syncs "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    print(json.dumps(out), flush=True)
    print("# queue: K4 launches by (C, B, emit_us): " + json.dumps(
        [[*key, n] for key, n in sorted(sweep.rollout_bm.by_shape.items())]),
        flush=True)
    _check_outcome(f"queue {QUEUE_TOTAL}/2048", res, out,
                   (QUEUE_TOTAL, N, X), launches,
                   ("K1", "K2", "K3", "K4"), JAX_QUEUE_COST_P50)
    for k in kernels:
        name = k["name"][:2]
        k["launches"] = (backend_launches["kernel"][name] if name == "K5"
                         else backend_launches["pallas"][name]
                         if name == "K6" else launches[name])

    elapsed(5)

    # ---- phases 7-10 and 16 here, 11-15 and 17 in the second process ----
    entries = {2: kernels}
    for n, run in ((7, functools.partial(phase7, problem)), (8, phase8),
                   (9, phase9), (10, phase10), (16, phase16)):
        entries[n] = run(dev)
        elapsed(n)
    _pair_done()
    entries.update(_join_second(conn))
    _time_later([e for es in entries.values() for e in es])
    ends.append(time.time())
    print(f"# at {ends[-1] - t_start:.1f} s: the second process's phases "
          "joined, every kernel timed with the card alone", flush=True)

    # ---- phase 6: the probes, with the card alone ----
    entries[6] = phase6(dyn, spec, dev)
    elapsed(6)
    _stop_cpu_jobs()
    kernels = [e for n in sorted(entries) for e in entries[n]]

    print(f"# total: {time.time() - t_main:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
