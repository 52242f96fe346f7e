"""Benchmark of the port: batched three-player-intersection solves per
second on one CUDA device (counterpart of the repo's bench.py with
BENCH_QUEUE=0, the plain host-stepped driver).

Same workload as bench.py: the flagship, the reference exec main's
solver parameters, bench.py's x0 draw (nominal x0 + 0.1 * N(0, 1) from
numpy RandomState(0), prefix-stable in the batch size) and its baseline
denominator (baselines/measured.json "perturbed_x0_batch"). Prints ONE
JSON line with bench.py's fields plus the device, batch, wall time and
the driver's counters. Needs a CUDA device: it never measures on a CPU.

    BENCH_BATCH=1024 python3 -m ilqgames_tpu_torch.bench
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from ilqgames_tpu_torch.examples.three_player_intersection import \
    make_problem
from ilqgames_tpu_torch.ops.cuda import lq, sweep
from ilqgames_tpu_torch.solver import batched
from ilqgames_tpu_torch.solver.params import SolverParams

_BASELINE = Path(__file__).resolve().parents[1] / "baselines" / "measured.json"


def set_precision() -> None:
    """Full float32 everywhere: the JAX package forces f32 matmul
    precision, so the port allows no TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def exec_main_params() -> SolverParams:
    """The reference exec main's parameters (bench.py:83-90)."""
    return SolverParams(max_solver_iters=100,
                        unconstrained_solver_max_iters=10,
                        max_backtracking_steps=100, initial_alpha_scaling=0.1,
                        convergence_tolerance=1.0,
                        expected_decrease_fraction=0.001)


def perturbed_x0(problem, batch: int) -> np.ndarray:
    """bench.py's x0 draw: [batch, xdim] float32."""
    rng = np.random.RandomState(0)
    x0 = np.tile(problem.x0.numpy()[None], (batch, 1))
    x0 += 0.1 * rng.randn(*x0.shape).astype(np.float32)
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


def run_bench(batch: int = 1024, device="cuda"):
    """Solve the flagship batch once on `device`: (ALResult, JSON dict).
    The kernels are built before the clock starts."""
    set_precision()
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("the benchmark measures on a CUDA device only")
    problem = make_problem()
    lq.load_kernels(problem.spec)
    sweep.load_kernels(problem.spec)
    solver = batched.make_host_batched_solver(
        problem.dynamics, problem.player_costs, problem.spec,
        exec_main_params())
    x0 = torch.tensor(perturbed_x0(problem, batch), device=dev)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    res = solver(x0)
    torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t0
    out = summarize(res, batch, elapsed)
    stats = solver.last_stats
    out.update(device=torch.cuda.get_device_name(dev), B=batch,
               wall_s=round(elapsed, 3), trips=stats["trips"],
               host_syncs=stats["host_syncs"],
               deep_rounds=stats["deep_rounds"],
               collapse_exits=stats["collapse_exits"])
    return res, out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("ilqgames_tpu_torch.bench needs a CUDA device")
    _, out = run_bench(int(os.environ.get("BENCH_BATCH", "1024")))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
