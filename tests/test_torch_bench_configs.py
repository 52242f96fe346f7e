"""The port's bench on bench_all.py's configs 1, 2, 4 and 5 without a card: the
x0 draw with the config's sigma equals bench_all.py's `_perturbed_x0` bit
for bit (run in its own process: importing bench_all.py configures the
JAX package's compilation cache), the fields of a batch, and the refusal
to measure on a CPU."""

import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from ilqgames_tpu_torch import bench

REPO = Path(__file__).resolve().parents[1]

_DRAW = """
import sys
import numpy as np
import bench_all
from ilqgames_tpu.examples import reachability, \
    three_player_flat_intersection, two_player_collision, \
    two_player_point_mass
for make, b, sigma in ((two_player_point_mass.make_problem, 1024, 0.5),
                       (two_player_collision.make_problem, 256, 0.1),
                       (three_player_flat_intersection.make_problem, 256,
                        0.1),
                       (reachability.make_three_player_collision_avoidance,
                        1000, 0.25)):
    x0 = np.asarray(bench_all._perturbed_x0(make(), b, sigma))
    sys.stdout.write(x0.astype(np.float32).tobytes().hex() + "\\n")
"""


def test_config_draws_are_bench_all_draws():
    out = subprocess.run([sys.executable, "-c", _DRAW], cwd=REPO,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()[-4:]
    for c, line in zip((1, 2, 4, 5), lines):
        cfg = bench.CONFIGS[c]
        problem = cfg["make"]()
        got = bench.perturbed_x0(problem, cfg["batch"], cfg["sigma"])
        want = np.frombuffer(bytes.fromhex(line), np.float32).reshape(
            got.shape)
        np.testing.assert_array_equal(got, want)
    # The default sigma is bench.py's.
    np.testing.assert_array_equal(
        bench.perturbed_x0(bench.CONFIGS[2]["make"](), 4),
        bench.perturbed_x0(bench.CONFIGS[2]["make"](), 4, 0.1))


def test_config_fields_show_violations_only_when_finite():
    """bench_all.py's fields: no viol_* for a game without constraints;
    overflowed costs count as diverged and sort last."""
    costs = np.full((4, 2), 10.0, np.float32)
    costs[3] = np.inf
    res = types.SimpleNamespace(
        total_costs=torch.tensor(costs),
        max_violation=torch.full((4,), -float("inf")),
        converged=torch.tensor([True, True, False, False]),
        cumulative_iterations=torch.tensor([2, 4, 40, 40]))
    out = bench.config_fields(res, 4, 0.5)
    assert out["converged"] == 0.5 and out["mean_iters"] == 21.5
    assert out["diverged_frac"] == 0.25 and out["overflowed_lanes"] == 1
    assert out["cost_p50"] == [10.0, 10.0]
    assert not any(k.startswith("viol") for k in out)


def test_run_config_refuses_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        bench.run_config(1, device="cpu")


def test_config4_mirrors_bench_all_and_its_r05_run():
    """CONFIGS[4] is bench_all.py's config4_flat_intersection (256
    instances, sigma 0.1, the exec main's parameters, its metric) with the
    unfused stages of the BENCH_ALL_r05 run (tools/bench_queue_r5i.sh:27,
    ILQ_FUSE_STAGES=0)."""
    src = (REPO / "bench_all.py").read_text()
    fn = src[src.index("def config4_flat_intersection"):
             src.index("def config5_receding_horizon_1k")]
    assert 'BENCH_BATCH_FLAT", "256"' in fn
    assert "sigma=0.1" in fn and "params = _exec_params()" in fn
    script = (REPO / "tools" / "bench_queue_r5i.sh").read_text()
    assert ("BENCH_CONFIGS=4 ILQ_FUSE_STAGES=0 BENCH_BATCH_FLAT=256"
            in script)
    cfg = bench.CONFIGS[4]
    assert f'metric="{cfg["metric"]}"' in fn
    assert (cfg["batch"], cfg["sigma"], cfg["params"], cfg["fuse_stages"]) \
        == (256, 0.1, {}, False)
    assert cfg["make"]().name == "three_player_flat_intersection"
    assert bench.CONFIGS[1]["fuse_stages"] and bench.CONFIGS[2]["fuse_stages"]


def test_config5_mirrors_bench_all():
    """CONFIGS[5] is bench_all.py's config5_receding_horizon_1k (1000
    agents drawn with sigma 0.25, the exec main's parameters with 20
    iterations and an inner budget of 10, final time 2 s, a replan every
    0.25 s, its metric, its baseline of 4 replans/s) on the JAX package's
    default, fused stages (the BENCH_ALL_r05 run took row 5 unfused,
    tools/bench_queue_r5i.sh:25); the bench refuses a CPU."""
    src = (REPO / "bench_all.py").read_text()
    fn = src[src.index("def config5_receding_horizon_1k"):
             src.index("def latency_single_solve")]
    cfg = bench.CONFIGS[5]
    assert 'BENCH_BATCH_RH", "1000"' in fn and "sigma=0.25" in fn
    assert 'RH_ITERS", "20"' in fn and "unconstrained_solver_max_iters=10" in fn
    assert 'RH_FINAL_TIME", "2.0"' in fn and "replan_interval=0.25" in fn
    assert f'metric="{cfg["metric"]}"' in fn and "rps / 4.0" in fn
    assert (cfg["batch"], cfg["sigma"], cfg["final_time"],
            cfg["replan_interval"], cfg["planner_time"]) == (
                1000, 0.25, 2.0, 0.25, 0.25)
    assert cfg["params"] == dict(max_solver_iters=20,
                                 unconstrained_solver_max_iters=10)
    assert cfg["fuse_stages"] and bench.REPLANS_BASELINE == 4.0
    assert "ILQ_FUSE_STAGES=0" in (REPO / "tools" /
                                   "bench_queue_r5i.sh").read_text()
    assert cfg["make"]().name == \
        "three_player_collision_avoidance_reachability"
    with pytest.raises(ValueError, match="CUDA"):
        bench.run_config(5, device="cpu")
