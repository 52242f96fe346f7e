"""The port's benchmark pieces that run without a card: bench.py's x0 draw,
the JSON summary of a batch, and the refusal to measure on a CPU."""

import types

import numpy as np
import pytest
import torch

from ilqgames_tpu_torch import bench
from ilqgames_tpu_torch.examples.three_player_intersection import \
    make_problem

torch.set_num_threads(1)


def test_perturbed_x0_is_bench_draw():
    """bench.py's draw: nominal x0 + 0.1 * randn from RandomState(0),
    prefix-stable in the batch size."""
    problem = make_problem(num_time_steps=11)
    x0 = bench.perturbed_x0(problem, 8)
    nominal = problem.x0.numpy()
    want = np.tile(nominal[None], (8, 1)) + 0.1 * np.random.RandomState(
        0).randn(8, nominal.shape[0]).astype(np.float32)
    assert x0.dtype == np.float32
    np.testing.assert_array_equal(x0, want)
    np.testing.assert_array_equal(bench.perturbed_x0(problem, 3), x0[:3])


def test_summarize_counts_overflowed_lanes_as_diverged():
    """A lane with NaN costs (its trajectory overflowed) is diverged and
    sorts last, so the medians stay finite."""
    costs = np.full((8, 3), 100.0, np.float32)
    costs[1] = 5e6
    costs[2] = np.nan
    res = types.SimpleNamespace(
        total_costs=torch.tensor(costs),
        max_violation=torch.tensor([0.1] * 7 + [float("nan")]))
    out = bench.summarize(res, 8, 2.0)
    assert out["value"] == 4.0
    assert out["diverged_frac"] == 0.25
    assert out["overflowed_lanes"] == 1
    assert out["cost_p50"] == [100.0, 100.0, 100.0]
    assert np.isfinite(out["viol_p50"])
    baseline, tail = bench.reference_baseline()
    assert out["vs_baseline"] == round(4.0 / baseline, 3)
    assert set(tail) <= set(out)


def test_run_bench_refuses_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        bench.run_bench(4, device="cpu")


def test_run_latency_refuses_cpu():
    """The warm-latency driver never measures on a CPU either."""
    with pytest.raises(ValueError, match="CUDA"):
        bench.run_bench(4, device="cpu", driver="latency")
