"""The trip profile's bookkeeping (tools/trip_profile.py) on made-up
profiler events: kernels by name, per-trip device ms, launches and busy
share."""

from types import SimpleNamespace

import pytest
import torch

from ilqgames_tpu_torch.tools import trip_profile


@pytest.mark.parametrize("name,kernel", [
    ("(anonymous namespace)::stage_kernel(float const*)", "K1"),
    ("lq_backward_kernel", "K2"), ("lq_forward_kernel", "K3"),
    ("(anonymous namespace)::rollout_warp_kernel(float const*, int)", "K4"),
    ("rollout_merit_warp_kernel", "K5"), ("merit_kernel", "K6"),
    ("void at::native::elementwise_kernel<128, 2>", "glue")])
def test_kernel_of(name, kernel):
    assert trip_profile.kernel_of(name) == kernel


def test_summarize():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    ev = lambda name, dev, us: SimpleNamespace(
        name=name, device_type=dev,
        time_range=SimpleNamespace(elapsed_us=lambda: us))
    events = ([ev("rollout_warp_kernel", cuda, 1000.0)] * 4
              + [ev("elementwise_kernel", cuda, 50.0)] * 10
              + [ev("cudaLaunchKernel", cpu, 3.0)] * 12
              + [ev("aten::add", cpu, 7.0)])
    out = trip_profile.summarize(events, n_trips=2, wall_s=0.02)
    assert out["wall_ms_per_trip"] == pytest.approx(10.0)
    assert out["device_ms"] == pytest.approx({"K4": 2.0, "glue": 0.25})
    assert out["launches"] == {"K4": 2.0, "glue": 5.0}
    assert out["device_ms_per_trip"] == pytest.approx(2.25)
    assert out["busy"] == pytest.approx(0.225)
    assert out["cudaLaunchKernel_per_trip"] == 6.0


def test_window_is_trips_of_the_queue_solver():
    """The window brackets exactly trips warm .. warm + traced - 1 of the
    queue solver's run (on the CPU at a small size), then ends the run and
    leaves the driver's parts as they were."""
    from ilqgames_tpu_torch import bench
    from ilqgames_tpu_torch.examples.three_player_intersection import \
        make_problem
    from ilqgames_tpu_torch.solver import batched

    problem = make_problem(num_time_steps=5)
    x0 = torch.tensor(bench.perturbed_x0(problem, 16))
    parts = batched._driver_parts
    calls = []
    trips = []

    def counting(*args, **kw):
        trip, finalize = parts(*args, **kw)

        def counted(*a):
            trips.append(len(calls))
            return trip(*a)

        return counted, finalize

    batched._driver_parts = counting
    try:
        s = trip_profile.window_seconds(
            problem, x0, bench.exec_main_params(), device_batch=8,
            harvest_block=4, trips_per_call=2, warm=3, traced=2,
            start=lambda: calls.append("start"),
            stop=lambda: calls.append("stop"))
    finally:
        batched._driver_parts = parts
    assert s > 0
    assert calls == ["start", "stop"]
    assert trips == [0, 0, 0, 1, 1]
