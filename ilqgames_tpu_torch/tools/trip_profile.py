"""Where a trip of the queue cell goes, on the card: trips 10-19 of the
bench's default run (8192 instances of bench.py's x0 draw through 2048
lanes on the wave-refill queue driver, harvest chunks of 32, `done` read
every 10 trips, fused stages, merit backend "xla", the reference exec
main's parameters).

    python3 -m ilqgames_tpu_torch.tools.trip_profile

The run starts twice from the beginning (the kernels are built before)
and stops after trip 19: once with the window timed on the host clock,
once with it under torch.profiler. The window holds the ten trips and
nothing else: the driver reads `done` and harvests after trip 9 and after
trip 19, outside it. Each window starts and ends in
torch.cuda.synchronize(). Prints one JSON line: wall ms per trip without
the profiler and with it, device ms per trip by kernel (K1-K6 by their
kernels' names, every other CUDA kernel as glue) with launches per trip,
the busy share (device ms over the wall ms without the profiler),
cudaLaunchKernel calls per trip, the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch

from ilqgames_tpu_torch import bench
from ilqgames_tpu_torch.examples.three_player_intersection import \
    make_problem
from ilqgames_tpu_torch.solver import batched

B, TOTAL, HARVEST, TPC = 2048, 8192, 32, 10
WARM, TRACED = 10, 10
# A CUDA kernel's name -> the port's kernel it belongs to (else "glue").
KERNEL_NAMES = (("stage_kernel", "K1"), ("lq_backward_kernel", "K2"),
                ("lq_forward_kernel", "K3"), ("rollout_warp_kernel", "K4"),
                ("rollout_merit_warp_kernel", "K5"), ("merit_kernel", "K6"))


def kernel_of(name: str) -> str:
    return next((k for n, k in KERNEL_NAMES if n in name), "glue")


def summarize(events, n_trips: int, wall_s: float) -> dict:
    """Per-trip device ms and launches by kernel, busy share and
    cudaLaunchKernel calls from a profiler's events (name, device type,
    time range)."""
    dev_us, count, host_launches = {}, {}, 0
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = kernel_of(e.name)
            dev_us[k] = dev_us.get(k, 0.0) + e.time_range.elapsed_us()
            count[k] = count.get(k, 0) + 1
        elif e.name == "cudaLaunchKernel":
            host_launches += 1
    wall_ms = wall_s * 1e3 / n_trips
    device_ms = sum(dev_us.values()) / 1e3 / n_trips
    return {"wall_ms_per_trip": wall_ms, "device_ms_per_trip": device_ms,
            "busy": device_ms / wall_ms,
            "device_ms": {k: v / 1e3 / n_trips
                          for k, v in sorted(dev_us.items())},
            "launches": {k: v / n_trips for k, v in sorted(count.items())},
            "cudaLaunchKernel_per_trip": host_launches / n_trips}


class _WindowEnded(Exception):
    pass


def window_seconds(problem, x0, params, *, device_batch, harvest_block,
                   trips_per_call, warm=WARM, traced=TRACED, start=None,
                   stop=None) -> float:
    """Run the queue solver on x0 from the start and stop it after trip
    warm + traced - 1: the host-clock seconds of trips warm .. warm +
    traced - 1. `start` and `stop` (if given) are called just inside the
    window's ends, each after a device synchronize."""
    sync = (torch.cuda.synchronize if x0.device.type == "cuda"
            else lambda: None)
    clock = {}

    def parts(*args, **kw):
        trip, finalize = make_parts(*args, **kw)
        n = iter(range(warm + traced))

        def windowed(x0_b, fc, stats=None):
            i = next(n)
            if i == warm:
                sync()
                if start:
                    start()
                clock["t0"] = time.perf_counter()
            out = trip(x0_b, fc, stats)
            if i == warm + traced - 1:
                sync()
                clock["s"] = time.perf_counter() - clock["t0"]
                if stop:
                    stop()
                raise _WindowEnded
            return out

        return windowed, finalize

    # The solver takes its trip from _driver_parts once, when it is made.
    make_parts = batched._driver_parts
    batched._driver_parts = parts
    try:
        solver = batched.make_host_batched_queue_solver(
            problem.dynamics, problem.player_costs, problem.spec, params,
            device_batch=device_batch, trips_per_call=trips_per_call,
            harvest_block=harvest_block, fuse_stages=True)
    finally:
        batched._driver_parts = make_parts
    try:
        solver(x0)
    except _WindowEnded:
        return clock["s"]
    raise RuntimeError(f"the run ended before trip {warm + traced - 1}")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("trip_profile needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    bench.set_precision()
    dev = torch.device("cuda")
    problem = make_problem()
    bench.build_kernels(problem.dynamics, problem.spec)
    x0 = torch.tensor(bench.perturbed_x0(problem, TOTAL), device=dev)
    run = lambda **kw: window_seconds(
        problem, x0, bench.exec_main_params(), device_batch=B,
        harvest_block=HARVEST, trips_per_call=TPC, **kw)
    wall = run()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    wall_profiled = run(start=prof.start, stop=prof.stop)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    out = {"probe": "trip_profile", "cell": f"queue {TOTAL}/{B}",
           "trips": f"{WARM}-{WARM + TRACED - 1}", "card": card,
           **summarize(prof.events(), TRACED, wall),
           "wall_ms_per_trip_profiled": wall_profiled * 1e3 / TRACED}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
