"""Where a port launch's time goes, on the card: P3 (`probes.smoke`,
o = x * 2 + 1) beside the one PyTorch call for the same function,
`torch.add(1, x, alpha=2)`, on profile_components' [128, 256] operand;
and K3's wrapper (`lq.lq_forward`) at the queue's lanes.

    python3 -m ilqgames_tpu_torch.tools.launch_split

For each of the two: device us per call (the kernel's time under
torch.profiler, over 20 calls), call us (host clock per call, 2000 calls
issued back to back, before the synchronize), total us per call (the
same, after it) and ms per call over 20 back-to-back calls on CUDA events
(chip_smoke.py's measure of P3; the two timed in turns, P3, add, add,
P3). Then the host us of each step of P3's wrapper on its own, each over
2000 repetitions: the operand checks, the output's allocation,
the cached library function, the current stream's raw handle, the data
pointers and the bare ctypes call of the C function (the launch
included); of the steps the K1-K6 wrappers take in their place
(`build.check_operands`, `load_kernels`); and of a Stream object's handle
(`torch.cuda.current_stream(dev).cuda_stream`), which `build.stream`
replaces in every wrapper.
Last, K3 at N=100, B=2048 on random operands: its call and total us per
call over K3_REPS calls, fewer than the launch queue holds, so that the
host clock reads the enqueue and not the device. One JSON line, with the
card's name and power limit.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ilqgames_tpu_torch.examples.three_player_intersection import \
    make_problem
from ilqgames_tpu_torch.ops.cuda import build, lq, probes
from ilqgames_tpu_torch.tools import _probe

SHAPE = (128, 256)
PROFILED, REPS = 20, 2000
SMOKE_REPS = 20         # chip_smoke.py times P3 over 20 calls
K3_B, K3_REPS = 2048, 200


def device_us(fn, kernel: str) -> float:
    """Device us per call of the CUDA kernels whose name holds `kernel`,
    over PROFILED calls under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    _probe._warm(fn)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and kernel in e.name]
    if len(us) != PROFILED:
        raise RuntimeError(f"{len(us)} {kernel!r} kernels traced, want "
                           f"{PROFILED}")
    return sum(us) / PROFILED


def host_us(fn) -> float:
    """Host us per call of fn over REPS calls."""
    fn()
    t0 = time.perf_counter()
    for _ in range(REPS):
        fn()
    return (time.perf_counter() - t0) * 1e6 / REPS


def k3_call_us(spec, dev) -> dict:
    """K3's call and total us per call at N=100, B=K3_B."""
    N, x = spec.num_time_steps, spec.xdim
    Pu = spec.num_players * spec.umax
    rng = np.random.RandomState(0)
    f = lambda *s: torch.tensor(0.1 * rng.randn(*s).astype(np.float32),
                                device=dev)
    A, Bf, al, dx0 = (f(N, x, x, K3_B), f(N, x, Pu, K3_B),
                      f(N - 1, Pu, K3_B), f(x, K3_B))
    call = lambda: lq.lq_forward(spec, A, Bf, al, dx0)
    if not torch.equal(call(), lq.lq_forward_plain(spec, A, Bf, al, dx0)):
        raise RuntimeError("K3 differs from lq_forward_plain")
    enq, tot = _probe.split_ms(call, K3_REPS)
    return {"call_us": enq * 1e3, "total_us": tot * 1e3}


def main():
    dev = _probe.require_cuda()
    spec = make_problem().spec
    x = torch.tensor(np.random.RandomState(0).randn(*SHAPE).astype(
        np.float32), device=dev)
    one = torch.ones((), device=dev)
    p3 = lambda: probes.smoke(spec, x)
    add = lambda: torch.add(one, x, alpha=2.0)
    if not torch.equal(p3(), probes.smoke_plain(x)):
        raise RuntimeError("P3 differs from smoke_plain")
    out = {"probe": "launch_split", "shape": list(SHAPE)}
    for name, fn, kernel in (("P3", p3, "smoke_kernel"),
                             ("torch.add", add, "")):
        enq, tot = _probe.split_ms(fn, REPS)
        out[name] = {"device_us": device_us(fn, kernel),
                     "call_us": enq * 1e3, "total_us": tot * 1e3}
    for name, fn in (("P3", p3), ("torch.add", add), ("torch.add", add),
                     ("P3", p3)):
        out[name].setdefault("ms_20_calls", []).append(
            _probe.time_ms(fn, SMOKE_REPS))
    o = torch.empty_like(x)
    stream = build.stream(dev)
    fn = probes._smoke_fn(spec)
    xp, op = x.data_ptr(), o.data_ptr()
    out["P3 wrapper steps, host us"] = {
        "dtype and contiguity": host_us(
            lambda: (x.dtype != torch.float32, x.is_contiguous())),
        "empty_like": host_us(lambda: torch.empty_like(x)),
        "library function (cached per game)": host_us(
            lambda: probes._smoke_fn(spec)),
        "raw stream handle": host_us(lambda: build.stream(dev)),
        "data_ptr x2": host_us(lambda: (x.data_ptr(), o.data_ptr())),
        "ctypes call (launch included)": host_us(
            lambda: fn(xp, op, x.numel(), stream)),
    }
    # The K1-K6 wrappers' own steps, and the Stream object's handle that
    # build.stream replaces.
    out["K wrappers' steps, host us"] = {
        "check_operands": host_us(
            lambda: build.check_operands([("x", x, tuple(x.shape))])),
        "load_kernels (lru_cache on the game)": host_us(
            lambda: probes.load_kernels(spec)),
        "current_stream(dev).cuda_stream": host_us(
            lambda: torch.cuda.current_stream(dev).cuda_stream),
    }
    out[f"K3 N={spec.num_time_steps} B={K3_B}, us per call"] = k3_call_us(
        spec, dev)
    torch.cuda.synchronize()
    out["card"] = _probe.card_line()
    _probe.emit(out)


if __name__ == "__main__":
    main()
