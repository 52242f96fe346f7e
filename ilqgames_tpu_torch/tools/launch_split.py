"""Where a port launch's time goes, on the card: P3 (`probes.smoke`,
o = x * 2 + 1) beside the one PyTorch call for the same function,
`torch.add(1, x, alpha=2)`, on profile_components' [128, 256] operand.

    python3 -m ilqgames_tpu_torch.tools.launch_split

For each of the two: device us per call (the kernel's time under
torch.profiler, over 20 calls), call us (host clock per call, 2000 calls
issued back to back, before the synchronize) and total us per call (the
same, after it). Then the host us of each step of P3's wrapper on its own,
each over 2000 repetitions: the operand checks, the output's allocation,
the cached library function, the current stream's raw handle, the data
pointers and the bare ctypes call of the C function (the launch
included); and of the steps the K1-K6 wrappers take in their place
(`build.check_operands`, `load_kernels`, a Stream object's handle). One
JSON line, with the card's name and power limit.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ilqgames_tpu_torch.examples.three_player_intersection import \
    make_problem
from ilqgames_tpu_torch.ops.cuda import build, probes
from ilqgames_tpu_torch.tools import _probe

SHAPE = (128, 256)
PROFILED, REPS = 20, 2000


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
    o = torch.empty_like(x)
    stream = probes._stream(dev)
    fn = probes._smoke_fn(spec)
    xp, op = x.data_ptr(), o.data_ptr()
    out["P3 wrapper steps, host us"] = {
        "dtype and contiguity": host_us(
            lambda: (x.dtype != torch.float32, x.is_contiguous())),
        "empty_like": host_us(lambda: torch.empty_like(x)),
        "library function (cached per game)": host_us(
            lambda: probes._smoke_fn(spec)),
        "raw stream handle": host_us(lambda: probes._stream(dev)),
        "data_ptr x2": host_us(lambda: (x.data_ptr(), o.data_ptr())),
        "ctypes call (launch included)": host_us(
            lambda: fn(xp, op, x.numel(), stream)),
    }
    # What the K1-K6 wrappers do instead, for the same steps.
    out["K wrappers' steps, host us"] = {
        "check_operands": host_us(
            lambda: build.check_operands([("x", x, tuple(x.shape))])),
        "load_kernels (lru_cache on the game)": host_us(
            lambda: probes.load_kernels(spec)),
        "current_stream(dev).cuda_stream": host_us(
            lambda: torch.cuda.current_stream(dev).cuda_stream),
    }
    torch.cuda.synchronize()
    out["card"] = _probe.card_line()
    _probe.emit(out)


if __name__ == "__main__":
    main()
