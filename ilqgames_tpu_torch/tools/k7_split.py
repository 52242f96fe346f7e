"""Where one warp's chain in K7 (csrc/lq_open_loop.cu, the open-loop LQ
sweep) spends its cycles, on the card.

    python3 -m ilqgames_tpu_torch.tools.k7_split

At dubins_origin's dims (x=6, 2 players x 1 control, N=100) on random
operands from a seed (SPD state and own control costs), for B = 1024 (the
dubins_ol_1024 cell's launches) and B = 8 (the golden run's): K7's ms per
call (the main path's build, CUDA events over REPS calls), then the build
with -DOL_STAMPS=1, which every warp runs with clock64() stamps between the
phases of its chain (its outputs held bitwise against the main build's).
Per phase, the cycles per knot of a warp (the mean over the warps, and the
largest), its share of the warp's whole run, and the warp's cycles over
the stamped launch's ms (the SM clock the run saw). The backward phases
are per backward knot, the forward's per forward knot. Since the column
assembly of Lambda folds W M and W m itself, their slot reads 0 and
"Lambda assembly" holds both. One JSON line per
B, with the card's name and power limit. Not a phase of chip_smoke.py.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ilqgames_tpu_torch.examples import dubins_origin
from ilqgames_tpu_torch.ops.cuda import build, lq_open_loop
from ilqgames_tpu_torch.tools import _probe

SHAPES = (1024, 8)
REPS = 20
SLOTS = ("R_ii solves", "W M and W m folds", "Lambda assembly",
         "Lambda LU", "cache store and staging", "value update",
         "forward: cache wait", "forward: folds and stores")


def operands(spec, B: int, seed: int, dev):
    """K2's operand dict and dx0 of a random LQ game of `spec`'s dims:
    SPD state and own control costs, cross control costs, on `dev`."""
    N, P, x, u = spec.num_time_steps, spec.num_players, spec.xdim, spec.umax
    rng = np.random.RandomState(seed)

    def spd(n):
        G = rng.randn(N, n, n, B)
        return (np.einsum("kabz,kcbz->kacz", G, G) / n
                + np.eye(n)[None, :, :, None])

    R = 0.1 * rng.randn(N, P, P, u, u, B)
    for i in range(P):
        R[:, i, i] = spd(u)
    f = lambda a: torch.tensor(np.ascontiguousarray(a, np.float32),
                               device=dev)
    ops = {"A": f(np.eye(x)[None, :, :, None]
                  + 0.1 * rng.randn(N, x, x, B)),
           "Bf": f(0.1 * rng.randn(N, x, P * u, B)),
           "Qf": f(np.concatenate([spd(x) for _ in range(P)], 1)),
           "lf": f(rng.randn(N, P * x, B)),
           "Rf": f(R.reshape(N, P * P * u, u, B)),
           "rf": f(rng.randn(N, P * P * u, B))}
    return ops, f(rng.randn(x, B))


def stamped(spec):
    """The C function of K7's build with -DOL_STAMPS=1."""
    name, defines = lq_open_loop.library(spec)
    lib = build.load(name, {**defines, "OL_STAMPS": 1})
    fn = lib.lq_open_loop_stamps
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


def split(spec, B: int, fn, dev) -> dict:
    ops, dx0 = operands(spec, B, B, dev)
    ms = _probe.time_ms(lambda: lq_open_loop.lq_open_loop(spec, ops, dx0),
                        REPS)
    want = lq_open_loop.lq_open_loop(spec, ops, dx0)
    nslot = len(SLOTS)
    stamps = torch.zeros(((B + 7) // 8, 8, nslot + 1), dtype=torch.int64,
                         device=dev)
    run = lambda: lq_open_loop._run(fn, spec, ops, dx0, stamps.data_ptr())
    ms_stamped = _probe.time_ms(run, REPS)
    got = run()
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
            raise RuntimeError("the stamped build differs from the main one")
    warps = stamps.reshape(-1, nslot + 1)[:B].double().cpu()
    knots = spec.num_time_steps - 1
    total = warps[:, nslot]
    per_knot = warps[:, :nslot] / knots
    return {
        "B": B, "ms": round(ms, 4), "ms_stamped": round(ms_stamped, 4),
        "warp_cycles": round(float(total.mean()), 1),
        "GHz": round(float(total.mean()) / (ms_stamped * 1e6), 3),
        "cycles_per_knot": {s: round(float(per_knot[:, i].mean()), 1)
                            for i, s in enumerate(SLOTS)},
        "max_cycles_per_knot": {s: round(float(per_knot[:, i].max()), 1)
                                for i, s in enumerate(SLOTS)},
        "share": {s: round(float((warps[:, i] / total).mean()), 4)
                  for i, s in enumerate(SLOTS)},
    }


def main():
    dev = _probe.require_cuda()
    spec = dubins_origin.make_problem().spec
    fn = stamped(spec)
    for B in SHAPES:
        _probe.emit({"probe": "k7_split", "dims": [spec.xdim,
                                                   spec.num_players,
                                                   spec.umax],
                     "N": spec.num_time_steps, **split(spec, B, fn, dev),
                     "card": _probe.card_line()})


if __name__ == "__main__":
    main()
