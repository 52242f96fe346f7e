#!/usr/bin/env python3
"""Smoke test of the PyTorch port (ilqgames_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ and drives its main path: the
flagship three-player intersection solved in a batch of perturbed x0 by
the batched AL + iLQ machine, through kernels K2 (LQ Riccati sweep), K3
(δx forward pass) and K4 (candidate rollout). Phases:

1. the card's name and power limit, and the kernels' build time;
2. each kernel against its plain PyTorch version on the card, on operands
   from a real flagship stage (the first rollout of bench.py's x0 draw),
   at the main path's shapes, with both times;
3. six trips of the machine on the card against six on the CPU (plain
   versions) from the same carry: decisions exactly equal;
4. the port's bench path at B=1024 with launch counters reset just
   before, and its outcome distribution against the JAX package's
   (BENCH_ALL_r05.jsonl row 3: same x0, same batch).

Prints the kernels' JSON line and the card line, then, last,
{"ok": true, "device": {...}}. Exits nonzero, with no result line, when
there is no CUDA device or any phase fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

# Tolerances, |kernel - plain| <= tol + tol * |plain|, those of the JAX
# package's kernel tests. Each kernel repeats its plain version's float32
# operations in the same order, without FMA contraction, so the two are
# expected to agree bit for bit; the script prints how many lanes do.
TOL = {"K2": 2e-4, "K3": 5e-4, "K4": 2e-4}
TRIP_TOL = 2e-3           # merits and trajectories, card vs CPU, per trip
DIVERGED_BAND = (0.02, 0.12)  # JAX: 0.0566 at B=1024 on this x0
JAX_COST_P50 = (3057.4, 855.7, 78.2)
COST_P50_REL = 0.15


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def _compare(name, got, ref, tol):
    """NaN-aware closeness over every lane: NaNs must sit in the same
    places (the JAX package gives the same NaN lanes on this draw), other
    entries equal or within tol. Returns the max abs error over the
    entries that differ."""
    import torch

    nan_g, nan_r = torch.isnan(got), torch.isnan(ref)
    if not torch.equal(nan_g, nan_r):
        _fail(f"{name}: NaN pattern differs from the plain version")
    diff = ~nan_r & (got != ref)
    err = (got - ref).abs()[diff]
    bound = tol + tol * ref.abs()[diff]
    max_abs = float(err.max()) if err.numel() else 0.0
    max_rel = float((err / ref.abs()[diff]).max()) if err.numel() else 0.0
    lanes_equal = int((~diff).flatten(0, -2).all(0).sum())
    print(f"# {name}: max_abs_err {max_abs:.3e} max_rel_err {max_rel:.3e} "
          f"(tol {tol:g}); {lanes_equal} of {got.shape[-1]} lanes bitwise "
          f"equal; NaN entries {int(nan_r.sum())}", flush=True)
    if not bool((err <= bound).all()):
        _fail(f"{name}: disagrees with its plain version beyond {tol:g}")
    return max_abs


def _time_ms(fn, reps):
    import torch

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


def main():
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
    from ilqgames_tpu_torch.ops.cuda import lq, sweep
    from ilqgames_tpu_torch.solver import batched
    from ilqgames_tpu_torch.types import tree_map

    dev = torch.device("cuda")
    bench.set_precision()
    card = _card_line()
    print(f"# card: {card}", flush=True)

    # ---- phase 1: build ----
    problem = make_problem()
    spec = problem.spec
    t0 = time.perf_counter()
    lq.load_kernels(spec)
    sweep.load_kernels(spec)
    print(f"# build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc, csrc/lq.cu + csrc/sweep.cu)", flush=True)

    # ---- phase 2: each kernel against its plain version ----
    B = 1024
    params = bench.exec_main_params()
    x0 = torch.tensor(bench.perturbed_x0(problem, B), device=dev)
    trip, _ = batched._driver_parts(problem.dynamics, problem.player_costs,
                                    spec, params, 128)

    def carry0(x):
        bc = lambda t: tree_map(lambda a: a.to(x.device)[None].expand(
            (x.shape[0],) + a.shape).contiguous(), t)
        return batched._carry0(
            problem.dynamics, problem.player_costs, spec, x,
            bc(problem.initial_operating_point()),
            bc(problem.initial_strategy()),
            batched.pcost.ALState.init(problem.player_costs, spec,
                                       x.shape[0], device=x.device), 128)

    c0 = carry0(x0).c
    lin = dyn_base.linearize(problem.dynamics, spec, c0.op)
    ops = lq.lq_operands(spec, lin, c0.quad)
    kernels = []

    def entry(name, source, replaces, err, ms, plain_ms):
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "max_abs_err": err,
                        "ms": round(ms, 4), "plain_ms": round(plain_ms, 4)})

    Ps_k, al_k = lq.lq_backward(spec, ops)
    Ps_p, al_p = lq.lq_backward_plain(spec, ops)
    err = max(_compare("K2 Ps", Ps_k, Ps_p, TOL["K2"]),
              _compare("K2 alphas", al_k, al_p, TOL["K2"]))
    entry("K2 lq_backward (B=1024)", "ilqgames_tpu_torch/csrc/lq.cu",
          "ilqgames_tpu/ops/pallas/lq.py:82", err,
          _time_ms(lambda: lq.lq_backward(spec, ops), 10),
          _time_ms(lambda: lq.lq_backward_plain(spec, ops), 2))

    dx0 = (x0 - c0.op.xs[:, 0]).T.contiguous()
    dxs_k = lq.lq_forward(spec, ops["A"], ops["Bf"], al_k, dx0)
    dxs_p = lq.lq_forward_plain(spec, ops["A"], ops["Bf"], al_k, dx0)
    entry("K3 lq_forward (B=1024)", "ilqgames_tpu_torch/csrc/lq.cu",
          "ilqgames_tpu/ops/pallas/lq.py:254",
          _compare("K3 dxs", dxs_k, dxs_p, TOL["K3"]),
          _time_ms(lambda: lq.lq_forward(spec, ops["A"], ops["Bf"], al_k,
                                         dx0), 20),
          _time_ms(lambda: lq.lq_forward_plain(spec, ops["A"], ops["Bf"],
                                               al_k, dx0), 3))

    sol = lq.solve_lq_feedback(spec, lin, c0.quad, x0 - c0.op.xs[:, 0])
    op_bm, st_bm, x0m = sweep._prep_common(spec, x0, c0.op, sol.strategy, 1)
    dyn = problem.dynamics
    for C, Bk in ((1, B), (8, 128)):
        scal = (0.1 * 0.5 ** torch.arange(1, C + 1, dtype=torch.float32,
                                          device=dev))[:, None]
        sub = lambda d: {k: v[..., :Bk].contiguous() for k, v in d.items()}
        args = (dyn, spec, x0m[:, :Bk].contiguous(), sub(op_bm), sub(st_bm),
                scal.expand(C, Bk).contiguous())
        xs_k = sweep.rollout_bm(*args)
        xs_p = sweep.rollout_plain(*args)
        entry(f"K4 rollout (C={C}, B={Bk})", "ilqgames_tpu_torch/csrc/sweep.cu",
              "ilqgames_tpu/ops/pallas/sweep.py:176",
              _compare(f"K4 xs C={C} B={Bk}", xs_k, xs_p, TOL["K4"]),
              _time_ms(lambda: sweep.rollout_bm(*args), 20),
              _time_ms(lambda: sweep.rollout_plain(*args), 3))

    # ---- phase 3: six trips on the card against six on the CPU ----
    Bt = 64
    x0c = torch.tensor(bench.perturbed_x0(problem, Bt))
    fc_cpu = carry0(x0c)
    fc_gpu = tree_map(lambda a: a.to(dev), fc_cpu)
    x0g = x0c.to(dev)
    for i in range(6):
        fc_cpu = trip(x0c, fc_cpu)
        fc_gpu = trip(x0g, fc_gpu)
        for name in ("failed", "converged"):
            g = getattr(fc_gpu.c, name).cpu()
            if not torch.equal(g, getattr(fc_cpu.c, name)):
                _fail(f"trip {i}: {name} differs card vs CPU on lanes "
                      f"{(g != getattr(fc_cpu.c, name)).nonzero().flatten().tolist()}")
        if not torch.equal(fc_gpu.done.cpu(), fc_cpu.done):
            _fail(f"trip {i}: done differs card vs CPU")
        if not torch.equal(fc_gpu.al.mu.cpu(), fc_cpu.al.mu):
            _fail(f"trip {i}: AL mu differs card vs CPU")
        for name, g, c in (("last_merit", fc_gpu.c.last_merit,
                            fc_cpu.c.last_merit),
                           ("op.xs", fc_gpu.c.op.xs, fc_cpu.c.op.xs)):
            g = g.cpu()
            if not torch.allclose(g, c, rtol=TRIP_TOL, atol=TRIP_TOL,
                                  equal_nan=True):
                bad = ~torch.isclose(g, c, rtol=TRIP_TOL, atol=TRIP_TOL,
                                     equal_nan=True)
                _fail(f"trip {i}: {name} differs card vs CPU beyond "
                      f"{TRIP_TOL:g} on {int(bad.sum())} entries: card "
                      f"{g[bad][:4].tolist()} CPU {c[bad][:4].tolist()}")
        same = torch.equal(fc_gpu.c.op.xs.cpu().nan_to_num(),
                           fc_cpu.c.op.xs.nan_to_num())
        print(f"# trip {i}: decisions equal card vs CPU on all {Bt} lanes; "
              f"merits and xs within {TRIP_TOL:g} (xs bitwise equal: "
              f"{same}); failed {int(fc_cpu.c.failed.sum())}", flush=True)

    # ---- phase 4: the bench path at B=1024, counters reset ----
    lq.lq_backward.launches = 0
    lq.lq_forward.launches = 0
    sweep.rollout_bm.launches = 0
    res, out = bench.run_bench(B, dev)
    launches = {"K2": lq.lq_backward.launches, "K3": lq.lq_forward.launches,
                "K4": sweep.rollout_bm.launches}
    out["launches"] = launches
    print(json.dumps(out), flush=True)
    if min(launches.values()) <= 0:
        _fail(f"a kernel of the main path was not launched: {launches}")
    if tuple(res.op.xs.shape) != (B, spec.num_time_steps, spec.xdim):
        _fail(f"result shape {tuple(res.op.xs.shape)}")
    conv = res.converged
    if not bool(torch.isfinite(res.op.xs[conv]).all()):
        _fail("non-finite trajectory on a converged lane")
    lo, hi = DIVERGED_BAND
    if not lo <= out["diverged_frac"] <= hi:
        _fail(f"diverged_frac {out['diverged_frac']} outside [{lo}, {hi}]")
    for p, (got, ref) in enumerate(zip(out["cost_p50"], JAX_COST_P50)):
        if not abs(got - ref) <= COST_P50_REL * ref:
            _fail(f"player {p} cost_p50 {got} vs JAX {ref}")
    for k in kernels:
        k["launches"] = launches[k["name"][:2]]

    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
