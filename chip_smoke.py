#!/usr/bin/env python3
"""Smoke test of the PyTorch port (ilqgames_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ and drives its paths: the
flagship three-player intersection solved for perturbed x0 by the batched
AL + iLQ machine, through kernels K1 (fused stage), K2 (LQ Riccati
sweep), K3 (δx forward pass), K4 (candidate rollout), K5 (rollout with
in-kernel merit) and K6 (merit consumer). Phases:

1. the card's name and power limit, and the kernels' build time (one
   nvcc per source, all at once);
2. each kernel against its plain PyTorch version on the card, on operands
   from a real flagship stage (the first rollout of bench.py's x0 draw;
   K1 with the multipliers of one AL update), at the main path's shapes,
   with both times and the count of bitwise-equal lanes;
3. six trips on the card against six on the CPU (plain versions) from
   the same carry, without and with fused stages: decisions exactly
   equal; then six fused trips on the card with the K5 and the K6 merit
   backends against the plain fold: decisions and merits exactly equal
   (each backend's launches counted from zero over its trips);
4. the unfused path: the plain driver at B=1024 without fused stages, launch
   counters reset just before, and its outcome distribution against the
   JAX package's (BENCH_ALL_r05.jsonl row 3: same x0, same batch);
5. the bench's default path: 8192 instances through 2048 lanes on the
   wave-refill queue driver, harvest chunks of 32, fused stages, launch
   counters reset just before, against the JAX package's outcome on the
   same draw and configuration (BENCH_r05.json).

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
TOL = {"K1": 1e-5, "K2": 2e-4, "K3": 5e-4, "K4": 2e-4, "K5": 1e-5,
       "K6": 1e-5}
TRIP_TOL = 2e-3           # merits and trajectories, card vs CPU, per trip
DIVERGED_BAND = (0.02, 0.12)  # JAX: 0.0566 at B=1024, 0.058 queue (r05)
JAX_COST_P50 = (3057.4, 855.7, 78.2)        # plain driver, B=1024
JAX_QUEUE_COST_P50 = (3024.2, 837.1, 76.3)  # queue, 8192 through 2048
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
    """Mean ms per call over `reps` calls, after at least 0.2 s of calls:
    the card idles at a low clock and takes a while to raise it."""
    import torch

    warm_until = time.perf_counter() + 0.2
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


def _same_decisions(what, a, b):
    """failed, converged, done and AL mu of two carries exactly equal."""
    import torch

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
    from ilqgames_tpu_torch.ops.cuda import lq, stage, sweep
    from ilqgames_tpu_torch.solver import batched
    from ilqgames_tpu_torch.solver.al import constraint_violations
    from ilqgames_tpu_torch.types import tree_map

    dev = torch.device("cuda")
    bench.set_precision()
    card = _card_line()
    print(f"# card: {card}", flush=True)

    # ---- phase 1: build ----
    problem = make_problem()
    spec = problem.spec
    t0 = time.perf_counter()
    bench.build_kernels(spec)
    print(f"# build: {time.perf_counter() - t0:.1f} s (concurrent nvcc: "
          f"csrc/stage.cu, lq.cu, sweep.cu, merit.cu)", flush=True)

    # ---- phase 2: each kernel against its plain version ----
    B = 1024
    params = bench.exec_main_params()
    x0 = torch.tensor(bench.perturbed_x0(problem, B), device=dev)
    dyn, costs = problem.dynamics, problem.player_costs

    def carry0(x, fuse):
        return batched._fresh_init(dyn, costs, spec, None, None, 128,
                                   fuse)(x)

    c0 = carry0(x0, False).c
    lin = dyn_base.linearize(dyn, spec, c0.op)
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

    # K1 at B=2048, on the first rollout of bench's draw with the
    # multipliers and mu of one AL update.
    B1 = 2048
    x1 = torch.tensor(bench.perturbed_x0(problem, B1), device=dev)
    c1 = carry0(x1, True)
    al1, _ = constraint_violations(costs, spec, c1.c.op, c1.al)
    al1 = al1.replace(mu=al1.mu * params.geometric_mu_scaling)
    op1, x1m = sweep._prep_op(spec, x1, c1.c.op, 1)
    lamS, lamC, mu1 = sweep._prep_al(spec, al1, 1)
    k1_args = (dyn, costs, spec, op1, lamS, lamC, mu1)
    ops_k = stage.lin_quad(*k1_args)
    ops_p = stage.lin_quad_plain(*k1_args)
    err = max(_compare(f"K1 {name}", ops_k[name], ops_p[name], TOL["K1"])
              for name in ops_p)
    entry(f"K1 lin_quad (B={B1})", "ilqgames_tpu_torch/csrc/stage.cu",
          "ilqgames_tpu/ops/pallas/stage.py:65", err,
          _time_ms(lambda: stage.lin_quad(*k1_args), 20),
          _time_ms(lambda: stage.lin_quad_plain(*k1_args), 3))

    # K5 and K6 on the LQ strategy at those operands.
    Ps_r, al_r, _ = lq.solve_lq_feedback_bm(spec, ops_k, x1m - op1["xs"][0])
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
        m5_p = sweep.rollout_merits_plain(*k5_args)
        entry(f"K5 rollout+merit (C={C}, B={Bk})",
              "ilqgames_tpu_torch/csrc/sweep.cu",
              "ilqgames_tpu/ops/pallas/sweep.py:176",
              _compare(f"K5 merits C={C} B={Bk}", m5_k, m5_p, TOL["K5"]),
              _time_ms(lambda: sweep.rollout_merits(*k5_args), 20),
              _time_ms(lambda: sweep.rollout_merits_plain(*k5_args), 1))
        xs_c = sweep.rollout_bm(dyn, spec, x1m[:, :Bk].contiguous(), sub(op1),
                                sub(st1), scal_cb)
        us_c = sweep._us_from_xs(spec, xs_c, sub(op1), sub(st1), scal_cb)
        k6_args = (costs, spec, xs_c, us_c, sub(op1)["t0"], lam_k, None,
                   mu_k)
        m6_k = sweep.consumer_merits(*k6_args)
        m6_p = sweep.merit_plain(*k6_args)
        entry(f"K6 merit consumer (C={C}, B={Bk})",
              "ilqgames_tpu_torch/csrc/merit.cu",
              "ilqgames_tpu/ops/pallas/sweep.py:395",
              _compare(f"K6 merits C={C} B={Bk}", m6_k, m6_p, TOL["K6"]),
              _time_ms(lambda: sweep.consumer_merits(*k6_args), 20),
              _time_ms(lambda: sweep.merit_plain(*k6_args), 3))
        same = torch.equal(m5_k.nan_to_num(), m6_k.nan_to_num())
        print(f"# K5 == K4 + K6 bitwise (C={C}, B={Bk}): {same}", flush=True)
        if not same:
            _fail(f"K5 and K4 + K6 disagree at C={C}, B={Bk}")

    # ---- phase 3: six trips on the card against six on the CPU ----
    Bt = 64
    x0c = torch.tensor(bench.perturbed_x0(problem, Bt))
    x0g = x0c.to(dev)
    for fuse in (False, True):
        trip, _ = batched._driver_parts(dyn, costs, spec, params, 128, fuse)
        fc_cpu = carry0(x0c, fuse)
        fc_gpu = tree_map(lambda a: a.to(dev), fc_cpu)
        for i in range(6):
            fc_cpu = trip(x0c, fc_cpu)
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
        if not torch.equal(fc.c.last_merit.nan_to_num(),
                           ref.c.last_merit.nan_to_num()):
            _fail(f"merit_backend={backend!r}: merits differ from 'xla'")
        n = backend_launches[backend][kname]
        print(f"# merit_backend={backend!r}: six fused trips on the card, "
              f"decisions and merits bitwise equal to 'xla'; {kname} "
              f"launched {n} times", flush=True)
        if n <= 0:
            _fail(f"merit_backend={backend!r} never launched {kname}")

    # ---- phase 4: the plain driver at B=1024, unfused stages ----
    bench.reset_launches()
    res, out = bench.run_bench(B, dev, driver="plain", fuse_stages=False)
    launches = bench.launches()
    print(json.dumps(out), flush=True)
    N, X = spec.num_time_steps, spec.xdim
    _check_outcome("plain B=1024", res, out, (B, N, X), launches,
                   ("K2", "K3", "K4"), JAX_COST_P50)

    # ---- phase 5: the bench's default path, 8192 through 2048 lanes ----
    bench.reset_launches()
    t0 = time.perf_counter()
    res, out = bench.run_bench(2048, dev, driver="queue", total=8192,
                               harvest_block=32, trips_per_call=10,
                               fuse_stages=True)
    launches = bench.launches()
    print(f"# queue: {out['dispatches']} dispatches, {out['harvests']} "
          f"harvests, {out['compactions']} compactions, {out['trips']} "
          f"trips, {out['host_syncs']} host syncs "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    print(json.dumps(out), flush=True)
    _check_outcome("queue 8192/2048", res, out, (8192, N, X), launches,
                   ("K1", "K2", "K3", "K4"), JAX_QUEUE_COST_P50)
    for k in kernels:
        name = k["name"][:2]
        k["launches"] = (backend_launches["kernel"][name] if name == "K5"
                         else backend_launches["pallas"][name]
                         if name == "K6" else launches[name])

    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
