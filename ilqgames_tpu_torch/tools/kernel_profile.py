"""Host enqueue against total time per call, on the card: the counterpart
of the JAX package's TPU probe tools/kernel_profile6i.py (its launch site
:138), on its operands (RandomState(0) draws in its order; C=8, B=128,
N=100). For each case, 20 calls are issued back to back on the host
clock (enqueue), then one torch.cuda.synchronize() ends the total:

- t1_merit_fixed: sweep.merit_plain over fixed trajectories (plain
  PyTorch, hundreds of small kernels per call);
- t2_chain: K4 emitting xs and us, then torch.sum of both;
- t3_slow_kernel: K5 on the three nominal-speed costs;
- t4_emit_only: K4 emitting xs and us.

    python3 -m ilqgames_tpu_torch.tools.kernel_profile

prints one JSON line per case: enqueue and total ms per call and the
device ms per call (CUDA events), with the card's name and power limit.
"""

from __future__ import annotations

import torch

from ilqgames_tpu_torch.ops.cuda import sweep
from ilqgames_tpu_torch.tools import _probe
from ilqgames_tpu_torch.tools._probe import Call, Case
from ilqgames_tpu_torch.tools.sweep_floor import SUBSETS

SITE = "tools/kernel_profile6i.py:138"
QUEUED = 20


def _draws(ctx):
    return ctx.tensors("profile6i", lambda: _probe.merit_chain_draws(
        ctx.spec, ctx.n_constraints, lam_first=True))


def _op_st(d):
    return ({"xs": d["xs"], "us": d["us"], "t0": d["t0"]},
            {"Ps": d["Ps"], "alphas": d["al"]})


def t1(ctx):
    d = _draws(ctx)
    return [Call("merit_plain", lambda: sweep.merit_plain(
        ctx.costs, ctx.spec, d["xc0"], d["uc0"], d["t0"], d["lamS"], None,
        d["mu"]))]


def _emit_args(ctx):
    d = _draws(ctx)
    return (ctx.dyn, ctx.spec, d["x0m"]) + _op_st(d) + (d["scal"],)


def t2(ctx):
    args = _emit_args(ctx)

    def chain():
        xc, uc = sweep.rollout_bm(*args, emit_us=True)
        return torch.sum(xc) + torch.sum(uc)
    return [Call("K4 + sum", chain)]


def t3(ctx):
    d = _draws(ctx)
    pcs, _ = ctx.subset("nomv", SUBSETS["nomv"])
    args = (ctx.dyn, pcs, ctx.spec, d["x0c"][:, 0].contiguous()) \
        + _op_st(d) + (d["scal"], None, None, d["mu"])
    return [Call("K5", lambda: sweep.rollout_merits(*args),
                 lambda: sweep.rollout_merits_plain(*args),
                 ("K5", "nomv") + tuple(d["scal"].shape))]


def t4(ctx):
    args = _emit_args(ctx)
    return [Call("K4", lambda: sweep.rollout_bm(*args, emit_us=True),
                 lambda: sweep.rollout_plain(*args, emit_us=True),
                 ("K4", True) + tuple(args[-1].shape))]


CASES = [
    Case("6i.t1_merit_fixed", SITE, "sweep.merit_plain (plain PyTorch)", t1),
    Case("6i.t2_chain", SITE, "K4 emit_us -> torch.sum", t2),
    Case("6i.t3_slow_kernel", SITE, "K5 on the nominal speeds", t3,
         "K5's start is the first candidate's x0c[:, 0]"),
    Case("6i.t4_emit_only", SITE, "K4 emit_us", t4),
]


def run(reps: int = 20, ctx=None):
    """Enqueue, total and device time of every case; yields one dict
    each."""
    dev = _probe.require_cuda()
    ctx = ctx or _probe.Context(dev)
    card = _probe.card_line()
    for case in CASES:
        fn = case.run(ctx)[0].fn
        enq, tot = _probe.split_ms(fn, QUEUED)
        ms = _probe.time_ms(fn, reps)
        yield _probe.emit({
            "case": case.key, "replaces": case.replaces,
            "counterpart": case.counterpart, "enqueue_ms": enq,
            "total_ms": tot, "ms": ms, "card": card})


def main():
    for _ in run():
        pass


if __name__ == "__main__":
    main()
