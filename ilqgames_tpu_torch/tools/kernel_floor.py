"""What one rollout knot costs at the floor, on the card: the counterpart
of the JAX package's TPU probe tools/kernel_floor.py (its launch site
:63), on the same operands (RandomState(0) draws in its order), N=100:

- fma50: P1, 50 dependent multiply-adds per step on [16, B];
- rk4_fixed_u: P2 "fixed_u", the flagship ODE, RK4 with 2 substeps under
  fixed controls [3, 2, B], compile-time state offsets;
- rk4_feedback: P2 "plus", + u = P_k (x - xbar_k) + alpha_k from Ps
  [100, 6, 16, B], alpha [100, 6, B], xbar [100, 16, B] (the probe's +);
- rk4_feedback_c26: the same at C=26 candidates.

Each runs at the probe's B=128 and, for the rollout floors and fma50
(on [16, C*B]), at the shapes where chip_smoke.py times K4: C=1, B=1024
and C=8, B=128, so each floor stands beside K4's time.

    python3 -m ilqgames_tpu_torch.tools.kernel_floor

prints one JSON line per (case, shape): device ms per call and us per
knot, and the card's name and power limit.
"""

from __future__ import annotations

import torch

from ilqgames_tpu_torch.ops.cuda import probes
from ilqgames_tpu_torch.tools import _probe
from ilqgames_tpu_torch.tools._probe import Call, Case

N = _probe.N_KNOTS
SITE = "tools/kernel_floor.py:63"
PROBE_B, PROBE_C = 128, 26
K4_SHAPES = ((1, 1024), (8, 128))


def _draws(ctx, C, B):
    return ctx.tensors(("floor", C, B),
                       lambda: _probe.floor_draws(ctx.spec, C, B))


def _start(d, x0_key):
    """[16, C, B] starts: the probe's x0 [16, B] as one candidate, or
    x0c."""
    return (d["x0"][:, None, :] if x0_key == "x0" else d["x0c"]).contiguous()


def _p2(rung):
    def make(ctx, C, B, x0_key, label):
        d = _draws(ctx, C, B)
        x0c = _start(d, x0_key)
        op = {"xs": d["xs"], "us": torch.zeros_like(d["al"]),
              "t0": torch.zeros((1, B), device=ctx.dev)}
        st = {"Ps": d["Ps"], "alphas": d["al"]}
        scal = torch.ones((x0c.shape[1], B), device=ctx.dev)
        args = (rung, ctx.dyn, ctx.costs, ctx.spec, x0c, op, st, scal)
        return Call(label,
                    lambda: probes.probe_rollout(*args, ufix=d["ufix"]),
                    lambda: probes.probe_rollout_plain(*args,
                                                       ufix=d["ufix"]),
                    ("P2", rung, None, x0c.shape[1], B))
    return make


def _fma50(ctx, C, B, x0_key, label):
    x = _start(_draws(ctx, C, B), x0_key).reshape(16, -1)
    return Call(label, lambda: probes.fma_chain(ctx.spec, x, N),
                lambda: probes.fma_chain_plain(x, N), ("P1", x.numel()))


def _shapes(c26: bool):
    """(C, B, start) per run: the probe's own shape, then K4's (not for the
    C=26 case, which is rk4_feedback at another C)."""
    if c26:
        return [(PROBE_C, PROBE_B, "x0c")]
    return [(PROBE_C, PROBE_B, "x0")] + [(C, B, "x0c") for C, B in K4_SHAPES]


def _at_shapes(make, c26=False):
    """run(ctx): one Call per shape, the label naming the shape."""
    def run(ctx):
        return [make(ctx, C, B, x0, f"C={1 if x0 == 'x0' else C}, B={B}")
                for C, B, x0 in _shapes(c26)]
    return run


CASES = [
    Case("floor.fma50", SITE, "P1 fma_chain on [16, C*B]",
         _at_shapes(_fma50),
         "--fmad=false: each step is a separate multiply and add"),
    Case("floor.rk4_fixed_u", SITE, "P2 fixed_u", _at_shapes(_p2("fixed_u")),
         aliases=("rk4",)),
    Case("floor.rk4_feedback", SITE, "P2 plus", _at_shapes(_p2("plus")),
         aliases=("rk4_fb",)),
    Case("floor.rk4_feedback_c26", SITE, "P2 plus at C=26",
         _at_shapes(_p2("plus"), c26=True), aliases=("rk4_c26",)),
]


def run(reps: int = 20, ctx=None):
    """Time every case at every shape on the card; yields one dict each."""
    dev = _probe.require_cuda()
    ctx = ctx or _probe.Context(dev)
    card = _probe.card_line()
    for case in CASES:
        for call in case.run(ctx):
            ms = _probe.time_ms(call.fn, reps)
            yield _probe.emit({
                "case": case.key, "replaces": case.replaces,
                "counterpart": case.counterpart, "shape": call.label,
                "ms": ms,
                "us_per_knot": ms * 1e3 / N, "card": card})


def main():
    for _ in run():
        pass


if __name__ == "__main__":
    main()
