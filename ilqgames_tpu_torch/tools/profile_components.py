"""The fused trip's components at B=256, on the card: the counterpart of
the JAX package's TPU probe tools/profile_components.py (its Pallas smoke
launch at :101).

First P3 (o = x * 2 + 1 on [128, 256]), checked against 3 on ones. Then,
on bench.py's x0 draw at B=256 with the reference exec main's
parameters, each component runs 10 steps in a row, every step's output
feeding the next (serialized, as in the solver's loop):

- trip_full, trip_no_linesearch: `batched._driver_parts` trips with
  fused stages (K1-K4), with and without the linesearch;
- rollout: `sweep.rollout` (K4);
- linearize: `dynamics.base.linearize`;
- lq_feedback: `lq.solve_lq_feedback` (K2, K3);
- quadraticize: `player_cost.quadraticize`;
- totalcost_and_violations: `player_cost.total_costs` and
  `al.constraint_violations`.

    python3 -m ilqgames_tpu_torch.tools.profile_components

prints one JSON line per component: wall ms per step on the host clock
(each loop ends in torch.cuda.synchronize()), and the card's name and
power limit.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from ilqgames_tpu_torch import bench
from ilqgames_tpu_torch.costs import player_cost as pcost
from ilqgames_tpu_torch.dynamics import base as dyn_base
from ilqgames_tpu_torch.ops.cuda import lq, probes, sweep
from ilqgames_tpu_torch.solver import batched
from ilqgames_tpu_torch.solver.al import constraint_violations
from ilqgames_tpu_torch.tools import _probe
from ilqgames_tpu_torch.tools._probe import Call, Case

SITE = "tools/profile_components.py:101"
B = 256
NSTEPS = 10


def _state(ctx):
    """bench.py's x0 at B=256, the fresh fused carry, and the unfused
    stage operands at its operating point."""
    def make():
        x0 = torch.tensor(bench.perturbed_x0(ctx.problem, B), device=ctx.dev)
        fc0 = batched._fresh_init(ctx.dyn, ctx.costs, ctx.spec, None, None,
                                  128, True)(x0)
        op0 = fc0.c.op
        al0 = pcost.ALState.init(ctx.costs, ctx.spec, B, device=ctx.dev)
        lin0 = dyn_base.linearize(ctx.dyn, ctx.spec, op0)
        quad0 = pcost.quadraticize(ctx.costs, ctx.spec, op0, al0)
        return dict(x0=x0, fc0=fc0, op0=op0, al0=al0, lin0=lin0, quad0=quad0)
    return ctx.cached("components", make)


def smoke(ctx):
    x = torch.ones((128, 256), device=ctx.dev)
    return [Call("P3", lambda: probes.smoke(ctx.spec, x),
                 lambda: probes.smoke_plain(x), ("P3", x.numel()))]


def init(ctx):
    s = _state(ctx)
    return lambda: batched._fresh_init(ctx.dyn, ctx.costs, ctx.spec, None,
                                       None, 128, True)(s["x0"])


def trips(ctx, linesearch):
    s = _state(ctx)
    params = dataclasses.replace(bench.exec_main_params(),
                                 linesearch=linesearch)
    trip, _ = batched._driver_parts(ctx.dyn, ctx.costs, ctx.spec, params,
                                    128, True)

    def loop():
        fc = s["fc0"]
        for _ in range(NSTEPS):
            fc = trip(s["x0"], fc)
        return fc
    return loop


def _chain(step):
    def loop(x):
        for _ in range(NSTEPS):
            x = step(x)
        return x
    return loop


def rollout(ctx):
    s = _state(ctx)
    step = lambda x: x + 1e-9 * sweep.rollout(
        ctx.dyn, ctx.spec, x, s["op0"], s["fc0"].c.strategy).xs[:, -1]
    return lambda: _chain(step)(s["x0"])


def _nudged(s, x):
    return s["op0"].replace(xs=s["op0"].xs + 1e-9 * x[:, None, :])


def linearize(ctx):
    s = _state(ctx)
    step = lambda x: x + 1e-9 * dyn_base.linearize(
        ctx.dyn, ctx.spec, _nudged(s, x)).A[:, 0, 0]
    return lambda: _chain(step)(s["x0"])


def lq_feedback(ctx):
    s = _state(ctx)
    step = lambda dx: dx + 1e-9 * lq.solve_lq_feedback(
        ctx.spec, s["lin0"], s["quad0"], dx).delta_xs[:, -1]
    return lambda: _chain(step)(s["x0"] - s["op0"].xs[:, 0])


def quadraticize(ctx):
    s = _state(ctx)
    step = lambda x: x + 1e-9 * pcost.quadraticize(
        ctx.costs, ctx.spec, _nudged(s, x), s["al0"]).l[:, 0, 0]
    return lambda: _chain(step)(s["x0"])


def totals(ctx):
    s = _state(ctx)

    def step(x):
        op = _nudged(s, x)
        tot, _ = pcost.total_costs(ctx.costs, ctx.spec, op)
        _, viol = constraint_violations(ctx.costs, ctx.spec, op, s["al0"])
        return x + 1e-9 * (tot[:, :1] + viol[:, None])
    return lambda: _chain(step)(s["x0"])


def _component(name, make, counterpart):
    return Case(f"components.{name}", SITE, counterpart,
                lambda ctx: [Call(name, make(ctx))])


CASES = [
    Case("components.pallas_smoke", SITE, "P3 smoke", smoke),
    _component("init", init, "batched._fresh_init (K4), fused"),
    _component("trip_full", lambda ctx: trips(ctx, True),
               "batched._driver_parts trip, fused (K1-K4)"),
    _component("trip_no_linesearch", lambda ctx: trips(ctx, False),
               "the same trip with linesearch=False"),
    _component("rollout", rollout, "sweep.rollout (K4)"),
    _component("linearize", linearize, "dynamics.base.linearize"),
    _component("lq_feedback", lq_feedback, "lq.solve_lq_feedback (K2, K3)"),
    _component("quadraticize", quadraticize, "player_cost.quadraticize"),
    _component("totalcost_and_violations", totals,
               "player_cost.total_costs + al.constraint_violations"),
]


def run(reps: int = 1, ctx=None):
    """P3's check and time, then each component's wall ms per step;
    yields one dict each."""
    dev = _probe.require_cuda()
    ctx = ctx or _probe.Context(dev)
    card = _probe.card_line()
    for case in CASES:
        call = case.run(ctx)[0]
        name, fn = call.label, call.fn
        line = {"case": case.key, "replaces": case.replaces,
                "counterpart": case.counterpart}
        if name == "P3":
            ok = bool((fn() == 3.0).all())
            if not ok:
                raise RuntimeError("P3 smoke kernel: x * 2 + 1 != 3 on ones")
            line.update(works=ok, ms=_probe.time_ms(fn, 20))
        else:
            fn()                                        # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            per = (time.perf_counter() - t0) / reps
            line["ms_per_step"] = per * 1e3 / (1 if name == "init"
                                               else NSTEPS)
        line["card"] = card
        yield _probe.emit(line)


def main():
    for _ in run():
        pass


if __name__ == "__main__":
    main()
