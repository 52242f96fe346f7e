"""The sweep-kernel ladder on the card: one registry row for every case of
the JAX package's eleven tools/sweep_floor5*.py TPU probes, keyed
"<script>.<case>" (5b.f_lane, ...), each run by the port's counterpart on
the TPU script's own operands at C=8, B=128, N=100 unless it says
otherwise:

- P2 rungs (ops/cuda/probes.py RUNGS) for the structural steps: the floor
  law, the production law, the state layout (compile-time offsets against
  the run-time SubsysTable that K4's and K5's one-thread designs took
  before one warp per subsystem), the per-lane time, the merit fold's gate,
  knot-0 and accumulator choices, and raw merit content;
- K5 (sweep.rollout_merits) on sub-tables of the flagship's costs for the
  cost-content cases (tools/sweep_floor5b.py's filters, `_probe`);
- K4 (sweep.rollout_bm) and K6 (sweep.consumer_merits) for the emission and
  merit-consumer cases.

Where a TPU case probes a choice of the TPU compiler with no CUDA
analogue, the row says so and names the nearest rung.

    python3 -m ilqgames_tpu_torch.tools.sweep_floor

prints one JSON line per case (device ms per call and per knot, and the
card's name and power limit).
"""

from __future__ import annotations

import torch

from ilqgames_tpu_torch.ops.cuda import probes, sweep
from ilqgames_tpu_torch.tools import _probe
from ilqgames_tpu_torch.tools._probe import Call, Case

N = _probe.N_KNOTS
SITES = {"5": "tools/sweep_floor5.py:73", "5b": "tools/sweep_floor5b.py:70",
         "5c": "tools/sweep_floor5c.py:73", "5d": "tools/sweep_floor5d.py:71",
         "5e": "tools/sweep_floor5e.py:71", "5g": "tools/sweep_floor5g.py:75",
         "5h": "tools/sweep_floor5h.py:78",
         "5i": "tools/sweep_floor5i.py:148",
         "5j": "tools/sweep_floor5j.py:72",
         "5k": "tools/sweep_floor5k.py:126"}

# Which sweep5 draws each script makes (tools/sweep_floor5*.py).
_DRAW_KW = {"5": {}, "5b": {}, "5c": {}, "5g": {}, "5h": {},
            "5d": {"x0c1": True, "lamS": True}, "5e": {"lamS": True},
            "5j": {"lamS": True}}

# The cost sub-tables of the content cases: keep(player, kind, name).
SUBSETS = {
    "empty": lambda pi, kind, nm: False,
    "full": lambda pi, kind, nm: True,
    "lane": lambda pi, kind, nm: kind == "state" and "Lane" in nm,
    "nomv": lambda pi, kind, nm: kind == "state" and "NominalV" in nm,
    "ctrl": lambda pi, kind, nm: kind == "ctrl",
    "prox": lambda pi, kind, nm: kind == "sconstr",
    "lane2": lambda pi, kind, nm: (pi == 1 and kind == "state"
                                   and "Lane" in nm),
    "nomv_p0": lambda pi, kind, nm: (pi == 0 and kind == "state"
                                     and "NominalV" in nm),
    "nomv_p01": lambda pi, kind, nm: (pi < 2 and kind == "state"
                                      and "NominalV" in nm),
    "prox_p1_p3": lambda pi, kind, nm: (pi == 1 and kind == "sconstr"
                                        and nm.endswith("P3")),
    "player0": lambda pi, kind, nm: pi == 0,
    "player1": lambda pi, kind, nm: pi == 1,
    "player2": lambda pi, kind, nm: pi == 2,
}


def _draw_key(tag):
    return ("sweep5",) + tuple(sorted(_DRAW_KW[tag]))


def _draws(ctx, tag):
    """A script's operands; scripts that draw the same share one set."""
    return ctx.tensors(_draw_key(tag), lambda: _probe.sweep5_draws(
        ctx.spec, ctx.n_constraints, **_DRAW_KW[tag]))


def _costs(ctx, subset):
    """(player costs, kept constraint rows) of a sub-table; "seg1",
    "seg2": the truncated lanes of 5h."""
    if subset.startswith("seg"):
        return ctx.cached(("seg", subset), lambda: (
            _probe.truncated_lane_costs(ctx.costs, int(subset[3:])), []))
    return ctx.subset(subset, SUBSETS[subset])


def _lam(ctx, d, rows, real):
    """lamS of the kept constraint rows: the script's drawn multipliers
    (`real`) or zeros, as the scripts without a lamS draw pass."""
    if not rows:
        return None
    if real:
        return d["lamS"][:, rows].contiguous()
    return torch.zeros((ctx.spec.num_time_steps, len(rows),
                        d["x0c"].shape[-1]), device=ctx.dev)


def _op_st(d):
    return ({"xs": d["xs"], "us": d["us"], "t0": d["t0"]},
            {"Ps": d["Ps"], "alphas": d["al"]})


def _k4_operands(ctx, tag, x0_key):
    """K4's (x0m, op, st, scal) on a script's draws: x0 = x0c[:, 0] (or
    x0c1[:, 0] at C=1)."""
    d = _draws(ctx, tag)
    op, st = _op_st(d)
    return (d[x0_key][:, 0].contiguous(), op, st,
            d["scal"][:d[x0_key].shape[1]].contiguous())


def _rollout_plain(ctx, tag, x0_key):
    """sweep.rollout_plain's (xs, us) on a script's draws, kept: the plain
    versions of the K4 and K5 rows on one draw share it."""
    return ctx.cached(("rollout_plain", _draw_key(tag), x0_key),
                      lambda: sweep.rollout_plain(
                          ctx.dyn, ctx.spec,
                          *_k4_operands(ctx, tag, x0_key), emit_us=True))


def k5(tag, subset, label="K5"):
    """K5 on a sub-table, x0 = the first candidate's start x0c[:, 0] (K5's
    candidates share a start; the scripts' scal is 0.5 for all eight)."""
    def run(ctx):
        d = _draws(ctx, tag)
        pcs, rows = _costs(ctx, subset)
        x0m, op, st, scal = _k4_operands(ctx, tag, "x0c")
        lamS = _lam(ctx, d, rows, "lamS" in d)

        def plain():
            # sweep.rollout_merits_plain, on the kept plain rollout.
            xs = _rollout_plain(ctx, tag, "x0c")[0]
            us = sweep._us_from_xs(ctx.spec, xs, op, st, scal)
            return sweep.merit_plain(pcs, ctx.spec, xs, us, op["t0"], lamS,
                                     None, d["mu"])
        return [Call(label, lambda: sweep.rollout_merits(
            ctx.dyn, pcs, ctx.spec, x0m, op, st, scal, lamS, None,
            d["mu"]), plain, ("K5", subset) + tuple(scal.shape))]
    return run


def p2(tag, rung, subset=None, beside=()):
    """P2 at `rung` (with the sub-table's merit content), and other rungs
    on the same operands beside it."""
    def run(ctx):
        d = _draws(ctx, tag)
        pcs, rows = _costs(ctx, subset) if subset else (ctx.costs, [])
        op, st = _op_st(d)
        lamS = _lam(ctx, d, rows, "lamS" in d)

        def call(r):
            args = (r, ctx.dyn, pcs, ctx.spec, d["x0c"], op, st, d["scal"])
            kw = dict(gate=d["gate"], lamS=lamS, mu=d["mu"])
            table = (subset or "full") if probes.RUNGS[r].merit == "table" \
                else None
            return Call(f"P2 {r}", lambda: probes.probe_rollout(*args, **kw),
                        lambda: probes.probe_rollout_plain(*args, **kw),
                        ("P2", r, table) + tuple(d["scal"].shape))
        return [call(r) for r in (rung,) + tuple(beside)]
    return run


def k4(tag, x0_key="x0c", emit_us=False):
    """K4 on a script's operands, x0 = x0c[:, 0] (or x0c1[:, 0] at C=1)."""
    def run(ctx):
        args = _k4_operands(ctx, tag, x0_key)

        def plain():
            xs, us = _rollout_plain(ctx, tag, x0_key)
            return (xs, us) if emit_us else xs
        return [Call("K4", lambda: sweep.rollout_bm(
            ctx.dyn, ctx.spec, *args, emit_us=emit_us), plain,
            ("K4", emit_us) + tuple(args[3].shape))]
    return run


def emit5i(case):
    def run(ctx):
        d = _draws5i(ctx)[case]
        args = (ctx.dyn, ctx.spec, d["x0m"],
                {"xs": d["xs"], "us": d["us"], "t0": d["t0"]},
                {"Ps": d["Ps"], "alphas": d["al"]}, d["scal"])
        return [Call("K4", lambda: sweep.rollout_bm(*args, emit_us=True),
                     lambda: sweep.rollout_plain(*args, emit_us=True),
                     ("K4", True) + tuple(d["scal"].shape))]
    return run


def _draws5i(ctx):
    return ctx.tensors("sweep5i", lambda: _probe.sweep5i_draws(
        ctx.spec, ctx.n_constraints))


def _k6(args):
    """K6 on merit_plain's operands, checked against merit_plain."""
    return Call("K6", lambda: sweep.consumer_merits(*args),
                lambda: sweep.merit_plain(*args),
                ("K6", "full") + tuple(args[2].shape[2:]))


def merit5i(ctx):
    d = _draws5i(ctx)["i4"]
    args = (ctx.costs, ctx.spec, d["xs_cand"], d["us_cand"], d["t0"],
            d["lamS"], None, d["mu"])
    return [Call("merit_plain", lambda: sweep.merit_plain(*args)), _k6(args)]


def _draws5k(ctx):
    return ctx.tensors("sweep5k", lambda: _probe.merit_chain_draws(
        ctx.spec, ctx.n_constraints, lam_first=False))


def m1(ctx):
    d = _draws5k(ctx)
    return [_k6((ctx.costs, ctx.spec, d["xc0"], d["uc0"], d["t0"],
                 d["lamS"], None, d["mu"]))]


def m2(ctx):
    d = _draws5k(ctx)
    op = {"xs": d["xs"], "us": d["us"], "t0": d["t0"]}
    st = {"Ps": d["Ps"], "alphas": d["al"]}

    def chain():
        xc, uc = sweep.rollout_bm(ctx.dyn, ctx.spec, d["x0m"], op, st,
                                  d["scal"], emit_us=True)
        return sweep.consumer_merits(ctx.costs, ctx.spec, xc, uc, d["t0"],
                                     d["lamS"], None, d["mu"])
    return [Call("K4 -> K6", chain)]


def p2_perplayer(ctx):
    calls = [k5("5j", f"player{i}", f"K5 player{i}")(ctx)[0]
             for i in range(3)]

    def all3():
        return [c.fn() for c in calls]
    return [Call("3 x K5", all3)] + calls


FLOATMASK = ("the float-mask rewrite of the polyline query was never "
             "shipped in the JAX package, so it has no CUDA variant; "
             "nearest: K5 on the same lane with the shipped query")
_OUTPUT_REF = ("accumulating into the output ref is P2's ACC=global "
               "(device memory every knot)")


def _cases():
    s = SITES
    c = Case
    return [
        # tools/sweep_floor5.py: the structural ladder.
        c("5.v0_floor", s["5"], "P2 floor (compile-time layout, "
          "u = -P delta - alpha, scalar t)", p2("5", "floor"),
          "the TPU code adds (P delta + alpha) where its docstring "
          "subtracts; the sign costs nothing"),
        c("5.v1_ctrl_law", s["5"], "P2 prod_static (production law)",
          p2("5", "prod_static")),
        c("5.v2_scratch_x", s["5"], "P2 prod_table (run-time SubsysTable "
          "layout, as K4's and K5's one-thread designs)",
          p2("5", "prod_table"),
          "x through a VMEM scratch ref has no CUDA form; the analogue is "
          "the state indexed through run-time subsystem offsets (K4's and "
          "K5's layout before one warp per subsystem) against v1's "
          "compile-time offsets"),
        c("5.v3_lane_t", s["5"], "P2 lane_t (per-lane t)", p2("5", "lane_t"),
          "the flagship's models ignore t, so nvcc drops it"),
        c("5.v3_emit", s["5"], "P2 emit_xs and emit_xs_us (the top rung)",
          p2("5", "emit_xs", beside=("emit_xs_us",)),
          "no TPU case: v3 + emission, K4's one-thread design before one "
          "warp per subsystem"),
        c("5.k4", s["5"], "K4 (emit xs, as shipped)", k4("5"),
          "no TPU case: K4, one warp per subsystem, beside v3 + "
          "emission"),
        c("5.v4_merit_zero", s["5"], "P2 gate_select_global on the empty "
          "table", p2("5", "gate_select_global", "empty")),
        c("5.v5_merit_real", s["5"], "K5 (full table, lamS 0)",
          k5("5", "full")),
        # tools/sweep_floor5b.py: one cost family at a time.
        c("5b.f_lane", s["5b"], "K5 on the three lane costs",
          k5("5b", "lane")),
        c("5b.f_nomv", s["5b"], "K5 on the three nominal-speed costs",
          k5("5b", "nomv")),
        c("5b.f_ctrl", s["5b"], "K5 on the six control costs",
          k5("5b", "ctrl")),
        c("5b.f_prox", s["5b"], "K5 on the six proximity constraints "
          "(lamS 0)", k5("5b", "prox")),
        c("5b.f_lane2", s["5b"], "K5 on player index 1's 6-segment lane",
          k5("5b", "lane2")),
        # tools/sweep_floor5c.py: the merit machinery on tiny content.
        c("5c.c1_raw_accum", s["5c"], "P2 raw_nomv (nominal speeds at "
          "compile-time indices, no table)", p2("5c", "raw_nomv"),
          _OUTPUT_REF),
        c("5c.c2_one_nomv", s["5c"], "K5 on one quadratic (player 0's "
          "nominal speed)", k5("5c", "nomv_p0")),
        c("5c.c3_scratch_acc", s["5c"], "P2 gate_select_reg on the "
          "nominal speeds, gate_select_global beside",
          p2("5c", "gate_select_reg", "nomv",
             beside=("gate_select_global",)),
          "a VMEM scratch accumulator is a register here"),
        c("5c.c4_no_gate", s["5c"], "P2 select_global on the nominal "
          "speeds", p2("5c", "select_global", "nomv"), _OUTPUT_REF),
        c("5c.c5_no_where", s["5c"], "P2 gate_hoist_global on the nominal "
          "speeds", p2("5c", "gate_hoist_global", "nomv"),
          "dropping the select is hoisting knot 0 (the TPU case also "
          "added knot 0's state term)"),
        c("5c.c6_novmap_nomv", s["5c"], "K5 on one quadratic (as c2)",
          k5("5c", "nomv_p0"),
          "CUDA has no vmap: every K5 thread runs the content inline, so "
          "c6 is c2"),
        # tools/sweep_floor5d.py: full content; emission.
        c("5d.d1_full_scratch", s["5d"], "K5 (full table, drawn lamS)",
          k5("5d", "full")),
        c("5d.d2_full_output", s["5d"], "P2 gate_select_global (full "
          "table, drawn lamS)", p2("5d", "gate_select_global", "full"),
          _OUTPUT_REF),
        c("5d.d3_emit_direct", s["5d"], "K4 emit_us, C=1",
          k4("5d", "x0c1", emit_us=True)),
        c("5d.d4_emit_scratch", s["5d"], "K4 emit_us, C=1 (as d3)",
          k4("5d", "x0c1", emit_us=True),
          "K4's stores already coalesce over lanes, and one block's "
          "trajectory (22 x 100 x 128 floats = 1.1 MB) does not fit the "
          "228 KB of shared memory, so there is nothing to buffer; "
          "nearest: d3"),
        # tools/sweep_floor5e.py: the fold at full content.
        c("5e.e1_nogate", s["5e"], "P2 select_global (full table)",
          p2("5e", "select_global", "full")),
        c("5e.e2_nowhere", s["5e"], "P2 gate_hoist_global (full table)",
          p2("5e", "gate_hoist_global", "full")),
        c("5e.e3_neither", s["5e"], "P2 hoist_global (full table)",
          p2("5e", "hoist_global", "full")),
        c("5e.e4_multwhere", s["5e"], "P2 gate_mult_global (full table)",
          p2("5e", "gate_mult_global", "full")),
        # tools/sweep_floor5g.py: one state cost on player index 1.
        c("5g.g1_trivial", s["5g"], "P2 raw_x6 (x[6]^2)", p2("5g", "raw_x6"),
          _OUTPUT_REF),
        c("5g.g2_cp", s["5g"], "K5 on player index 1's lane",
          k5("5g", "lane2"),
          "a bare closest-point pair has no device form; nearest: the "
          "real lane cost (g4)"),
        c("5g.g3_onepair", s["5g"], "K5 on player index 1's lane",
          k5("5g", "lane2"),
          "one pair of the lane's scalars has no device form; nearest: "
          "the real lane cost (g4)"),
        c("5g.g4_real", s["5g"], "K5 on player index 1's lane",
          k5("5g", "lane2")),
        c("5g.g5_nomv3", s["5g"], "K5 on three nominal speeds",
          k5("5g", "nomv")),
        c("5g.g6_nomv2", s["5g"], "K5 on two nominal speeds (players 0, "
          "1)", k5("5g", "nomv_p01")),
        # tools/sweep_floor5h.py: inside the polyline query.
        c("5h.h1_seg_arith", s["5h"], "K5 on a 1-segment lane",
          k5("5h", "seg1"),
          "the arithmetic-only projection has no device form; nearest: "
          "the shipped query on one segment"),
        c("5h.h2_clamp_where", s["5h"], "K5 on a 1-segment lane",
          k5("5h", "seg1"),
          "the clamped projection has no device form; nearest: the "
          "shipped query on one segment"),
        c("5h.h3_abs_eq", s["5h"], "K5 on a 1-segment lane",
          k5("5h", "seg1"),
          "nearest: the shipped query on one segment"),
        c("5h.h4_two_seg_min", s["5h"], "K5 on a 2-segment lane",
          k5("5h", "seg2")),
        c("5h.h6_floatmask", s["5h"], "K5 on the 6-segment lane",
          k5("5h", "seg6"), FLOATMASK),
        c("5h.h7_prox", s["5h"], "K5 on one proximity constraint (lamS 0)",
          k5("5h", "prox_p1_p3")),
        # tools/sweep_floor5i.py: emission and the merit over it.
        c("5i.i1_emit4d_c1", s["5i"], "K4 emit_us, C=1", emit5i("i1")),
        c("5i.i2_emit4d_c8", s["5i"], "K4 emit_us, C=8", emit5i("i2")),
        c("5i.i3_emit_flat_c8", s["5i"], "K4 emit_us, C=8 (as i2)",
          emit5i("i3"),
          "the flattened store is a Mosaic layout choice; CUDA has one "
          "layout, so i3 is i2"),
        c("5i.i4_xla_merit", s["5i"], "sweep.merit_plain at C=8, B=1024, "
          "K6 beside", merit5i),
        # tools/sweep_floor5j.py: per-player merit calls.
        c("5j.p1_fm_select", s["5j"], "K5 on player index 1's lane",
          k5("5j", "lane2"), FLOATMASK),
        c("5j.p2_perplayer", s["5j"], "three K5 calls, one player's "
          "content each (drawn lamS rows)", p2_perplayer),
        c("5j.p3_onecall_fm", s["5j"], "K5 (full table, drawn lamS)",
          k5("5j", "full"), FLOATMASK),
        # tools/sweep_floor5k.py: the merit consumer.
        c("5k.m1_meritkernel", s["5k"], "K6", m1),
        c("5k.m2_chain", s["5k"], "K4 emit_us -> K6", m2),
    ]


CASES = _cases()


def run(reps: int = 20, ctx=None):
    """Time every case on the card; yields one dict per case."""
    dev = _probe.require_cuda()
    ctx = ctx or _probe.Context(dev)
    card = _probe.card_line()
    for case in CASES:
        times = [(call.label, _probe.time_ms(call.fn, reps))
                 for call in case.run(ctx)]
        line = {"case": case.key, "replaces": case.replaces,
                "counterpart": case.counterpart, "ms": times[0][1],
                "us_per_knot": times[0][1] * 1e3 / N}
        if len(times) > 1:
            line["beside_ms"] = dict(times[1:])
        if case.note:
            line["note"] = case.note
        line["card"] = card
        yield _probe.emit(line)


def main():
    for _ in run():
        pass


if __name__ == "__main__":
    main()
