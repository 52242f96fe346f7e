"""Batch-level AL + iLQ solver driving the CUDA kernels (counterpart of
ilqgames_tpu/solver/batched.py:55-1057).

The machine mirrors the JAX package's flat per-lane state machine: the
same accept rules, merit carryover across inner solves and AL
bookkeeping, on whole batches. The horizon recursions run as the
hand-written kernels K2/K3 (ops/cuda/lq.py) and K4 (ops/cuda/sweep.py).
With `fuse_stages` (the drivers' default, as in the JAX package),
linearize and quadraticize run as the stage kernel K1 (ops/cuda/stage.py)
from (op, al) every trip, feeding K2 batch-minor, and no quadraticization
is carried; without it they are plain PyTorch over every lane and knot
and the quadraticization is carried. `merit_backend` picks how the
linesearch merits are folded (ops/cuda/sweep.py: plain PyTorch, K5 or
K6).

Where the JAX package decides on device (`while_loop`, `cond` on any()),
the port reads one flag to the host per round: the deep-ladder round
condition, the any-lane reinit condition and the all-done condition of
the driver. `run.last_stats["host_syncs"]` counts those reads.

A constrained game's trip is the flat AL machine's; an unconstrained
game's is a bare iLQ iteration with the full budget, as in the JAX
package. A game with MAX or MIN players carries each lane's extreme knots
(`extreme_ks`, from `pcost.total_costs`, evaluated again on the selected
operating point every trip) and gates those players' state terms with
them in the stage and the merits; a game of SUM players makes no gate and
skips that evaluation, as the JAX package's `_all_sum` does.

With `params.open_loop` the trip solves each lane's open-loop Nash LQ
game (K7, solver/lq_open_loop.py) where the feedback path runs K2/K3;
its stages stay unfused, as in the JAX package, and everything after the
LQ solve (expected decrease, linesearch, reroll) is the feedback path's:
the open-loop strategies are affine laws with P == 0.
"""

from __future__ import annotations

import dataclasses

import torch

from ilqgames_tpu_torch.costs import player_cost as pcost
from ilqgames_tpu_torch.dynamics import base as dyn_base
from ilqgames_tpu_torch.ops.cuda import lq, stage, sweep
from ilqgames_tpu_torch.ops.cuda.layout import mb, pad_batch
from ilqgames_tpu_torch.solver import ilq
from ilqgames_tpu_torch.solver.al import ALResult, constraint_violations, \
    max_constraint_violation
from ilqgames_tpu_torch.solver.fused import _FusedCarry
from ilqgames_tpu_torch.solver.lq_open_loop import solve_lq_open_loop
from ilqgames_tpu_torch.solver.params import SolverParams
from ilqgames_tpu_torch.types import OperatingPoint, QuadraticCosts, \
    Strategy, tree_leaves, tree_map


def new_stats() -> dict:
    """Per-run counters of the host-stepped machine."""
    return {"trips": 0, "host_syncs": 0, "deep_rounds": 0,
            "collapse_exits": 0}


def _host_any(flags: torch.Tensor, stats) -> bool:
    """Read one any() flag to the host (one device sync)."""
    if stats is not None:
        stats["host_syncs"] += 1
    return bool(flags.any().item())


def _host_all(flags: torch.Tensor, stats) -> bool:
    return not _host_any(~flags, stats)


def _bwhere(mask, a, b):
    """Per-lane select over containers with a leading batch axis."""
    def sel(x, y):
        return torch.where(mask.reshape(mask.shape + (1,) * (x.ndim - 1)),
                           x, y)

    return tree_map(sel, a, b)


def _resolve_fuse_for(params: SolverParams, fuse_stages, dyn) -> bool:
    """fuse_stages None -> True (the JAX package's default); False for
    dynamics without analytic Jacobians, which K1 needs, and for open
    loop (the fused stage feeds the feedback LQ kernels only, as in the
    JAX package)."""
    fs = True if fuse_stages is None else bool(fuse_stages)
    if params.open_loop or dyn.ode_jac is None:
        return False
    return fs


def _empty_quad(Bt: int, device) -> QuadraticCosts:
    """Zero-size quadraticization placeholder of the fused-stage machine,
    which recomputes the quadraticization from (op, al) every trip: a
    carried one is never consumed with a stale al, since failed lanes
    always pass through the reinit boundary."""
    z = lambda *s: torch.zeros((Bt,) + s, device=device)
    return QuadraticCosts(Q=z(0, 0, 0, 0), l=z(0, 0, 0), R=z(0, 0, 0, 0, 0),
                          r=z(0, 0, 0, 0))


def _expected_decrease_bm(spec, ops: dict, al_r, dxs):
    """`ilq._expected_decrease` from the batch-minor stage and LQ arrays
    (ops, al_r [ns, Pu, B], dxs [N, x, B]): [B]. The same left folds and
    the same `ilq._fixed_order_sum` over the same (knot, player, index)
    order as the batch-major form, with the strategy's zero terminal row,
    so both give the same bits on every device."""
    N, P, x, u = spec.num_time_steps, spec.num_players, spec.xdim, spec.umax
    B = dxs.shape[-1]
    R6 = ops["Rf"].reshape(N, P, P, u, u, B)
    r5 = ops["rf"].reshape(N, P, P, u, B)
    R_ii = torch.stack([R6[:, i, i] for i in range(P)], 1)   # [N,P,u,u,B]
    r_ii = torch.stack([r5[:, i, i] for i in range(P)], 1)   # [N,P,u,B]
    Rr = R_ii[:, :, :, 0] * r_ii[:, :, 0, None]              # [N,P,u,B]
    for v in range(1, u):
        Rr = Rr + R_ii[:, :, :, v] * r_ii[:, :, v, None]
    Q6 = ops["Qf"].reshape(N, P, x, x, B)
    l5 = ops["lf"].reshape(N, P, x, B)
    Ql = Q6[1:, :, :, 0] * l5[1:, :, 0, None]                # [N-1,P,x,B]
    for y in range(1, x):
        Ql = Ql + Q6[1:, :, :, y] * l5[1:, :, y, None]
    alphas = torch.cat([al_r, al_r.new_zeros((1,) + al_r.shape[1:])])
    control = ilq._fixed_order_sum(
        (alphas.reshape(N, P, u, B) * Rr).reshape(-1, B).T)
    state = ilq._fixed_order_sum((dxs[1:, None] * Ql).reshape(-1, B).T)
    return -control - state


def iteration_step_batched(dyn, player_costs, spec, params, x0, al_state, c,
                           *, active=None, batch_block=128, stats=None,
                           fuse_stages=False, merit_backend="xla"):
    """ONE iLQ iteration for a whole batch (the batch-level twin of
    ilq.iteration_step). `active` ([Bt] bool) marks lanes whose results the
    caller keeps; lanes outside it cannot force deep-ladder rounds.
    `fuse_stages`: linearize and quadraticize through K1 from (c.op,
    al_state) and keep the operands batch-minor; `c.quad` is not read.
    Open loop (`params.open_loop`) takes unfused stages only, as in the
    JAX package."""
    if params.open_loop and fuse_stages:
        raise ValueError(
            "fuse_stages supports feedback LQ only; open-loop problems run "
            "the open-loop LQ kernel on unfused stages (fuse_stages=False)")
    Bt = x0.shape[0]
    dev = x0.device
    last_op = c.op
    Bb = batch_block
    all_sum = pcost.all_sum(player_costs)
    gate = None if all_sum else pcost.extreme_gate(player_costs, spec,
                                                  c.extreme_ks)

    def extremes_of(op):
        """The extreme knots of an operating point (the carry's where
        every player is SUM: then they are all 0)."""
        return (c.extreme_ks if all_sum else
                pcost.total_costs(player_costs, spec, op)[1])

    if fuse_stages:
        N, P, um, xd = (spec.num_time_steps, spec.num_players, spec.umax,
                        spec.xdim)
        op_bm, x0m = sweep._prep_op(spec, x0, last_op, Bb)
        lamS, lamC, mu_bm, gate_bm = sweep._prep_al(spec, al_state, gate, Bb)
        ops = stage.lin_quad(dyn, player_costs, spec, op_bm, lamS, lamC,
                             mu_bm, gate_bm)
        Ps_r, al_r, dxs = lq.solve_lq_feedback_bm(
            spec, ops, x0m - op_bm["xs"][0],
            adaptive_regularization=params.adaptive_regularization)
        st_bm = {"Ps": torch.cat([Ps_r, Ps_r.new_zeros((1,) + Ps_r.shape[1:])]),
                 "alphas": torch.cat([al_r,
                                      al_r.new_zeros((1,) + al_r.shape[1:])])}
        expected_decrease = _expected_decrease_bm(spec, ops, al_r, dxs)[:Bt]
        lq_strategy = Strategy(
            Ps=mb(st_bm["Ps"], Bt).reshape(Bt, N, P, um, xd),
            alphas=mb(st_bm["alphas"], Bt).reshape(Bt, N, P, um))

        def sweep_chunk_fn(scal_c):
            scal_cb = scal_c[:, None].expand(-1, x0m.shape[-1]).contiguous()
            m = sweep.sweep_merits_bm(dyn, player_costs, spec, x0m, op_bm,
                                      st_bm, scal_cb, lamS, lamC, mu_bm,
                                      merit_backend, gate_bm)
            return m[:, :Bt].T

        def sweep_compact_fn(sel, scal_w):
            # Gather the selected lanes (the last axis) into one block;
            # scal_w [Bc, CD] gives each gathered lane its own window.
            g = lambda a: None if a is None else a[..., sel]
            m = sweep.sweep_merits_bm(
                dyn, player_costs, spec, g(x0m),
                {k: g(v) for k, v in op_bm.items()},
                {k: g(v) for k, v in st_bm.items()}, scal_w.T.contiguous(),
                g(lamS), g(lamC), g(mu_bm), merit_backend, g(gate_bm))
            return m.T

        def reroll_fn(scal_lane):
            scal_cb = pad_batch(scal_lane[None], Bb).contiguous()
            xs_r, us_r = sweep.rollout_bm(dyn, spec, x0m, op_bm, st_bm,
                                          scal_cb, emit_us=True)
            return OperatingPoint(
                xs=mb(xs_r[:, :, 0], Bt),
                us=mb(us_r[:, :, 0], Bt).reshape(Bt, N, P, um), t0=last_op.t0)

        quad_of = lambda op: _empty_quad(Bt, dev)
    else:
        lin = dyn_base.linearize(dyn, spec, c.op)
        if params.open_loop:
            lqsol = solve_lq_open_loop(spec, lin, c.quad, x0 - c.op.xs[:, 0],
                                       batch_block=batch_block)
        else:
            lqsol = lq.solve_lq_feedback(
                spec, lin, c.quad, x0 - c.op.xs[:, 0],
                adaptive_regularization=params.adaptive_regularization,
                batch_block=batch_block)
        expected_decrease = ilq._expected_decrease(
            spec, c.quad, lqsol.strategy.alphas, lqsol.delta_xs)
        lq_strategy = lqsol.strategy

        def sweep_chunk_fn(scal_c):
            return sweep.sweep_merits(dyn, player_costs, spec, x0, last_op,
                                      lq_strategy, scal_c, al_state,
                                      batch_block=batch_block,
                                      merit_backend=merit_backend, gate=gate)

        def sweep_compact_fn(sel, scal_w):
            # Gather the selected lanes into one block; scal_w [Bc, CD]
            # gives each gathered lane its own candidate window.
            g = lambda t: tree_map(lambda a: a[sel], t)
            return sweep.sweep_merits(dyn, player_costs, spec, x0[sel],
                                      g(last_op), g(lq_strategy), scal_w,
                                      g(al_state), batch_block=sel.shape[0],
                                      merit_backend=merit_backend,
                                      gate=None if gate is None else gate[sel])

        def reroll_fn(scal_lane):
            return sweep.rollout(dyn, spec, x0, last_op, lq_strategy,
                                 scal=scal_lane, batch_block=batch_block)

        # The selected operating point is quadraticized with the carry's
        # gate, as the JAX package's `quad_of` does.
        quad_of = lambda op: pcost.quadraticize(player_costs, spec, op,
                                                al_state, gate=gate)

    if not params.linesearch:
        # The full step at the initial scaling, taken on every lane, and
        # its quadraticization with the trial point's own gate.
        scal = torch.full((Bt,), params.initial_alpha_scaling, device=dev)
        trial_op = reroll_fn(scal)
        extreme_ks = extremes_of(trial_op)
        quad = (_empty_quad(Bt, dev) if fuse_stages else pcost.quadraticize(
            player_costs, spec, trial_op, al_state,
            gate=None if all_sum else pcost.extreme_gate(
                player_costs, spec, extreme_ks)))
        return c.replace(
            op=trial_op,
            strategy=lq_strategy.scale_alphas(params.initial_alpha_scaling),
            quad=quad, extreme_ks=extreme_ks, iteration=c.iteration + 1)

    n_cand = params.max_backtracking_steps
    scalings = params.initial_alpha_scaling * (
        params.geometric_alpha_scaling
        ** torch.arange(n_cand, dtype=torch.float32, device=dev))

    # Two-phase linesearch ladder with the reference's first-Armijo-pass
    # selection: unevaluated merits stay +inf and never pass, so
    # evaluating extra candidates for any lane never changes its choice.
    cap = params.linesearch_eval_cap
    n_eval = min(n_cand, cap) if cap > 0 else n_cand
    C1 = min(params.linesearch_chunk, n_eval)
    CD = min(params.linesearch_deep_chunk, n_eval)
    n_deep = -(-max(n_eval - C1, 0) // CD)
    Cp = C1 + n_deep * CD
    scal_full = torch.cat([scalings[:n_eval],
                           scalings[n_eval - 1].expand(Cp - n_eval)])

    def armijo(merits, scal_c):
        return ((c.last_merit[:, None] - merits)
                >= params.expected_decrease_fraction * scal_c[None, :]
                * expected_decrease[:, None])

    def unhappy_of(buf):
        u = ~armijo(buf, scal_full).any(1)
        return u if active is None else u & active

    # Phase 1: the first chunk, full batch.
    buf = torch.full((Bt, Cp), torch.inf, device=dev)
    buf[:, :C1] = sweep_chunk_fn(scal_full[:C1])

    if n_deep > 0:
        # Compact deep ladder with per-lane windows: each round gathers up
        # to Bc unhappy lanes, smallest next-candidate offset first, and
        # evaluates each one's own next CD candidates.
        Bc = min(batch_block, Bt)
        nxt = torch.full((Bt,), C1, dtype=torch.int64, device=dev)
        window = torch.arange(CD, device=dev)
        cols = torch.arange(Cp, device=dev)[None, :]
        exits = torch.zeros((), dtype=torch.int64, device=dev)
        while True:
            u = unhappy_of(buf) & (nxt < Cp)
            if not _host_any(u, stats):
                break
            key = torch.where(u, nxt, Cp + 1)
            sel = torch.argsort(key, stable=True)[:Bc]
            offs = nxt[sel]
            # Windows clamp at the ladder end (re-evaluating identical
            # tail merits), as dynamic_slice does.
            idx = offs.clamp(0, Cp - CD)[:, None] + window      # [Bc, CD]
            m_c = sweep_compact_fn(sel, scal_full[idx])
            rows = buf[sel].scatter(1, idx, m_c)
            if CD >= 2:
                # f32-collapse exit: a lane whose whole window came back
                # bitwise-uniform is in the frozen regime of the ladder;
                # fill the rest of its ladder with that value and stop.
                uniform = (m_c == m_c[:, :1]).all(1)
                fill = uniform[:, None] & (cols >= (offs + CD)[:, None])
                rows = torch.where(fill, m_c[:, -1:], rows)
                nxt_new = torch.where(uniform, Cp, offs + CD)
                exits = exits + (u[sel] & uniform & (offs + CD < Cp)).sum()
            else:
                nxt_new = offs + CD
            buf[sel] = rows
            nxt[sel] = nxt_new
            if stats is not None:
                stats["deep_rounds"] += 1
        if stats is not None:
            stats["collapse_exits"] = stats["collapse_exits"] + exits

    # Extend the evaluated merits across the full ladder (constant past
    # n_eval) and apply Armijo with every candidate's own threshold.
    merits_full = torch.cat(
        [buf[:, :n_eval], buf[:, n_eval - 1:n_eval].expand(Bt, n_cand - n_eval)],
        dim=1)
    ok = armijo(merits_full, scalings)
    passed = ok.any(1)
    idx = ok.to(torch.int8).argmax(1)
    scal_sel = torch.where(passed, scalings[idx], scalings[0])
    merit_sel = torch.where(passed, merits_full.gather(1, idx[:, None])[:, 0],
                            c.last_merit)

    strategy_sel = lq_strategy.replace(
        alphas=lq_strategy.alphas * scal_sel[:, None, None, None])
    op_sel = reroll_fn(scal_sel)
    quad_sel = quad_of(op_sel)

    converged = passed & (merit_sel <= c.last_merit) & (
        torch.abs(c.last_merit - merit_sel) < params.convergence_tolerance)
    return ilq._SolveCarry(
        op=_bwhere(passed, op_sel, c.op),
        strategy=_bwhere(passed, strategy_sel, c.strategy),
        quad=_bwhere(passed, quad_sel, c.quad),
        extreme_ks=(c.extreme_ks if all_sum else
                    _bwhere(passed, extremes_of(op_sel), c.extreme_ks)),
        last_merit=torch.where(passed, merit_sel, c.last_merit),
        iteration=c.iteration + 1,
        converged=converged,
        failed=~passed,
    )


def _init_inner_batched(dyn, player_costs, spec, x0, op, strategy, al,
                        last_merit, *, batch_block, fuse_stages=False):
    """Batched ILQSolver::Solve initialization: roll out from the warm
    start, find its extreme knots (0 where every player is SUM) and
    quadraticize at the current multipliers (not carried under
    `fuse_stages`)."""
    Bt = x0.shape[0]
    xs = op.xs.clone()
    xs[:, 0] = x0
    current_op = sweep.rollout(dyn, spec, x0, op.replace(xs=xs), strategy,
                               batch_block=batch_block)
    if pcost.all_sum(player_costs):
        extreme_ks = torch.zeros((Bt, spec.num_players), dtype=torch.int32,
                                 device=x0.device)
        gate = None
    else:
        extreme_ks = pcost.total_costs(player_costs, spec, current_op)[1]
        gate = pcost.extreme_gate(player_costs, spec, extreme_ks)
    quad = (_empty_quad(Bt, x0.device) if fuse_stages else
            pcost.quadraticize(player_costs, spec, current_op, al, gate=gate))
    zi = torch.zeros((Bt,), dtype=torch.int32, device=x0.device)
    zb = torch.zeros((Bt,), dtype=torch.bool, device=x0.device)
    return ilq._SolveCarry(
        op=current_op, strategy=strategy, quad=quad, extreme_ks=extreme_ks,
        last_merit=last_merit, iteration=zi, converged=zb, failed=zb)


def _trip_batched(dyn, player_costs, spec, params, x0, fc, *, batch_block,
                  stats=None, fuse_stages=False, merit_backend="xla"):
    """One trip of the flat machine, batch-level (twin of fused._trip)."""
    c2 = iteration_step_batched(
        dyn, player_costs, spec, params, x0, fc.al, fc.c, active=~fc.done,
        batch_block=batch_block, stats=stats, fuse_stages=fuse_stages,
        merit_backend=merit_backend)
    inner_iters = fc.inner_iters + 1
    cum_iters = fc.cum_iters + 1
    inner_end = c2.converged | c2.failed | (
        inner_iters >= params.unconstrained_solver_max_iters)
    inner_ok = ~c2.failed

    al_pre = fc.al
    down = lambda lam: lam * params.geometric_lambda_downscaling
    al_failed = al_pre.replace(
        state_lambdas=tuple(down(l) for l in al_pre.state_lambdas),
        control_lambdas=tuple(down(l) for l in al_pre.control_lambdas),
        mu=al_pre.mu * params.geometric_mu_downscaling,
    )
    al_base = _bwhere(c2.failed, al_failed, al_pre)

    continuing = (cum_iters < params.max_solver_iters) & (
        fc.violation > params.constraint_error_tolerance)
    done_now = inner_end & ~continuing

    adv = inner_end & inner_ok
    warm_op = _bwhere(adv, c2.op, fc.warm_op)
    warm_strategy = _bwhere(adv, c2.strategy, fc.warm_strategy)

    # The AL update + inner re-initialization only matters on trips where
    # some lane crosses an inner-solve boundary.
    reinit = inner_end & continuing
    if _host_any(reinit, stats):
        al_inc, violation_new = constraint_violations(
            player_costs, spec, c2.op, al_base)
        al_inc = al_inc.replace(mu=al_inc.mu * params.geometric_mu_scaling)
        c3 = _init_inner_batched(
            dyn, player_costs, spec, x0, warm_op, warm_strategy, al_inc,
            c2.last_merit, batch_block=batch_block, fuse_stages=fuse_stages)
    else:
        c3, al_inc, violation_new = c2, fc.al, fc.violation

    return _FusedCarry(
        c=_bwhere(reinit, c3, c2),
        al=_bwhere(reinit, al_inc, _bwhere(c2.failed, al_failed, fc.al)),
        warm_op=warm_op,
        warm_strategy=warm_strategy,
        inner_iters=torch.where(reinit, 0, inner_iters),
        cum_iters=cum_iters,
        violation=torch.where(reinit, violation_new, fc.violation),
        success=fc.success & torch.where(inner_end, inner_ok, True),
        done=fc.done | done_now,
    )


def _trip_unconstrained(dyn, player_costs, spec, params, x0, fc, *,
                        batch_block, stats=None, fuse_stages=False,
                        merit_backend="xla"):
    """One trip of an unconstrained game: a bare iLQ iteration with the
    full budget (counterpart of the JAX package's unconstrained trip,
    batched.py:689-709)."""
    c2 = iteration_step_batched(
        dyn, player_costs, spec, params, x0, fc.al, fc.c, active=~fc.done,
        batch_block=batch_block, stats=stats, fuse_stages=fuse_stages,
        merit_backend=merit_backend)
    cum = fc.cum_iters + 1
    done_now = c2.converged | c2.failed | (cum >= params.max_solver_iters)
    return fc.replace(c=c2, cum_iters=cum, success=fc.success & ~c2.failed,
                      done=fc.done | done_now)


def _carry0(dyn, player_costs, spec, x0_b, wop_b, wst_b, al_b, batch_block,
            fuse_stages=False):
    Bt = x0_b.shape[0]
    dev = x0_b.device
    c0 = _init_inner_batched(
        dyn, player_costs, spec, x0_b, wop_b, wst_b, al_b,
        torch.full((Bt,), torch.inf, device=dev), batch_block=batch_block,
        fuse_stages=fuse_stages)
    return _FusedCarry(
        c=c0, al=al_b, warm_op=c0.op, warm_strategy=c0.strategy,
        inner_iters=torch.zeros((Bt,), dtype=torch.int32, device=dev),
        cum_iters=torch.zeros((Bt,), dtype=torch.int32, device=dev),
        violation=torch.full((Bt,), torch.inf, device=dev),
        success=torch.ones((Bt,), dtype=torch.bool, device=dev),
        done=torch.zeros((Bt,), dtype=torch.bool, device=dev),
    )


def _pad_args(args, m):
    """Pad every arg's leading batch dim up to a multiple of m by
    replicating lane 0 (a real instance: zero padding could spin the
    loop on lanes that never finish)."""
    Bt = tree_leaves(args[0])[0].shape[0]
    Bp = -(-Bt // m) * m
    if Bp == Bt:
        return args, Bt
    pad1 = lambda a: torch.cat(
        [a, a[:1].expand((Bp - Bt,) + a.shape[1:])])
    return tuple(tree_map(pad1, a) for a in args), Bt


def _driver_parts(dyn, player_costs, spec, params, batch_block,
                  fuse_stages=False, merit_backend="xla"):
    """(trip, finalize): the masked trip and the result assembly shared by
    the host-stepped drivers. The trip is the AL machine's for a
    constrained game and a bare iLQ iteration otherwise, as in the JAX
    package's `_driver_parts`; a game without constraints has max
    violation -inf and converges when its last iteration did without
    failing."""
    constrained = pcost.is_constrained(player_costs)
    one_trip = _trip_batched if constrained else _trip_unconstrained

    def trip(x0_b, fc, stats=None):
        fc2 = one_trip(dyn, player_costs, spec, params, x0_b, fc,
                       batch_block=batch_block, stats=stats,
                       fuse_stages=fuse_stages, merit_backend=merit_backend)
        return _bwhere(fc.done, fc, fc2)

    def finalize(fc):
        fv = max_constraint_violation(player_costs, spec, fc.c.op)
        totals, _ = pcost.total_costs(player_costs, spec, fc.c.op)
        if constrained:
            conv = fc.success & (fv <= params.constraint_error_tolerance)
        else:
            conv = fc.c.converged & ~fc.c.failed
        return ALResult(
            op=fc.c.op, strategy=fc.c.strategy, total_costs=totals,
            converged=conv, max_violation=fv,
            cumulative_iterations=fc.cum_iters, al_state=fc.al)

    return trip, finalize


def _fresh_init(dyn, player_costs, spec, warm_op, warm_strategy, batch_block,
                fuse_stages):
    """init(x0_b) -> the carry of a fresh solve of every lane of x0_b."""
    if warm_op is None:
        warm_op = OperatingPoint.zeros(spec)
    if warm_strategy is None:
        warm_strategy = Strategy.zeros(spec)

    def init(x0_b):
        Bt = x0_b.shape[0]
        dev = x0_b.device
        al0 = pcost.ALState.init(player_costs, spec, Bt, device=dev)
        bc = lambda t: tree_map(
            lambda a: a.to(dev)[None].expand((Bt,) + a.shape).contiguous(), t)
        return _carry0(dyn, player_costs, spec, x0_b, bc(warm_op),
                       bc(warm_strategy), al0, batch_block, fuse_stages)

    return init


def _make_driver(trip, finalize, init, trips_per_call, batch_block):
    """The host-stepped driver shared by the plain and the warm solver
    (counterpart of the JAX package's `_make_driver`): pad every argument
    to `batch_block` lanes, `init(*args)` (args[0] is x0), then dispatches
    of at most `trips_per_call` masked trips until every lane is done.
    JAX ends a dispatch early on the device once every lane is done; the
    port reads that flag to the host after each trip, so neither the
    trips nor the results depend on `trips_per_call`: only the count of
    dispatches does."""

    def run(*args):
        stats = dict(new_stats(), dispatches=0)
        args, Bt = _pad_args(args, batch_block)
        x0p = args[0]
        fc = init(*args)
        done = _host_all(fc.done, stats)
        while not done:
            stats["dispatches"] += 1
            for _ in range(trips_per_call):
                fc = trip(x0p, fc, stats)
                stats["trips"] += 1
                done = _host_all(fc.done, stats)
                if done:
                    break
        out = finalize(fc)
        stats["collapse_exits"] = int(stats["collapse_exits"])
        run.last_stats = stats
        return tree_map(lambda a: a[:Bt], out)

    run.last_stats = None
    return run


def make_host_batched_solver(dyn, player_costs, spec, params,
                             warm_op=None, warm_strategy=None,
                             trips_per_call: int = 25,
                             batch_block: int = 128, fuse_stages=None,
                             merit_backend: str = "xla"):
    """Batched solve stepped from the host: fn(x0 [B, xdim]) -> batched
    ALResult, on x0's device, every lane started from the same warm start
    and fresh multipliers. Each trip advances every unfinished lane by one
    iLQ iteration; a dispatch runs at most `trips_per_call` trips, and the
    host reads one all-done flag per trip. `fuse_stages` None means True
    (K1), as in the JAX package. After a call, `fn.last_stats` holds the
    run's counters (trips, dispatches, host syncs, deep-ladder rounds,
    f32-collapse exits)."""
    fuse_stages = _resolve_fuse_for(params, fuse_stages, dyn)
    trip, finalize = _driver_parts(dyn, player_costs, spec, params,
                                   batch_block, fuse_stages, merit_backend)
    init = _fresh_init(dyn, player_costs, spec, warm_op, warm_strategy,
                       batch_block, fuse_stages)
    return _make_driver(trip, finalize, init, trips_per_call, batch_block)


def make_host_batched_warm_solver(dyn, player_costs, spec, params,
                                  trips_per_call: int = 25,
                                  batch_block: int = 128, fuse_stages=None,
                                  merit_backend: str = "xla"):
    """Warm-started batched solve (counterpart of the JAX package's
    make_host_batched_warm_solver): fn(x0 [B, xdim], warm_op,
    warm_strategy, al_state), all batched, -> ALResult on x0's device.
    Each lane starts from its own operating point (with its own t0),
    strategy and multipliers; the AL bookkeeping goes on from the given
    state. The receding-horizon replanning path
    (runtime/receding_horizon.simulate_batched). Driver and counters as
    make_host_batched_solver's."""
    fuse_stages = _resolve_fuse_for(params, fuse_stages, dyn)
    trip, finalize = _driver_parts(dyn, player_costs, spec, params,
                                   batch_block, fuse_stages, merit_backend)

    def init(x0_b, wop_b, wst_b, al_b):
        return _carry0(dyn, player_costs, spec, x0_b, wop_b, wst_b, al_b,
                       batch_block, fuse_stages)

    return _make_driver(trip, finalize, init, trips_per_call, batch_block)


def make_host_ilq_solver(dyn, player_costs, spec, params,
                         max_iterations=None, record_history: bool = False,
                         trips_per_call: int = 25, batch_block: int = 128,
                         fuse_stages=None, merit_backend: str = "xla"):
    """Bare iLQ solve stepped from the host (the batched counterpart of
    the JAX package's ilq.solve, ilq.py:287-340, which Problem's
    solve_unconstrained and solve_logged run): fn(x0 [B, xdim], warm_op,
    warm_strategy, al_state), all batched, -> ilq.ILQResult on x0's
    device. Constraints enter only through their AL terms at the given
    multipliers, which no trip updates: every game takes the unconstrained
    game's trip (`_trip_unconstrained`), a lane ending when it converges,
    its linesearch fails or it has taken `max_iterations` iterations
    (default params.max_solver_iters). With `record_history` the result's
    `history` holds each lane's initial rollout and, per trip, its carry
    after the trip (masked past its end, a failed step's reverted iterate
    included) and whether it was active, as the JAX package's scan
    records them: kept on the device and stacked once, after the last
    trip. Driver and counters as make_host_batched_solver's."""
    budget = (params.max_solver_iters if max_iterations is None
              else max_iterations)
    prm = dataclasses.replace(params, max_solver_iters=budget)
    fuse_stages = _resolve_fuse_for(prm, fuse_stages, dyn)
    record = []

    def entry(fc_before, fc_after):
        c = fc_after.c
        return (c.op, c.strategy, c.last_merit, c.converged, c.failed,
                ~fc_before.done)

    def init(x0_b, wop_b, wst_b, al_b):
        fc = _carry0(dyn, player_costs, spec, x0_b, wop_b, wst_b, al_b,
                     batch_block, fuse_stages)
        fc = fc.replace(done=fc.cum_iters >= budget)
        record[:] = [fc.c.op]
        return fc

    def trip(x0_b, fc, stats=None):
        fc2 = _trip_unconstrained(dyn, player_costs, spec, prm, x0_b, fc,
                                  batch_block=batch_block, stats=stats,
                                  fuse_stages=fuse_stages,
                                  merit_backend=merit_backend)
        fc2 = _bwhere(fc.done, fc, fc2)
        if record_history:
            record.append(entry(fc, fc2))
        return fc2

    def finalize(fc):
        history = ()
        if record_history:
            rows = record[1:]
            trips = (tree_map(lambda *a: torch.stack(a, 1), *rows) if rows
                     else tree_map(lambda a: a[:, None][:, :0],
                                   entry(fc, fc)))
            history = (record[0],) + trips
        record.clear()
        return ilq.ILQResult(
            op=fc.c.op, strategy=fc.c.strategy,
            total_costs=pcost.total_costs(player_costs, spec, fc.c.op)[0],
            converged=fc.c.converged, failed=fc.c.failed,
            num_iterations=fc.c.iteration, merit=fc.c.last_merit,
            history=history)

    return _make_driver(trip, finalize, init, trips_per_call, batch_block)


def _to_device(a, dev) -> torch.Tensor:
    """A host index array on `dev`, copied without waiting for the
    card's queue to drain (from pinned memory)."""
    t = torch.from_numpy(a)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t


def make_host_batched_queue_solver(dyn, player_costs, spec, params,
                                   warm_op=None, warm_strategy=None,
                                   device_batch: int = 1024,
                                   trips_per_call: int = 10,
                                   batch_block: int = 128,
                                   harvest_block=None, fuse_stages=None,
                                   merit_backend: str = "xla"):
    """Wave-refill batched solve (counterpart of the JAX package's
    make_host_batched_queue_solver): keeps `device_batch` lanes busy by
    harvesting finished lanes and refilling them from the pending
    instances, so the batch does not idle behind its slowest lanes.
    fn(x0 [B_total, xdim]) -> ALResult for all instances, in order, on
    x0's device.

    Per-instance results are bitwise equal to make_host_batched_solver's:
    the trip is the same (_driver_parts), every kernel and plain op is
    lane-elementwise (lanes meet only in the selection-invariant packing
    of the deep ladder and the any-lane reinit branch), and a refilled
    lane starts exactly as lane 0 of a fresh solve.

    Mechanics:
    - each dispatch runs `trips_per_call` masked trips, and then reads
      `done` once; between reads the host tracks it;
    - harvest/refill goes in chunks of `harvest_block` lanes (default
      `batch_block`): finalize the chunk's lanes, write their results
      into a device-resident result buffer (in place), start the next
      pending instances in those lanes, and retire as done the lanes
      with no pending instance left. Ragged final chunks are padded
      with duplicate lanes, which rewrite the same rows;
    - once no instance is pending, the batch is compacted to half its
      size while the active lanes fit.
    After a call, `fn.last_stats` holds dispatches, harvests,
    compactions, done_per_dispatch and the trip counters of
    make_host_batched_solver."""
    import numpy as np

    fuse_stages = _resolve_fuse_for(params, fuse_stages, dyn)
    trip, finalize = _driver_parts(dyn, player_costs, spec, params,
                                   batch_block, fuse_stages, merit_backend)
    init = _fresh_init(dyn, player_costs, spec, warm_op, warm_strategy,
                       batch_block, fuse_stages)
    H = batch_block if harvest_block is None else harvest_block

    def put_rows(dst, idx, src):
        tree_map(lambda d, s_: d.index_put_((idx,), s_), dst, src)

    def run(x0_all):
        dev = x0_all.device
        stats = dict(new_stats(), dispatches=0, harvests=0, compactions=0,
                     done_per_dispatch=[])
        Btot = x0_all.shape[0]
        D = min(-(-device_batch // H) * H, -(-Btot // H) * H)
        n0 = min(D, Btot)
        slot_inst = np.full((D,), -1, np.int64)
        slot_inst[:n0] = np.arange(n0)
        x0d = torch.cat([x0_all[:n0],
                         x0_all[:1].expand(D - n0, x0_all.shape[1])])
        next_i = n0
        harvested = np.zeros((Btot,), bool)
        fc = init(x0d)
        if D > n0:
            fc.done[n0:] = True
        buf = None

        while not harvested.all():
            for _ in range(trips_per_call):
                fc = trip(x0d, fc, stats)
                stats["trips"] += 1
            stats["dispatches"] += 1
            stats["host_syncs"] += 1
            done = fc.done.cpu().numpy().copy()
            stats["done_per_dispatch"].append(int(done.sum()))
            while True:
                elig = np.nonzero(done & (slot_inst >= 0))[0]
                pending = next_i < Btot
                # Full chunks while instances remain; ragged chunks only
                # in the final drain, where every harvested lane retires.
                if not (len(elig) >= H or (not pending and len(elig))):
                    break
                lanes = elig[:H]
                n = len(lanes)
                inst = slot_inst[lanes]
                k = min(n, Btot - next_i)
                keep = np.zeros((H,), bool)
                keep[:k] = True
                fill = np.zeros((H,), np.int64)
                fill[:k] = np.arange(next_i, next_i + k)
                next_i += k
                pad = lambda a: np.concatenate([a, np.full(H - n, a[0])])
                idx = _to_device(np.stack(
                    [pad(lanes), pad(inst), fill, keep.astype(np.int64)]),
                    dev)
                lanes_d, inst_d, fill_d, keep_d = idx[0], idx[1], idx[2], \
                    idx[3].bool()
                res = finalize(tree_map(lambda a: a[lanes_d], fc))
                if buf is None:
                    buf = tree_map(
                        lambda a: a.new_zeros((Btot,) + a.shape[1:]), res)
                put_rows(buf, inst_d, res)
                x0_new = x0_all[fill_d]
                new_fc = init(x0_new)
                put_rows(fc, lanes_d, new_fc)
                fc.done[lanes_d] = ~keep_d
                x0d[lanes_d] = x0_new
                stats["harvests"] += 1
                harvested[inst] = True
                slot_inst[lanes] = np.where(keep[:n], fill[:n], -1)
                done[lanes] = ~keep[:n]
            # Drain compaction: with no instance pending, gather the
            # active lanes into half the batch while they fit.
            if next_i >= Btot:
                while D > batch_block:
                    active_idx = np.nonzero(~done)[0]
                    newD = D // 2
                    if (newD < batch_block or newD % batch_block
                            or len(active_idx) > newD):
                        break
                    fill_idx = np.nonzero(done)[0][:newD - len(active_idx)]
                    perm = np.concatenate([active_idx, fill_idx])
                    perm_d = _to_device(perm, dev)
                    fc = tree_map(lambda a: a[perm_d], fc)
                    x0d = x0d[perm_d]
                    slot_inst = slot_inst[perm]
                    done = done[perm]
                    D = newD
                    stats["compactions"] += 1
        stats["collapse_exits"] = int(stats["collapse_exits"])
        run.last_stats = stats
        return buf

    run.last_stats = None
    return run
