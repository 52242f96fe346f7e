"""Batch-level AL + iLQ solver driving the CUDA kernels (counterpart of
ilqgames_tpu/solver/batched.py:55-847 under `fuse_stages=False`).

The machine mirrors the JAX package's flat per-lane state machine: the
same accept rules, merit carryover across inner solves and AL
bookkeeping, on whole batches. Linearize and quadraticize are plain
PyTorch over every lane and knot; the horizon recursions run as the
hand-written kernels K2/K3 (ops/cuda/lq.py) and K4 (ops/cuda/sweep.py).

Where the JAX package decides on device (`while_loop`, `cond` on any()),
the port reads one flag to the host per round: the deep-ladder round
condition, the any-lane reinit condition and the all-done condition of
the driver. `run.last_stats["host_syncs"]` counts those reads.

Only the feedback-Nash, linesearch-on, constrained, SUM-structure
configuration of the flagship is ported; the others raise.
"""

from __future__ import annotations

import torch

from ilqgames_tpu_torch.costs import player_cost as pcost
from ilqgames_tpu_torch.dynamics import base as dyn_base
from ilqgames_tpu_torch.ops.cuda import lq, sweep
from ilqgames_tpu_torch.solver import ilq
from ilqgames_tpu_torch.solver.al import ALResult, constraint_violations, \
    max_constraint_violation
from ilqgames_tpu_torch.solver.fused import _FusedCarry
from ilqgames_tpu_torch.solver.params import SolverParams
from ilqgames_tpu_torch.types import OperatingPoint, Strategy, tree_leaves, \
    tree_map


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


def _check_supported(player_costs, params: SolverParams):
    pcost.check_structures(player_costs)
    if params.open_loop:
        raise NotImplementedError("open-loop Nash is not ported yet")
    if not params.linesearch:
        raise NotImplementedError("linesearch=False is not ported yet")
    if not pcost.is_constrained(player_costs):
        raise NotImplementedError(
            "unconstrained problems are not ported yet (the flat AL machine "
            "runs constrained problems only)")


def iteration_step_batched(dyn, player_costs, spec, params, x0, al_state, c,
                           *, active=None, batch_block=128, stats=None):
    """ONE iLQ iteration for a whole batch (the batch-level twin of
    ilq.iteration_step). `active` ([Bt] bool) marks lanes whose results the
    caller keeps; lanes outside it cannot force deep-ladder rounds."""
    _check_supported(player_costs, params)
    Bt = x0.shape[0]
    dev = x0.device
    last_op = c.op

    lin = dyn_base.linearize(dyn, spec, c.op)
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
                                  batch_block=batch_block)

    def sweep_compact_fn(sel, scal_w):
        # Gather the selected lanes into one block; scal_w [Bc, CD] gives
        # each gathered lane its own candidate window.
        g = lambda t: tree_map(lambda a: a[sel], t)
        return sweep.sweep_merits(dyn, player_costs, spec, x0[sel],
                                  g(last_op), g(lq_strategy), scal_w,
                                  g(al_state), batch_block=sel.shape[0])

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
    op_sel = sweep.rollout(dyn, spec, x0, last_op, lq_strategy,
                           scal=scal_sel, batch_block=batch_block)
    quad_sel = pcost.quadraticize(player_costs, spec, op_sel, al_state)

    converged = passed & (merit_sel <= c.last_merit) & (
        torch.abs(c.last_merit - merit_sel) < params.convergence_tolerance)
    return ilq._SolveCarry(
        op=_bwhere(passed, op_sel, c.op),
        strategy=_bwhere(passed, strategy_sel, c.strategy),
        quad=_bwhere(passed, quad_sel, c.quad),
        extreme_ks=c.extreme_ks,
        last_merit=torch.where(passed, merit_sel, c.last_merit),
        iteration=c.iteration + 1,
        converged=converged,
        failed=~passed,
    )


def _init_inner_batched(dyn, player_costs, spec, x0, op, strategy, al,
                        last_merit, *, batch_block):
    """Batched ILQSolver::Solve initialization: roll out from the warm
    start and quadraticize at the current multipliers."""
    Bt = x0.shape[0]
    xs = op.xs.clone()
    xs[:, 0] = x0
    current_op = sweep.rollout(dyn, spec, x0, op.replace(xs=xs), strategy,
                               batch_block=batch_block)
    quad = pcost.quadraticize(player_costs, spec, current_op, al)
    zi = torch.zeros((Bt,), dtype=torch.int32, device=x0.device)
    zb = torch.zeros((Bt,), dtype=torch.bool, device=x0.device)
    return ilq._SolveCarry(
        op=current_op, strategy=strategy, quad=quad,
        extreme_ks=torch.zeros((Bt, spec.num_players), dtype=torch.int32,
                               device=x0.device),
        last_merit=last_merit, iteration=zi, converged=zb, failed=zb)


def _trip_batched(dyn, player_costs, spec, params, x0, fc, *, batch_block,
                  stats=None):
    """One trip of the flat machine, batch-level (twin of fused._trip)."""
    c2 = iteration_step_batched(
        dyn, player_costs, spec, params, x0, fc.al, fc.c, active=~fc.done,
        batch_block=batch_block, stats=stats)
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
            c2.last_merit, batch_block=batch_block)
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


def _carry0(dyn, player_costs, spec, x0_b, wop_b, wst_b, al_b, batch_block):
    Bt = x0_b.shape[0]
    dev = x0_b.device
    c0 = _init_inner_batched(
        dyn, player_costs, spec, x0_b, wop_b, wst_b, al_b,
        torch.full((Bt,), torch.inf, device=dev), batch_block=batch_block)
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


def _driver_parts(dyn, player_costs, spec, params, batch_block):
    """(trip, finalize): the masked trip and the result assembly shared by
    the host-stepped drivers."""
    _check_supported(player_costs, params)

    def trip(x0_b, fc, stats=None):
        fc2 = _trip_batched(dyn, player_costs, spec, params, x0_b, fc,
                            batch_block=batch_block, stats=stats)
        return _bwhere(fc.done, fc, fc2)

    def finalize(fc):
        fv = max_constraint_violation(player_costs, spec, fc.c.op)
        totals, _ = pcost.total_costs(player_costs, spec, fc.c.op)
        return ALResult(
            op=fc.c.op, strategy=fc.c.strategy, total_costs=totals,
            converged=fc.success & (fv <= params.constraint_error_tolerance),
            max_violation=fv, cumulative_iterations=fc.cum_iters,
            al_state=fc.al)

    return trip, finalize


def make_host_batched_solver(dyn, player_costs, spec, params,
                             warm_op=None, warm_strategy=None,
                             batch_block: int = 128):
    """Batched solve stepped from the host: fn(x0 [B, xdim]) -> batched
    ALResult, on x0's device. Each trip advances every unfinished lane by
    one iLQ iteration; the host loops until every lane is done, reading
    one all-done flag per trip. After a call, `fn.last_stats` holds the
    run's counters (trips, host syncs, deep-ladder rounds, f32-collapse
    exits)."""
    trip, finalize = _driver_parts(dyn, player_costs, spec, params,
                                   batch_block)
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
                       bc(warm_strategy), al0, batch_block)

    def run(x0):
        stats = new_stats()
        (x0p,), Bt = _pad_args((x0,), batch_block)
        fc = init(x0p)
        while not _host_all(fc.done, stats):
            fc = trip(x0p, fc, stats)
            stats["trips"] += 1
        out = finalize(fc)
        stats["collapse_exits"] = int(stats["collapse_exits"])
        run.last_stats = stats
        return tree_map(lambda a: a[:Bt], out)

    run.last_stats = None
    return run
