"""The port's minimally-invasive simulator (`ilqgames_tpu_torch/runtime/
receding_horizon.simulate_minimally_invasive`), one agent's lane in a
block of 8 on the batched machine, against the JAX package's on the CPU.

The reference's pair (modified_three_player_intersection, three_player_
intersection_reachability: x=15, car_5d, a MAX player in the safety game)
runs at N=11, 2 cycles, with a safety threshold between the two cycles'
safety totals, so that the first cycle keeps the original plan and the
second splices the safety plan. On a MAX game the JAX package's two
machines may part (its per-instance iLQ quadraticizes the accepted
iterate with the previous iterate's extreme knots, ilq.py:263; its
batched machine with the accepted iterate's, batched.py:202) and the port
follows the batched machine: so each cycle's safety solve of the port is
held to the JAX package's batched warm solver in interpret mode on the
same start (as tests/test_torch_reachability_solve.py holds config 5),
and the switch and splice decisions to the JAX package's rule
(receding_horizon.py:495-511, its `splice`) applied to those results.

Classes (ROADMAP Queue 3): decisions (converged, iteration counts, the
safety flags, replans) and times exactly equal; states, costs and plans
within the per-trip class, 2e-3.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ilqgames_tpu.examples as jexamples
from ilqgames_tpu.runtime import receding_horizon as jrh
from ilqgames_tpu.solver import batched as jbatched
from ilqgames_tpu.solver.params import SolverParams as JParams
from ilqgames_tpu.types import OperatingPoint as JOp
from ilqgames_tpu.types import Strategy as JStrategy
import ilqgames_tpu_torch.examples as examples
from ilqgames_tpu_torch.runtime import receding_horizon as rh
from ilqgames_tpu_torch.solver import batched
from ilqgames_tpu_torch.solver.params import SolverParams

torch.set_num_threads(1)

TRIP_TOL = 2e-3
N = 11
MI_KW = dict(max_solver_iters=4, unconstrained_solver_max_iters=2,
             max_backtracking_steps=20, initial_alpha_scaling=0.1,
             convergence_tolerance=1.0, expected_decrease_fraction=0.001)
# P1's safety totals of the two cycles are about -33.9 and -32.9 (metres
# of margin): between them, the first cycle keeps the original plan and
# the second takes the safety plan.
SAFETY_THRESHOLD = -33.4


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=TRIP_TOL, atol=TRIP_TOL, err_msg=what)


def _jax_plan(sp):
    """Lane 0 of the port's Splicer as the JAX package's."""
    a = lambda t: jnp.asarray(t[0].numpy())
    return jrh.Splicer(op=JOp(xs=a(sp.op.xs), us=a(sp.op.us), t0=a(sp.op.t0)),
                       strategy=JStrategy(Ps=a(sp.strategy.Ps),
                                          alphas=a(sp.strategy.alphas)),
                       length=a(sp.length))


@pytest.fixture(scope="module")
def minimally_invasive():
    """The port's run with every warm solve's start and result, and every
    splice's plan, recorded; the JAX package's batched warm solver on each
    safety solve's start."""
    prob = examples.get("modified_three_player_intersection")(
        num_time_steps=N)
    safety = examples.get("three_player_intersection_reachability")(
        num_time_steps=N)
    solves, plans = [], []
    make_warm, splice = batched.make_host_batched_warm_solver, rh.splice

    def recording_warm(*args, **kwargs):
        fn = make_warm(*args, **kwargs)

        def run(*a):
            res = fn(*a)
            run.last_stats = fn.last_stats
            solves.append((a, res))
            return res
        return run

    def recording_splice(spec, plan, *args):
        plans.append(plan)
        return splice(spec, plan, *args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(batched, "make_host_batched_warm_solver", recording_warm)
        mp.setattr(rh, "splice", recording_splice)
        out = rh.simulate_minimally_invasive(
            prob, safety, SolverParams(**MI_KW), final_time=0.75,
            safety_threshold=SAFETY_THRESHOLD, device="cpu")

    jsafety = jexamples.get("three_player_intersection_reachability")(
        num_time_steps=N)
    warm = jbatched.make_host_batched_warm_solver(
        jsafety.dynamics, jsafety.player_costs, jsafety.spec,
        JParams(**MI_KW), batch_block=1, interpret=True)
    lane = lambda t: jnp.asarray(t[:1].numpy())
    jal = jax.tree_util.tree_map(lambda a: a[None],
                                 jsafety.initial_al_state())
    jres = []
    for (x0, op, st, _), _ in solves[1::2]:
        jres.append(warm(lane(x0), JOp(xs=lane(op.xs), us=lane(op.us),
                                       t0=lane(op.t0)),
                         JStrategy(Ps=lane(st.Ps), alphas=lane(st.alphas)),
                         jal))
    return prob, out, solves, plans[::2], jres


def test_minimally_invasive_run(minimally_invasive):
    prob, (xs, ts, flags, state), solves, _, _ = minimally_invasive
    assert xs.shape == (3, prob.spec.xdim) and ts.tolist() == [0.0, 0.25,
                                                                 0.5]
    assert flags.tolist() == [False, True]
    assert int(state.num_replans) == 2 and len(solves) == 4
    assert bool(torch.isfinite(xs).all())
    stats = rh.simulate_minimally_invasive.last_stats
    assert [c["trips"] for c in stats["cycles"]] == [
        int(solves[2 * c][1].cumulative_iterations[0])
        + int(solves[2 * c + 1][1].cumulative_iterations[0])
        for c in range(2)]


def test_minimally_invasive_safety_solves_match_jax_batched(
        minimally_invasive):
    _, _, solves, _, jres = minimally_invasive
    for c, ((_, res), j) in enumerate(zip(solves[1::2], jres)):
        assert bool(res.converged[0]) == bool(j.converged[0]), c
        assert int(res.cumulative_iterations[0]) == int(
            j.cumulative_iterations[0]), c
        _close(res.total_costs[0], j.total_costs[0], f"costs, cycle {c}")
        _close(res.op.xs[0], j.op.xs[0], f"xs, cycle {c}")
        _close(res.strategy.alphas[0], j.strategy.alphas[0],
               f"alphas, cycle {c}")


def _plan_arrays(sp, lane):
    """(length, t0, xs, alphas) of a plan as numpy: lane 0 of a batched
    Splicer, or an unbatched one."""
    pick = (lambda t: t[0].numpy()) if lane else (lambda t: t.numpy())
    return (pick(sp.length), pick(sp.op.t0), pick(sp.op.xs),
            pick(sp.strategy.alphas))


def test_minimally_invasive_decisions_follow_jax_rule(minimally_invasive):
    """Per cycle, the JAX package's switch rule on its safety result and
    the port's original result gives the port's flag, and its splice of
    the chosen plan (or no splice) gives the port's next plan."""
    _, (_, _, flags, state), solves, plans, jres = minimally_invasive
    spec = jexamples.get("modified_three_player_intersection")(
        num_time_steps=N).spec
    nexts = [_plan_arrays(plans[1], True), _plan_arrays(state.splicer, False)]
    a = lambda t: jnp.asarray(t[0].numpy())
    for c in range(2):
        orig, j = solves[2 * c][1], jres[c]
        orig_conv = bool(orig.converged[0])
        use = bool(j.total_costs[0, 0] > SAFETY_THRESHOLD) or (
            bool(j.converged[0]) and not orig_conv)
        assert use == bool(flags[c]), c
        plan = _jax_plan(plans[c])
        if use:
            plan = jrh.splice(
                spec, plan, jax.tree_util.tree_map(lambda t: t[0], j.op),
                jax.tree_util.tree_map(lambda t: t[0], j.strategy))
        elif orig_conv:
            plan = jrh.splice(
                spec, plan, JOp(xs=a(orig.op.xs), us=a(orig.op.us),
                                t0=a(orig.op.t0)),
                JStrategy(Ps=a(orig.strategy.Ps),
                          alphas=a(orig.strategy.alphas)))
        length, t0, xs, alphas = nexts[c]
        assert int(length) == int(plan.length), c
        _close(t0, plan.op.t0, f"plan t0, cycle {c}")
        _close(xs, plan.op.xs, f"plan xs, cycle {c}")
        _close(alphas, plan.strategy.alphas, f"plan alphas, cycle {c}")
