"""The port's receding-horizon runtime
(`ilqgames_tpu_torch/runtime/receding_horizon.py`) against the JAX
package's (`ilqgames_tpu/runtime/receding_horizon.py`, its per-instance
functions vmapped over lanes), on the same plans and states at N=11.

The plans are a JAX cold solve of four instances from RandomState(3)
(the batched machine, its Pallas kernels in interpret mode, as
tests/test_batched_pallas.py runs it), each lane given its own t0 and
its own query time: on a knot, mid-knot, inside the `bump` window of
setup_next_receding_horizon (less than 0.9 dt left to the next knot) and
deep in the plan, and states near different knots of the plan, so that
lanes shift by different counts (at least one by more than zero).
Integer results (shift, length, cur/initial through t0) and masks are
held exactly equal; states within 1e-5 abs + 1e-5 rel (one RK4 chain,
`fmath` trig against XLA's). Then the whole batched simulation, two
replanning cycles on the warm solver, against the JAX package's
simulate_batched(backend="pallas"): decisions exactly equal, states and
the splicer's arrays within the per-trip class (2e-3,
tests/test_batched_pallas.py:119-140)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqgames_tpu.examples.three_player_intersection import \
    make_problem as jmake
from ilqgames_tpu.runtime import receding_horizon as jrh
from ilqgames_tpu.solver import batched as jbatched
from ilqgames_tpu.solver.params import SolverParams as JParams
from ilqgames_tpu.types import OperatingPoint as JOp
from ilqgames_tpu.types import Strategy as JStrategy
from ilqgames_tpu_torch.examples.three_player_intersection import \
    make_problem
from ilqgames_tpu_torch.runtime import receding_horizon as rh
from ilqgames_tpu_torch.solver.params import SolverParams
from ilqgames_tpu_torch.types import OperatingPoint, Strategy

torch.set_num_threads(1)

N, B, BB = 11, 4, 2
PARAMS_KW = dict(max_solver_iters=12, unconstrained_solver_max_iters=5,
                 max_backtracking_steps=20, initial_alpha_scaling=0.1,
                 convergence_tolerance=1.0, expected_decrease_fraction=0.001)
STATE_TOL = 1e-5
TRIP_TOL = 2e-3
PLANNER_TIME = 0.25
# Per lane: the plan's t0 and the query time's offset from it. Lane 0 on
# a knot; lane 1 mid-knot, 0.095 s before the next one (outside the bump
# window); lane 2 inside the bump window (0.08 s left); lane 3 on a knot
# where float32 floor(rel / dt) lands one knot short (3e-8 s left), which
# the bump branch corrects.
PLAN_T0 = (0.0, 0.3, 1.1, 0.15)
REL = (0.2, 0.305, 0.22, 0.5)
# Per lane: the plan knot the true state sits near.
NEAR = (0, 3, 5, 1)


def x0_draw():
    prob = make_problem(num_time_steps=N)
    rng = np.random.RandomState(3)
    return (np.tile(prob.x0.numpy()[None], (B, 1))
            + 0.1 * rng.randn(B, prob.spec.xdim)).astype(np.float32)


@pytest.fixture(scope="module")
def shared_trip():
    """Memoize the JAX package's `_driver_parts` while this module runs,
    so that its cold solve, its warm solver and simulate_batched's two
    solvers share one compiled trip program (one problem and one params
    here: the rest of the call is the key)."""
    parts = {}
    driver_parts = jbatched._driver_parts

    def shared(dyn, costs, spec, params, *args, **kwargs):
        key = (args, tuple(sorted(kwargs.items())))
        if key not in parts:
            parts[key] = driver_parts(dyn, costs, spec, params, *args,
                                      **kwargs)
        return parts[key]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbatched, "_driver_parts", shared)
        yield


@pytest.fixture(scope="module")
def game(shared_trip):
    """(port problem, JAX problem, plans as numpy dicts): the JAX cold
    solve, each lane's t0 set to PLAN_T0."""
    prob, jprob = make_problem(num_time_steps=N), jmake(num_time_steps=N)
    run = jbatched.make_host_batched_solver(
        jprob.dynamics, jprob.player_costs, jprob.spec, JParams(**PARAMS_KW),
        warm_op=jprob.initial_operating_point(),
        warm_strategy=jprob.initial_strategy(), batch_block=BB,
        interpret=True)
    res = run(jnp.asarray(x0_draw()))
    plan = {"xs": np.asarray(res.op.xs), "us": np.asarray(res.op.us),
            "t0": np.float32(PLAN_T0), "Ps": np.asarray(res.strategy.Ps),
            "alphas": np.asarray(res.strategy.alphas)}
    return prob, jprob, plan


def port_plan(plan):
    t = lambda k: torch.tensor(plan[k])
    return (OperatingPoint(xs=t("xs"), us=t("us"), t0=t("t0")),
            Strategy(Ps=t("Ps"), alphas=t("alphas")))


def jax_plan(plan):
    return (JOp(xs=jnp.asarray(plan["xs"]), us=jnp.asarray(plan["us"]),
                t0=jnp.asarray(plan["t0"])),
            JStrategy(Ps=jnp.asarray(plan["Ps"]),
                      alphas=jnp.asarray(plan["alphas"])))


def query(plan):
    """(t [B], x [B, x]) float32: each lane's query time and a true state
    near plan knot NEAR[b], off it by a small RandomState(5) draw."""
    t = np.float32(np.float32(PLAN_T0) + np.float32(REL))
    x = plan["xs"][np.arange(B), list(NEAR)]
    x = (x + 0.05 * np.random.RandomState(5).randn(*x.shape)).astype(
        np.float32)
    return t, x


def vmapped(fn):
    return jax.jit(jax.vmap(fn))


def assert_states(got, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=STATE_TOL, atol=STATE_TOL, err_msg=what)


def test_integrate_to_next_time_step_matches_jax(game):
    prob, jprob, plan = game
    t, x = query(plan)
    op, st = port_plan(plan)
    x1, t1 = rh.integrate_to_next_time_step(
        prob.dynamics, prob.spec, op, st, torch.tensor(t), torch.tensor(x))
    jx1, jt1 = vmapped(lambda o, s, tt, xx: jrh.integrate_to_next_time_step(
        jprob.dynamics, jprob.spec, o, s, tt, xx))(*jax_plan(plan), t, x)
    assert_states(x1, jx1, "x")
    np.testing.assert_array_equal(t1.numpy(), np.asarray(jt1))


def test_integrate_span_matches_jax(game):
    """The splicer-sized playback of simulate_batched: the partial step,
    the masked full steps and the final partial step."""
    prob, jprob, plan = game
    t, x = query(plan)
    t_to = np.float32(t + np.float32(0.25))
    op, st = port_plan(plan)
    sp = rh.Splicer.create(prob.spec, op, st)
    got = rh.integrate_span(prob.dynamics, rh._splicer_spec(prob.spec),
                            sp.op, sp.strategy, torch.tensor(t),
                            torch.tensor(t_to), torch.tensor(x), 4)
    jsspec = jrh._splicer_spec(jprob.spec)

    def jspan(o, s, tf, tt, xx):
        jsp = jrh.Splicer.create(jprob.spec, o, s)
        return jrh.integrate_span(jprob.dynamics, jsspec, jsp.op,
                                  jsp.strategy, tf, tt, xx, 4)

    assert_states(got, vmapped(jspan)(*jax_plan(plan), t, t_to, x), "x")


def _shift_of(xs, new_x0, ego):
    """The knot of each lane's plan whose ego sub-state new_x0 took (the
    stitch copies it bit for bit)."""
    eq = (xs[:, :, :ego] == new_x0[:, None, :ego]).all(-1)
    assert eq.any(1).all()
    return eq.argmax(1)


def test_setup_next_receding_horizon_matches_jax(game):
    prob, jprob, plan = game
    t, x = query(plan)
    op, st = port_plan(plan)
    new_op, new_st, new_x0 = rh.setup_next_receding_horizon(
        prob.dynamics, prob.spec, op, st, torch.tensor(x), torch.tensor(t),
        PLANNER_TIME)
    jop, jst, jx0 = vmapped(lambda o, s, xx, tt: jrh.setup_next_receding_horizon(
        jprob.dynamics, jprob.spec, o, s, xx, tt, PLANNER_TIME))(
            *jax_plan(plan), x, t)
    ego = prob.spec.xdims[0]
    shift = _shift_of(plan["xs"], new_x0.numpy(), ego)
    np.testing.assert_array_equal(shift, _shift_of(plan["xs"],
                                                   np.asarray(jx0), ego))
    assert shift.max() > 0 and len(set(shift.tolist())) > 1, shift
    np.testing.assert_array_equal(new_op.t0.numpy(), np.asarray(jop.t0))
    # The zeroed tail: the same entries are zero on both sides.
    for name, got, want in (("us", new_op.us, jop.us),
                            ("Ps", new_st.Ps, jst.Ps),
                            ("alphas", new_st.alphas, jst.alphas)):
        np.testing.assert_array_equal(got.numpy() == 0,
                                      np.asarray(want) == 0, err_msg=name)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=name)
    assert_states(new_op.xs, jop.xs, "xs")
    assert_states(new_x0, jx0, "x0")
    # The reference's invariant (src/problem.cpp:124).
    assert (np.abs(new_op.t0.numpy() - (t + PLANNER_TIME))
            <= prob.spec.dt + 1e-5).all()


def test_tail_starts_at_first_invalid_knot(game):
    """The tail's chain started at the first knot that some lane lacks
    equals, bit for bit, the chain over every knot (the JAX package's
    scan) on lanes shifted by different counts."""
    prob, _, plan = game
    op, _ = port_plan(plan)
    shift = torch.tensor([0, 3, 6, 1])
    idx = torch.arange(N)[None] + shift[:, None]
    xs_shift = op.xs[torch.arange(B)[:, None], idx.clamp(max=N - 1)]
    new_t0 = torch.tensor(np.float32(PLAN_T0))
    full = rh._propagate_tail(prob.dynamics, prob.spec, xs_shift, idx < N,
                              new_t0, 1)
    short = rh._propagate_tail(prob.dynamics, prob.spec, xs_shift, idx < N,
                               new_t0, N - int(shift.max()))
    assert torch.equal(full, short)
    assert not torch.equal(full, xs_shift)


def test_splicer_and_splice_match_jax(game):
    """Splicer.create, contains_time and splice on new plans that start
    before the old one (cur truncated toward zero: -1, not -2), on it,
    within the kept window and beyond it (initial > 0)."""
    prob, jprob, plan = game
    op, st = port_plan(plan)
    jop, jst = jax_plan(plan)
    sp = rh.Splicer.create(prob.spec, op, st)
    jcreate = vmapped(lambda o, s: jrh.Splicer.create(jprob.spec, o, s))
    jsp = jcreate(jop, jst)
    np.testing.assert_array_equal(sp.length.numpy(), np.asarray(jsp.length))
    np.testing.assert_array_equal(sp.op.xs.numpy(), np.asarray(jsp.op.xs))
    for dt_rel in (-0.1, 0.0, 0.5, 0.95, 1.0, 1.5):
        tq = np.float32(np.float32(PLAN_T0) + np.float32(dt_rel))
        np.testing.assert_array_equal(
            sp.contains_time(torch.tensor(tq), prob.spec).numpy(),
            np.asarray(jax.vmap(lambda s, tt: s.contains_time(
                tt, jprob.spec))(jsp, tq)), err_msg=str(dt_rel))

    # New plans: the old plan rolled by two knots and moved, with t0
    # offsets giving cur = 3, 8, -1 and 5 (5.49 truncated).
    offs = np.float32((0.3, 0.8, -0.2, 0.549))
    new = {"xs": np.roll(plan["xs"], -2, 1) + 1.0,
           "us": np.roll(plan["us"], -2, 1),
           "t0": np.float32(np.float32(PLAN_T0) + offs),
           "Ps": plan["Ps"] * 0.5, "alphas": plan["alphas"] + 0.25}
    nop, nst = port_plan(new)
    got = rh.splice(prob.spec, sp, nop, nst)
    want = vmapped(lambda s, o, t: jrh.splice(jprob.spec, s, o, t))(
        jsp, *jax_plan(new))
    np.testing.assert_array_equal(got.length.numpy(),
                                  np.asarray(want.length))
    np.testing.assert_array_equal(got.length.numpy(), [N + 3, N + 5,
                                                       N - 1, N + 5])
    np.testing.assert_array_equal(got.op.t0.numpy(), np.asarray(want.op.t0))
    for name in ("xs", "us"):
        np.testing.assert_array_equal(getattr(got.op, name).numpy(),
                                      np.asarray(getattr(want.op, name)),
                                      err_msg=name)
    for name in ("Ps", "alphas"):
        np.testing.assert_array_equal(
            getattr(got.strategy, name).numpy(),
            np.asarray(getattr(want.strategy, name)), err_msg=name)


def test_simulate_batched_matches_jax(game):
    """Two replanning cycles of four agents: the cold solve, then per
    cycle playback, warm-start shift, the warm solve and the splice."""
    prob, jprob, _ = game
    x0 = x0_draw()
    states, times, state = rh.simulate_batched(
        prob, SolverParams(**PARAMS_KW), torch.tensor(x0), final_time=0.75,
        batch_block=BB)
    jstates, jtimes, jstate = jrh.simulate_batched(
        jprob, JParams(**PARAMS_KW), jnp.asarray(x0), final_time=0.75,
        backend="pallas", batch_block=BB, interpret=True)
    stats = rh.simulate_batched.last_stats
    assert len(stats["cycles"]) == 2
    np.testing.assert_array_equal(times.numpy(), np.asarray(jtimes))
    np.testing.assert_array_equal(state.t.numpy(), np.asarray(jstate.t))
    for name in ("converged", "num_replans"):
        np.testing.assert_array_equal(getattr(state, name).numpy(),
                                      np.asarray(getattr(jstate, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(state.splicer.length.numpy(),
                                  np.asarray(jstate.splicer.length))
    np.testing.assert_array_equal(state.splicer.op.t0.numpy(),
                                  np.asarray(jstate.splicer.op.t0))
    for name, got, want in (
            ("states", states, jstates),
            ("splicer xs", state.splicer.op.xs, jstate.splicer.op.xs),
            ("splicer alphas", state.splicer.strategy.alphas,
             jstate.splicer.strategy.alphas)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TRIP_TOL, atol=TRIP_TOL,
                                   err_msg=name)
