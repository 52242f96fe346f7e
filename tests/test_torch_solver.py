"""Port parity: the batched AL + iLQ machine against the JAX package's
vmapped flat machine (`fused._trip`, `fused.make_host_batched_solver`),
started from the same carry at N=11, B=4. Decisions must be exactly
equal; arrays agree to the tolerances of tests/test_batched_pallas.py."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ilqgames_tpu.costs import player_cost as jpc  # noqa: E402
from ilqgames_tpu.dynamics import base as jdyn  # noqa: E402
from ilqgames_tpu.examples.three_player_intersection import \
    make_problem as jmake  # noqa: E402
from ilqgames_tpu.solver import fused as jfused  # noqa: E402
from ilqgames_tpu.solver import ilq as jilq  # noqa: E402
from ilqgames_tpu.solver.params import SolverParams as JParams  # noqa: E402
from ilqgames_tpu.types import OperatingPoint, Strategy  # noqa: E402

from ilqgames_tpu_torch import convert  # noqa: E402
from ilqgames_tpu_torch.examples.three_player_intersection import \
    make_problem  # noqa: E402
from ilqgames_tpu_torch.solver import batched  # noqa: E402
from ilqgames_tpu_torch.solver.params import SolverParams  # noqa: E402

torch.set_num_threads(1)

B, N = 4, 11
PARAMS = dict(max_solver_iters=30, unconstrained_solver_max_iters=5,
              max_backtracking_steps=20, initial_alpha_scaling=0.1,
              convergence_tolerance=1.0, expected_decrease_fraction=0.001)


@pytest.fixture(scope="module")
def setup():
    jprob = jmake(num_time_steps=N)
    rng = np.random.RandomState(0)
    x0 = (np.tile(np.asarray(jprob.x0)[None], (B, 1))
          + 0.1 * rng.randn(B, jprob.spec.xdim)).astype(np.float32)
    return jprob, make_problem(num_time_steps=N), x0


def _jax_carry0(jprob, x0b):
    dyn, costs, spec = jprob.dynamics, jprob.player_costs, jprob.spec
    warm_op, warm_st = OperatingPoint.zeros(spec), Strategy.zeros(spec)
    al0 = jpc.ALState.init(costs, spec)

    def init_one(x0):
        last_op = warm_op.replace(xs=warm_op.xs.at[0].set(x0))
        op = jdyn.rollout(dyn, spec, x0, last_op, warm_st)
        _, ek = jpc.total_costs(costs, spec, op)
        c0 = jilq._SolveCarry(
            op=op, strategy=warm_st,
            quad=jpc.quadraticize(costs, spec, op, al0, ek), extreme_ks=ek,
            last_merit=jnp.asarray(jnp.inf, jnp.float32),
            iteration=jnp.asarray(0, jnp.int32),
            converged=jnp.asarray(False), failed=jnp.asarray(False))
        return jfused._FusedCarry(
            c=c0, al=al0, warm_op=c0.op, warm_strategy=c0.strategy,
            inner_iters=jnp.asarray(0, jnp.int32),
            cum_iters=jnp.asarray(0, jnp.int32),
            violation=jnp.asarray(jnp.inf, jnp.float32),
            success=jnp.asarray(True), done=jnp.asarray(False))

    return jax.vmap(init_one)(x0b)


def test_trip_parity(setup):
    """Six trips from the same carry (the production ladder widths:
    phase-1 chunk 1, deep windows of 8). Lane 0 starts with a carried
    merit of 0, so it rejects every candidate: the deep ladder walks its
    whole window sequence, and the failure path (AL downscaling, reinit)
    runs against the JAX machine's."""
    jprob, prob, x0 = setup
    params = JParams(**PARAMS)
    tparams = SolverParams(**PARAMS)
    fc_ref = _jax_carry0(jprob, jnp.asarray(x0))
    fc_ref = fc_ref.replace(c=fc_ref.c.replace(
        last_merit=fc_ref.c.last_merit.at[0].set(0.0)))
    fc = convert.from_fused_carry(fc_ref)
    trip_ref = jax.jit(jax.vmap(lambda x, f: jfused._trip(
        jprob.dynamics, jprob.player_costs, jprob.spec, params, x, f)))
    stats = batched.new_stats()
    for i in range(6):
        fc_ref = trip_ref(jnp.asarray(x0), fc_ref)
        fc = batched._trip_batched(prob.dynamics, prob.player_costs,
                                   prob.spec, tparams, torch.tensor(x0), fc,
                                   batch_block=4, stats=stats)
        for name in ("failed", "converged"):
            np.testing.assert_array_equal(
                getattr(fc.c, name).numpy(),
                np.asarray(getattr(fc_ref.c, name)),
                err_msg=f"trip {i}: {name}")
        np.testing.assert_array_equal(fc.done.numpy(),
                                      np.asarray(fc_ref.done))
        np.testing.assert_allclose(fc.c.last_merit.numpy(),
                                   np.asarray(fc_ref.c.last_merit),
                                   rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(fc.c.op.xs.numpy(),
                                   np.asarray(fc_ref.c.op.xs),
                                   rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(fc.al.mu.numpy(), np.asarray(fc_ref.al.mu),
                                   rtol=1e-6)
    assert bool(fc.c.failed[0]) and stats["deep_rounds"] >= 2


def test_init_parity(setup):
    """The port's batched init (K4 rollout + quadraticize) against the
    vmapped JAX init."""
    jprob, prob, x0 = setup
    fc_ref = _jax_carry0(jprob, jnp.asarray(x0))
    spec = prob.spec
    bc = lambda t: batched.tree_map(
        lambda a: a[None].expand((B,) + a.shape).contiguous(), t)
    fc = batched._carry0(
        prob.dynamics, prob.player_costs, spec, torch.tensor(x0),
        bc(prob.initial_operating_point()), bc(prob.initial_strategy()),
        batched.pcost.ALState.init(prob.player_costs, spec, B), 4)
    np.testing.assert_allclose(fc.c.op.xs.numpy(), np.asarray(fc_ref.c.op.xs),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(fc.c.quad.Q.numpy(),
                               np.asarray(fc_ref.c.quad.Q), rtol=1e-4,
                               atol=1e-4)


def test_full_solve_parity(setup):
    """The unfused stages (the drivers' default is fused stages,
    held in test_torch_solver_fused_solve.py)."""
    jprob, prob, x0 = setup
    run_ref = jfused.make_host_batched_solver(
        jprob.dynamics, jprob.player_costs, jprob.spec, JParams(**PARAMS),
        trips_per_call=10)
    run = batched.make_host_batched_solver(
        prob.dynamics, prob.player_costs, prob.spec, SolverParams(**PARAMS),
        batch_block=4, fuse_stages=False)
    ref = run_ref(jnp.asarray(x0))
    got = run(torch.tensor(x0))
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(ref.converged))
    np.testing.assert_array_equal(got.cumulative_iterations.numpy(),
                                  np.asarray(ref.cumulative_iterations))
    np.testing.assert_allclose(got.total_costs.numpy(),
                               np.asarray(ref.total_costs), rtol=5e-3,
                               atol=5e-3)
    np.testing.assert_allclose(got.op.xs.numpy(), np.asarray(ref.op.xs),
                               rtol=5e-3, atol=5e-3)
    assert run.last_stats["trips"] == int(np.asarray(
        ref.cumulative_iterations).max())


def test_f32_collapse_exit_is_decision_neutral(setup):
    """A lane driven into the frozen regime of the linesearch ladder (its
    carried merit is below every candidate's, so it rejects everything):
    the f32-collapse exit must fire, and the trip with the exit on must
    equal the trip with it off (deep windows of 1 cannot trigger it) on
    decisions and merits."""
    _, prob, x0 = setup
    spec = prob.spec
    kw = dict(PARAMS, max_backtracking_steps=60, linesearch_eval_cap=0)
    bc = lambda t: batched.tree_map(
        lambda a: a[None].expand((B,) + a.shape).contiguous(), t)
    fc0 = batched._carry0(
        prob.dynamics, prob.player_costs, spec, torch.tensor(x0),
        bc(prob.initial_operating_point()), bc(prob.initial_strategy()),
        batched.pcost.ALState.init(prob.player_costs, spec, B), 4)
    fc = batched._trip_batched(prob.dynamics, prob.player_costs, spec,
                               SolverParams(**kw), torch.tensor(x0), fc0,
                               batch_block=4)
    frozen = fc.c.last_merit.clone()
    frozen[0] = 0.0
    fc = fc.replace(c=fc.c.replace(last_merit=frozen))

    out = {}
    for name, deep in (("on", 8), ("off", 1)):
        stats = batched.new_stats()
        out[name] = batched.iteration_step_batched(
            prob.dynamics, prob.player_costs, spec,
            SolverParams(**kw, linesearch_deep_chunk=deep),
            torch.tensor(x0), fc.al, fc.c, active=~fc.done, batch_block=4,
            stats=stats)
        out[name + "_stats"] = stats
    assert bool(out["on"].failed[0]), "lane 0 should reject every candidate"
    assert int(out["on_stats"]["collapse_exits"]) >= 1
    assert out["on_stats"]["deep_rounds"] < out["off_stats"]["deep_rounds"]
    for f in ("failed", "converged"):
        np.testing.assert_array_equal(getattr(out["on"], f).numpy(),
                                      getattr(out["off"], f).numpy())
    np.testing.assert_array_equal(out["on"].last_merit.numpy(),
                                  out["off"].last_merit.numpy())
    np.testing.assert_array_equal(out["on"].op.xs.numpy(),
                                  out["off"].op.xs.numpy())


def test_expected_decrease(setup):
    """The fixed-order expected decrease against JAX's einsum form, on
    random stage costs and LQ steps."""
    jprob, prob, _ = setup
    spec = jprob.spec
    P, x, u = spec.num_players, spec.xdim, spec.umax
    rng = np.random.RandomState(3)
    r = lambda *s: rng.randn(B, N, *s).astype(np.float32)
    quad = dict(Q=r(P, x, x), l=r(P, x), R=r(P, P, u, u), r=r(P, P, u))
    alphas, dxs = r(P, u), r(x)
    ref = jax.vmap(lambda q, a, d: jilq._expected_decrease(
        spec, jilq.QuadraticCosts(**q), a, d))(
        {k: jnp.asarray(v) for k, v in quad.items()}, jnp.asarray(alphas),
        jnp.asarray(dxs))
    got = batched.ilq._expected_decrease(
        prob.spec, batched.ilq.QuadraticCosts(
            **{k: torch.tensor(v) for k, v in quad.items()}),
        torch.tensor(alphas), torch.tensor(dxs))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("fuse", [False, True])
def test_trip_parity_without_linesearch(setup, fuse):
    """`linesearch=False`: every lane takes the step at the initial
    scaling, against the vmapped JAX trip with the same parameters (the
    configuration of the trip_no_linesearch probe)."""
    jprob, prob, x0 = setup
    kw = dict(PARAMS, linesearch=False)
    fc_ref = _jax_carry0(jprob, jnp.asarray(x0))
    fc = convert.from_fused_carry(fc_ref)
    trip_ref = jax.jit(jax.vmap(lambda x, f: jfused._trip(
        jprob.dynamics, jprob.player_costs, jprob.spec, JParams(**kw), x, f)))
    for i in range(3):
        fc_ref = trip_ref(jnp.asarray(x0), fc_ref)
        fc = batched._trip_batched(prob.dynamics, prob.player_costs,
                                   prob.spec, SolverParams(**kw),
                                   torch.tensor(x0), fc, batch_block=4,
                                   fuse_stages=fuse)
        np.testing.assert_array_equal(fc.c.iteration.numpy(),
                                      np.asarray(fc_ref.c.iteration))
        np.testing.assert_array_equal(fc.done.numpy(),
                                      np.asarray(fc_ref.done))
        np.testing.assert_allclose(fc.c.op.xs.numpy(),
                                   np.asarray(fc_ref.c.op.xs),
                                   rtol=2e-3, atol=2e-3, err_msg=f"trip {i}")
        np.testing.assert_allclose(fc.c.strategy.alphas.numpy(),
                                   np.asarray(fc_ref.c.strategy.alphas),
                                   rtol=2e-3, atol=2e-3, err_msg=f"trip {i}")
