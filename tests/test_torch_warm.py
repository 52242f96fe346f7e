"""The port's warm-started batched solver
(`ilqgames_tpu_torch/solver/batched.py:make_host_batched_warm_solver`)
against the JAX package's (`ilqgames_tpu/solver/batched.py:850-869`, its
Pallas kernels in interpret mode, as tests/test_batched_pallas.py runs
it) at N=11: a JAX cold solve of four instances from RandomState(3),
carried across by `convert`, re-solved from each lane's knot-2 state on
its own operating point, strategy (non-zero gains) and converged
multipliers. Decisions (converged, iterations, AL mu) exactly equal;
trajectories, strategies, cost totals and violations within the per-trip
class (2e-3, tests/test_batched_pallas.py:119-140).

And `trips_per_call` of the plain driver: a dispatch runs at most that
many trips and ends once every lane is done (the JAX package's device
`while_loop`), so results and trips are bitwise the same for every value;
only the count of dispatches changes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqgames_tpu.examples.three_player_intersection import \
    make_problem as jmake
from ilqgames_tpu.solver import batched as jbatched
from ilqgames_tpu.solver.params import SolverParams as JParams
from ilqgames_tpu_torch import convert
from ilqgames_tpu_torch.examples.three_player_intersection import \
    make_problem
from ilqgames_tpu_torch.solver import batched
from ilqgames_tpu_torch.solver.params import SolverParams
from ilqgames_tpu_torch.types import tree_leaves, tree_map

torch.set_num_threads(1)

N, B, BB = 11, 4, 2
PARAMS_KW = dict(max_solver_iters=12, unconstrained_solver_max_iters=5,
                 max_backtracking_steps=20, initial_alpha_scaling=0.1,
                 convergence_tolerance=1.0, expected_decrease_fraction=0.001)
TRIP_TOL = 2e-3


def x0_draw():
    prob = make_problem(num_time_steps=N)
    rng = np.random.RandomState(3)
    return torch.tensor((np.tile(prob.x0.numpy()[None], (B, 1))
                         + 0.1 * rng.randn(B, prob.spec.xdim)
                         ).astype(np.float32))


@pytest.fixture(scope="module")
def warm_pair():
    """(port result, JAX result, warm inputs) of one warm re-solve. The
    JAX package's `_driver_parts` is memoized while its two solvers are
    made, so that they share one compiled trip program."""
    jprob = jmake(num_time_steps=N)
    jparams = JParams(**PARAMS_KW)
    parts = {}
    driver_parts = jbatched._driver_parts

    def shared(dyn, costs, spec, params, *args, **kwargs):
        key = (args, tuple(sorted(kwargs.items())))
        if key not in parts:
            parts[key] = driver_parts(dyn, costs, spec, params, *args,
                                      **kwargs)
        return parts[key]

    args = (jprob.dynamics, jprob.player_costs, jprob.spec, jparams)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbatched, "_driver_parts", shared)
        cold = jbatched.make_host_batched_solver(
            *args, warm_op=jprob.initial_operating_point(),
            warm_strategy=jprob.initial_strategy(), batch_block=BB,
            interpret=True)(jnp.asarray(x0_draw().numpy()))
        jwarm = jbatched.make_host_batched_warm_solver(
            *args, batch_block=BB, interpret=True)
        jres = jwarm(cold.op.xs[:, 2], cold.op, cold.strategy,
                     cold.al_state)

    prob = make_problem(num_time_steps=N)
    inputs = (torch.tensor(np.asarray(cold.op.xs[:, 2])),
              convert.from_operating_point(cold.op),
              convert.from_strategy(cold.strategy),
              convert.from_al_state(cold.al_state))
    warm = batched.make_host_batched_warm_solver(
        prob.dynamics, prob.player_costs, prob.spec,
        SolverParams(**PARAMS_KW), batch_block=BB)
    return warm(*inputs), jres, inputs


def test_warm_solver_matches_jax(warm_pair):
    res, jres, (_, wop, wst, wal) = warm_pair
    # A real warm start: gains and multipliers the drivers' fresh starts
    # never carry.
    assert bool((wst.Ps != 0).any()) and bool((wal.mu > 10.0).any())
    for name in ("converged", "cumulative_iterations"):
        np.testing.assert_array_equal(getattr(res, name).numpy(),
                                      np.asarray(getattr(jres, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(res.al_state.mu.numpy(),
                                  np.asarray(jres.al_state.mu))
    np.testing.assert_array_equal(res.op.t0.numpy(), np.asarray(jres.op.t0))
    for name, got, want in (
            ("op.xs", res.op.xs, jres.op.xs),
            ("Ps", res.strategy.Ps, jres.strategy.Ps),
            ("alphas", res.strategy.alphas, jres.strategy.alphas),
            ("total_costs", res.total_costs, jres.total_costs),
            ("max_violation", res.max_violation, jres.max_violation)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TRIP_TOL, atol=TRIP_TOL,
                                   err_msg=name)


def test_warm_solver_keeps_per_lane_t0(warm_pair):
    """Each lane's own t0 reaches the result (replanned lanes start at
    different times), and a batch that is not a multiple of the lane
    block is padded and trimmed."""
    _, _, (x0, wop, wst, wal) = warm_pair
    prob = make_problem(num_time_steps=N)
    t0 = torch.tensor([0.25, 0.5, 0.75])
    pick = lambda t: tree_map(lambda a: a[:3], t)
    warm = batched.make_host_batched_warm_solver(
        prob.dynamics, prob.player_costs, prob.spec,
        SolverParams(**PARAMS_KW), batch_block=BB)
    res = warm(x0[:3], pick(wop).replace(t0=t0), pick(wst), pick(wal))
    assert torch.equal(res.op.t0, t0)
    assert res.op.xs.shape == (3, N, prob.spec.xdim)


@pytest.fixture(scope="module")
def plain_runs():
    """trips_per_call -> (result, last_stats) of the plain driver on the
    cold draw."""
    prob = make_problem(num_time_steps=N)
    x0 = x0_draw()
    runs = {}

    def get(tpc):
        if tpc not in runs:
            run = batched.make_host_batched_solver(
                prob.dynamics, prob.player_costs, prob.spec,
                SolverParams(**PARAMS_KW), trips_per_call=tpc,
                batch_block=BB)
            runs[tpc] = (run(x0), run.last_stats)
        return runs[tpc]

    return get


@pytest.mark.parametrize("tpc", [1, 3, 25])
def test_trips_per_call_changes_only_dispatches(plain_runs, tpc):
    """Against one trip per dispatch (one all-done read per trip, the
    read that ends a JAX dispatch on the device): the same bits, the same
    trips and host reads, ceil(trips / tpc) dispatches."""
    ref, ref_stats = plain_runs(1)
    res, stats = plain_runs(tpc)
    for a, b in zip(tree_leaves(res), tree_leaves(ref)):
        assert torch.equal(a, b)
    assert stats["trips"] == ref_stats["trips"] > 0
    assert stats["host_syncs"] == ref_stats["host_syncs"]
    assert stats["dispatches"] == -(-stats["trips"] // tpc)
    assert ref_stats["dispatches"] == ref_stats["trips"]
