"""The port's wave-refill queue driver against its plain driver: per
instance bitwise equal, as the JAX package pins its own pair
(tests/test_batched_pallas.py::test_queue_solver_matches_plain). Ten
instances through four device lanes (lane blocks of two) cover the
initial fill, mid-run refills, the ragged final chunk, lane retirement
and drain compaction; harvest chunks of one lane cover the bench's
harvest_block < batch_block shape.

And the same runs against the JAX package's queue driver
(`ilqgames_tpu/solver/batched.py:make_host_batched_queue_solver`, its
Pallas kernels in interpret mode, as tests/test_batched_pallas.py runs
it): per instance `converged` and `cumulative_iterations` exactly equal,
cost totals and violations within the per-trip class (2e-3), and the
driver's counters (dispatches, harvests, compactions) exactly equal."""

import dataclasses

import numpy as np
import pytest
import torch

from ilqgames_tpu_torch.examples.three_player_intersection import \
    make_problem
from ilqgames_tpu_torch.solver import batched
from ilqgames_tpu_torch.solver.params import SolverParams

torch.set_num_threads(1)

N, BTOT = 11, 10
PARAMS_KW = dict(max_solver_iters=12, unconstrained_solver_max_iters=5,
                 max_backtracking_steps=20, initial_alpha_scaling=0.1,
                 convergence_tolerance=1.0, expected_decrease_fraction=0.001)
PARAMS = SolverParams(**PARAMS_KW)
DRIVER = dict(device_batch=4, trips_per_call=3, batch_block=2)
HARVEST = pytest.mark.parametrize("harvest_block", [None, 1],
                                  ids=["harvest=block", "harvest<block"])
TRIP_TOL = 2e-3   # per-trip arrays, tests/test_batched_pallas.py:119-140


@pytest.fixture(scope="module")
def plain():
    prob = make_problem(num_time_steps=N)
    rng = np.random.RandomState(3)
    x0 = torch.tensor((np.tile(prob.x0.numpy()[None], (BTOT, 1))
                       + 0.1 * rng.randn(BTOT, prob.spec.xdim)
                       ).astype(np.float32))
    run = batched.make_host_batched_solver(
        prob.dynamics, prob.player_costs, prob.spec, PARAMS, batch_block=2)
    return prob, x0, run(x0)


@pytest.fixture(scope="module")
def queue(plain):
    """harvest_block -> (result, last_stats) of the port's queue driver,
    each run once for the tests of this module."""
    prob, x0, _ = plain
    runs = {}

    def get(harvest_block):
        if harvest_block not in runs:
            run = batched.make_host_batched_queue_solver(
                prob.dynamics, prob.player_costs, prob.spec, PARAMS,
                harvest_block=harvest_block, **DRIVER)
            runs[harvest_block] = (run(x0), run.last_stats)
        return runs[harvest_block]

    return get


@HARVEST
def test_queue_solver_matches_plain(plain, queue, harvest_block):
    prob, x0, res_p = plain
    res_q, stats = queue(harvest_block)
    for name in ("converged", "cumulative_iterations", "max_violation",
                 "total_costs"):
        assert torch.equal(getattr(res_q, name), getattr(res_p, name)), name
    assert torch.equal(res_q.op.xs, res_p.op.xs)
    assert torch.equal(res_q.strategy.alphas, res_p.strategy.alphas)
    for f in dataclasses.fields(res_p.al_state):
        for a, b in zip(batched.tree_leaves(getattr(res_q.al_state, f.name)),
                        batched.tree_leaves(getattr(res_p.al_state, f.name))):
            assert torch.equal(a, b), f.name
    assert stats["compactions"] >= 1, stats
    assert stats["harvests"] >= BTOT // (harvest_block or 2)
    # Every dispatch ran trips_per_call trips and read `done` once.
    assert len(stats["done_per_dispatch"]) == stats["dispatches"]
    assert stats["trips"] == 3 * stats["dispatches"]


@pytest.fixture(scope="module")
def jax_queue(plain):
    """harvest_block -> (result, last_stats) of the JAX package's queue
    driver on the same x0. Its `_driver_parts` is memoized while these
    run, so that the two harvest blocks share one trip program and its
    compilation (about 27 s per batch size in interpret mode): the
    harvest/refill programs are built per call as before."""
    jax = pytest.importorskip("jax")
    from ilqgames_tpu.examples.three_player_intersection import \
        make_problem as jmake
    from ilqgames_tpu.solver import batched as jbatched
    from ilqgames_tpu.solver.params import SolverParams as JParams

    _, x0, _ = plain
    jprob = jmake(num_time_steps=N)
    jparams = JParams(**PARAMS_KW)
    parts, runs = {}, {}
    driver_parts = jbatched._driver_parts

    def shared_parts(dyn, costs, spec, params, *args, **kwargs):
        # One problem and one params here: the rest of the call is the key.
        key = (args, tuple(sorted(kwargs.items())))
        if key not in parts:
            parts[key] = driver_parts(dyn, costs, spec, params, *args,
                                      **kwargs)
        return parts[key]

    def get(harvest_block):
        if harvest_block not in runs:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jbatched, "_driver_parts", shared_parts)
                run = jbatched.make_host_batched_queue_solver(
                    jprob.dynamics, jprob.player_costs, jprob.spec, jparams,
                    harvest_block=harvest_block, interpret=True, **DRIVER)
                res = run(jax.numpy.asarray(x0.numpy()))
            runs[harvest_block] = (res, run.last_stats)
        return runs[harvest_block]

    return get


@HARVEST
def test_queue_solver_matches_jax(queue, jax_queue, harvest_block):
    res, stats = queue(harvest_block)
    jres, jstats = jax_queue(harvest_block)
    for name in ("converged", "cumulative_iterations"):
        np.testing.assert_array_equal(getattr(res, name).numpy(),
                                      np.asarray(getattr(jres, name)),
                                      err_msg=name)
    for name in ("total_costs", "max_violation"):
        np.testing.assert_allclose(getattr(res, name).numpy(),
                                   np.asarray(getattr(jres, name)),
                                   rtol=TRIP_TOL, atol=TRIP_TOL,
                                   err_msg=name)
    # JAX's last_stats has "compactions" only once one happened.
    assert (stats["dispatches"], stats["harvests"], stats["compactions"]) \
        == (jstats["dispatches"], jstats["harvests"],
            jstats.get("compactions", 0)), (stats, jstats)
