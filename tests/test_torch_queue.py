"""The port's wave-refill queue driver against its plain driver: per
instance bitwise equal, as the JAX package pins its own pair
(tests/test_batched_pallas.py::test_queue_solver_matches_plain). Ten
instances through four device lanes (lane blocks of two) cover the
initial fill, mid-run refills, the ragged final chunk, lane retirement
and drain compaction; harvest chunks of one lane cover the bench's
harvest_block < batch_block shape."""

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
PARAMS = SolverParams(max_solver_iters=12, unconstrained_solver_max_iters=5,
                      max_backtracking_steps=20, initial_alpha_scaling=0.1,
                      convergence_tolerance=1.0,
                      expected_decrease_fraction=0.001)


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


@pytest.mark.parametrize("harvest_block", [None, 1],
                         ids=["harvest=block", "harvest<block"])
def test_queue_solver_matches_plain(plain, harvest_block):
    prob, x0, res_p = plain
    run = batched.make_host_batched_queue_solver(
        prob.dynamics, prob.player_costs, prob.spec, PARAMS, device_batch=4,
        trips_per_call=3, batch_block=2, harvest_block=harvest_block)
    res_q = run(x0)
    for name in ("converged", "cumulative_iterations", "max_violation",
                 "total_costs"):
        assert torch.equal(getattr(res_q, name), getattr(res_p, name)), name
    assert torch.equal(res_q.op.xs, res_p.op.xs)
    assert torch.equal(res_q.strategy.alphas, res_p.strategy.alphas)
    for f in dataclasses.fields(res_p.al_state):
        for a, b in zip(batched.tree_leaves(getattr(res_q.al_state, f.name)),
                        batched.tree_leaves(getattr(res_p.al_state, f.name))):
            assert torch.equal(a, b), f.name
    stats = run.last_stats
    assert stats["compactions"] >= 1, stats
    assert stats["harvests"] >= BTOT // (harvest_block or 2)
    # Every dispatch ran trips_per_call trips and read `done` once.
    assert len(stats["done_per_dispatch"]) == stats["dispatches"]
    assert stats["trips"] == 3 * stats["dispatches"]
