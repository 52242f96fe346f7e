"""Whole fused trips of the four-car roundabout against the JAX package's
batched trip (its Pallas kernels in interpret mode), at N=11, B=4: each
trip from the JAX machine's carry before it, with the exec main's
parameters (bench_all.py's) and a short budget. Decisions (failed,
converged, done) exactly equal on every lane, merits and trajectories
within the per-trip class (2e-3, tests/test_batched_pallas.py:119-140).
The JAX package compiles the roundabout's trip in interpret mode for
most of this file's time (~110 s), so three_player_intersection_
reachability's trips are tests/test_torch_driving.py's."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import ilqgames_tpu.examples as jex  # noqa: E402
from ilqgames_tpu.costs import player_cost as jpc  # noqa: E402
from ilqgames_tpu.solver import batched as jbatched  # noqa: E402
from ilqgames_tpu.solver.params import SolverParams as JParams  # noqa: E402
from ilqgames_tpu.types import OperatingPoint as JOp  # noqa: E402
from ilqgames_tpu.types import Strategy as JStrategy  # noqa: E402

import ilqgames_tpu_torch.examples as ex  # noqa: E402
from ilqgames_tpu_torch import convert  # noqa: E402
from ilqgames_tpu_torch.solver import batched  # noqa: E402
from ilqgames_tpu_torch.solver.params import SolverParams  # noqa: E402

torch.set_num_threads(1)

N, B = 11, 4
PARAMS_KW = dict(max_solver_iters=4, unconstrained_solver_max_iters=10,
                 max_backtracking_steps=100, initial_alpha_scaling=0.1,
                 convergence_tolerance=1.0, expected_decrease_fraction=0.001)
TRIP_TOL = 2e-3


def _jax_carry0(jprob, x0):
    spec = jprob.spec
    bc = lambda t: jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a[None], (B,) + a.shape), t)
    al0 = jax.vmap(lambda _: jpc.ALState.init(jprob.player_costs, spec))(
        jnp.arange(B))
    return jbatched._carry0(jprob.dynamics, jprob.player_costs, spec,
                            jnp.asarray(x0), bc(JOp.zeros(spec)),
                            bc(JStrategy.zeros(spec)), al0, B, True,
                            fuse_stages=True)


def _trips_match_jax(name):
    """Fused trips of example `name` from the JAX machine's carry before
    each: decisions equal, merits and trajectories within TRIP_TOL."""
    prob = ex.get(name)(num_time_steps=N)
    jprob = jex.get(name)(num_time_steps=N)
    rng = np.random.RandomState(0)
    x0 = (np.tile(prob.x0.numpy()[None], (B, 1))
          + 0.1 * rng.randn(B, prob.spec.xdim)).astype(np.float32)
    steps, _, constrained = jbatched._driver_parts(
        jprob.dynamics, jprob.player_costs, jprob.spec, JParams(**PARAMS_KW),
        1, B, True, fuse_stages=True)
    assert not constrained
    steps = jax.jit(steps)
    trip, _ = batched._driver_parts(prob.dynamics, prob.player_costs,
                                    prob.spec, SolverParams(**PARAMS_KW), B,
                                    True)
    fcj = _jax_carry0(jprob, x0)
    for i in range(PARAMS_KW["max_solver_iters"]):
        fc = convert.from_fused_carry(fcj)
        fc = fc.replace(c=fc.c.replace(quad=batched._empty_quad(B, "cpu")))
        fcj = steps(jnp.asarray(x0), fcj)
        fc = trip(torch.tensor(x0), fc)
        for what, got, want in (("failed", fc.c.failed, fcj.c.failed),
                                ("converged", fc.c.converged,
                                 fcj.c.converged),
                                ("done", fc.done, fcj.done)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f"trip {i}: {what}")
        np.testing.assert_allclose(fc.c.last_merit.numpy(),
                                   np.asarray(fcj.c.last_merit),
                                   rtol=TRIP_TOL, atol=TRIP_TOL)
        np.testing.assert_allclose(fc.c.op.xs.numpy(),
                                   np.asarray(fcj.c.op.xs), rtol=TRIP_TOL,
                                   atol=TRIP_TOL)
        if bool(np.asarray(fcj.done).all()):
            break


def test_roundabout_trips_from_the_jax_carry():
    _trips_match_jax("roundabout_merging")
