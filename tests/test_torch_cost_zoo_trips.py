"""The two zoo games of chip_smoke.py (`chip_smoke.zoo_player_costs`: the
flagship with one of each of the rest of the cost layer's pieces; fused,
the pieces K1 takes; unfused, the convex proximities, a final-time gate
over a dense atom and the three dense-only constraints) stepped by both
machines: three AL trips at N=11, B=4 of bench.py's draw, by the port
(fused: K1's plain version) and by the JAX package's batched machine (its
Pallas kernels, the fused stage kernel among them, in interpret mode),
from one carry: the port's fresh carry, carried into the JAX machine's
carry type (the JAX machine's own `_carry0` would cost a compile of its
own). After each trip every decision of the carry is exactly equal
(failed, converged, done, the iteration counts, success, AL mu: every
bool and integer leaf) and every float leaf (merits, trajectories,
strategy, quadraticization, multipliers, violation) within the per-trip
class (2e-3). The JAX trips' compiles take ~45 s (fused) and ~55 s
(unfused) of this file's time.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ilqgames_tpu.costs import atoms as jatoms  # noqa: E402
from ilqgames_tpu.costs import constraints as jcons  # noqa: E402
from ilqgames_tpu.costs import player_cost as jpc  # noqa: E402
from ilqgames_tpu.examples import three_player_intersection as jti  # noqa
from ilqgames_tpu.solver import batched as jbatched  # noqa: E402
from ilqgames_tpu.solver.params import SolverParams as JParams  # noqa: E402
from ilqgames_tpu.types import OperatingPoint as JOp  # noqa: E402
from ilqgames_tpu.types import Strategy as JStrategy  # noqa: E402

import chip_smoke  # noqa: E402
from ilqgames_tpu_torch import bench  # noqa: E402
from ilqgames_tpu_torch.solver import batched  # noqa: E402
from ilqgames_tpu_torch.solver.params import SolverParams  # noqa: E402
from ilqgames_tpu_torch.types import tree_map  # noqa: E402

torch.set_num_threads(1)

N, B = 11, 4
TRIPS = 3
TRIP_TOL = 2e-3
PARAMS_KW = dict(max_solver_iters=3, unconstrained_solver_max_iters=10,
                 max_backtracking_steps=100, initial_alpha_scaling=0.1,
                 convergence_tolerance=1.0, expected_decrease_fraction=0.001)


def _jax_carry(jprob, x0, fc, fused):
    """The port's carry `fc` in the JAX machine's carry type, whose
    structure `jax.eval_shape` gives without compiling `_carry0`."""
    spec = jprob.spec
    bc = lambda t: jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a[None], (B,) + a.shape), t)

    def carry0(x):
        al0 = jax.vmap(lambda _: jpc.ALState.init(jprob.player_costs,
                                                  spec))(jnp.arange(B))
        return jbatched._carry0(jprob.dynamics, jprob.player_costs, spec, x,
                                bc(JOp.zeros(spec)), bc(JStrategy.zeros(spec)),
                                al0, B, True, fuse_stages=fused)

    def leaf(want, got):
        assert tuple(want.shape) == tuple(got.shape), (want, got.shape)
        return jnp.asarray(got.numpy(), want.dtype)

    return tree_map(leaf, jax.eval_shape(carry0, jnp.asarray(x0)), fc)


@pytest.mark.parametrize("fused", [False, True])
def test_zoo_trips_match_jax(fused):
    """Three trips of each zoo game by both machines from one carry:
    decisions exactly equal, arrays within the per-trip class."""
    prob = chip_smoke.zoo_problem(fused, N)
    jbase = jti.make_problem(num_time_steps=N)
    jprob = dataclasses.replace(jbase, player_costs=chip_smoke.
                                zoo_player_costs(jbase, jatoms, jcons, fused))
    x0 = bench.perturbed_x0(prob, B)
    fc = batched._fresh_init(prob.dynamics, prob.player_costs, prob.spec,
                             None, None, B, fused)(torch.tensor(x0))
    fcj = _jax_carry(jprob, x0, fc, fused)
    jtrip, _, _ = jbatched._driver_parts(
        jprob.dynamics, jprob.player_costs, jprob.spec, JParams(**PARAMS_KW),
        1, B, True, fuse_stages=fused)
    trip, _ = batched._driver_parts(prob.dynamics, prob.player_costs,
                                    prob.spec, SolverParams(**PARAMS_KW), B,
                                    fused)
    jtrip = jax.jit(jtrip)
    counts = {"decisions": 0, "arrays": 0}

    def check(i):
        def leaf(got, want):
            got, want = got.numpy(), np.asarray(want)
            if got.dtype.kind in "biu":
                np.testing.assert_array_equal(got, want, f"trip {i}")
                counts["decisions"] += 1
            else:
                np.testing.assert_allclose(got, want, rtol=TRIP_TOL,
                                           atol=TRIP_TOL, err_msg=f"trip {i}")
                counts["arrays"] += 1
            return got

        return leaf

    for i in range(TRIPS):
        fcj = jtrip(jnp.asarray(x0), fcj)
        fc = trip(torch.tensor(x0), fc)
        tree_map(check(i), fc, fcj)
        # The line search accepted a step on some lane of the first trip.
        assert i > 0 or not bool(fc.c.failed.all())
    assert counts["decisions"] >= 5 * TRIPS and counts["arrays"] > 0
