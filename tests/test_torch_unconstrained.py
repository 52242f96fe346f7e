"""The unconstrained trip and finalize (`solver/batched.py`
`_trip_unconstrained`, `_driver_parts`) against the JAX package's
(`ilqgames_tpu/solver/batched.py:689-709, 730-743`, its Pallas kernels in
interpret mode), at N=11, B=4, on the two-player point mass, the
two-player collision and the flagship with its state constraints
removed, under the plain and the queue drivers: per instance
`converged` and `cumulative_iterations` exactly equal, costs within the
per-trip class (2e-3), max_violation -inf; and the queue driver's
results bitwise equal to the plain driver's.

The collision's merits are ~4.5e10 at N=11 (its goal costs), where one
float32 ulp (4,096) is far above the convergence tolerance (1.0), so its
linesearch decisions turn on the last bit of sums that the port forms in
another order than XLA (fmath's trigonometry in the linearization, the
Riccati sweep's folds): a lane's merit step of one ulp is accepted by one
package and rejected by the other. Every decision of every lane is held
all the same, and a disagreement passes only with the evidence that it
is such a knife edge: trip by trip from the JAX machine's own carry, both
packages' merit steps on that lane are within KNIFE_ULPS of its merit;
over whole solves, a lane's iterations may differ by one only where the
two final trajectories' merits are within KNIFE_ULPS of each other (the
extra iteration moved nothing but the last bits)"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ilqgames_tpu.costs import player_cost as jpc  # noqa: E402
from ilqgames_tpu.examples import three_player_intersection as jfl  # noqa: E402
from ilqgames_tpu.examples import two_player_collision as jtc  # noqa: E402
from ilqgames_tpu.examples import two_player_point_mass as jpm  # noqa: E402
from ilqgames_tpu.solver import batched as jbatched  # noqa: E402
from ilqgames_tpu.solver.params import SolverParams as JParams  # noqa: E402
from ilqgames_tpu.types import OperatingPoint as JOp  # noqa: E402
from ilqgames_tpu.types import Strategy as JStrategy  # noqa: E402

from ilqgames_tpu_torch import convert  # noqa: E402
from ilqgames_tpu_torch.costs import player_cost as pcost  # noqa: E402
from ilqgames_tpu_torch.examples import three_player_intersection as fl  # noqa: E402
from ilqgames_tpu_torch.examples import two_player_collision as tc  # noqa: E402
from ilqgames_tpu_torch.examples import two_player_point_mass as pm  # noqa: E402
from ilqgames_tpu_torch.ops.cuda import sweep  # noqa: E402
from ilqgames_tpu_torch.solver import batched  # noqa: E402
from ilqgames_tpu_torch.solver.params import SolverParams  # noqa: E402

torch.set_num_threads(1)

N, B = 11, 4
PARAMS_KW = dict(max_solver_iters=12, unconstrained_solver_max_iters=5,
                 max_backtracking_steps=20, initial_alpha_scaling=0.1,
                 convergence_tolerance=1.0, expected_decrease_fraction=0.001)
QUEUE = dict(device_batch=2, trips_per_call=3, batch_block=2)
TRIP_TOL = 2e-3   # per-trip arrays, tests/test_batched_pallas.py:119-140
KNIFE_ULPS = 2    # a merit step this small decides on the last bits


def _unconstrained(prob):
    """The game with every player's state constraints removed."""
    return dataclasses.replace(prob, player_costs=tuple(
        dataclasses.replace(c, state_constraints=())
        for c in prob.player_costs))


GAMES = {
    "point_mass": (pm.make_problem, jpm.make_problem, 0.5),
    "collision": (tc.make_problem, jtc.make_problem, 0.1),
    "flagship": (lambda **k: _unconstrained(fl.make_problem(**k)),
                 lambda **k: _unconstrained(jfl.make_problem(**k)), 0.1),
}


@pytest.fixture(scope="module")
def runs():
    """game -> (port plain, port queue, JAX plain, JAX queue) results on
    the same x0, each solved once for this module. The JAX package's
    `_driver_parts` is memoized while these run, so that its plain and
    queue drivers share one trip program and its interpret-mode
    compilation (both take the same trips per call and lane block)."""
    cache, parts = {}, {}
    driver_parts = jbatched._driver_parts

    def shared_parts(*args, **kwargs):
        key = (tuple(id(a) for a in args[:4]) + args[4:],
               tuple(sorted(kwargs.items())))
        if key not in parts:
            parts[key] = driver_parts(*args, **kwargs)
        return parts[key]

    def get(game):
        if game not in cache:
            make, jmake, sigma = GAMES[game]
            prob, jprob = make(num_time_steps=N), jmake(num_time_steps=N)
            rng = np.random.RandomState(0)
            x0 = (np.tile(prob.x0.numpy()[None], (B, 1))
                  + sigma * rng.randn(B, prob.spec.xdim)).astype(np.float32)
            args = (prob.dynamics, prob.player_costs, prob.spec,
                    SolverParams(**PARAMS_KW))
            jargs = (jprob.dynamics, jprob.player_costs, jprob.spec,
                     JParams(**PARAMS_KW))
            plain = batched.make_host_batched_solver(
                *args, trips_per_call=3, batch_block=2)(torch.tensor(x0))
            queue = batched.make_host_batched_queue_solver(*args, **QUEUE)(
                torch.tensor(x0))
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jbatched, "_driver_parts", shared_parts)
                jplain = jbatched.make_host_batched_solver(
                    *jargs, trips_per_call=3, batch_block=2,
                    interpret=True)(jnp.asarray(x0))
                jqueue = jbatched.make_host_batched_queue_solver(
                    *jargs, interpret=True, **QUEUE)(jnp.asarray(x0))
            cache[game] = (plain, queue, jplain, jqueue)
        return cache[game]

    return get


@pytest.mark.parametrize("game", list(GAMES))
def test_queue_matches_plain(runs, game):
    plain, queue, _, _ = runs(game)
    for name in ("converged", "cumulative_iterations", "total_costs",
                 "max_violation"):
        assert torch.equal(getattr(queue, name), getattr(plain, name)), name
    assert torch.equal(queue.op.xs, plain.op.xs)


@pytest.mark.parametrize("driver", ["plain", "queue"])
@pytest.mark.parametrize("game", list(GAMES))
def test_drivers_match_jax(runs, game, driver):
    plain, queue, jplain, jqueue = runs(game)
    res, jres = (plain, jplain) if driver == "plain" else (queue, jqueue)
    iters = res.cumulative_iterations.numpy()
    jiters = np.asarray(jres.cumulative_iterations)
    np.testing.assert_array_equal(res.converged.numpy(),
                                  np.asarray(jres.converged))
    differ = iters != jiters
    if game == "collision" and differ.any():
        # Knife edges only: one iteration apart, and final trajectories
        # whose merits (the port's, on both) differ in the last bits.
        prob = GAMES[game][0](num_time_steps=N)
        m, jm = _final_merits(prob, res.op), _final_merits(prob, jres.op)
        gap = np.abs(m - jm) / np.spacing(np.abs(jm))
        assert (np.abs(iters - jiters)[differ] == 1).all(), (iters, jiters)
        assert (gap[differ] <= KNIFE_ULPS).all(), (iters, jiters, gap)
    else:
        np.testing.assert_array_equal(iters, jiters)
    np.testing.assert_allclose(res.total_costs.numpy(),
                               np.asarray(jres.total_costs), rtol=TRIP_TOL,
                               atol=TRIP_TOL)
    assert torch.isinf(res.max_violation).all()
    assert (res.max_violation < 0).all()
    np.testing.assert_array_equal(np.asarray(jres.max_violation),
                                  res.max_violation.numpy())
    if game == "point_mass":
        assert res.converged.all()


def _final_merits(prob, op):
    """The port's plain merits [B] of a result's trajectories (either
    package's), as the linesearch computes a candidate's."""
    spec = prob.spec
    xs = torch.tensor(np.asarray(op.xs))
    us = torch.tensor(np.asarray(op.us))
    Bn = xs.shape[0]
    al = pcost.ALState.init(prob.player_costs, spec, Bn)
    return sweep.merit_plain(
        prob.player_costs, spec, xs.permute(1, 2, 0)[:, :, None],
        us.reshape(Bn, N, -1).permute(1, 2, 0)[:, :, None],
        torch.zeros(1, Bn), None, None, al.mu[None])[0].numpy()


def _jax_carry0(jprob, x0):
    spec = jprob.spec
    bc = lambda t: jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a[None], (B,) + a.shape), t)
    al0 = jax.vmap(lambda _: jpc.ALState.init(jprob.player_costs, spec))(
        jnp.arange(B))
    return jbatched._carry0(jprob.dynamics, jprob.player_costs, spec,
                            jnp.asarray(x0), bc(JOp.zeros(spec)),
                            bc(JStrategy.zeros(spec)), al0, 2, True,
                            fuse_stages=True)


@pytest.mark.parametrize("game", list(GAMES))
def test_trips_from_the_jax_carry(game):
    """Each of twelve fused trips from the JAX machine's carry before it:
    failed, converged and done exactly equal on every lane (for the
    collision, but for knife edges: lanes where both packages' merit steps
    are within KNIFE_ULPS of the merit), merits and trajectories within
    the per-trip class."""
    make, jmake, sigma = GAMES[game]
    prob, jprob = make(num_time_steps=N), jmake(num_time_steps=N)
    rng = np.random.RandomState(0)
    x0 = (np.tile(prob.x0.numpy()[None], (B, 1))
          + sigma * rng.randn(B, prob.spec.xdim)).astype(np.float32)
    steps, _, constrained = jbatched._driver_parts(
        jprob.dynamics, jprob.player_costs, jprob.spec, JParams(**PARAMS_KW),
        1, 2, True, fuse_stages=True)
    assert not constrained
    steps = jax.jit(steps)
    trip, _ = batched._driver_parts(prob.dynamics, prob.player_costs,
                                    prob.spec, SolverParams(**PARAMS_KW), 2,
                                    True)
    fcj = _jax_carry0(jprob, x0)
    for i in range(PARAMS_KW["max_solver_iters"]):
        fc = convert.from_fused_carry(fcj)
        fc = fc.replace(c=fc.c.replace(quad=batched._empty_quad(B, "cpu")))
        before = np.asarray(fcj.c.last_merit)
        fcj = steps(jnp.asarray(x0), fcj)
        fc = trip(torch.tensor(x0), fc)
        after = np.asarray(fcj.c.last_merit)
        decisions = [(fc.c.failed.numpy(), np.asarray(fcj.c.failed)),
                     (fc.c.converged.numpy(), np.asarray(fcj.c.converged)),
                     (fc.done.numpy(), np.asarray(fcj.done))]
        differ = np.any([a != b for a, b in decisions], axis=0)
        if differ.any():
            assert game == "collision", f"trip {i}: lanes {differ}"
            with np.errstate(invalid="ignore"):
                ulp = np.spacing(np.abs(before))
                steps_ulps = np.abs(
                    before - np.stack([fc.c.last_merit.numpy(), after])) / ulp
            assert (steps_ulps[:, differ] <= KNIFE_ULPS).all(), (
                f"trip {i}: lanes {differ} decide apart on merit steps of "
                f"{steps_ulps} ulps")
        np.testing.assert_allclose(fc.c.last_merit.numpy(), after,
                                   rtol=TRIP_TOL, atol=TRIP_TOL)
        np.testing.assert_allclose(fc.c.op.xs.numpy(),
                                   np.asarray(fcj.c.op.xs), rtol=TRIP_TOL,
                                   atol=TRIP_TOL)
        if bool(np.asarray(fcj.done).all()):
            break
