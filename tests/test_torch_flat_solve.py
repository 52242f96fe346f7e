"""The three-player flat intersection solved by the port's unfused
unconstrained trip (`solver/batched.py`, `fuse_stages=False`: the plain
linearize and quadraticize with the dense fold, K2/K3 and K4 with the
plain merit fold) against the JAX package's `make_host_batched_solver`
with `fuse_stages=False` (its Pallas kernels in interpret mode), at N=11,
B=4, under the plain and the queue drivers, on two x0 draws (the
bench's sigma 0.1, where every lane stops after two iterations at this
horizon, and sigma 2.0, where lanes run four to five, with deep-ladder
rounds), with the classes of tests/test_torch_unconstrained.py: per
instance `converged` and `cumulative_iterations` equal, costs within the
per-trip class (2e-3), max_violation -inf; the queue driver's results
bitwise equal to the plain driver's; and each of twelve unfused trips
from the JAX machine's own carry with equal decisions on every lane.

Merits here reach ~1e6 (one ulp 0.0625) and the convergence tolerance is
1.0, so a decision can turn on a merit step of an ulp or two, which the
port's sums (formed in another order than XLA's) and the JAX package's
may round apart. A decision passes apart only with the evidence that it
is such a knife edge: trip by trip from the JAX carry, both packages'
merit steps on that lane are within KNIFE_ULPS of its merit; over whole
solves, the lane's iterations are at most one apart and the two final
trajectories' merits within KNIFE_ULPS of each other. At sigma 2.0 lane 0
is one: on its fifth iteration the port steps its merit down by 2 ulps
and converges, the JAX package finds no step and fails."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ilqgames_tpu.costs import player_cost as jpc  # noqa: E402
from ilqgames_tpu.examples import three_player_flat_intersection as jff  # noqa: E402
from ilqgames_tpu.solver import batched as jbatched  # noqa: E402
from ilqgames_tpu.solver.params import SolverParams as JParams  # noqa: E402
from ilqgames_tpu.types import OperatingPoint as JOp  # noqa: E402
from ilqgames_tpu.types import Strategy as JStrategy  # noqa: E402

from ilqgames_tpu_torch import convert  # noqa: E402
from ilqgames_tpu_torch.costs import player_cost as pcost  # noqa: E402
from ilqgames_tpu_torch.examples import three_player_flat_intersection as ff  # noqa: E402
from ilqgames_tpu_torch.ops.cuda import sweep  # noqa: E402
from ilqgames_tpu_torch.solver import batched  # noqa: E402
from ilqgames_tpu_torch.solver.params import SolverParams  # noqa: E402

torch.set_num_threads(1)

N, B = 11, 4
SIGMAS = (0.1, 2.0)
PARAMS_KW = dict(max_solver_iters=12, unconstrained_solver_max_iters=5,
                 max_backtracking_steps=20, initial_alpha_scaling=0.1,
                 convergence_tolerance=1.0, expected_decrease_fraction=0.001)
QUEUE = dict(device_batch=2, trips_per_call=3, batch_block=2)
TRIP_TOL = 2e-3   # per-trip arrays, tests/test_batched_pallas.py:119-140
KNIFE_ULPS = 2    # a merit step this small decides on the last bits


def _x0(prob, sigma):
    rng = np.random.RandomState(0)
    return (np.tile(prob.x0.numpy()[None], (B, 1))
            + sigma * rng.randn(B, prob.spec.xdim)).astype(np.float32)


@pytest.fixture(scope="module")
def runs():
    """sigma -> (port plain, port queue, JAX plain, JAX queue) on the same
    x0, each solved once for this module, all unfused. The JAX package's
    `_driver_parts` is memoized while its drivers run, so that every solve
    shares one trip program and its interpret-mode compilation."""
    cache, parts = {}, {}
    driver_parts = jbatched._driver_parts

    def shared_parts(*args, **kwargs):
        key = (tuple(id(a) for a in args[:4]) + args[4:],
               tuple(sorted(kwargs.items())))
        if key not in parts:
            parts[key] = driver_parts(*args, **kwargs)
        return parts[key]

    prob, jprob = ff.make_problem(num_time_steps=N), jff.make_problem(
        num_time_steps=N)
    args = (prob.dynamics, prob.player_costs, prob.spec,
            SolverParams(**PARAMS_KW))
    jargs = (jprob.dynamics, jprob.player_costs, jprob.spec,
             JParams(**PARAMS_KW))

    def get(sigma):
        if sigma not in cache:
            x0 = _x0(prob, sigma)
            plain = batched.make_host_batched_solver(
                *args, trips_per_call=3, batch_block=2, fuse_stages=False)(
                    torch.tensor(x0))
            queue = batched.make_host_batched_queue_solver(
                *args, fuse_stages=False, **QUEUE)(torch.tensor(x0))
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jbatched, "_driver_parts", shared_parts)
                jplain = jbatched.make_host_batched_solver(
                    *jargs, trips_per_call=3, batch_block=2, interpret=True,
                    fuse_stages=False)(jnp.asarray(x0))
                jqueue = jbatched.make_host_batched_queue_solver(
                    *jargs, interpret=True, fuse_stages=False, **QUEUE)(
                        jnp.asarray(x0))
            cache[sigma] = (plain, queue, jplain, jqueue)
        return cache[sigma]

    return get


@pytest.mark.parametrize("sigma", SIGMAS)
def test_queue_matches_plain(runs, sigma):
    plain, queue, _, _ = runs(sigma)
    for name in ("converged", "cumulative_iterations", "total_costs",
                 "max_violation"):
        assert torch.equal(getattr(queue, name), getattr(plain, name)), name
    assert torch.equal(queue.op.xs, plain.op.xs)


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


@pytest.mark.parametrize("driver", ["plain", "queue"])
@pytest.mark.parametrize("sigma", SIGMAS)
def test_drivers_match_jax(runs, sigma, driver):
    plain, queue, jplain, jqueue = runs(sigma)
    res, jres = (plain, jplain) if driver == "plain" else (queue, jqueue)
    iters = res.cumulative_iterations.numpy()
    jiters = np.asarray(jres.cumulative_iterations)
    conv, jconv = res.converged.numpy(), np.asarray(jres.converged)
    differ = (iters != jiters) | (conv != jconv)
    if differ.any():
        # Knife edges only: at most one iteration apart, and final
        # trajectories whose merits differ in the last bits.
        prob = ff.make_problem(num_time_steps=N)
        m, jm = _final_merits(prob, res.op), _final_merits(prob, jres.op)
        gap = np.abs(m - jm) / np.spacing(np.abs(jm))
        assert (np.abs(iters - jiters)[differ] <= 1).all(), (iters, jiters)
        assert (gap[differ] <= KNIFE_ULPS).all(), (conv, jconv, gap)
    np.testing.assert_allclose(res.total_costs.numpy(),
                               np.asarray(jres.total_costs), rtol=TRIP_TOL,
                               atol=TRIP_TOL)
    assert torch.isinf(res.max_violation).all()
    assert (res.max_violation < 0).all()
    np.testing.assert_array_equal(np.asarray(jres.max_violation),
                                  res.max_violation.numpy())


def _jax_carry0(jprob, x0):
    spec = jprob.spec
    bc = lambda t: jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a[None], (B,) + a.shape), t)
    al0 = jax.vmap(lambda _: jpc.ALState.init(jprob.player_costs, spec))(
        jnp.arange(B))
    return jbatched._carry0(jprob.dynamics, jprob.player_costs, spec,
                            jnp.asarray(x0), bc(JOp.zeros(spec)),
                            bc(JStrategy.zeros(spec)), al0, 2, True,
                            fuse_stages=False)


@pytest.mark.parametrize("sigma", SIGMAS)
def test_unfused_trips_from_the_jax_carry(sigma):
    """Each of twelve unfused trips from the JAX machine's carry before it
    (its carried quadraticization included): failed, converged and done
    equal on every lane but knife edges, merits, trajectories and the
    carried quadraticization within the per-trip class."""
    prob, jprob = ff.make_problem(num_time_steps=N), jff.make_problem(
        num_time_steps=N)
    x0 = _x0(prob, sigma)
    steps, _, constrained = jbatched._driver_parts(
        jprob.dynamics, jprob.player_costs, jprob.spec, JParams(**PARAMS_KW),
        1, 2, True, fuse_stages=False)
    assert not constrained
    steps = jax.jit(steps)
    trip, _ = batched._driver_parts(prob.dynamics, prob.player_costs,
                                    prob.spec, SolverParams(**PARAMS_KW), 2,
                                    False)
    fcj = _jax_carry0(jprob, x0)
    for i in range(PARAMS_KW["max_solver_iters"]):
        fc = convert.from_fused_carry(fcj)
        before = np.asarray(fcj.c.last_merit)
        fcj = steps(jnp.asarray(x0), fcj)
        fc = trip(torch.tensor(x0), fc)
        after = np.asarray(fcj.c.last_merit)
        decisions = [(fc.c.failed.numpy(), np.asarray(fcj.c.failed)),
                     (fc.c.converged.numpy(), np.asarray(fcj.c.converged)),
                     (fc.done.numpy(), np.asarray(fcj.done))]
        differ = np.any([a != b for a, b in decisions], axis=0)
        if differ.any():
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
        for name in ("Q", "l", "R", "r"):
            np.testing.assert_allclose(
                getattr(fc.c.quad, name).numpy(),
                np.asarray(getattr(fcj.c.quad, name)), rtol=TRIP_TOL,
                atol=TRIP_TOL, err_msg=f"trip {i}: quad {name}")
        if bool(np.asarray(fcj.done).all()):
            break
