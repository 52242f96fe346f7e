"""The second half of the reachability family in the port against the JAX
package: the coupled systems and their two games.

- `two_player_unicycle_4d` and `air_3d`: `ode` against the JAX package's
  at seeded (x, u) with inf and NaN lanes: the rows without trigonometry
  bitwise, the rows with it within TRIG_ULPS (2) ulps of the larger of
  the row's value and its trigonometric term (`fmath`'s sin and cos are
  correctly rounded, XLA's within an ulp or two of them), 4 on the lane
  whose heading is 1e6 rad (XLA's reduction of a large argument against
  `fmath`'s exact one); `ode_jac` the same entries in the same order, the
  ones without trigonometry bitwise, the others within the same ulps;
  `linearize` within 1e-6;
- each builder (`reachability.make_two_player`, `air_3d.make_problem`)
  against the JAX builder: x0 bitwise, dims with a player of no state,
  each player's atoms by name, the circle's points bitwise, the
  nominals, the structures and air_3d's control constraints (P2's on
  its control 0);
- the registry: all 18 of its names resolve, the two flat games (ported
  after this family) among them;
- one fused trip of each game at N=11, B=4 by both machines (the JAX
  package's Pallas kernels in interpret mode; the AL trip for air_3d, the
  bare iLQ iteration for two_player_reachability) from one carry: the
  port's fresh carry, carried into the JAX machine's carry type (the
  JAX machine's own `_carry0` would cost a compile of its own);
  decisions exactly equal, merits, trajectories and control multipliers
  within the per-trip class (2e-3).

The port's two-player solve at N=100 against the pin of
tests/test_golden_more.py is in tests/test_torch_coupled_reach_kernels.py,
which imports no JAX (this file's JAX compiles fill its minute).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import ilqgames_tpu.examples as jex  # noqa: E402
from ilqgames_tpu import geometry as jgeom  # noqa: E402
from ilqgames_tpu.costs import player_cost as jpc  # noqa: E402
from ilqgames_tpu.dynamics import base as jdyn  # noqa: E402
from ilqgames_tpu.dynamics import models as jmodels  # noqa: E402
from ilqgames_tpu.solver import batched as jbatched  # noqa: E402
from ilqgames_tpu.solver.params import SolverParams as JParams  # noqa: E402
from ilqgames_tpu.types import OperatingPoint as JOp  # noqa: E402
from ilqgames_tpu.types import Strategy as JStrategy  # noqa: E402

import ilqgames_tpu_torch.examples as ex  # noqa: E402
from ilqgames_tpu_torch import convert  # noqa: E402
from ilqgames_tpu_torch.dynamics import base as dyn_base  # noqa: E402
from ilqgames_tpu_torch.dynamics import models  # noqa: E402
from ilqgames_tpu_torch.solver import batched  # noqa: E402
from ilqgames_tpu_torch.solver.params import SolverParams  # noqa: E402
from ilqgames_tpu_torch.types import tree_map  # noqa: E402

torch.set_num_threads(1)

N, B = 11, 4
GAMES = ("two_player_reachability", "air_3d")
UNPORTED = ()
TRIP_TOL = 2e-3   # per-trip arrays, tests/test_batched_pallas.py:119-140
TRIG_ULPS = 2     # twice that where the heading is beyond 8192 rad


def _same_bits(got, want, msg=""):
    got = np.asarray(got, np.float32)
    want = np.broadcast_to(np.asarray(want, np.float32), got.shape)
    nan = np.isnan(want)
    assert (np.isnan(got) == nan).all(), msg
    assert (got.view(np.int32)[~nan] == want.view(np.int32)[~nan]).all(), (
        msg, got, want)


def _within_ulps(got, want, scale, heading, msg=""):
    """Equal NaN and inf places, and |got - want| within TRIG_ULPS ulps of
    `scale` (the row's value or its trigonometric term, the larger), twice
    that where |heading| is beyond 8192 rad."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert (np.isnan(got) == np.isnan(want)).all(), msg
    fin = np.isfinite(want)
    assert (got[~fin & ~np.isnan(want)] == want[~fin & ~np.isnan(want)]
            ).all(), msg
    ulp = np.spacing(np.maximum(np.abs(want), np.abs(scale)).astype(
        np.float32))
    err = np.abs(got.astype(np.float64) - want) / ulp
    bound = np.where(np.abs(heading) > 8192.0, 2 * TRIG_ULPS, TRIG_ULPS)
    assert (err[fin] <= bound[fin]).all(), (msg, err[fin].max())


def _xu(n, xdim, umax, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, xdim) * 3).astype(np.float32)
    us = (rng.randn(n, 2, umax) * 2).astype(np.float32)
    x[0, 2] = np.inf
    x[1, 3 % xdim] = np.nan
    us[2, 0, 0] = np.nan
    us[3, 1, 0] = np.inf
    x[4, 2] = 1e6                       # a diverged heading
    return x, us


CASES = {
    "two_player_unicycle_4d": (models.two_player_unicycle_4d,
                               jmodels.two_player_unicycle_4d, (), 4, 2),
    "air_3d": (models.air_3d, jmodels.air_3d, (0.75, 1.25), 3, 1),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_coupled_model_matches_jax(name):
    make, jmake, args, xdim, umax = CASES[name]
    dyn, jd = make(*args), jmake(*args)
    assert (dyn.name, dyn.xdims, dyn.udims, dyn.position_dims) == (
        jd.name, jd.xdims, jd.udims, jd.position_dims) == (
        name, (xdim, 0), (umax, umax), ((0, 1), (0, 1)))
    assert dyn.kind in models.COUPLED_KINDS and not dyn.models
    assert dyn.params == tuple(float(a) for a in args)
    x, us = _xu(256, xdim, umax, 1)
    tx, tu = torch.tensor(x), torch.tensor(us)
    got = dyn.ode(0.0, tx, tu).numpy()
    want = np.asarray(jax.vmap(lambda a, b: jd.ode(0.0, a, b))(x, us))
    # The trigonometric term of each row: v cos, v sin (unicycle), vp cos,
    # vp sin (air_3d).
    v = x[:, 3] if name == "two_player_unicycle_4d" else np.float32(args[1])
    trig = {0: v * np.cos(x[:, 2]), 1: v * np.sin(x[:, 2])}
    for r in range(xdim):
        if r in trig:
            _within_ulps(got[:, r], want[:, r], trig[r], x[:, 2],
                         f"ode row {r}")
        else:
            _same_bits(got[:, r], want[:, r], f"ode row {r}")
    jx, ju = dyn.ode_jac(0.0, tx, tu)
    jjx, jju = jax.vmap(lambda a, b: tuple(
        [val for _, val in e] for e in jd.ode_jac(0.0, a, b)))(x, us)
    keys = lambda e: [k for k, _ in e]
    kx, ku = (keys(e) for e in jd.ode_jac(0.0, x[5], us[5]))
    assert keys(jx) == kx and keys(ju) == ku
    for k, (_, g), w in zip(kx + ku, jx + ju, list(jjx) + list(jju)):
        g = np.broadcast_to(np.asarray(g, np.float32), np.shape(w))
        if k[-1] == 2 and len(k) == 2:      # d/dtheta: a sine or a cosine
            _within_ulps(g, w, w, x[:, 2], str(k))
        elif len(k) == 2 and name == "air_3d" or len(k) == 3:
            _same_bits(g, w, str(k))
        else:                               # the unicycle's c and s
            _within_ulps(g, w, w, x[:, 2], str(k))


@pytest.mark.parametrize("name", sorted(CASES))
def test_coupled_linearize_matches_jax(name):
    make, jmake, args, xdim, umax = CASES[name]
    dyn, jd = make(*args), jmake(*args)
    spec = dyn.spec(num_time_steps=5)
    x, us = _xu(40, xdim, umax, 2)
    xs, uss = x.reshape(8, 5, xdim), us.reshape(8, 5, 2, umax)
    t0 = np.full(8, 0.3, np.float32)
    lin = dyn_base.linearize(dyn, spec, convert.from_operating_point(
        JOp(xs=xs, us=uss, t0=t0)))
    jlin = jax.jit(jax.vmap(lambda o: jdyn.linearize(jd, spec, o)))(
        JOp(xs=jnp.asarray(xs), us=jnp.asarray(uss), t0=jnp.asarray(t0)))
    for got, want, what in ((lin.A, jlin.A, "A"), (lin.Bs, jlin.Bs, "Bs")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6, err_msg=what)


def _atoms(pc):
    return ([c.name for c in pc.state_costs],
            [(j, c.name) for j, c in pc.control_costs],
            [(j, c.name) for j, c in pc.control_constraints], pc.structure,
            pc.state_regularization, pc.control_regularization)


@pytest.mark.parametrize("name", GAMES)
def test_builder_matches_jax(name):
    prob, jprob = ex.get(name)(), jex.get(name)()
    assert prob.name == jprob.name == name
    assert prob.x0.numpy().tobytes() == np.asarray(jprob.x0).tobytes()
    spec = prob.spec
    assert (spec.xdims, spec.udims, spec.num_time_steps, spec.dt) == (
        jprob.spec.xdims, jprob.spec.udims, jprob.spec.num_time_steps,
        jprob.spec.dt)
    assert 0 in spec.xdims
    assert prob.dynamics.name == jprob.dynamics.name
    assert len(prob.player_costs) == len(jprob.player_costs) == 2
    for pc, jpc_ in zip(prob.player_costs, jprob.player_costs):
        assert _atoms(pc) == _atoms(jpc_)
    assert [pc.structure for pc in prob.player_costs] == ["max", "min"]
    radius = 1.0 if name == "two_player_reachability" else 5.0
    circle = np.asarray(jgeom.draw_circle(jnp.zeros(2), radius, 10))
    for pc, nominal in zip(prob.player_costs, (0.0, 1.0)):
        prm = pc.state_costs[0].device[1]
        assert prm["points"].tobytes() == circle.tobytes()
        assert (prm["nominal"], prm["flip"], prm["xidx"], prm["yidx"]) == (
            nominal, 1.0, 0, 1)
    rng = np.random.RandomState(5)
    v = (np.asarray(prob.x0)[None] + 3 * rng.randn(32, spec.xdim)).astype(
        np.float32)
    for pc, jpc_ in zip(prob.player_costs, jprob.player_costs):
        for c, jc in zip(pc.state_costs, jpc_.state_costs):
            _same_bits(c.evaluate(0.0, torch.tensor(v)).numpy(),
                       jax.vmap(lambda a: jc.evaluate(0.0, a))(v), c.name)
        u = np.linspace(-3.0, 3.0, 13, dtype=np.float32)[:, None]
        for (j, c), (jj, jc) in zip(pc.control_constraints,
                                    jpc_.control_constraints):
            assert j == jj and jc.support == (c.device[1]["dim"],)
            _same_bits(c.g(0.0, torch.tensor(u)).numpy(),
                       jax.vmap(lambda a: jc.g(0.0, a))(u), c.name)
    if name == "air_3d":
        assert prob.dynamics.params == (1.0, 1.0)
        assert [(j, c.device) for pc in prob.player_costs
                for j, c in pc.control_constraints] == [
            (i, ("single_dimension", dict(dim=0, threshold=th,
                                          keep_below=below)))
            for i in (0, 1) for th, below in ((1.0, True), (-1.0, False))]


def test_registry_resolves_16_of_18():
    assert ex.names() == jex.names() and len(ex.names()) == 18
    assert len(ex.ported()) == 18 and set(GAMES) <= set(ex.ported())
    assert sorted(set(ex.names()) - set(ex.ported())) == sorted(UNPORTED)
    for name in UNPORTED:
        with pytest.raises(NotImplementedError, match=name):
            ex.get(name)


PARAMS_KW = dict(max_solver_iters=4, unconstrained_solver_max_iters=10,
                 max_backtracking_steps=100, initial_alpha_scaling=0.1,
                 convergence_tolerance=1.0, expected_decrease_fraction=0.001)


def _jax_carry(jprob, x0, fc):
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
                                al0, B, True, fuse_stages=True)

    def leaf(want, got):
        assert tuple(want.shape) == tuple(got.shape), (want, got.shape)
        return jnp.asarray(got.numpy(), want.dtype)

    return tree_map(leaf, jax.eval_shape(carry0, jnp.asarray(x0)), fc)


@pytest.mark.parametrize("name", GAMES)
def test_fused_trip_matches_jax(name):
    """One fused trip of each game by both machines from one carry."""
    prob, jprob = ex.get(name)(num_time_steps=N), jex.get(name)(
        num_time_steps=N)
    rng = np.random.RandomState(0)
    x0 = (np.tile(prob.x0.numpy()[None], (B, 1))
          + 0.1 * rng.randn(B, prob.spec.xdim)).astype(np.float32)
    jtrip, _, _ = jbatched._driver_parts(
        jprob.dynamics, jprob.player_costs, jprob.spec, JParams(**PARAMS_KW),
        1, B, True, fuse_stages=True)
    trip, _ = batched._driver_parts(prob.dynamics, prob.player_costs,
                                    prob.spec, SolverParams(**PARAMS_KW), B,
                                    True)
    fc = batched._fresh_init(prob.dynamics, prob.player_costs, prob.spec,
                             None, None, B, True)(torch.tensor(x0))
    fcj = jax.jit(jtrip)(jnp.asarray(x0), _jax_carry(jprob, x0, fc))
    fc = trip(torch.tensor(x0), fc)
    for got, want in ((fc.c.failed, fcj.c.failed),
                      (fc.c.converged, fcj.c.converged), (fc.done, fcj.done),
                      (fc.c.extreme_ks, fcj.c.extreme_ks)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(fc.c.last_merit.numpy(),
                               np.asarray(fcj.c.last_merit), rtol=TRIP_TOL,
                               atol=TRIP_TOL)
    for got, want in ((fc.c.op.xs, fcj.c.op.xs), (fc.c.op.us, fcj.c.op.us)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TRIP_TOL, atol=TRIP_TOL)
    for got, want in zip(fc.al.control_lambdas, fcj.al.control_lambdas):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TRIP_TOL, atol=TRIP_TOL)

