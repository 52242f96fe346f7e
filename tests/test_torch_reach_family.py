"""The first half of the reachability family in the port against the JAX
package:

- `geometry.draw_circle` and `draw_square`: bitwise (the reference's
  circle of 10 segments among others);
- `point_mass_2d`: its ODE and Jacobian entries, and the concatenation of
  two (one linear system): `ode` bitwise and `ode_jac` the same entries,
  `linearize` bitwise, at seeded (x, u) with inf and NaN lanes;
- `polyline2_signed_distance`: its value, gradient pairs and
  quadraticization pairs bitwise (0 ulps) against the JAX atom's, which
  runs op by op here (eager vmap; a jitted JAX program contracts
  multiplies and adds into FMAs and moves the last bits), in both
  orientations and at nominal 0 and 1, at seeded points outside (the
  vertex and the interior branch), inside the circle, on a segment and at
  the vertices (sgn(0) = 0), and a NaN lane;
- the three builders (`make_one_player`, `make_two_player_collision_
  avoidance`, `make_modified_air_3d`): x0 bitwise, dims, each player's
  atoms by name and device form, the circle's points and the shared
  atom's nominal (float64 numpy, as the JAX builder computes it);
- the registry: all 18 of its names resolve (the flat driving games, the
  last two, came after this family);
- one fused trip of each game at N=11, B=4 from the JAX machine's carry
  (its Pallas kernels in interpret mode): decisions exactly equal, merits
  and trajectories within the per-trip class (2e-3); for
  modified_air_3d, whose +-1e6 weights put its merits where one ulp is
  0.0625 or more, a decision may differ only where both packages' merit
  steps are within KNIFE_ULPS of the merit;
- the port's one-player solve at N=40 with tests/test_regression_pins.py's
  budgets: 3 iterations and total cost 4.1052866 within 1e-4 relative,
  the JAX package's pin (the port alone).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import ilqgames_tpu.examples as jex  # noqa: E402
from ilqgames_tpu import geometry as jgeom  # noqa: E402
from ilqgames_tpu.costs import atoms as jatoms  # noqa: E402
from ilqgames_tpu.costs import player_cost as jpc  # noqa: E402
from ilqgames_tpu.dynamics import base as jdyn  # noqa: E402
from ilqgames_tpu.dynamics import models as jmodels  # noqa: E402
from ilqgames_tpu.solver import batched as jbatched  # noqa: E402
from ilqgames_tpu.solver.params import SolverParams as JParams  # noqa: E402
from ilqgames_tpu.types import OperatingPoint as JOp  # noqa: E402
from ilqgames_tpu.types import Strategy as JStrategy  # noqa: E402

import ilqgames_tpu_torch.examples as ex  # noqa: E402
from ilqgames_tpu_torch import convert, geometry  # noqa: E402
from ilqgames_tpu_torch.costs import atoms  # noqa: E402
from ilqgames_tpu_torch.dynamics import base as dyn_base  # noqa: E402
from ilqgames_tpu_torch.dynamics import models  # noqa: E402
from ilqgames_tpu_torch.ops.cuda import sweep  # noqa: E402
from ilqgames_tpu_torch.solver import batched  # noqa: E402
from ilqgames_tpu_torch.solver.params import SolverParams  # noqa: E402

torch.set_num_threads(1)

N, B = 11, 4
GAMES = ("one_player_reachability",
         "two_player_collision_avoidance_reachability", "modified_air_3d")
UNPORTED = ()
TRIP_TOL = 2e-3   # per-trip arrays, tests/test_batched_pallas.py:119-140
KNIFE_ULPS = 2    # a merit step this small decides on the last bits


def _same_bits(got, want, msg=""):
    got = np.asarray(got, np.float32)
    want = np.broadcast_to(np.asarray(want, np.float32), got.shape)
    nan = np.isnan(want)
    assert (np.isnan(got) == nan).all(), msg
    assert (got.view(np.int32)[~nan] == want.view(np.int32)[~nan]).all(), (
        msg, got, want)


@pytest.mark.parametrize("center", [(0.0, 0.0), (1.5, -2.25), (-7.0, 30.0)])
def test_draw_shapes_match_jax(center):
    jc = jnp.asarray(center, jnp.float32)
    for n in (3, 4, 7, 10, 12, 16, 20, 33):
        for r in (1.0, 2.0, 0.7, 3.3):
            got = geometry.draw_circle(center, r, n)
            assert got.dtype == np.float32 and got.shape == (n + 1, 2)
            assert got.tobytes() == np.asarray(
                jgeom.draw_circle(jc, r, n)).tobytes(), (n, r)
    for side in (1.0, 2.5, 0.3):
        got = geometry.draw_square(center, side)
        assert got.tobytes() == np.asarray(
            jgeom.draw_square(jc, side)).tobytes(), side


def _xu(n, xdim, udims, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, xdim) * 3).astype(np.float32)
    us = (rng.randn(n, len(udims), max(udims)) * 2).astype(np.float32)
    x[0, 2] = np.inf
    us[1, 0, 0] = np.nan
    return x, us


def test_point_mass_2d_matches_jax():
    m, jm = models.point_mass_2d(), jmodels.point_mass_2d()
    assert (m.name, m.xdim, m.udim, m.position_dims) == (
        jm.name, jm.xdim, jm.udim, jm.position_dims)
    x, us = _xu(64, 4, (2,), 0)
    _same_bits(m.ode(0.0, torch.tensor(x), torch.tensor(us[:, 0])),
               jax.vmap(lambda a, b: jm.ode(0.0, a, b))(x, us[:, 0]), "ode")
    assert m.jac(0.0, None, None) == jm.jac(0.0, x[0], us[0, 0])

    dyn = dyn_base.concatenate("pm2", [m, models.point_mass_2d()])
    jdyn_ = jdyn.concatenate("pm2", [jm, jmodels.point_mass_2d()])
    assert dyn.linear_rows is not None and not dyn.linear_per_player
    assert (dyn.xdims, dyn.udims, dyn.position_dims) == (
        jdyn_.xdims, jdyn_.udims, jdyn_.position_dims)
    x, us = _xu(64, 8, (2, 2), 1)
    _same_bits(dyn.ode(0.0, torch.tensor(x), torch.tensor(us)),
               jax.vmap(lambda a, b: jdyn_.ode(0.0, a, b))(x, us), "ode")
    jx, ju = dyn.ode_jac(0.0, torch.tensor(x), torch.tensor(us))
    jjx, jju = jdyn_.ode_jac(0.0, x[0], us[0])
    assert dict(jx) == dict(jjx) and len(jx) == len(jjx)
    assert dict(ju) == dict(jju) and len(ju) == len(jju)

    spec = dyn.spec(num_time_steps=5)
    xs = x[:40].reshape(8, 5, 8)
    uss = us[:40].reshape(8, 5, 2, 2)
    op = convert.from_operating_point(JOp(xs=xs, us=uss,
                                          t0=np.zeros(8, np.float32)))
    lin = dyn_base.linearize(dyn, spec, op)
    jlin = jax.vmap(lambda o: jdyn.linearize(jdyn_, spec, o))(
        JOp(xs=jnp.asarray(xs), us=jnp.asarray(uss), t0=jnp.zeros(8)))
    _same_bits(lin.A.numpy(), jlin.A, "A")
    _same_bits(lin.Bs.numpy(), jlin.Bs, "Bs")
    tab = sweep._device_table(dyn, spec)
    assert (tab.n, tab.kind[0]) == (1, models.KIND_LINEAR)


def _psd_points(circle):
    """Seeded queries: outside, inside, at the center, on each segment's
    midpoint, at each vertex, and a NaN."""
    rng = np.random.RandomState(4)
    v = (rng.randn(160, 3) * 2.5).astype(np.float32)
    v[:40, :2] *= 0.3
    mids = 0.5 * (circle[:-1] + circle[1:])
    v[40:50, :2] = mids
    v[50:61, :2] = circle
    v[61, :2] = 0.0
    v[62, :2] = [np.nan, 1.0]
    return v


@pytest.mark.parametrize("oriented", [True, False])
@pytest.mark.parametrize("nominal", [0.0, 1.0])
def test_polyline2_signed_distance_matches_jax(oriented, nominal):
    circle = geometry.draw_circle((0.0, 0.0), 2.0, 10)
    c = atoms.polyline2_signed_distance(circle, 0, 1, nominal, oriented,
                                        "Target")
    jc = jatoms.polyline2_signed_distance(jnp.asarray(circle), 0, 1,
                                          nominal, oriented, "Target")
    v = _psd_points(circle)
    tv = torch.tensor(v)
    _same_bits(c.evaluate(0.0, tv).numpy(),
               jax.vmap(lambda a: jc.evaluate(0.0, a))(v), "value")
    res = geometry.polyline_closest_point_xy(circle, tv[:, 0], tv[:, 1],
                                             need_sign=True)
    vertex = res.is_vertex[:62].numpy()
    assert vertex.any() and (~vertex).any()       # both branches
    assert (res.signed_sq_distance[50:61] == 0).all()  # sgn(0) = 0
    jgp = jax.vmap(lambda a: [p for _, p in jc.gradient_pairs(0.0, a)])(v)
    gp = c.gradient_pairs(0.0, tv)
    assert [k for k, _ in gp] == [0, 1]
    for (_, g), w in zip(gp, jgp):
        _same_bits(g.numpy(), w, "gradient")
    hp, qp = c.quad_pairs(0.0, tv)
    jhp, jqp = jax.vmap(lambda a: tuple(
        [p for _, p in e] for e in jc.quad_pairs(0.0, a)))(v)
    assert [k for k, _ in hp] == [(0, 0), (1, 1), (0, 1), (1, 0)]
    for (_, g), w in zip(hp + qp, list(jhp) + list(jqp)):
        _same_bits(g.numpy(), w, "quad pairs")
    assert c.device == ("polyline_signed_distance", {
        "points": circle, "xidx": 0, "yidx": 1, "nominal": nominal,
        "flip": 1.0 if oriented else -1.0})


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
    assert prob.dynamics.name == jprob.dynamics.name
    assert len(prob.player_costs) == len(jprob.player_costs)
    for pc, jpc_ in zip(prob.player_costs, jprob.player_costs):
        assert _atoms(pc) == _atoms(jpc_)
        assert all(c.device is not None for c in pc.state_costs)
    rng = np.random.RandomState(5)
    v = (np.asarray(prob.x0)[None] + 3 * rng.randn(32, spec.xdim)).astype(
        np.float32)
    for pc, jpc_ in zip(prob.player_costs, jprob.player_costs):
        for c, jc in zip(pc.state_costs, jpc_.state_costs):
            _same_bits(c.evaluate(0.0, torch.tensor(v)).numpy(),
                       jax.vmap(lambda a: jc.evaluate(0.0, a))(v), c.name)
    if name == "one_player_reachability":
        prm = prob.player_costs[0].state_costs[0].device[1]
        assert prm["points"].tobytes() == np.asarray(jgeom.draw_circle(
            jnp.zeros(2), 2.0, 10)).tobytes()
        assert (prm["nominal"], prm["flip"]) == (1.0, 1.0)
    elif name == "two_player_collision_avoidance_reachability":
        sd0, sd1 = (pc.state_costs[0] for pc in prob.player_costs)
        assert sd0 is sd1
        horizon = spec.dt * spec.num_time_steps
        t = 0.5 * horizon
        p1 = np.array([0.0, -5.0]) + t * 5.0 * np.array(
            [np.cos(0.1), np.sin(0.1)])
        p2 = np.array([0.0, 0.0]) + t * 5.0 * np.array([1.0, 0.0])
        assert sd0.device[1]["nominal"] == float(np.linalg.norm(p1 - p2))
    else:
        assert prob.dynamics.linear_rows is not None
        assert [pc.state_costs[0].device[1]["weight"]
                for pc in prob.player_costs] == [-1e6, 1e6]


def test_registry_resolves_14_of_18():
    assert ex.names() == jex.names() and len(ex.names()) == 18
    assert len(ex.ported()) == 18 - len(UNPORTED) and set(GAMES) <= set(
        ex.ported())
    assert sorted(set(ex.names()) - set(ex.ported())) == sorted(UNPORTED)
    for name in UNPORTED:
        with pytest.raises(NotImplementedError, match=name):
            ex.get(name)


PARAMS_KW = dict(max_solver_iters=4, unconstrained_solver_max_iters=10,
                 max_backtracking_steps=100, initial_alpha_scaling=0.1,
                 convergence_tolerance=1.0, expected_decrease_fraction=0.001)


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


@pytest.mark.parametrize("name", GAMES)
def test_fused_trip_from_the_jax_carry(name):
    """One fused trip of each game with the exec main's parameters from
    the JAX machine's first carry (the AL trip for the one-player game,
    the bare iLQ iteration for the others)."""
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
    fcj = _jax_carry0(jprob, x0)
    fc = convert.from_fused_carry(fcj)
    fc = fc.replace(c=fc.c.replace(quad=batched._empty_quad(B, "cpu")))
    before = np.asarray(fcj.c.last_merit)
    fcj = jax.jit(jtrip)(jnp.asarray(x0), fcj)
    fc = trip(torch.tensor(x0), fc)
    after = np.asarray(fcj.c.last_merit)
    decisions = [(fc.c.failed.numpy(), np.asarray(fcj.c.failed)),
                 (fc.c.converged.numpy(), np.asarray(fcj.c.converged)),
                 (fc.done.numpy(), np.asarray(fcj.done))]
    differ = np.any([a != b for a, b in decisions], axis=0)
    if differ.any():
        assert name == "modified_air_3d", f"lanes {differ}"
        with np.errstate(invalid="ignore"):
            ulp = np.spacing(np.abs(before))
            steps = np.abs(before - np.stack([fc.c.last_merit.numpy(),
                                              after])) / ulp
        assert (steps[:, differ] <= KNIFE_ULPS).all(), steps
    np.testing.assert_allclose(fc.c.last_merit.numpy(), after,
                               rtol=TRIP_TOL, atol=TRIP_TOL)
    np.testing.assert_allclose(fc.c.op.xs.numpy(), np.asarray(fcj.c.op.xs),
                               rtol=TRIP_TOL, atol=TRIP_TOL)
    for got, want in zip(fc.al.control_lambdas, fcj.al.control_lambdas):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TRIP_TOL, atol=TRIP_TOL)


def test_one_player_solve_matches_the_pin():
    """tests/test_regression_pins.py:29's pin of the JAX package: N=40,
    its budgets, 3 iterations and total cost 4.1052866 (rtol 1e-4)."""
    prob = ex.get("one_player_reachability")(num_time_steps=40)
    params = SolverParams(max_solver_iters=25,
                          unconstrained_solver_max_iters=10,
                          max_backtracking_steps=20,
                          initial_alpha_scaling=0.1,
                          convergence_tolerance=1.0,
                          expected_decrease_fraction=0.001)
    res = batched.make_host_batched_solver(
        prob.dynamics, prob.player_costs, prob.spec, params,
        batch_block=1)(prob.x0[None])
    assert int(res.cumulative_iterations[0]) == 3
    np.testing.assert_allclose(res.total_costs[0].numpy(), [4.1052866],
                               rtol=1e-4, atol=0)
