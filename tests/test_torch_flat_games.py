"""The flat driving games in the port against the JAX package:
three_player_flat_overtaking and flat_roundabout_merging, on inputs made
from numpy seeds.

- `route_progress` (ilqgames_tpu/costs/atoms.py:589): value, gradient
  pairs and Hessian pairs at seeded states and times, before, along and
  past the end of both games' routes: bitwise against the JAX atom run op
  by op (eager `jax.vmap`); against the jitted JAX atom, whose program XLA
  simplifies (a fused multiply-add in the route walk), the pairs within
  JIT_ULPS (8) ulps of w (|v| + |desired point|) and the value within
  JIT_ULPS ulps of itself, the Hessian bitwise (w on the diagonal, +0
  across, whatever v is);
- the flat models' real-coordinate half (ilqgames_tpu/dynamics/flat.py:
  `ode`, `inv_decoupling` with the reference's `_v_offset`,
  `affine_term`, `linear_controls_to_real`): the entries without
  trigonometry bitwise, the others within TRIG_ULPS (2) ulps of the
  largest term they sum for each trigonometric factor they multiply
  (`fmath`'s sin, cos and tan against XLA's);
- both builders against the JAX builders: x0 in xi bitwise, dims, every
  atom by name and its value at seeded states and times bitwise, the
  roundabout's initial operating point along the lanes bitwise;
- the registry: all 18 names resolve;
- the player-level quadraticization and merit terms of both games at
  seeded states and knot times (1e-5, the stage class);
- one fused trip of the flat overtaking by both machines (the JAX
  package's Pallas kernels in interpret mode) from one carry: decisions
  exactly equal, merits and trajectories within the per-trip class
  (2e-3);
- the flat overtaking's nominal run (N=100, the exec main's parameters,
  its x0 in a block of 8): the port's first three trips' merits within
  2e-3 of the JAX package's batched machine (chip_smoke.FLAT_OVERTAKING_
  JAX), and the float64 witness of why the two part at the fourth: that
  trip's LQ solve is ill-conditioned. On its operands the port's float32
  solve and the JAX package's lie more than 1e-3 of the alphas' scale
  from the float64 solve (the port's plain K2 and K3 in float64), where
  on the trip before the port's lies within 1e-6 of it.

The kernels' layout and K1's plain version against the JAX stage kernel
are in tests/test_torch_flat_games_kernels.py.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import importlib.util  # noqa: E402
from pathlib import Path  # noqa: E402

import ilqgames_tpu.examples as jex  # noqa: E402
from ilqgames_tpu.costs import atoms as jatoms  # noqa: E402
from ilqgames_tpu.costs import player_cost as jpc  # noqa: E402
from ilqgames_tpu.dynamics import flat as jflat  # noqa: E402
from ilqgames_tpu.ops.pallas import lq as jlq  # noqa: E402
from ilqgames_tpu.solver import batched as jbatched  # noqa: E402
from ilqgames_tpu.solver.params import SolverParams as JParams  # noqa: E402
from ilqgames_tpu.types import OperatingPoint as JOp  # noqa: E402
from ilqgames_tpu.types import Strategy as JStrategy  # noqa: E402

import ilqgames_tpu_torch.examples as ex  # noqa: E402
from ilqgames_tpu_torch import bench, geometry  # noqa: E402
from ilqgames_tpu_torch.costs import atoms  # noqa: E402
from ilqgames_tpu_torch.costs import player_cost as pcost  # noqa: E402
from ilqgames_tpu_torch.dynamics import flat  # noqa: E402
from ilqgames_tpu_torch.examples.routes import roundabout_lane_center  # noqa: E402
from ilqgames_tpu_torch.ops.cuda import lq  # noqa: E402
from ilqgames_tpu_torch.solver import batched  # noqa: E402
from ilqgames_tpu_torch.solver.params import SolverParams  # noqa: E402
from ilqgames_tpu_torch.types import OperatingPoint, tree_map  # noqa: E402

torch.set_num_threads(1)

N, B = 11, 4
GAMES = ("three_player_flat_overtaking", "flat_roundabout_merging")
TRIP_TOL = 2e-3   # per-trip arrays, tests/test_batched_pallas.py:119-140
STAGE_TOL = 1e-5
JIT_ULPS = 8
TRIG_ULPS = 2


def _same_bits(got, want, msg=""):
    got = np.asarray(got, np.float32)
    want = np.broadcast_to(np.asarray(want, np.float32), got.shape)
    nan = np.isnan(want)
    assert (np.isnan(got) == nan).all(), msg
    assert (got.view(np.int32)[~nan] == want.view(np.int32)[~nan]).all(), (
        msg, got, want)


def _within_ulps(got, want, scale, ulps, msg=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert (np.isnan(got) == np.isnan(want)).all(), msg
    ok = ~np.isnan(want)
    ulp = np.spacing(np.abs(np.asarray(scale, np.float32)))
    err = np.abs(got - want) / ulp
    assert (err[ok] <= ulps).all(), (msg, err[ok].max())


# (route, nominal speed, initial route position): the flat roundabout's
# first lane (16 points, the last segment 1e4 m), and the overtaking's
# straight lane from P1's start with P1's initial position 0.
ROUTES = {
    "roundabout": (roundabout_lane_center(np.pi / 4, np.pi / 4 + np.pi,
                                          25.0), 10.0, 0.0),
    "straight": (np.array([[-1.0, -10.0], [-1.0, 1000.0]], np.float32),
                 15.0, 2.5),
}


def _route_inputs(seed):
    """States near the routes and far off them, and times from 0 to 250 s
    (past both routes' ends), with t = 0 and a NaN state among them."""
    rng = np.random.RandomState(seed)
    v = (rng.randn(512, 6) * 30).astype(np.float32)
    t = (rng.rand(512) * 250).astype(np.float32)
    t[:4] = 0.0
    v[5, 1] = np.nan
    return v, t


def _keys(pairs):
    """The keys of vmapped pairs (vmap makes each an array per lane)."""
    return [tuple(int(np.asarray(a)[0]) for a in k) if isinstance(k, tuple)
            else int(np.asarray(k)[0]) for k, _ in pairs]


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route_progress_matches_jax(route):
    pts, v_nom, s0 = ROUTES[route]
    c = atoms.route_progress(10.0, pts, 0, 1, v_nom, s0, "RouteProgress")
    jc = jatoms.route_progress(10.0, pts, 0, 1, v_nom, s0, "RouteProgress")
    v, t = _route_inputs(1)
    tv, tt = torch.tensor(v), torch.tensor(t)
    # The JAX atom run op by op: bitwise.
    _same_bits(c.evaluate(tt, tv), jax.vmap(jc.evaluate)(t, v), "value")
    hp, gp = c.quad_pairs(tt, tv)
    jhp, jgp = jax.vmap(jc.quad_pairs)(t, v)
    assert [k for k, _ in hp] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [k for k, _ in gp] == [0, 1]
    assert _keys(jhp) == [k for k, _ in hp] and _keys(jgp) == [0, 1]
    for (k, g), (_, w) in zip(hp + gp, list(jhp) + list(jgp)):
        _same_bits(g, w, str(k))
    for (k, g), (_, w) in zip(gp, jax.vmap(jc.gradient_pairs)(t, v)):
        _same_bits(g, w, f"gradient {k}")
    # The Hessian: w on the diagonal, +0 across, whatever v is.
    for (i, j), h in hp:
        want = 10.0 if i == j else 0.0
        _same_bits(h, np.full(512, want, np.float32), str((i, j)))
    # The jitted JAX atom: the desired point's walk compiled with an FMA.
    jv = jax.jit(jax.vmap(jc.evaluate))(t, v)
    _within_ulps(c.evaluate(tt, tv), jv, jv, JIT_ULPS, "jit value")
    desired = geometry.polyline_point_at(pts, s0 + tt * v_nom).numpy()
    _, jgp = jax.jit(jax.vmap(jc.quad_pairs))(t, v)
    for n, ((k, g), (_, w)) in enumerate(zip(gp, jgp)):
        scale = 10.0 * (np.abs(v[:, k]) + np.abs(desired[:, n]))
        _within_ulps(g, w, scale, JIT_ULPS, f"jit gradient {k}")


def _real_states(n, seed):
    """Real-coordinate car states [px py theta phi v a] with headings up to
    +-6 rad, steering within +-1.2 rad and speeds through zero (where
    `_v_offset` matters), controls around them."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, 6) * (10, 10, 2, 0.4, 4, 1)).astype(np.float32)
    x[:8, 4] = (0.0, -0.0, 1e-7, -1e-7, 1e-3, -1e-3, 0.5, -0.5)
    return x, (rng.randn(n, 2) * 2).astype(np.float32)


@pytest.mark.parametrize("model", ["flat_car_6d", "flat_unicycle_4d"])
def test_flat_model_real_half_matches_jax(model):
    args = (4.0,) if model == "flat_car_6d" else ()
    m, jm = getattr(flat, model)(*args), getattr(jflat, model)(*args)
    x, u = _real_states(256, 4)
    if model == "flat_unicycle_4d":
        x = x[:, [0, 1, 2, 4]]
    tx, tu = torch.tensor(x), torch.tensor(u)
    v = x[:, 4] if model == "flat_car_6d" else x[:, 3]
    c, s = np.cos(x[:, 2]), np.sin(x[:, 2])
    got = m.ode(0.0, tx, tu).numpy()
    want = np.asarray(jax.vmap(lambda a, b: jm.ode(0.0, a, b))(x, u))
    _within_ulps(got[:, 0], want[:, 0], np.maximum(np.abs(v), 1e-30),
                 TRIG_ULPS, "ode 0")
    _within_ulps(got[:, 1], want[:, 1], np.maximum(np.abs(v), 1e-30),
                 TRIG_ULPS, "ode 1")
    if model == "flat_car_6d":
        _within_ulps(got[:, 2], want[:, 2], np.maximum(
            np.abs(want[:, 2]), 1e-30), TRIG_ULPS, "ode 2")
        _same_bits(got[:, 3:], want[:, 3:], "ode 3-5")
    else:
        _same_bits(got[:, 2:], want[:, 2:], "ode 2-3")
    M = m.inv_decoupling(tx).numpy()
    jM = np.asarray(jax.vmap(jm.inv_decoupling)(x))
    assert M.shape == jM.shape == (256, 2, 2)
    # The car's first row multiplies cos(phi)^2 by sin or cos(theta): two
    # ulps for each trigonometric factor.
    _within_ulps(M, jM, np.maximum(np.abs(jM), 1e-30), 2 * TRIG_ULPS,
                 "inv_decoupling")
    aff = m.affine_term(tx).numpy()
    jaff = np.asarray(jax.vmap(jm.affine_term)(x))
    if model == "flat_unicycle_4d":
        _same_bits(aff, jaff, "affine_term")
    else:
        # Each entry sums 3 a sin(theta) and v^2 tan(phi) cos(theta) / L
        # (and their mirror): its scale is the larger product times
        # v tan(phi) / L.
        vt = np.abs(x[:, 4] / 4.0 * np.tan(x[:, 3]))
        big = vt * (3 * np.abs(x[:, 5]) + np.abs(x[:, 4] * vt))
        _within_ulps(aff, jaff, np.maximum(big, 1e-30)[:, None],
                     2 * TRIG_ULPS, "affine_term")
    # _v_offset's sign at v = +-0 is 0: the offset vanishes there, as the
    # JAX package's.
    assert np.isinf(M[0, 1]).all() == np.isinf(jM[0, 1]).all()


def test_linear_controls_to_real_matches_jax():
    mods = [flat.flat_car_6d(4.0), flat.flat_unicycle_4d()]
    jmods = [jflat.flat_car_6d(4.0), jflat.flat_unicycle_4d()]
    x, _ = _real_states(128, 5)
    xu, _ = _real_states(128, 6)
    xs = np.concatenate([x, xu[:, [0, 1, 2, 4]]], 1)
    vs = np.random.RandomState(7).randn(128, 2, 2).astype(np.float32)
    got = flat.linear_controls_to_real(mods, torch.tensor(xs),
                                       torch.tensor(vs)).numpy()
    want = np.asarray(jax.vmap(
        lambda a, b: jflat.linear_controls_to_real(jmods, a, b))(xs, vs))
    assert got.shape == want.shape == (128, 2, 2)
    # Each row sums two products: its scale is the larger of them.
    w = [vs[:, i] - np.asarray(jax.vmap(jm.affine_term)(
        xs[:, o:o + jm.xdim])) for i, (jm, o) in enumerate(
            zip(jmods, (0, 6)))]
    Ms = [np.asarray(jax.vmap(jm.inv_decoupling)(xs[:, o:o + jm.xdim]))
          for jm, o in zip(jmods, (0, 6))]
    for i in range(2):
        scale = np.abs(Ms[i] * w[i][:, None, :]).max(-1)
        _within_ulps(got[:, i], want[:, i], np.maximum(scale, 1e-30),
                     4 * TRIG_ULPS, f"player {i}")


def _atoms(pc):
    return ([c.name for c in pc.state_costs],
            [(j, c.name) for j, c in pc.control_costs],
            pc.structure, pc.state_regularization,
            pc.control_regularization)


@pytest.mark.parametrize("name", GAMES)
def test_builder_matches_jax(name):
    prob, jprob = ex.get(name)(), jex.get(name)()
    assert prob.name == jprob.name == name
    assert prob.x0.numpy().tobytes() == np.asarray(jprob.x0).tobytes()
    spec = prob.spec
    assert (spec.xdims, spec.udims, spec.num_time_steps, spec.dt) == (
        jprob.spec.xdims, jprob.spec.udims, jprob.spec.num_time_steps,
        jprob.spec.dt)
    P = len(spec.xdims)
    assert spec.xdims == (6,) * P and P == (3 if "overtaking" in name else 4)
    assert [pc.state_costs[3].name for pc in prob.player_costs] == [
        "RouteProgress"] * P
    rng = np.random.RandomState(9)
    v = (np.asarray(prob.x0)[None] + 5 * rng.randn(64, spec.xdim)).astype(
        np.float32)
    t = (rng.rand(64) * 10).astype(np.float32)
    for pc, jpc_ in zip(prob.player_costs, jprob.player_costs):
        assert _atoms(pc) == _atoms(jpc_)
        for c, jc in zip(pc.state_costs, jpc_.state_costs):
            _same_bits(c.evaluate(torch.tensor(t), torch.tensor(v)),
                       jax.vmap(jc.evaluate)(t, v), c.name)
    op = prob.initial_operating_point()
    jop = jprob.initial_operating_point()
    _same_bits(op.xs, jop.xs, "initial xs")
    _same_bits(op.us, jop.us, "initial us")
    if name == "flat_roundabout_merging":
        assert (op.xs[:, 0] != 0).all() and (op.xs[:, 2:6] == 0).all()
    else:
        assert (op.xs == 0).all()


def test_registry_resolves_all_18():
    assert ex.names() == jex.names() and len(ex.names()) == 18
    assert ex.ported() == ex.names()
    for name in GAMES:
        assert ex.get(name)().name == name


def _stage_inputs(name, seed):
    """[B, N] states near the game's x0 (some on the lanes' vertices) and
    controls from a seed."""
    prob = ex.get(name)(num_time_steps=N)
    rng = np.random.RandomState(seed)
    x = (prob.x0.numpy()[None, None] + 3 * rng.randn(B, N, prob.spec.xdim)
         ).astype(np.float32)
    us = (rng.randn(B, N, len(prob.spec.xdims), 2) * 2).astype(np.float32)
    return prob, x, us


@pytest.mark.parametrize("name", GAMES)
def test_player_quadraticize_matches_jax(name):
    prob, x, us = _stage_inputs(name, 2)
    jprob = jex.get(name)(num_time_steps=N)
    spec, P = prob.spec, len(prob.spec.xdims)
    t0 = 0.7
    op = OperatingPoint(xs=torch.tensor(x), us=torch.tensor(us),
                        t0=torch.full((B,), t0))
    al = pcost.ALState.init(prob.player_costs, spec, B)
    q = pcost.quadraticize(prob.player_costs, spec, op, al)
    # The unfused quadraticize reads the knot's time k dt.
    empty = tuple(jnp.zeros((0,)) for _ in range(P))
    ts = np.arange(N, dtype=np.float32) * np.float32(spec.dt)
    core = jax.vmap(jax.vmap(
        lambda t, xx, uu: jpc.stage_quadraticize_core(
            jprob.player_costs, jprob.spec, empty, empty, 1.0, t, xx, uu,
            jnp.ones(P)), in_axes=(0, 0, 0)), in_axes=(None, 0, 0))
    for got, w in zip((q.Q, q.l, q.R, q.r), core(ts, x, us)):
        np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                   rtol=STAGE_TOL, atol=STAGE_TOL)


@pytest.mark.parametrize("name", GAMES)
def test_player_merit_terms_match_jax(name):
    prob, x, us = _stage_inputs(name, 3)
    jprob = jex.get(name)(num_time_steps=N)
    P = len(prob.spec.xdims)
    lam = tuple(torch.zeros(B, N, 0) for _ in range(P))
    mu = torch.full((B, N), 10.0)
    ts = (0.3 + np.arange(N, dtype=np.float32)
          * np.float32(prob.spec.dt)).astype(np.float32)
    t = torch.tensor(np.tile(ts[None], (B, 1)))
    s_sq, r_sq = pcost.stage_gradient_sq_tuple(
        prob.player_costs, prob.spec, lam, lam, mu, t, torch.tensor(x),
        torch.tensor(us))
    empty = tuple(jnp.zeros((0,)) for _ in range(P))
    js, jr = jax.vmap(jax.vmap(
        lambda tt, xx, uu: jpc.stage_gradient_sq_tuple(
            jprob.player_costs, jprob.spec, empty, empty, 10.0, tt, xx, uu),
        in_axes=(0, 0, 0)), in_axes=(None, 0, 0))(ts, x, us)
    for p_ in range(P):
        np.testing.assert_allclose(s_sq[p_].numpy(), np.asarray(js[p_]),
                                   rtol=STAGE_TOL, atol=STAGE_TOL)
        np.testing.assert_allclose(r_sq[p_].numpy(), np.asarray(jr[p_]),
                                   rtol=STAGE_TOL, atol=STAGE_TOL)


PARAMS_KW = dict(max_solver_iters=4, max_backtracking_steps=100,
                 initial_alpha_scaling=0.75, convergence_tolerance=0.01,
                 expected_decrease_fraction=0.1)


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


def test_fused_trip_matches_jax():
    """One fused trip of the flat overtaking (the bare iLQ iteration) by
    both machines from one carry: the port's fresh carry, carried into the
    JAX machine's carry type."""
    name = GAMES[0]
    prob, jprob = ex.get(name)(num_time_steps=N), jex.get(name)(
        num_time_steps=N)
    rng = np.random.RandomState(0)
    x0 = (np.tile(prob.x0.numpy()[None], (B, 1))
          + 0.1 * rng.randn(B, prob.spec.xdim)).astype(np.float32)
    jtrip, _, constrained = jbatched._driver_parts(
        jprob.dynamics, jprob.player_costs, jprob.spec, JParams(**PARAMS_KW),
        1, B, True, fuse_stages=True)
    assert not constrained
    trip, _ = batched._driver_parts(prob.dynamics, prob.player_costs,
                                    prob.spec, SolverParams(**PARAMS_KW), B,
                                    True)
    fc = batched._fresh_init(prob.dynamics, prob.player_costs, prob.spec,
                             None, None, B, True)(torch.tensor(x0))
    fcj = jax.jit(jtrip)(jnp.asarray(x0), _jax_carry(jprob, x0, fc))
    fc = trip(torch.tensor(x0), fc)
    for got, want in ((fc.c.failed, fcj.c.failed),
                      (fc.c.converged, fcj.c.converged), (fc.done, fcj.done)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(fc.c.last_merit.numpy(),
                               np.asarray(fcj.c.last_merit), rtol=TRIP_TOL,
                               atol=TRIP_TOL)
    for got, want in ((fc.c.op.xs, fcj.c.op.xs), (fc.c.op.us, fcj.c.op.us)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TRIP_TOL, atol=TRIP_TOL)


def _flat_overtaking_jax():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs.FLAT_OVERTAKING_JAX, cs.TRIP_TOL


def test_flat_overtaking_parts_on_an_ill_conditioned_lq(monkeypatch):
    jax_run, trip_tol = _flat_overtaking_jax()
    assert trip_tol == TRIP_TOL
    make, prm = bench.GOLDEN_RUNS["flat_overtaking"]
    prob = make()
    spec, Bb = prob.spec, bench.GOLDEN_BLOCK
    trip, _ = batched._driver_parts(prob.dynamics, prob.player_costs, spec,
                                    SolverParams(**prm), Bb, True)
    x0 = prob.x0[None].expand(Bb, -1).contiguous()
    fc = batched._fresh_init(prob.dynamics, prob.player_costs, spec, None,
                             None, Bb, True)(x0)
    seen = {}
    solve = lq.solve_lq_feedback_bm

    def spy(spec_, ops, dx0m, **kw):
        seen["ops"], seen["dx0m"] = ops, dx0m
        seen["out"] = solve(spec_, ops, dx0m, **kw)
        return seen["out"]

    monkeypatch.setattr(lq, "solve_lq_feedback_bm", spy)

    def f64_gap():
        """The LQ solve's alphas against the float64 solve of the same
        operands: (the port's gap, the float64 alphas)."""
        o64 = {k: v.double() for k, v in seen["ops"].items()}
        _, al64 = lq.lq_backward_plain(spec, o64)
        return (float((seen["out"][1].double() - al64).abs().max()),
                al64)

    for i in range(3):
        fc = trip(x0, fc)
        np.testing.assert_allclose(fc.c.last_merit[0].item(),
                                   jax_run["merits"][i], rtol=TRIP_TOL)
    gap, al64 = f64_gap()
    assert gap <= 1e-6 * float(al64.abs().max())
    fc = trip(x0, fc)
    merit = fc.c.last_merit[0].item()
    assert abs(merit - jax_run["merits"][3]) > TRIP_TOL * jax_run["merits"][3]
    gap, al64 = f64_gap()
    scale = float(al64.abs().max())
    _, jal, _ = jax.jit(lambda o, d: jlq.solve_lq_feedback_bm(
        spec, o, d, True, Bb, True))(
        {k: jnp.asarray(v.numpy()) for k, v in seen["ops"].items()},
        jnp.asarray(seen["dx0m"].numpy()))
    jgap = float(np.abs(np.asarray(jal, np.float64) - al64.numpy()).max())
    print(f"fourth trip: merit {merit} (the JAX package's "
          f"{jax_run['merits'][3]}); alphas from the float64 solve: the "
          f"port's {gap:.4g}, the JAX package's {jgap:.4g}, of {scale:.4g}")
    assert gap > 1e-3 * scale and jgap > 1e-3 * scale, (gap, jgap, scale)
