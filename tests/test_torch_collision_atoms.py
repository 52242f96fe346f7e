"""The atoms of the two unconstrained games against the JAX package's
(`ilqgames_tpu/costs/atoms.py`): `quadratic` over all dims (the control
padding included), `final_time`, `semiquadratic_polyline2` and the
`proximity` cost; each one's evaluate, gradient pairs and
quadraticization pairs on the same numpy-made inputs, within 1e-5
(relative, and absolute at 1e-5 of the atom's weight; the proximity
cost's Hessian is autodiff in the JAX package and written out in the
port). The inputs cover the polyline query's vertex, interior and
endpoint branches (and the interior-vertex side fix), both orientations,
inside and outside each threshold, a distance below EPS, and times just
below, at and just above a final-time gate.

Then the knot times: the stage kernel's plain version sees absolute
times t0 + k dt, as the JAX package's fused stage kernel does, and the
unfused quadraticize relative ones, as the JAX package's does; at t0 =
0.35 the two differ on the collision's goal gate, and the stage kernel's
plain version used to give the relative answer. At t0 = 0 knot 95's time
lands exactly on the gate (95 * 0.1f rounds to 9.5)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ilqgames_tpu.costs import atoms as jatoms  # noqa: E402
from ilqgames_tpu.costs import player_cost as jpc  # noqa: E402
from ilqgames_tpu.examples import two_player_collision as jtc  # noqa: E402
from ilqgames_tpu.ops.pallas import stage as jstage  # noqa: E402
from ilqgames_tpu.types import OperatingPoint as JOp  # noqa: E402

from ilqgames_tpu_torch import convert  # noqa: E402
from ilqgames_tpu_torch.costs import atoms, player_cost as pc  # noqa: E402
from ilqgames_tpu_torch.examples import two_player_collision as tc  # noqa: E402
from ilqgames_tpu_torch.ops.cuda import stage, sweep  # noqa: E402

torch.set_num_threads(1)

LANE = np.array([[2.5, -50.0], [2.5, 50.0]], np.float32)
BENT = np.array([[0.0, 0.0], [10.0, 0.0], [10.0, 10.0], [20.0, 15.0]],
                np.float32)


def _points(rng, polyline, n=400):
    """Queries near the polyline: random ones, its vertices and their
    neighbourhoods, points beyond its ends, on its lines (cross = 0) and
    at the thresholds' distances."""
    lo, hi = polyline.min(0) - 8.0, polyline.max(0) + 8.0
    q = [lo + (hi - lo) * rng.rand(n, 2)]
    for p in polyline:
        q.append(p + 0.3 * rng.randn(20, 2))
        q.append(p[None])
    d = polyline[-1] - polyline[0]
    q.append(polyline[0] - 0.1 * d[None] * rng.rand(10, 1))
    q.append(polyline[-1] + 0.1 * d[None] * rng.rand(10, 1))
    q.append(polyline[:1] + d[None] * rng.rand(10, 1))
    for off in (0.0, 2.5, -2.5, 5.0):
        n_ = np.array([d[1], -d[0]]) / np.linalg.norm(d)
        q.append(polyline[:1] + 0.5 * d[None] + off * n_[None])
    return np.concatenate(q).astype(np.float32)


def _state(q, xd=12, xidx=0, yidx=1, rng=None):
    v = (rng.randn(q.shape[0], xd) if rng is not None
         else np.zeros((q.shape[0], xd))).astype(np.float32)
    v[:, xidx], v[:, yidx] = q[:, 0], q[:, 1]
    return v


def _check(cost, jcost, t, v, scale):
    """evaluate, gradient pairs and quad pairs of the port's atom against
    the JAX package's, vmapped over the rows of v."""
    tol = dict(rtol=1e-5, atol=1e-5 * scale)
    tt, vt = torch.tensor(t), torch.tensor(v)
    tj, vj = jnp.asarray(t), jnp.asarray(v)
    np.testing.assert_allclose(cost.evaluate(tt, vt).numpy(),
                               np.asarray(jax.vmap(jcost.evaluate)(tj, vj)),
                               **tol)
    keys = lambda pairs: [k for k, _ in pairs]
    vals = lambda pairs: [v_ for _, v_ in pairs]
    got = cost.gradient_pairs(tt, vt)
    assert keys(got) == keys(jcost.gradient_pairs(tj[0], vj[0]))
    want = jax.vmap(lambda a, b: vals(jcost.gradient_pairs(a, b)))(tj, vj)
    for k, g, w in zip(keys(got), vals(got), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=str(k),
                                   **tol)
    hp, gp = cost.quad_pairs(tt, vt)
    jhp0, jgp0 = jcost.quad_pairs(tj[0], vj[0])
    assert keys(hp) == keys(jhp0) and keys(gp) == keys(jgp0)
    jhp, jgp = jax.vmap(lambda a, b: tuple(
        vals(p_) for p_ in jcost.quad_pairs(a, b)))(tj, vj)
    for k, g, w in zip(keys(hp) + keys(gp), vals(hp) + vals(gp),
                       list(jhp) + list(jgp)):
        np.testing.assert_allclose(
            np.broadcast_to(g.numpy(), np.shape(w)), np.asarray(w),
            err_msg=str(k), **tol)


@pytest.mark.parametrize("on", ["state", "padded control"])
def test_quadratic_all_dims(on):
    """w * I over every dim, the padding of a player's controls too."""
    rng = np.random.RandomState(1)
    d = 12 if on == "state" else 2
    v = rng.randn(64, d).astype(np.float32)
    if on != "state":
        v[:, 1] = 0.0   # a one-control player's padded entry
    for w, nom in ((1.0, 0.0), (0.1, 0.25)):
        _check(atoms.quadratic(w, None, nom), jatoms.quadratic(w, None, nom),
               np.zeros(64, np.float32), v, w)


@pytest.mark.parametrize("inner", ["quadratic", "proximity"])
def test_final_time_gate(inner):
    """Times just below, at and above the gate; the gate at 9.5 is met by
    knot 95 of a 0.1 s grid in float32."""
    rng = np.random.RandomState(2)
    gate = 9.5
    t = np.repeat(np.array([np.nextafter(np.float32(gate), np.float32(0)),
                            np.float32(95) * np.float32(0.1),
                            np.nextafter(np.float32(gate), np.float32(20)),
                            0.0, 10.0], np.float32), 40)
    v = rng.randn(t.shape[0], 12).astype(np.float32) * 4
    if inner == "quadratic":
        mk = lambda m: m.final_time(m.quadratic(1000.0, 1, 50.0), gate)
        scale = 1000.0 * 60
    else:
        mk = lambda m: m.final_time(m.proximity(5000.0, (0, 1), (6, 7), 7.5),
                                    gate)
        scale = 5000.0 * 8
    assert np.float32(95) * np.float32(0.1) == np.float32(gate)
    _check(mk(atoms), mk(jatoms), t, v, scale)
    # Below the gate every pair is zero, at and above it the inner atom's.
    cost = mk(atoms)
    g = cost.gradient_pairs(torch.tensor(t), torch.tensor(v))
    below = torch.tensor(t < gate)
    assert all(bool((p[below] == 0).all()) for _, p in g)


@pytest.mark.parametrize("polyline", ["lane", "bent"])
@pytest.mark.parametrize("threshold,right",
                         [(-2.5, False), (0.0, True), (2.5, True),
                          (0.0, False), (-2.5, True)])
def test_semiquadratic_polyline2(polyline, threshold, right):
    rng = np.random.RandomState(3)
    pts = LANE if polyline == "lane" else BENT
    v = _state(_points(rng, pts), rng=rng)
    w = 50000.0
    _check(atoms.semiquadratic_polyline2(w, pts, 0, 1, threshold, right),
           jatoms.semiquadratic_polyline2(w, pts, 0, 1, threshold, right),
           np.zeros(v.shape[0], np.float32), v, w * 100.0)


def test_semiquadratic_branches_are_covered():
    """The queries above reach every branch of the signed query and of
    the cost: vertex and interior winners, endpoints, the interior-vertex
    side fix, active and inactive."""
    from ilqgames_tpu_torch import geometry

    rng = np.random.RandomState(3)
    q = torch.tensor(_points(rng, BENT))
    res = geometry.polyline_closest_point_xy(BENT, q[:, 0], q[:, 1],
                                             need_sign=True)
    sign_free = geometry.polyline_closest_point_xy(BENT, q[:, 0], q[:, 1])
    assert res.is_vertex.any() and (~res.is_vertex).any()
    assert res.is_endpoint.any() and (~res.is_endpoint).any()
    inner_vertex = res.is_vertex & ~res.is_endpoint
    assert inner_vertex.any()
    assert (res.signed_sq_distance > 0).any() and \
        (res.signed_sq_distance < 0).any()
    torch.testing.assert_close(res.signed_sq_distance.abs(),
                               sign_free.signed_sq_distance, rtol=0, atol=0)


def test_proximity_cost():
    """Inside and outside the threshold, exactly at it, and with the
    points coinciding (d^2 = 0 < EPS)."""
    rng = np.random.RandomState(4)
    n = 300
    v = rng.randn(n, 12).astype(np.float32) * 3
    v[:, 6:8] = v[:, 0:2] + rng.randn(n, 2).astype(np.float32) * 5
    v[:10, 6:8] = v[:10, 0:2]                     # coincide
    v[10:20, 6] = v[10:20, 0] + 7.5               # at the threshold
    v[10:20, 7] = v[10:20, 1]
    w = 5000.0
    for d1, d2 in (((0, 1), (6, 7)), ((6, 7), (0, 1))):
        _check(atoms.proximity(w, d1, d2, 7.5), jatoms.proximity(w, d1, d2, 7.5),
               np.zeros(n, np.float32), v, w * 8)


@pytest.fixture(scope="module")
def collision_stage():
    """The collision game at N=11 on an operating point near its start,
    with every lane's t0 at 0.35 s: the goal gate (horizon - 0.5 = 0.6 s)
    then opens at knot 3 in absolute time and at knot 6 in relative time."""
    N, B = 11, 2
    jprob, prob = jtc.make_problem(num_time_steps=N), \
        tc.make_problem(num_time_steps=N)
    spec = jprob.spec
    rng = np.random.RandomState(5)
    xs = (np.asarray(jprob.x0)[None, None]
          + np.cumsum(0.3 * rng.randn(B, N, spec.xdim), axis=1)
          ).astype(np.float32)
    us = rng.randn(B, N, 2, 2).astype(np.float32)
    t0 = np.full((B,), 0.35, np.float32)
    return jprob, prob, xs, us, t0


def test_stage_plain_uses_absolute_time(collision_stage):
    """K1's plain version against the JAX package's fused stage kernel
    (interpret mode) at t0 = 0.35; the unfused quadraticize against the
    JAX package's unfused one, both relative; and the two conventions
    differ on the goal gate's knots."""
    jprob, prob, xs, us, t0 = collision_stage
    spec = jprob.spec
    B, N = xs.shape[:2]
    op = convert.from_operating_point(JOp(xs=xs, us=us, t0=t0))
    op_bm, _ = sweep._prep_op(prob.spec, torch.zeros((B, spec.xdim)), op, 1)
    al = pc.ALState.init(prob.player_costs, prob.spec, B)
    _, _, mu, _ = sweep._prep_al(prob.spec, al, None, 1)
    got = stage.lin_quad_plain(prob.dynamics, prob.player_costs, prob.spec,
                               op_bm, None, None, mu)
    jop_bm = {k: jnp.asarray(v.numpy()) for k, v in op_bm.items()}
    ref = jstage.lin_quad_pallas(
        jprob.dynamics, jprob.player_costs, spec, jop_bm, None, None,
        jnp.asarray(mu.numpy()), jnp.ones((N, 2, B), jnp.float32),
        batch_block=B, interpret=True)
    for k in ("Qf", "lf", "Rf", "rf", "Bf"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-2, err_msg=k)
    np.testing.assert_allclose(got["A"].numpy(), np.asarray(ref["A"]),
                               rtol=1e-5, atol=1e-6)

    # The unfused quadraticize keeps relative time, as the JAX package's.
    rel = pc.quadraticize(prob.player_costs, prob.spec, op, al)
    jal = jpc.ALState.init(jprob.player_costs, spec)
    jrel = jax.vmap(lambda o: jpc.quadraticize(
        jprob.player_costs, spec, o, jal, jnp.zeros((2,), jnp.int32)))(
            JOp(xs=jnp.asarray(xs), us=jnp.asarray(us), t0=jnp.asarray(t0)))
    np.testing.assert_allclose(rel.l.numpy(), np.asarray(jrel.l), rtol=1e-5,
                               atol=1e-2)
    lf_rel = rel.l.permute(1, 2, 3, 0).reshape(N, 2 * spec.xdim, B)
    differ = (got["lf"] != lf_rel).any(-1).any(-1)
    # Knots 3-5 are past the gate in absolute time only.
    assert differ.tolist() == [False] * 3 + [True] * 3 + [False] * 5
