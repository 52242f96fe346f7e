"""BENCH_ALL config 5's game, the three-player collision-avoidance
reachability problem, piece by piece against the JAX package
(`ilqgames_tpu/examples/reachability.py:103-157`), on the same numpy-made
inputs:

- `car_5d`'s ODE and Jacobian (trigonometry through `fmath`, within 1e-5);
- `signed_distance`: evaluate and the shipped gradient pairs within 1e-6
  (the clamp's tie, ssq == 1e-12 in float32, included: there the shipped
  gradient is 0 and autodiff's takes the clamp's derivative as 1/2); its
  quadraticization against the JAX package's autodiff over its support,
  the gradient within 2 ulps and every Hessian entry within 4 ulps of the
  largest one of its block (XLA forms each program's autodiff anew, so no
  written form is bitwise equal to all of them: the class reached here);
- `extreme_value` over two signed distances: its active member (ties:
  the first; a NaN member: the first NaN) exactly as `jnp.argmax` and
  `jnp.argmin` pick it, and its pairs gated by multiplies (a NaN member's
  pairs stay NaN on the lanes it is active, as in the JAX package);
- `single_dimension`: g and the AL pairs bitwise, both senses, inside,
  outside and on the bound, with zero and live multipliers;
- `total_costs` under MAX and MIN: totals within 1e-6 and the extreme
  knots exactly, a NaN knot and tied knots included;
- the gated unfused `quadraticize` against the JAX package's with its
  extreme knots, and the fused stage's plain version `lin_quad_plain`
  against `lin_quad_pallas` in interpret mode at N=9, B=3, within 1e-5;
- the example's x0 bitwise, and its AL state (the control multipliers
  [B, 4, N] per player) through `convert.from_al_state`.
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
from ilqgames_tpu.dynamics import models as jmodels  # noqa: E402
from ilqgames_tpu.examples import reachability as jreach  # noqa: E402
from ilqgames_tpu.ops.pallas import stage as jstage  # noqa: E402
from ilqgames_tpu.types import OperatingPoint as JOp  # noqa: E402

from ilqgames_tpu_torch import convert  # noqa: E402
from ilqgames_tpu_torch.costs import atoms, constraints  # noqa: E402
from ilqgames_tpu_torch.costs import player_cost as pc  # noqa: E402
from ilqgames_tpu_torch.dynamics import models  # noqa: E402
from ilqgames_tpu_torch.examples import reachability as reach  # noqa: E402
from ilqgames_tpu_torch.ops.cuda import stage, sweep  # noqa: E402

torch.set_num_threads(1)

EPS32 = np.float32(1e-12)
N, B = 9, 3


def _close(got, want, rtol=1e-6, atol=1e-6, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


def _vals(pairs):
    return [v for _, v in pairs]


def _keys(pairs):
    return [k for k, _ in pairs]


def test_car_5d_matches_jax():
    rng = np.random.RandomState(0)
    x = (rng.randn(64, 5) * [5, 5, 3, 0.5, 4]).astype(np.float32)
    x[0, 2] = 1e6                          # a diverged heading
    u = rng.randn(64, 2).astype(np.float32)
    m, jm = models.car_5d(4.0), jmodels.car_5d(4.0)
    _close(m.ode(0.0, torch.tensor(x), torch.tensor(u)),
           jax.vmap(lambda a, b: jm.ode(0.0, a, b))(x, u), 1e-5, 1e-5)
    jx, ju = m.jac(0.0, torch.tensor(x), torch.tensor(u))
    jjx, jju = jax.vmap(lambda a, b: tuple(
        [v for _, v in e] for e in jm.jac(0.0, a, b)))(x, u)
    kx, ku = (_keys(e) for e in jm.jac(0.0, x[0], u[0]))
    assert _keys(jx) == kx and _keys(ju) == ku
    for k, g, w in zip(kx + ku, _vals(jx) + _vals(ju), list(jjx) + list(jju)):
        _close(np.broadcast_to(np.asarray(g, np.float32), np.shape(w)), w,
               1e-5, 1e-5, str(k))
    assert (m.xdim, m.udim, m.position_dims, m.kind) == (
        5, 2, (0, 1), models.KIND_CAR_5D)


def _sd_points(rng, n=600):
    """Pairs of points: random, coincident, at the clamp's tie (dx = 1e-6
    gives ssq == 1e-12 in float32), just below and above it, far apart."""
    v = (rng.randn(n, 4) * 3).astype(np.float32)
    v[:20, 2:] = v[:20, :2]
    v[20:30] = [[1e-6, 0.0, 0.0, 0.0]]
    v[30:40] = [[0.0, 1e-6, 0.0, 0.0]]
    v[40:50] = [[9e-7, 0.0, 0.0, 0.0]]
    v[50:60] = [[1.1e-6, 0.0, 0.0, 0.0]]
    v[60:80] *= 1e4
    v[80:100] *= 1e-3
    return v


@pytest.mark.parametrize("less_is_positive", [True, False])
def test_signed_distance_matches_jax(less_is_positive):
    rng = np.random.RandomState(1)
    v = _sd_points(rng)
    assert (v[20:40, 0] ** 2 + v[20:40, 1] ** 2 == EPS32).all()
    args = ((0, 1), (2, 3), 3.0)
    c = atoms.signed_distance(*args, less_is_positive=less_is_positive)
    jc = jatoms.signed_distance(*args, less_is_positive=less_is_positive)
    vt, vj = torch.tensor(v), jnp.asarray(v)
    _close(c.evaluate(0.0, vt), jax.vmap(lambda x: jc.evaluate(0.0, x))(vj))
    got = c.gradient_pairs(0.0, vt)
    assert _keys(got) == _keys(jc.gradient_pairs(0.0, vj[0]))
    want = jax.vmap(lambda x: _vals(jc.gradient_pairs(0.0, x)))(vj)
    for g, w in zip(_vals(got), want):
        _close(g, w)
    # The shipped gradient is 0 at the tie.
    assert all((g[20:40] == 0).all() for g in _vals(got))

    hp, gp = c.quad_pairs(0.0, vt)
    jhp0, jgp0 = jc.quad_pairs(0.0, vj[0])
    assert _keys(hp) == _keys(jhp0) and _keys(gp) == _keys(jgp0)
    jhp, jgp = jax.vmap(lambda x: tuple(
        _vals(p) for p in jc.quad_pairs(0.0, x)))(vj)
    g, jg = np.stack([t.numpy() for t in _vals(gp)]), np.stack(jgp)
    assert (np.abs(g - jg) <= 2 * np.spacing(np.abs(jg))).all()
    h, jh = np.stack([t.numpy() for t in _vals(hp)]), np.stack(jhp)
    scale = np.abs(jh).max(0)
    assert (np.abs(h - jh) <= 4 * np.spacing(scale)).all()
    # At the tie autodiff halves the clamp's derivative: nonzero there.
    assert (np.abs(g[:, 20:40]) > 0).any()
    np.testing.assert_array_equal(g[:, 20:40] != 0, jg[:, 20:40] != 0)


def _extreme_inputs(rng, n=400):
    """States of three players' positions (dims 0-1, 5-6, 10-11 of 15),
    with ties between the two pairwise distances and NaN positions."""
    v = (rng.randn(n, 15) * 4).astype(np.float32)
    v[:20, 10:12] = v[:20, 5:7]           # SD12 == SD13: a tie
    v[20:30, 5] = np.nan                   # member 0 NaN
    v[30:40, 10] = np.nan                  # member 1 NaN
    v[40:45, 5] = v[40:45, 10] = np.nan    # both NaN
    v[45:50, 0:2] = v[45:50, 5:7]          # coincident: clamped
    return v


@pytest.mark.parametrize("is_min", [False, True])
def test_extreme_value_matches_jax(is_min):
    rng = np.random.RandomState(2)
    v = _extreme_inputs(rng)
    p = [(0, 1), (5, 6), (10, 11)]
    c = atoms.extreme_value(
        (atoms.signed_distance(p[0], p[1], 3.0),
         atoms.signed_distance(p[0], p[2], 3.0)), is_min)
    jc = jatoms.extreme_value(
        (jatoms.signed_distance(p[0], p[1], 3.0),
         jatoms.signed_distance(p[0], p[2], 3.0)), is_min)
    vt, vj = torch.tensor(v), jnp.asarray(v)
    vals = jax.vmap(lambda x: jnp.stack(
        [m.evaluate(0.0, x) for m in (jatoms.signed_distance(p[0], p[1], 3.0),
                                      jatoms.signed_distance(p[0], p[2],
                                                             3.0))]))(vj)
    jidx = np.asarray(jnp.argmin(vals, 1) if is_min else jnp.argmax(vals, 1))
    pvals = torch.tensor(np.asarray(vals))
    np.testing.assert_array_equal(
        atoms.extreme_index(pvals, is_min).numpy(), jidx)
    np.testing.assert_array_equal(
        torch.argmin(pvals, 1).numpy() if is_min else
        torch.argmax(pvals, 1).numpy(), jidx)
    assert set(jidx[20:30]) == {0} and set(jidx[30:40]) == {1}
    got_e = c.evaluate(0.0, vt).numpy()
    want_e = np.asarray(jax.vmap(lambda x: jc.evaluate(0.0, x))(vj))
    np.testing.assert_array_equal(np.isnan(got_e), np.isnan(want_e))
    _close(got_e, want_e)
    got = c.gradient_pairs(0.0, vt)
    assert _keys(got) == _keys(jc.gradient_pairs(0.0, vj[0]))
    want = jax.vmap(lambda x: _vals(jc.gradient_pairs(0.0, x)))(vj)
    for g, w in zip(_vals(got), want):
        np.testing.assert_array_equal(np.isnan(g.numpy()), np.isnan(w))
        _close(g, w)
    hp, gp = c.quad_pairs(0.0, vt)
    jhp, jgp = jax.vmap(lambda x: tuple(
        _vals(q) for q in jc.quad_pairs(0.0, x)))(vj)
    assert _keys(hp) == _keys(jc.quad_pairs(0.0, vj[0])[0])
    # The members' pairs are the signed distance's (its class above):
    # per lane, within 4 ulps of the largest Hessian entry, 2 ulps in the
    # gradient; NaN where the JAX package's are.
    h, jh = np.stack([t.numpy() for t in _vals(hp)]), np.stack(jhp)
    g, jg = np.stack([t.numpy() for t in _vals(gp)]), np.stack(jgp)
    for got_, want_ in ((h, jh), (g, jg)):
        np.testing.assert_array_equal(np.isnan(got_), np.isnan(want_))
    with np.errstate(invalid="ignore"):
        scale = np.nanmax(np.where(np.isnan(jh), 0, np.abs(jh)), 0)
        assert (np.isnan(jh) | (np.abs(h - jh) <= 4 * np.spacing(
            scale))).all()
        assert (np.isnan(jg) | (np.abs(g - jg) <= 2 * np.spacing(
            np.abs(jg)))).all()


@pytest.mark.parametrize("keep_below", [True, False])
def test_single_dimension_matches_jax(keep_below):
    rng = np.random.RandomState(3)
    n = 200
    u = (rng.randn(n, 2) * 0.3).astype(np.float32)
    u[:10, 1] = 0.1
    u[10:20, 1] = -0.1
    lam = np.abs(rng.randn(n)).astype(np.float32) * (rng.rand(n) < 0.5)
    mu = np.full((n,), 10.0, np.float32)
    thr = 0.1 if keep_below else -0.1
    c = constraints.single_dimension(1, thr, keep_below)
    jc = jcons.single_dimension(1, thr, keep_below)
    ut, uj = torch.tensor(u), jnp.asarray(u)
    lt, lj = torch.tensor(lam), jnp.asarray(lam)
    mt, mj = torch.tensor(mu), jnp.asarray(mu)
    np.testing.assert_array_equal(c.g(0.0, ut).numpy(),
                                  np.asarray(jax.vmap(lambda x: jc.g(0.0, x))(
                                      uj)))
    got = c.gradient_al_pairs(0.0, ut, lt, mt)
    want = jax.vmap(lambda x, l, m: _vals(jc.gradient_al_pairs(0.0, x, l, m)))(
        uj, lj, mj)
    assert _keys(got) == [1]
    np.testing.assert_array_equal(got[0][1].numpy(), np.asarray(want[0]))
    hp, gp = c.quad_al_pairs(0.0, ut, lt, mt)
    jhp, jgp = jax.vmap(lambda x, l, m: tuple(
        _vals(p) for p in jc.quad_al_pairs(0.0, x, l, m)))(uj, lj, mj)
    assert _keys(hp) == [(1, 1)] and _keys(gp) == [1]
    np.testing.assert_array_equal(hp[0][1].numpy(), np.asarray(jhp[0]))
    np.testing.assert_array_equal(gp[0][1].numpy(), np.asarray(jgp[0]))


def _problems(structure=None, n=N):
    """Both packages' config-5 game at horizon n; with `structure`, every
    player's structure replaced by it in both."""
    prob = reach.make_three_player_collision_avoidance(num_time_steps=n)
    jprob = jreach.make_three_player_collision_avoidance(num_time_steps=n)
    if structure is not None:
        prob = dataclasses.replace(prob, player_costs=tuple(
            dataclasses.replace(c, structure=structure)
            for c in prob.player_costs))
        jprob = dataclasses.replace(jprob, player_costs=tuple(
            dataclasses.replace(c, structure=structure)
            for c in jprob.player_costs))
    return prob, jprob


def _op(prob, seed):
    """A batched operating point near the game's start, with tied knots
    (a repeated state) and, on the last lane, a NaN state at knot 4."""
    spec = prob.spec
    rng = np.random.RandomState(seed)
    xs = (prob.x0.numpy()[None, None] + np.cumsum(
        0.6 * rng.randn(B, N, spec.xdim), axis=1)).astype(np.float32)
    xs[0, 5] = xs[0, 3]
    us = (0.3 * rng.randn(B, N, spec.num_players, spec.umax)).astype(
        np.float32)
    us[0, 5] = us[0, 3]
    xs[-1, 4, 5] = np.nan
    return xs, us, np.zeros((B,), np.float32)


@pytest.mark.parametrize("structure", [pc.STRUCTURE_MAX, pc.STRUCTURE_MIN])
def test_total_costs_match_jax(structure):
    prob, jprob = _problems(structure)
    xs, us, t0 = _op(prob, 4)
    totals, ks = pc.total_costs(prob.player_costs, prob.spec,
                                convert.from_operating_point(
                                    JOp(xs=xs, us=us, t0=t0)))
    jt, jk = jax.vmap(lambda x, u, t: jpc.total_costs(
        jprob.player_costs, jprob.spec, JOp(xs=x, us=u, t0=t)))(xs, us, t0)
    np.testing.assert_array_equal(ks.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(np.isnan(totals.numpy()),
                                  np.isnan(np.asarray(jt)))
    _close(totals.numpy(), jt)
    assert ks.dtype == torch.int32
    assert (ks[-1] == 4).all()           # the NaN knot wins
    gate = pc.extreme_gate(prob.player_costs, prob.spec, ks)
    assert gate.shape == (B, N, 3)
    np.testing.assert_array_equal(gate.argmax(1).numpy(), ks.numpy())
    assert (gate.sum(1) == 1).all()


def _al(prob, seed):
    """Live control multipliers (half of them zero) and mu."""
    rng = np.random.RandomState(seed)
    lamc = [(np.abs(rng.randn(B, 4, N)) * (rng.rand(B, 4, N) < 0.5)).astype(
        np.float32) for _ in prob.player_costs]
    return lamc, np.full((B,), 10.0, np.float32)


@pytest.mark.parametrize("structure", [pc.STRUCTURE_MAX, pc.STRUCTURE_MIN])
def test_gated_quadraticize_matches_jax(structure):
    """The unfused quadraticize with each lane's extreme knots: only the
    extreme knot's state terms, every knot's control terms."""
    prob, jprob = _problems(structure)
    xs, us, t0 = _op(prob, 5)
    xs[-1, 4, 5] = 0.0                    # finite, for allclose
    lamc, mu = _al(prob, 6)
    op = convert.from_operating_point(JOp(xs=xs, us=us, t0=t0))
    _, ks = pc.total_costs(prob.player_costs, prob.spec, op)
    al = pc.ALState(state_lambdas=tuple(torch.zeros(B, 0, N) for _ in lamc),
                    control_lambdas=tuple(torch.tensor(l) for l in lamc),
                    mu=torch.tensor(mu))
    got = pc.quadraticize(prob.player_costs, prob.spec, op, al,
                          gate=pc.extreme_gate(prob.player_costs, prob.spec,
                                               ks))
    jal = jpc.ALState(state_lambdas=tuple(jnp.zeros((B, 0, N))
                                          for _ in lamc),
                      control_lambdas=tuple(jnp.asarray(l) for l in lamc),
                      mu=jnp.asarray(mu))
    want = jax.vmap(lambda x, u, t, a, k: jpc.quadraticize(
        jprob.player_costs, jprob.spec, JOp(xs=x, us=u, t0=t), a, k))(
            xs, us, t0, jal, jnp.asarray(ks.numpy()))
    for name in ("Q", "l", "R", "r"):
        _close(getattr(got, name).numpy(), getattr(want, name), 1e-5, 1e-5,
               name)
    # State terms at the extreme knot alone.
    Q = got.Q.numpy()
    for b in range(B):
        for i in range(3):
            off = np.delete(np.arange(N), ks[b, i].item())
            assert (Q[b, off, i] == 0).all()


def test_lin_quad_plain_matches_lin_quad_pallas():
    """K1's plain version against the JAX package's fused stage kernel in
    interpret mode: gated state terms, the control constraints' AL terms,
    car_5d's Jacobian."""
    prob, jprob = _problems()
    spec = prob.spec
    xs, us, t0 = _op(prob, 7)
    xs[-1, 4, 5] = 0.0
    t0[:] = 0.3
    lamc, mu = _al(prob, 8)
    op = convert.from_operating_point(JOp(xs=xs, us=us, t0=t0))
    _, ks = pc.total_costs(prob.player_costs, spec, op)
    gate = pc.extreme_gate(prob.player_costs, spec, ks)
    al = pc.ALState(state_lambdas=tuple(torch.zeros(B, 0, N) for _ in lamc),
                    control_lambdas=tuple(torch.tensor(l) for l in lamc),
                    mu=torch.tensor(mu))
    op_bm, _ = sweep._prep_op(spec, torch.zeros((B, spec.xdim)), op, B)
    lamS, lamC, mu_bm, gate_bm = sweep._prep_al(spec, al, gate, B)
    assert lamS is None and lamC.shape == (N, 12, B)
    assert gate_bm.shape == (N, 3, B)
    got = stage.lin_quad_plain(prob.dynamics, prob.player_costs, spec,
                               op_bm, lamS, lamC, mu_bm, gate_bm)
    before = stage.lin_quad.launches
    again = stage.lin_quad(prob.dynamics, prob.player_costs, spec, op_bm,
                           lamS, lamC, mu_bm, gate_bm)
    assert stage.lin_quad.launches == before
    jop = {k: jnp.asarray(v.numpy()) for k, v in op_bm.items()}
    ref = jstage.lin_quad_pallas(
        jprob.dynamics, jprob.player_costs, spec, jop, None,
        jnp.asarray(lamC.numpy()), jnp.asarray(mu_bm.numpy()),
        jnp.asarray(gate_bm.numpy()), batch_block=B, interpret=True)
    assert set(got) == set(ref)
    for name in ref:
        _close(got[name].numpy(), ref[name], 1e-5, 1e-5, name)
        assert torch.equal(got[name], again[name])


def test_example_and_al_state_match_jax():
    prob, jprob = _problems(n=None)
    np.testing.assert_array_equal(prob.x0.numpy(), np.asarray(jprob.x0))
    assert prob.spec.xdims == (5, 5, 5) and prob.spec.udims == (2, 2, 2)
    assert prob.spec.num_time_steps == jprob.spec.num_time_steps == 100
    assert all(c.structure == pc.STRUCTURE_MAX for c in prob.player_costs)
    al = prob.initial_al_state(B)
    assert [tuple(l.shape) for l in al.control_lambdas] == [(B, 4, 100)] * 3
    assert [tuple(l.shape) for l in al.state_lambdas] == [(B, 0, 100)] * 3
    jal = jax.vmap(lambda _: jpc.ALState.init(jprob.player_costs,
                                              jprob.spec))(jnp.arange(B))
    back = convert.from_al_state(jal)
    for a, b in zip(back.control_lambdas + (back.mu,),
                    al.control_lambdas + (al.mu,)):
        assert torch.equal(a, b)
