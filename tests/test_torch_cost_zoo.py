"""The rest of the cost layer against the JAX package
(`ilqgames_tpu/costs/atoms.py`, `costs/constraints.py`), piece by piece,
on the same numpy-made inputs and parameters:

- the atoms `relative_distance`, `nominal_path_length`, `curvature` and
  `orientation`: evaluate, the gradient pairs (the merit's) and the
  quadraticization pairs, keys in the JAX package's order. What the JAX
  package differentiates by autodiff (all four's quadraticization, the
  first three's merit gradient) is held in the signed distance's class:
  each gradient within 2 ulps, each Hessian entry within 4 ulps of the
  largest of its block, NaN and inf in the same places (`curvature` at
  v = 0); `nominal_path_length`'s written merit gradient within 1e-5;
- `quadratic_norm`'s quadraticization pairs (K1's form; written out in
  closed form, so within 1e-5 of its block's largest entry),
  and `quadratic_difference`
  at one and three differences (bitwise);
- `locally_convex_proximity` and `weighted_convex_proximity`: the dense
  `quad_fn` (the shipped derivatives) and the merit gradient, within
  1e-5 (relative, and absolute at 1e-5 of the weight), on the x- and
  y-active branches, the inactive one and sgn(0);
- the constraints `affine_scalar` and `polyline2_signed_distance`
  (autodiff over all of v in the JAX package: the signed distance's
  class), `affine_vector` (the shipped `quad_fn`, within 1e-5) and
  `final_time` over a sparse and a dense inner constraint, at times just
  below, at and above its gate: g, the dense AL gradient and
  quadraticization, with zero and live multipliers, on both sides of
  each threshold and at the polyline's vertex, interior and endpoint
  branches;
- `final_time` over an atom with only a dense form (semiquadratic_norm,
  the convex proximities): no pairs, the gated dense forms within 1e-5;
- the refusals: the port's `check_sparse` and the JAX package's fused
  stage (`stage_quadraticize_entries`) reject the same pieces with the
  same ValueError (final_time over a dense atom among them), and the merit kernels' table refuses the three
  dense-only constraints with NotImplementedError.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ilqgames_tpu.costs import atoms as jatoms  # noqa: E402
from ilqgames_tpu.costs import constraints as jcons  # noqa: E402
from ilqgames_tpu.costs import player_cost as jpc  # noqa: E402
from ilqgames_tpu.types import GameSpec as JSpec  # noqa: E402

from ilqgames_tpu_torch.costs import atoms, constraints  # noqa: E402
from ilqgames_tpu_torch.costs import player_cost as pc  # noqa: E402
from ilqgames_tpu_torch.ops.cuda import cost_table  # noqa: E402
from ilqgames_tpu_torch.types import GameSpec  # noqa: E402

torch.set_num_threads(1)

EPS32 = np.float32(1e-12)
# Every test's inputs are ROWS rows, so that the JAX package's eager ops
# compile once for all of them.
ROWS = 256
LANE = np.array([[0.0, 0.0], [10.0, 0.0], [10.0, 10.0], [20.0, 15.0]],
                np.float32)


EAGER = {"on": False}


def _jvmap(fn):
    """The JAX package's function vmapped over the inputs' rows, compiled
    once; run op by op where EAGER is on (XLA forms each program's
    autodiff anew, and the signed distance's class was reached op by op:
    tests/test_torch_reachability.py)."""
    return jax.vmap(fn) if EAGER["on"] else jax.jit(jax.vmap(fn))


@pytest.fixture
def eager():
    EAGER["on"] = True
    yield
    EAGER["on"] = False


def _vals(pairs):
    return [v for _, v in pairs]


def _keys(pairs):
    return [k for k, _ in pairs]


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _same_specials(got, want):
    """NaN and +-inf in the same places."""
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    inf = np.isinf(want)
    np.testing.assert_array_equal(np.isinf(got), inf)
    np.testing.assert_array_equal(got[inf], want[inf])


def _ulps(got, want, n):
    """Each entry within n ulps of the JAX package's (the signed
    distance's gradient class), NaN and inf in the same places."""
    got, want = _np(got), _np(want)
    _same_specials(got, want)
    ok = np.isfinite(want)
    assert (np.abs(got[ok] - want[ok])
            <= n * np.spacing(np.abs(want[ok]))).all()


def _block_ulps(got, want, n=4):
    """Hessian entries [k, inputs]: each within n ulps of the largest
    finite entry of its block (per input), NaN and inf in the same
    places."""
    got, want = _np(got), _np(want)
    _same_specials(got, want)
    scale = np.where(np.isfinite(want), np.abs(want), 0.0).max(0)
    ok = np.isfinite(want)
    bound = np.broadcast_to(n * np.spacing(scale.astype(np.float32)),
                            want.shape)
    assert (np.abs(got - want)[ok] <= bound[ok]).all()


def _written(got, want, weight):
    """A written derivative: within 1e-5, relative and absolute at 1e-5
    of the weight."""
    got, want = _np(got), _np(want)
    _same_specials(got, want)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * weight)


def _written_block(got, want, weight):
    """Written Hessian entries [k, inputs]: each within 1e-5 of the
    largest finite entry of its block (per input) and absolute at 1e-5 of
    the weight, NaN and inf in the same places."""
    got, want = _np(got), _np(want)
    _same_specials(got, want)
    scale = np.where(np.isfinite(want), np.abs(want), 0.0).max(0)
    ok = np.isfinite(want)
    bound = np.broadcast_to(1e-5 * scale + 1e-5 * weight, want.shape)
    assert (np.abs(got - want)[ok] <= bound[ok]).all()


def _atom_check(cost, jcost, t, v, grad_class, hess_class, weight):
    """evaluate, the gradient pairs and the quad pairs of a sparse atom
    against the JAX package's, vmapped over the rows of (t, v)."""
    tt, vt = torch.tensor(t), torch.tensor(v)
    tj, vj = jnp.asarray(t), jnp.asarray(v)
    _written(cost.evaluate(tt, vt),
             _jvmap(jcost.evaluate)(tj, vj), weight)
    got = cost.gradient_pairs(tt, vt)
    assert _keys(got) == _keys(jcost.gradient_pairs(tj[0], vj[0]))
    want = _jvmap(lambda a, b: _vals(jcost.gradient_pairs(a, b)))(tj, vj)
    for g, w in zip(_vals(got), want):
        grad_class(g, w)
    hp, gp = cost.quad_pairs(tt, vt)
    jhp0, jgp0 = jcost.quad_pairs(tj[0], vj[0])
    assert _keys(hp) == _keys(jhp0) and _keys(gp) == _keys(jgp0)
    jhp, jgp = _jvmap(lambda a, b: tuple(
        _vals(p) for p in jcost.quad_pairs(a, b)))(tj, vj)
    for g, w in zip(_vals(gp), jgp):
        grad_class(torch.broadcast_to(g, vt.shape[:1]), w)
    hess_class(np.stack([np.broadcast_to(_np(h), v.shape[:1])
                         for h in _vals(hp)]), np.stack(jhp))


def _dist_points(rng, n=None):
    """Pairs of points: random, coincident, at the clamp's tie (dx = 1e-6
    gives ssq == 1e-12 in float32), just below and above it, far
    apart."""
    v = (rng.randn(n or ROWS, 5) * 3).astype(np.float32)
    v[:20, 2:4] = v[:20, :2]
    v[20:30, :4] = [[1e-6, 0.0, 0.0, 0.0]]
    v[30:40, :4] = [[0.0, 1e-6, 0.0, 0.0]]
    v[40:50, :4] = [[9e-7, 0.0, 0.0, 0.0]]
    v[50:60, :4] = [[1.1e-6, 0.0, 0.0, 0.0]]
    v[60:80] *= 1e4
    v[80:100] *= 1e-3
    assert (v[20:40, 0] ** 2 + v[20:40, 1] ** 2 == EPS32).all()
    return v


def test_relative_distance_matches_jax(eager):
    v = _dist_points(np.random.RandomState(0))
    t = np.zeros(v.shape[0], np.float32)
    args = (0.7, (0, 1), (2, 3))
    c, jc = atoms.relative_distance(*args), jatoms.relative_distance(*args)
    _atom_check(c, jc, t, v, lambda g, w: _ulps(g, w, 2), _block_ulps, 0.7)
    # Autodiff halves the clamp's derivative at the tie: nonzero there.
    g = _vals(c.gradient_pairs(torch.tensor(t), torch.tensor(v)))[0]
    assert (g[20:30] != 0).all() and (g[40:50] == 0).all()


def test_nominal_path_length_matches_jax():
    rng = np.random.RandomState(1)
    n = ROWS
    v = (rng.randn(n, 3) * 20).astype(np.float32)
    t = (rng.rand(n) * 10).astype(np.float32)
    t[:20] = 0.0
    v[20:40, 1] = t[20:40] * np.float32(8.0)  # on the nominal path
    args = (0.3, 1, 8.0)
    c, jc = atoms.nominal_path_length(*args), jatoms.nominal_path_length(
        *args)
    tt, vt = torch.tensor(t), torch.tensor(v)
    tj, vj = jnp.asarray(t), jnp.asarray(v)
    _written(c.evaluate(tt, vt), jax.vmap(jc.evaluate)(tj, vj), 0.3)
    (dim, g), = c.gradient_pairs(tt, vt)
    (jdim, _), = jc.gradient_pairs(tj[0], vj[0])
    assert dim == jdim
    _written(g, jax.vmap(lambda a, b: jc.gradient_pairs(a, b)[0][1])(tj, vj),
             0.3)
    hp, gp = c.quad_pairs(tt, vt)
    jhp, jgp = jax.vmap(lambda a, b: tuple(
        _vals(p) for p in jc.quad_pairs(a, b)))(tj, vj)
    assert _keys(hp) == [(1, 1)] and _keys(gp) == [1]
    _ulps(gp[0][1], jgp[0], 2)
    _block_ulps(np.stack([_np(hp[0][1])]), np.stack(jhp))


def test_curvature_matches_jax():
    rng = np.random.RandomState(2)
    n = ROWS
    v = (rng.randn(n, 5) * [1.0, 1.0, 0.3, 0.3, 4.0]).astype(np.float32)
    v[:10, 4] = 0.0               # v = 0: inf, and NaN with omega = 0
    v[10:20, 3:5] = 0.0
    v[20:30, 4] = -0.0
    v[30:40, 3] = 0.0
    v[40:60, 4] *= 1e-3
    t = np.zeros(n, np.float32)
    c, jc = atoms.curvature(0.9, 3, 4), jatoms.curvature(0.9, 3, 4)
    _atom_check(c, jc, t, v, lambda g, w: _ulps(g, w, 2), _block_ulps, 0.9)
    hp, _ = c.quad_pairs(torch.tensor(t), torch.tensor(v))
    assert all(torch.isnan(h[:30]).all() for h in _vals(hp))


def test_orientation_matches_jax(eager):
    rng = np.random.RandomState(3)
    n = ROWS
    v = (rng.randn(n, 3) * 4).astype(np.float32)
    v[:40, 2] = np.float32(np.pi / 2) + np.float32(np.pi) * rng.choice(
        [-3, -1, 1, 3], 40).astype(np.float32)  # at the wrap
    v[40:60, 2] *= 1e3
    t = np.zeros(n, np.float32)
    c = atoms.orientation(1.3, 2, np.pi / 2)
    jc = jatoms.orientation(1.3, 2, np.pi / 2)
    _atom_check(c, jc, t, v, lambda g, w: _ulps(g, w, 2), _block_ulps, 1.3)


def test_quadratic_norm_pairs_match_jax():
    """K1's form of quadratic_norm: its quad pairs (the closed form of
    atoms._norm_quad) against the JAX package's autodiff over its
    support, within 1e-5."""
    v = _dist_points(np.random.RandomState(4))
    t = np.zeros(v.shape[0], np.float32)
    c = atoms.quadratic_norm(0.6, 0, 1, 2.5)
    jc = jatoms.quadratic_norm(0.6, 0, 1, 2.5)
    _atom_check(c, jc, t, v, lambda g, w: _written(g, w, 0.6),
                lambda h, w: _written_block(h, w, 0.6), 0.6)


@pytest.mark.parametrize("n_pairs", [1, 3])
def test_quadratic_difference_matches_jax(n_pairs):
    rng = np.random.RandomState(5 + n_pairs)
    v = (rng.randn(ROWS, 7) * 3).astype(np.float32)
    v[:20, 3] = v[:20, 0]         # a zero difference
    d1, d2 = (0, 1, 2)[:n_pairs], (3, 5, 6)[:n_pairs]
    c = atoms.quadratic_difference(0.4, d1, d2)
    jc = jatoms.quadratic_difference(0.4, d1, d2)
    t = np.zeros(v.shape[0], np.float32)
    _atom_check(c, jc, t, v, lambda g, w: _ulps(g, w, 0),
                lambda h, w: _block_ulps(h, w, 0), 0.4)
    assert c.device[0] == "quadratic_difference_n"


def _convex_points(rng, thr, n=None):
    """Two points (dims 0-1, 2-3) and two speeds (4, 5): inside the
    threshold on both axes with either axis active, outside on one, on
    the threshold, with a zero difference (sgn(0)) and ties."""
    v = (rng.randn(n or ROWS, 6) * [thr, thr, thr, thr, 3, 3]).astype(
        np.float32)
    v[:40, 2] = v[:40, 0]                     # dx = 0
    v[40:80, 3] = v[40:80, 1]                 # dy = 0
    v[80:100, 2] = v[80:100, 0] + np.float32(thr)   # |dx| == threshold
    v[100:120, 1] = v[100:120, 3] + 2 * thr   # outside
    v[120:140, 2:4] = v[120:140, 0:2] + 0.5   # delta_x == delta_y
    return v


@pytest.mark.parametrize("weighted", [False, True])
def test_convex_proximities_match_jax(weighted):
    rng = np.random.RandomState(8)
    thr = 3.0
    v = _convex_points(rng, thr)
    if weighted:
        args = (0.8, (0, 1), (2, 3), 4, 5, thr)
        c = atoms.weighted_convex_proximity(*args)
        jc = jatoms.weighted_convex_proximity(*args)
    else:
        args = (0.8, (0, 1), (2, 3), thr)
        c = atoms.locally_convex_proximity(*args)
        jc = jatoms.locally_convex_proximity(*args)
    assert c.quad_pairs(0.0, torch.tensor(v)) is None
    assert c.gradient_pairs(0.0, torch.tensor(v)) is None
    vt, vj = torch.tensor(v), jnp.asarray(v)
    _written(c.evaluate(0.0, vt), jax.vmap(lambda x: jc.evaluate(0.0, x))(vj),
             0.8)
    h, g = c.quad_fn(0.0, vt)
    jh, jg = jax.vmap(lambda x: jc.quad_fn(0.0, x))(vj)
    _written(g, jg, 0.8)
    _written(h, jh, 0.8)
    _written(c.gradient(0.0, vt), jax.vmap(
        lambda x: jc.gradient(0.0, x))(vj), 0.8)
    # Both branches and the inactive one are reached.
    gn = _np(g)
    assert (gn[:, 0] != 0).any() and (gn[:, 1] != 0).any()
    assert (gn == 0).all(1).any()


def _al_inputs(rng, n, gvals_fn):
    lam = (np.abs(rng.randn(n)) * (rng.rand(n) < 0.5)).astype(np.float32)
    mu = np.full((n,), 10.0, np.float32)
    return lam, mu


def _constraint_check(con, jcon, t, v, lam, mu, grad_class, hess_class,
                      weight=1.0):
    """g, the dense AL gradient and the AL quadraticization of a
    constraint against the JAX package's."""
    tt, vt, lt, mt = (torch.tensor(a) for a in (t, v, lam, mu))
    tj, vj, lj, mj = (jnp.asarray(a) for a in (t, v, lam, mu))
    _written(con.g(tt, vt), _jvmap(jcon.g)(tj, vj), weight)
    grad_class(con.gradient_al(tt, vt, lt, mt),
               _jvmap(jcon.gradient_al)(tj, vj, lj, mj))
    h, g = con.quadraticize_al(tt, vt, lt, mt)
    jh, jg = _jvmap(jcon.quadraticize_al)(tj, vj, lj, mj)
    grad_class(g, jg)
    hess_class(np.moveaxis(_np(h).reshape(h.shape[0], -1), 0, -1),
               np.moveaxis(np.asarray(jh).reshape(h.shape[0], -1), 0, -1))


def _dense_ulps(g, w):
    _ulps(g, w, 2)


def _dense_block(h, w):
    """[entries, inputs] -> each input's block within 4 ulps of its
    largest entry."""
    _block_ulps(h, w, 4)


@pytest.mark.parametrize("is_equality", [False, True])
def test_affine_scalar_matches_jax(is_equality):
    rng = np.random.RandomState(9)
    n, d = ROWS, 6
    a = rng.randn(d).astype(np.float32)
    v = (rng.randn(n, d) * 2).astype(np.float32)
    b = 0.5
    v[:30] = 0.0
    v[:30, 0] = np.float32(b) / a[0]          # on the bound
    lam, mu = _al_inputs(rng, n, None)
    con = constraints.affine_scalar(a, b, is_equality)
    jcon = jcons.affine_scalar(a, b, is_equality)
    assert con.gradient_al_pairs(0.0, torch.tensor(v), torch.tensor(lam),
                                 torch.tensor(mu)) is None
    t = np.zeros(n, np.float32)
    _constraint_check(con, jcon, t, v, lam, mu, _dense_ulps, _dense_block)


@pytest.mark.parametrize("is_equality", [False, True])
def test_affine_vector_matches_jax(is_equality):
    rng = np.random.RandomState(10)
    n, d = ROWS, 5
    A = np.zeros((d, d), np.float32)
    A[0, 3], A[1, 4], A[2, 2] = 1.0, 1.0, 0.5
    b = np.array([1.0, -2.0, 0.0, 0.0, 0.0], np.float32)
    v = (rng.randn(n, d) * 2).astype(np.float32)
    v[:20, 3], v[:20, 4], v[:20, 2] = 1.0, -2.0, 0.0   # at b: the clamp
    lam, mu = _al_inputs(rng, n, None)
    con = constraints.affine_vector(A, b, is_equality)
    jcon = jcons.affine_vector(A, b, is_equality)
    t = np.zeros(n, np.float32)
    _constraint_check(con, jcon, t, v, lam, mu,
                      lambda g, w: _written(g, w, 1.0),
                      lambda h, w: _written(h, w, 1.0))


@pytest.mark.parametrize("keep_left", [True, False])
def test_polyline_constraint_matches_jax(keep_left, eager):
    rng = np.random.RandomState(11)
    lo, hi = LANE.min(0) - 6.0, LANE.max(0) + 6.0
    q = [lo + (hi - lo) * rng.rand(ROWS - 4 * 20 - 5, 2)]
    for p in LANE:                    # vertices and their neighbourhoods
        q.append(p + 0.3 * rng.randn(20, 2))
    q.append(LANE[:1] - [[2.0, 0.5]])         # beyond the first endpoint
    q.append(LANE[-1:] + [[2.0, 1.0]])        # beyond the last
    q.append([[5.0, 0.0], [5.0, 1.0], [10.0, 5.0]])   # on the lines
    q = np.concatenate(q).astype(np.float32)
    n = q.shape[0]
    v = np.zeros((n, 4), np.float32)
    v[:, 1], v[:, 2] = q[:, 0], q[:, 1]
    v[:, 0] = rng.randn(n)
    lam, mu = _al_inputs(rng, n, None)
    args = (LANE, 1, 2, 1.5, keep_left)
    con = constraints.polyline2_signed_distance(*args)
    jcon = jcons.polyline2_signed_distance(*args)
    t = np.zeros(n, np.float32)
    _constraint_check(con, jcon, t, v, lam, mu, _dense_ulps, _dense_block)


@pytest.mark.parametrize("dense_inner", [False, True])
def test_final_time_constraint_matches_jax(dense_inner):
    rng = np.random.RandomState(12)
    n = ROWS
    v = (rng.randn(n, 4) * 2).astype(np.float32)
    v[:30, 2] = 1.0                           # on the bound
    thr_t = np.float32(0.5)
    t = np.where(rng.rand(n) < 0.5, thr_t, rng.rand(n)).astype(np.float32)
    t[:10] = np.nextafter(thr_t, np.float32(0))   # just below the gate
    t[10:20] = np.nextafter(thr_t, np.float32(1))
    lam, mu = _al_inputs(rng, n, None)
    if dense_inner:
        a = np.array([0.0, 0.5, -1.0, 2.0], np.float32)
        inner, jinner = (constraints.affine_scalar(a, 1.0, False),
                         jcons.affine_scalar(a, 1.0, False))
    else:
        inner, jinner = (constraints.single_dimension(2, 1.0, True),
                         jcons.single_dimension(2, 1.0, True))
    con = constraints.final_time(inner, float(thr_t))
    jcon = jcons.final_time(jinner, float(thr_t))
    tt, vt, lt, mt = (torch.tensor(x) for x in (t, v, lam, mu))
    tj, vj, lj, mj = (jnp.asarray(x) for x in (t, v, lam, mu))
    if dense_inner:
        assert con.gradient_al_pairs(tt, vt, lt, mt) is None
        assert con.device is None
        _constraint_check(con, jcon, t, v, lam, mu, _dense_ulps,
                          _dense_block)
        return
    gp = con.gradient_al_pairs(tt, vt, lt, mt)
    want = jax.vmap(lambda *a: _vals(jcon.gradient_al_pairs(*a)))(
        tj, vj, lj, mj)
    np.testing.assert_array_equal(_np(gp[0][1]), np.asarray(want[0]))
    hp, gq = con.quad_al_pairs(tt, vt, lt, mt)
    jhp, jgq = jax.vmap(lambda *a: tuple(
        _vals(p) for p in jcon.quad_al_pairs(*a)))(tj, vj, lj, mj)
    np.testing.assert_array_equal(_np(hp[0][1]), np.asarray(jhp[0]))
    np.testing.assert_array_equal(_np(gq[0][1]), np.asarray(jgq[0]))
    np.testing.assert_array_equal(_np(con.g(tt, vt)),
                                  np.asarray(jax.vmap(jcon.g)(tj, vj)))
    assert con.device == ("single_dimension", dict(
        dim=2, threshold=1.0, keep_below=True, gate_time=float(thr_t)))
    assert (_np(gp[0][1])[:10] == 0).all()


@pytest.mark.parametrize("inner", ["semiquadratic_norm",
                                   "locally_convex_proximity",
                                   "weighted_convex_proximity"])
def test_final_time_over_a_dense_atom_matches_jax(inner):
    """atoms.final_time over an atom with only a dense form: no pairs (the
    JAX package's gated quad_fn, so the fused stage refuses it), the gated
    dense quadraticization and merit gradient against the JAX package's
    at times just below, at and above the gate, and the inner atom's
    device form with the gate time (K5's and K6's dense gradient)."""
    rng = np.random.RandomState(13)
    thr = 3.0
    v = _convex_points(rng, thr)
    thr_t = np.float32(0.5)
    t = np.where(rng.rand(ROWS) < 0.5, thr_t, rng.rand(ROWS)).astype(
        np.float32)
    t[::3] = np.nextafter(thr_t, np.float32(0))   # just below the gate
    t[1::7] = np.nextafter(thr_t, np.float32(1))

    def make(A):
        return {"semiquadratic_norm": lambda: A.semiquadratic_norm(
                    0.8, 0, 1, 2.0, True),
                "locally_convex_proximity": lambda: A.
                locally_convex_proximity(0.8, (0, 1), (2, 3), thr),
                "weighted_convex_proximity": lambda: A.
                weighted_convex_proximity(0.8, (0, 1), (2, 3), 4, 5, thr),
                }[inner]()

    c = atoms.final_time(make(atoms), float(thr_t))
    jc = jatoms.final_time(make(jatoms), float(thr_t))
    tt, vt = torch.tensor(t), torch.tensor(v)
    tj, vj = jnp.asarray(t), jnp.asarray(v)
    assert not c.has_pairs and c.quad_pairs(tt, vt) is None
    assert c.gradient_pairs(tt, vt) is None
    assert jc.quad_pairs(tj[0], vj[0]) is None
    _written(c.evaluate(tt, vt), jax.vmap(jc.evaluate)(tj, vj), 0.8)
    h, g = c.quadraticize(tt, vt)
    jh, jg = jax.vmap(jc.quadraticize)(tj, vj)
    _written(g, jg, 0.8)
    _written(h, jh, 0.8)
    _written(c.gradient(tt, vt), jax.vmap(jc.gradient)(tj, vj), 0.8)
    gn = _np(g)
    assert (gn[t < thr_t] == 0).all() and (gn[t >= thr_t] != 0).any()
    kind, prm = c.device
    assert kind == inner and prm["gate_time"] == float(thr_t)


def _spec_pair():
    return (GameSpec(xdims=(6,), udims=(2,), dt=0.1, num_time_steps=3),
            JSpec(xdims=(6,), udims=(2,), dt=0.1, num_time_steps=3))


@pytest.mark.parametrize("piece", [
    "locally_convex_proximity", "weighted_convex_proximity",
    "affine_scalar", "affine_vector", "polyline2_signed_distance",
    "final_time_dense", "semiquadratic_norm", "final_time_semi_norm",
    "final_time_convex"])
def test_check_sparse_refuses_as_the_jax_fused_stage(piece):
    """The pieces the JAX package's fused stage refuses: the port's
    `check_sparse` raises its ValueError, text and all; the merit
    kernels' table refuses the dense-only constraints."""
    def build(A, C):
        a = np.zeros(6, np.float32)
        a[1] = 1.0
        lane = LANE
        return {
            "locally_convex_proximity": ("cost", lambda: A.
                                         locally_convex_proximity(
                                             1.0, (0, 1), (2, 3), 2.0)),
            "weighted_convex_proximity": ("cost", lambda: A.
                                          weighted_convex_proximity(
                                              1.0, (0, 1), (2, 3), 4, 5,
                                              2.0)),
            "semiquadratic_norm": ("cost", lambda: A.semiquadratic_norm(
                1.0, 0, 1, 2.0, True)),
            "affine_scalar": ("con", lambda: C.affine_scalar(a, 1.0,
                                                             False)),
            "affine_vector": ("con", lambda: C.affine_vector(
                np.eye(6, dtype=np.float32), np.ones(6, np.float32),
                False)),
            "polyline2_signed_distance": ("con", lambda: C.
                                          polyline2_signed_distance(
                                              lane, 0, 1, 1.0, True)),
            "final_time_dense": ("con", lambda: C.final_time(
                C.affine_scalar(a, 1.0, False), 0.5)),
            "final_time_semi_norm": ("cost", lambda: A.final_time(
                A.semiquadratic_norm(1.0, 0, 1, 2.0, True), 0.5)),
            "final_time_convex": ("cost", lambda: A.final_time(
                A.locally_convex_proximity(1.0, (0, 1), (2, 3), 2.0), 0.5)),
        }[piece]

    def costs(A, C, PC, quad):
        kind, make = build(A, C)
        base = dict(state_costs=(quad(1.0, 0, 0.0),),
                    control_costs=((0, quad(1.0, 0, 0.0)),))
        if kind == "cost":
            base["state_costs"] += (make(),)
        else:
            base["state_constraints"] = (make(),)
        return (PC(**base),)

    spec, jspec = _spec_pair()
    port = costs(atoms, constraints, pc.PlayerCost, atoms.quadratic)
    jax_ = costs(jatoms, jcons, jpc.PlayerCost, jatoms.quadratic)
    z = jnp.zeros(())
    with pytest.raises(ValueError) as jerr:
        jpc.stage_quadraticize_entries(
            jax_, jspec, (jnp.zeros((len(jax_[0].state_constraints),)),),
            (jnp.zeros((0,)),), 1.0, z, jnp.zeros(6), jnp.zeros((1, 2)),
            jnp.ones(1))
    with pytest.raises(ValueError) as err:
        pc.check_sparse(port)
    assert str(err.value) == str(jerr.value)
    if build(atoms, constraints)[0] == "con":
        with pytest.raises(NotImplementedError):
            cost_table.cost_table(port, spec, "cpu")
