"""The three-player flat intersection's modules against the JAX package's,
on inputs made from numpy seeds:

(a) the flat models and `concatenate_flat` (ilqgames_tpu/dynamics/flat.py):
    the ode (at an infinite state too, where the rows' x * 0 fold gives
    NaN), `to_linear_state`, `from_linear_state` and
    `linear_state_singular` within 1e-6; the port's `linearize` equal to
    the JAX `constant_linearization` bit for bit; the example's x0 equal to
    the JAX example's;
(b) `quadratic_norm` and `semiquadratic_norm` (costs/atoms.py:103-145):
    evaluate, gradient and quadraticize, with a norm exactly at each
    threshold (the quadraticization active, evaluate not) and one under
    the clamp;
(c) the player-level quadraticization and merit terms of the game against
    `stage_quadraticize_core`, the unfused `quadraticize`,
    `stage_gradients_core` and `stage_gradient_sq_tuple` (1e-5);
(e) both packages refuse the game with fused stages, with one message."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ilqgames_tpu.costs import atoms as jatoms  # noqa: E402
from ilqgames_tpu.costs import player_cost as jpc  # noqa: E402
from ilqgames_tpu.dynamics import base as jdyn  # noqa: E402
from ilqgames_tpu.dynamics import flat as jflat  # noqa: E402
from ilqgames_tpu.examples import three_player_flat_intersection as jff  # noqa: E402
from ilqgames_tpu.solver import batched as jbatched  # noqa: E402
from ilqgames_tpu.solver.params import SolverParams as JParams  # noqa: E402
from ilqgames_tpu.types import OperatingPoint as JOp  # noqa: E402

from ilqgames_tpu_torch.costs import atoms  # noqa: E402
from ilqgames_tpu_torch.costs import player_cost as pcost  # noqa: E402
from ilqgames_tpu_torch.dynamics import base as dyn_base  # noqa: E402
from ilqgames_tpu_torch.dynamics import flat  # noqa: E402
from ilqgames_tpu_torch.examples import three_player_flat_intersection as ff  # noqa: E402
from ilqgames_tpu_torch.ops.cuda import stage  # noqa: E402
from ilqgames_tpu_torch.types import OperatingPoint  # noqa: E402

torch.set_num_threads(1)

N, B = 11, 4
REL = 1e-6
STAGE_TOL = 1e-5


def _models(lib):
    return [lib.flat_car_6d(4.0), lib.flat_car_6d(4.0),
            lib.flat_unicycle_4d()]


def _pair():
    return (flat.concatenate_flat("f", _models(flat)),
            jflat.concatenate_flat("f", _models(jflat)))


def _close(got, want, rtol=REL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=rtol)


def test_flat_ode_and_maps_match_jax():
    dyn, jdyn_ = _pair()
    rng = np.random.RandomState(0)
    xi = (5 * rng.randn(64, 16)).astype(np.float32)
    vs = rng.randn(64, 3, 2).astype(np.float32)
    want = jax.vmap(lambda x, v: jdyn_.ode(0.0, x, v))(xi, vs)
    got = dyn.ode(0.0, torch.tensor(xi), torch.tensor(vs))
    _close(got, want)
    # An infinite and a NaN state: the rows that read them are NaN, as the
    # JAX package's xi * 0.0 fold leaves them.
    xi[0, 5], xi[1, 13] = np.inf, np.nan
    want = np.asarray(jax.vmap(lambda x, v: jdyn_.ode(0.0, x, v))(xi, vs))
    got = dyn.ode(0.0, torch.tensor(xi), torch.tensor(vs)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[0, 5]) and np.isnan(got[1, 13])
    ok = ~np.isnan(want)
    _close(got[ok], want[ok])
    # The coordinate maps on real states: headings, steering and speeds.
    x = rng.randn(64, 16).astype(np.float32)
    for o in (0, 6):
        x[:, o + 3] *= 0.3
        x[:, o + 4] = 2 + 5 * np.abs(x[:, o + 4])
    x[:, 15] = 1 + np.abs(x[:, 15])
    xi_j = jax.vmap(jdyn_.to_linear_state)(x)
    xi_p = dyn.to_linear_state(torch.tensor(x))
    _close(xi_p, xi_j)
    _close(dyn.from_linear_state(xi_p), jax.vmap(jdyn_.from_linear_state)(
        xi_j), rtol=1e-5)
    # Singular: a NaN speed, and speeds within 1e-2 of zero.
    xi = (5 * rng.randn(6, 16)).astype(np.float32)
    xi[0, 2] = np.nan
    xi[1, 14:16] = (0.005, -0.004)
    xi[2, 8:10] = (0.005, 0.02)
    got = dyn.linear_state_singular(torch.tensor(xi)).numpy()
    want = np.asarray(jax.vmap(jdyn_.linear_state_singular)(xi))
    np.testing.assert_array_equal(got, want)
    assert got.tolist()[:3] == [True, True, False]


def test_flat_linearize_is_jax_constant_linearization_bitwise():
    prob, jprob = ff.make_problem(num_time_steps=N), jff.make_problem(
        num_time_steps=N)
    A, Bs = jprob.dynamics.constant_linearization(jprob.spec)
    rng = np.random.RandomState(4)
    op = OperatingPoint(
        xs=torch.tensor(rng.randn(2, N, 16).astype(np.float32)),
        us=torch.tensor(rng.randn(2, N, 3, 2).astype(np.float32)),
        t0=torch.zeros(2))
    lin = dyn_base.linearize(prob.dynamics, prob.spec, op)
    for got, want in ((lin.A, A), (lin.Bs, Bs)):
        want = np.broadcast_to(np.asarray(want), got.shape)
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      want.view(np.int32))
    # The JAX package's own linearize takes the same constants.
    jlin = jdyn.linearize(jprob.dynamics, jprob.spec, JOp.zeros(jprob.spec))
    np.testing.assert_array_equal(np.asarray(jlin.A)[0], np.asarray(A))


def test_flat_example_matches_jax():
    prob, jprob = ff.make_problem(), jff.make_problem()
    np.testing.assert_array_equal(prob.x0.numpy().view(np.int32),
                                  np.asarray(jprob.x0).view(np.int32))
    assert (prob.spec.xdims, prob.spec.udims) == (jprob.spec.xdims,
                                                   jprob.spec.udims)
    for pc, jpc_ in zip(prob.player_costs, jprob.player_costs):
        assert [c.name for c in pc.state_costs] == [
            c.name for c in jpc_.state_costs]
        assert [(j, c.name) for j, c in pc.control_costs] == [
            (j, c.name) for j, c in jpc_.control_costs]


def _norm_inputs():
    """States with (v[2], v[3]) at random, at each threshold exactly, and
    under the clamp (norm^2 < 1e-12)."""
    rng = np.random.RandomState(1)
    v = (4 * rng.randn(40, 16)).astype(np.float32)
    v[0, 2:4] = (0.0, 1.0)       # MinV's threshold
    v[1, 2:4] = (12.0, 0.0)      # MaxV's
    v[2, 2:4] = (0.0, -2.0)      # a MaxV at 2 (the unicycle's)
    v[3, 2:4] = (8.0, 0.0)       # NominalV's nominal
    v[4, 2:4] = (1e-7, 0.0)      # under the clamp
    v[5, 2:4] = (0.0, 0.0)
    return v


NORM_ATOMS = {
    "quadratic_norm": ("quadratic_norm", (10.0, 2, 3, 8.0)),
    "min_v": ("semiquadratic_norm", (10.0, 2, 3, 1.0, False)),
    "max_v": ("semiquadratic_norm", (10.0, 2, 3, 12.0, True)),
    "max_v_unicycle": ("semiquadratic_norm", (10.0, 2, 3, 2.0, True)),
}


@pytest.mark.parametrize("which", list(NORM_ATOMS))
def test_norm_atoms_match_jax(which):
    name, args = NORM_ATOMS[which]
    c, jc = getattr(atoms, name)(*args), getattr(jatoms, name)(*args)
    v = _norm_inputs()
    vt = torch.tensor(v)
    _close(c.evaluate(0.0, vt), jax.vmap(lambda x: jc.evaluate(0.0, x))(v))
    _close(c.gradient(0.0, vt), jax.vmap(lambda x: jc.gradient(0.0, x))(v))
    h, g = c.quadraticize(0.0, vt)
    jh, jg = jax.vmap(lambda x: jc.quadraticize(0.0, x))(v)
    _close(g, jg)
    _close(h, jh, rtol=STAGE_TOL)
    assert not np.asarray(h)[4].any() and not np.asarray(g)[4].any()
    if which == "min_v":
        # At the threshold: evaluate off (diff < 0 fails), quad on (<=).
        assert float(c.evaluate(0.0, vt)[0]) == 0.0
        assert float(g[0, 3]) != 0.0 or float(h[0, 3, 3]) != 0.0
    if which == "max_v":
        assert float(c.evaluate(0.0, vt)[1]) == 0.0
        assert float(h[1, 2, 2]) != 0.0


def _stage_inputs(seed=2):
    """[B, N] stage inputs near the game's x0, with some speeds at or past
    the norm atoms' thresholds."""
    prob = ff.make_problem(num_time_steps=N)
    rng = np.random.RandomState(seed)
    x = (prob.x0.numpy()[None, None] + 3 * rng.randn(B, N, 16)).astype(
        np.float32)
    x[0, :, 2:4] *= 4.0
    x[1, 0, 14:16] = (0.0, 1.0)
    x[1, 1, 8:10] = (12.0, 0.0)
    us = rng.randn(B, N, 3, 2).astype(np.float32)
    return x, us


def test_player_quadraticize_matches_jax():
    prob, jprob = ff.make_problem(num_time_steps=N), jff.make_problem(
        num_time_steps=N)
    spec, jspec = prob.spec, jprob.spec
    x, us = _stage_inputs()
    op = OperatingPoint(xs=torch.tensor(x), us=torch.tensor(us),
                        t0=torch.zeros(B))
    al = pcost.ALState.init(prob.player_costs, spec, B)
    q = pcost.quadraticize(prob.player_costs, spec, op, al)
    empty = tuple(jnp.zeros((0,)) for _ in range(3))
    ts = np.arange(N, dtype=np.float32) * np.float32(spec.dt)
    core = jax.vmap(jax.vmap(
        lambda t, xx, uu: jpc.stage_quadraticize_core(
            jprob.player_costs, jspec, empty, empty, 1.0, t, xx, uu,
            jnp.ones(3)), in_axes=(0, 0, 0)), in_axes=(None, 0, 0))
    want = core(ts, x, us)
    for got, w in zip((q.Q, q.l, q.R, q.r), want):
        _close(got, w, rtol=STAGE_TOL)
    # The unfused solver's own quadraticize gives the same values.
    jal = jpc.ALState.init(jprob.player_costs, jspec)
    jq = jax.vmap(lambda xs, uu: jpc.quadraticize(
        jprob.player_costs, jspec, JOp(xs=xs, us=uu, t0=jnp.float32(0.0)),
        jal, jnp.zeros(3, jnp.int32)))(x, us)
    for got, w in zip((q.Q, q.l, q.R, q.r), (jq.Q, jq.l, jq.R, jq.r)):
        _close(got, w, rtol=STAGE_TOL)


def test_player_merit_terms_match_jax():
    prob, jprob = ff.make_problem(num_time_steps=N), jff.make_problem(
        num_time_steps=N)
    spec, jspec = prob.spec, jprob.spec
    x, us = _stage_inputs(3)
    lam = tuple(torch.zeros(B, N, 0) for _ in range(3))
    mu = torch.full((B, N), 10.0)
    t = torch.zeros(B, N)
    args = (prob.player_costs, spec, lam, lam, mu, t, torch.tensor(x),
            torch.tensor(us))
    s_sq, r_sq = pcost.stage_gradient_sq_tuple(*args)
    l, r = pcost.stage_gradients(*args)
    empty = tuple(jnp.zeros((0,)) for _ in range(3))

    def jax_b(fn):
        return jax.vmap(jax.vmap(lambda xx, uu: fn(
            jprob.player_costs, jspec, empty, empty, 10.0, 0.0, xx, uu)))(
                x, us)

    js, jr = jax_b(jpc.stage_gradient_sq_tuple)
    for p_ in range(3):
        _close(s_sq[p_], js[p_], rtol=STAGE_TOL)
        _close(r_sq[p_], jr[p_], rtol=STAGE_TOL)
    jl, jrr = jax_b(jpc.stage_gradients_core)
    _close(l, jl, rtol=STAGE_TOL)
    _close(r, jrr, rtol=STAGE_TOL)
    # Every player holds MinV and MaxV, so its state term is the square
    # of the whole assembled gradient.
    for p_ in range(3):
        _close(s_sq[p_], (l[..., p_, :] ** 2).sum(-1), rtol=STAGE_TOL)


def test_fused_stages_refused_by_both_packages():
    prob, jprob = ff.make_problem(num_time_steps=N), jff.make_problem(
        num_time_steps=N)
    kw = dict(max_solver_iters=2, unconstrained_solver_max_iters=2)
    x0 = np.tile(prob.x0.numpy()[None], (2, 1))
    with pytest.raises(ValueError) as jerr:
        jbatched.make_host_batched_solver(
            jprob.dynamics, jprob.player_costs, jprob.spec, JParams(**kw),
            batch_block=2, interpret=True, fuse_stages=True)(jnp.asarray(x0))
    op = {"xs": torch.zeros(N, 16, 2), "us": torch.zeros(N, 6, 2),
          "t0": torch.zeros(1, 2)}
    with pytest.raises(ValueError) as err:
        stage.lin_quad_plain(prob.dynamics, prob.player_costs, prob.spec, op,
                             None, None, torch.ones(1, 2))
    assert str(err.value) == str(jerr.value)
    assert "'MinV'" in str(err.value)
