"""dubins_origin's pieces in the port against the JAX package:

- `dubins_car`: its ODE and Jacobian within 1e-6 (trigonometry through
  `fmath`, a few ulps from XLA's; a diverged heading included), and
  `dyn_base.linearize` of the joint dynamics within 1e-6;
- `quadratic_difference`: evaluate bitwise (the same closed form), its
  gradient pairs and its quadraticization's 16 Hessian and 4 gradient
  pairs in support order bitwise against the JAX package's autodiff over
  the support (signs of zero included, on lanes with NaN, inf and signed
  zeros too), and its device form;
- the example: x0 bitwise, its atoms and device forms;
- the fused stage's plain version `lin_quad_plain` (dubins_car's Jacobian,
  quadratic_difference's pairs) against `lin_quad_pallas` in interpret
  mode at N=9, B=3, within 1e-5, at lane times t0 = 0.3;
- the merits (`merit_plain`, the plain fold of K5 and K6) against the JAX
  package's sweep merits in interpret mode at N=9, within 1e-5.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ilqgames_tpu.costs import atoms as jatoms  # noqa: E402
from ilqgames_tpu.costs import player_cost as jpc  # noqa: E402
from ilqgames_tpu.dynamics import base as jdyn  # noqa: E402
from ilqgames_tpu.dynamics import models as jmodels  # noqa: E402
from ilqgames_tpu.examples import dubins_origin as jdo  # noqa: E402
from ilqgames_tpu.ops.pallas import stage as jstage  # noqa: E402
from ilqgames_tpu.ops.pallas import sweep as jsweep  # noqa: E402
from ilqgames_tpu.types import OperatingPoint as JOp  # noqa: E402
from ilqgames_tpu.types import Strategy as JStrategy  # noqa: E402

from ilqgames_tpu_torch import convert  # noqa: E402
from ilqgames_tpu_torch.costs import atoms  # noqa: E402
from ilqgames_tpu_torch.costs import player_cost as pcost  # noqa: E402
from ilqgames_tpu_torch.dynamics import base as dyn_base  # noqa: E402
from ilqgames_tpu_torch.dynamics import models  # noqa: E402
from ilqgames_tpu_torch.examples import dubins_origin as do  # noqa: E402
from ilqgames_tpu_torch.ops.cuda import stage, sweep  # noqa: E402

torch.set_num_threads(1)

N, B = 9, 3


def _close(got, want, rtol=1e-6, atol=1e-6, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


def _same_bits(got, want, msg=""):
    got = np.asarray(got, np.float32)
    want = np.broadcast_to(np.asarray(want, np.float32), got.shape)
    nan = np.isnan(want)
    assert (np.isnan(got) == nan).all(), msg
    assert (got.view(np.int32)[~nan] == want.view(np.int32)[~nan]).all(), (
        msg, got, want)


def _states(n=64, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, 3) * [5, 5, 3]).astype(np.float32)
    x[0, 2] = 1e6                          # a diverged heading
    return x, rng.randn(n, 1).astype(np.float32)


def test_dubins_car_matches_jax():
    x, u = _states()
    m, jm = models.dubins_car(1.5), jmodels.dubins_car(1.5)
    assert (m.xdim, m.udim, m.position_dims, m.kind, m.length) == (
        3, 1, (0, 1), models.KIND_DUBINS, 1.5)
    _close(m.ode(0.0, torch.tensor(x), torch.tensor(u)),
           jax.vmap(lambda a, b: jm.ode(0.0, a, b))(x, u))
    jx, ju = m.jac(0.0, torch.tensor(x), torch.tensor(u))
    jjx, jju = jax.vmap(lambda a, b: tuple(
        [v for _, v in e] for e in jm.jac(0.0, a, b)))(x, u)
    keys = lambda e: [k for k, _ in e]
    kx, ku = (keys(e) for e in jm.jac(0.0, x[0], u[0]))
    assert keys(jx) == kx and keys(ju) == ku
    for k, (_, g), w in zip(kx + ku, jx + ju, list(jjx) + list(jju)):
        _close(np.broadcast_to(np.asarray(g, np.float32), np.shape(w)), w,
               msg=str(k))


def _op(prob, seed, Bn=B):
    """A batch of operating points near the example's x0: [B, N, ...]."""
    spec = prob.spec
    rng = np.random.RandomState(seed)
    xs = (prob.x0.numpy()[None, None] + np.cumsum(
        0.3 * rng.randn(Bn, N, spec.xdim), 1)).astype(np.float32)
    us = (0.2 * rng.randn(Bn, N, spec.num_players, spec.umax)).astype(
        np.float32)
    return xs, us, np.zeros((Bn,), np.float32)


def test_linearize_matches_jax():
    prob, jprob = do.make_problem(num_time_steps=N), jdo.make_problem(
        num_time_steps=N)
    xs, us, t0 = _op(prob, 1)
    lin = dyn_base.linearize(prob.dynamics, prob.spec,
                             convert.from_operating_point(JOp(xs=xs, us=us,
                                                              t0=t0)))
    jlin = jax.vmap(lambda o: jdyn.linearize(jprob.dynamics, jprob.spec, o))(
        JOp(xs=jnp.asarray(xs), us=jnp.asarray(us), t0=jnp.asarray(t0)))
    _close(lin.A.numpy(), jlin.A, msg="A")
    _close(lin.Bs.numpy(), jlin.Bs, msg="Bs")


def _diff_points():
    rng = np.random.RandomState(3)
    v = (rng.randn(40, 6) * 4).astype(np.float32)
    v[0] = [np.inf, 1.0, 0.0, np.nan, 2.0, 0.0]
    v[1] = [-0.0, 0.0, 0.0, 0.0, -0.0, 0.0]
    v[2, [0, 3]] = 7.25                  # a zero difference
    v[3] *= 1e18                         # squares overflow
    return v


def test_quadratic_difference_matches_jax():
    """Evaluate, the merit's gradient pairs and the quadraticization's
    pairs, bitwise, in the JAX package's order."""
    v = _diff_points()
    c = atoms.quadratic_difference(10.0, (0, 1), (3, 4), "Attraction")
    jc = jatoms.quadratic_difference(10.0, (0, 1), (3, 4), "Attraction")
    tv = torch.tensor(v)
    _same_bits(c.evaluate(0.0, tv).numpy(),
               jax.vmap(lambda a: jc.evaluate(0.0, a))(v), "evaluate")
    jg = jax.vmap(lambda a: [p for _, p in jc.gradient_pairs(0.0, a)])(v)
    gp = c.gradient_pairs(0.0, tv)
    assert [k for k, _ in gp] == [int(k) for k, _ in
                                  jc.gradient_pairs(0.0, v[0])]
    for (k, g), w in zip(gp, jg):
        _same_bits(g.numpy(), w, f"gradient {k}")
    hp, qg = c.quad_pairs(0.0, tv)
    jhp, jqg = jc.quad_pairs(0.0, jnp.asarray(v[0]))
    assert [k for k, _ in hp] == [(int(i), int(j)) for (i, j), _ in jhp]
    assert len(hp) == 16 and len(qg) == 4
    jh, jq = jax.vmap(lambda a: tuple(
        [p for _, p in e] for e in jc.quad_pairs(0.0, a)))(v)
    for (k, h), w in zip(hp, jh):
        _same_bits(h.numpy(), w, f"hessian {k}")
    for (k, g), w in zip(qg, jq):
        _same_bits(g.numpy(), w, f"quad gradient {k}")
    assert c.device == ("quadratic_difference", {"dims": (0, 1, 3, 4),
                                                 "weight": 10.0})
    # One difference: pairs, and the device form of any number of pairs.
    one = atoms.quadratic_difference(2.0, (1,), (4,))
    assert len(one.quad_pairs(0.0, tv)[0]) == 4 and one.device == (
        "quadratic_difference_n", {"dims1": (1,), "dims2": (4,),
                                   "weight": 2.0})


def test_example_matches_jax():
    prob, jprob = do.make_problem(), jdo.make_problem()
    assert prob.x0.numpy().tobytes() == np.asarray(jprob.x0).tobytes()
    assert (prob.spec.xdims, prob.spec.udims, prob.spec.num_time_steps,
            prob.spec.dt) == (jprob.spec.xdims, jprob.spec.udims,
                              jprob.spec.num_time_steps, jprob.spec.dt)
    assert [m.kind for m in prob.dynamics.models] == [models.KIND_DUBINS] * 2
    kinds = [[c.device[0] for c in pc.state_costs]
             for pc in prob.player_costs]
    assert kinds == [["quadratic", "quadratic"], ["quadratic_difference"]]
    assert [[j for j, _ in pc.control_costs] for pc in prob.player_costs] \
        == [[0], [1]]
    assert not pcost.is_constrained(prob.player_costs)


def test_lin_quad_plain_matches_lin_quad_pallas():
    """K1's plain version against the JAX package's fused stage kernel in
    interpret mode: dubins_car's Jacobian and quadratic_difference's
    pairs, at lane times t0 = 0.3."""
    prob, jprob = do.make_problem(num_time_steps=N), jdo.make_problem(
        num_time_steps=N)
    spec = prob.spec
    xs, us, t0 = _op(prob, 2)
    t0[:] = 0.3
    op = convert.from_operating_point(JOp(xs=xs, us=us, t0=t0))
    al = pcost.ALState.init(prob.player_costs, spec, B)
    op_bm, _ = sweep._prep_op(spec, torch.zeros((B, spec.xdim)), op, B)
    lamS, lamC, mu_bm, gate_bm = sweep._prep_al(spec, al, None, B)
    assert lamS is None and lamC is None and gate_bm is None
    got = stage.lin_quad_plain(prob.dynamics, prob.player_costs, spec,
                               op_bm, lamS, lamC, mu_bm, gate_bm)
    jop = {k: jnp.asarray(v.numpy()) for k, v in op_bm.items()}
    ref = jstage.lin_quad_pallas(
        jprob.dynamics, jprob.player_costs, spec, jop, None, None,
        jnp.asarray(mu_bm.numpy()), jnp.ones((N, 2, B), jnp.float32),
        batch_block=B, interpret=True)
    assert set(got) == set(ref)
    for name in ref:
        _close(got[name].numpy(), ref[name], 1e-5, 1e-5, name)


def test_merits_match_jax():
    """The linesearch merits of a few candidates (the plain fold of K5 and
    K6 after K4's plain rollout) against the JAX package's sweep in
    interpret mode, under a small feedback strategy."""
    prob, jprob = do.make_problem(num_time_steps=N), jdo.make_problem(
        num_time_steps=N)
    spec = prob.spec
    xs, us, t0 = _op(prob, 4)
    rng = np.random.RandomState(5)
    Ps = (0.05 * rng.randn(B, N, 2, 1, spec.xdim)).astype(np.float32)
    alphas = (0.2 * rng.randn(B, N, 2, 1)).astype(np.float32)
    x0 = xs[:, 0] + 0.05 * rng.randn(B, spec.xdim).astype(np.float32)
    scal = np.asarray([1.0, 0.5, 0.25], np.float32)
    op = convert.from_operating_point(JOp(xs=xs, us=us, t0=t0))
    st = convert.from_strategy(JStrategy(Ps=Ps, alphas=alphas))
    al = pcost.ALState.init(prob.player_costs, spec, B)
    got = sweep.sweep_merits(prob.dynamics, prob.player_costs, spec,
                             torch.tensor(x0), op, st, torch.tensor(scal),
                             al, batch_block=B)
    jal = jax.vmap(lambda _: jpc.ALState.init(jprob.player_costs, spec))(
        jnp.arange(B))
    ref = jsweep.sweep_merits_pallas(
        jprob.dynamics, jprob.player_costs, spec, jnp.asarray(x0),
        JOp(xs=jnp.asarray(xs), us=jnp.asarray(us), t0=jnp.asarray(t0)),
        JStrategy(Ps=jnp.asarray(Ps), alphas=jnp.asarray(alphas)),
        jnp.asarray(scal), jal, jnp.ones((B, N, 2), jnp.float32),
        batch_block=B, interpret=True)
    _close(got.numpy(), ref, 1e-5, 1e-5)
