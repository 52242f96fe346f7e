"""Port parity: the fused stage K1's plain version (`stage.lin_quad_plain`)
against the JAX package's Pallas stage kernel in interpret mode and,
bit for bit, against the port's own linearize + quadraticize, on the same
numpy-made inputs at N=11, B=4 with live multipliers. Also the large
headings of diverged lanes, where the port's trigonometry used to
overflow."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ilqgames_tpu.dynamics import base as jdyn  # noqa: E402
from ilqgames_tpu.examples import three_player_intersection as jex  # noqa: E402
from ilqgames_tpu.ops.pallas import stage as jstage  # noqa: E402
from ilqgames_tpu.ops.pallas import sweep as jsweep  # noqa: E402
from ilqgames_tpu.types import OperatingPoint as JOp  # noqa: E402
from ilqgames_tpu.types import Strategy as JStrategy  # noqa: E402

from ilqgames_tpu_torch import convert  # noqa: E402
from ilqgames_tpu_torch.costs import atoms, player_cost as pc  # noqa: E402
from ilqgames_tpu_torch.dynamics import base as dyn  # noqa: E402
from ilqgames_tpu_torch.examples import three_player_intersection as ex  # noqa: E402
from ilqgames_tpu_torch.ops.cuda import cost_table, lq, stage, sweep  # noqa: E402

torch.set_num_threads(1)

B, N = 4, 11
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def stage_in():
    """A batched operating point near the flagship's start and AL
    multipliers with live constraints (as tests/test_torch_stage.py), in
    both packages' batch-minor operand form."""
    jprob = jex.make_problem(num_time_steps=N)
    prob = ex.make_problem(num_time_steps=N)
    spec = jprob.spec
    rng = np.random.RandomState(0)
    x0 = np.asarray(jprob.x0)
    xs = (x0[None, None] + np.cumsum(
        0.5 * rng.randn(B, N, spec.xdim), axis=1)).astype(np.float32)
    us = rng.randn(B, N, spec.num_players, spec.umax).astype(np.float32)
    t0 = np.zeros((B,), np.float32)
    lams = [np.abs(rng.randn(B, len(c.state_constraints), N)).astype(
        np.float32) for c in jprob.player_costs]
    mu = np.full((B,), 12.5, np.float32)
    return jprob, prob, xs, us, t0, lams, mu


def _port_operands(prob, xs, us, t0, lams, mu):
    al = pc.ALState(
        state_lambdas=tuple(torch.tensor(l) for l in lams),
        control_lambdas=tuple(torch.zeros((B, 0, N)) for _ in lams),
        mu=torch.tensor(mu))
    op = convert.from_operating_point(JOp(xs=xs, us=us, t0=t0))
    op_bm, _ = sweep._prep_op(prob.spec, torch.zeros((B, prob.spec.xdim)),
                              op, 1)
    lamS, lamC, mu_bm, _ = sweep._prep_al(prob.spec, al, None, 1)
    return op, al, op_bm, lamS, lamC, mu_bm


def test_lin_quad_plain_vs_pallas_interpret(stage_in):
    jprob, prob, xs, us, t0, lams, mu = stage_in
    spec = jprob.spec
    jop = JOp(xs=jnp.asarray(xs), us=jnp.asarray(us), t0=jnp.asarray(t0))
    jop_bm, _, _ = jsweep._prep_common(
        spec, jnp.zeros((B, spec.xdim)), jop,
        JStrategy(Ps=jnp.zeros((B, N, spec.num_players, spec.umax,
                                spec.xdim)),
                  alphas=jnp.zeros((B, N, spec.num_players, spec.umax))), B)
    lamS = jnp.asarray(np.concatenate(lams, axis=1).transpose(2, 1, 0))
    gate = jnp.ones((N, spec.num_players, B), jnp.float32)
    ref = jstage.lin_quad_pallas(
        jprob.dynamics, jprob.player_costs, spec, jop_bm, lamS, None,
        jnp.asarray(mu)[None], gate, batch_block=B, interpret=True)
    _, _, op_bm, tlamS, tlamC, tmu = _port_operands(prob, xs, us, t0, lams,
                                                    mu)
    np.testing.assert_array_equal(tlamS.numpy(), np.asarray(lamS))
    got = stage.lin_quad_plain(prob.dynamics, prob.player_costs, prob.spec,
                               op_bm, tlamS, tlamC, tmu)
    assert set(got) == set(ref)
    for name in ref:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]),
                                   **TOL, err_msg=name)


def test_lin_quad_plain_is_linearize_quadraticize(stage_in):
    """Bit for bit the batch-major stage glue, as the LQ operand dict; the
    wrapper takes it on CPU tensors and launches nothing."""
    _, prob, xs, us, t0, lams, mu = stage_in
    op, al, op_bm, lamS, lamC, mu_bm = _port_operands(prob, xs, us, t0, lams,
                                                      mu)
    want = lq.lq_operands(prob.spec, dyn.linearize(prob.dynamics, prob.spec,
                                                   op),
                          pc.quadraticize(prob.player_costs, prob.spec, op,
                                          al))
    before = stage.lin_quad.launches
    got = stage.lin_quad(prob.dynamics, prob.player_costs, prob.spec, op_bm,
                         lamS, lamC, mu_bm)
    assert stage.lin_quad.launches == before
    for name in want:
        assert torch.equal(got[name], want[name]), name


def test_cost_table_refuses_atoms_without_device_form(stage_in):
    _, prob, *_ = stage_in
    pc0 = prob.player_costs[0]
    odd = atoms.quadratic(1.0, 0).__class__(
        name="custom", evaluate=None, grad_pairs_fn=None, quad_pairs_fn=None)
    costs = (pc0.__class__(state_costs=(odd,)),) + prob.player_costs[1:]
    with pytest.raises(NotImplementedError, match="custom"):
        cost_table.cost_table(costs, prob.spec, "cpu")
    tab, segs = cost_table.cost_table(prob.player_costs, prob.spec, "cpu")
    assert tab.n == 18 and segs.numel() == 7 * 8


@pytest.mark.parametrize("heading", [1e9, 1e14, -3e30])
def test_stage_and_rollout_at_huge_heading(stage_in, heading):
    """A diverged lane's heading far beyond 8192 rad (|x| > 1e8): the JAX
    package's linearization and rollout stay finite, and so must the
    port's (its float32 sin/cos reduced only by pi/4 multiples and
    overflowed to inf there, turning the lane's trajectory to NaN). Up
    to 1e9 rad the two agree to float32 accuracy, at 1e14 to the 1e-3
    rad of the float64 reduction; beyond, only finiteness is held."""
    jprob, prob, xs, us, t0, lams, mu = stage_in
    spec = jprob.spec
    xs = xs.copy()
    xs[:, :, 2] = heading      # player 1's heading
    xs[:, :, 8] = -heading     # player 2's
    jop = JOp(xs=jnp.asarray(xs), us=jnp.asarray(us), t0=jnp.asarray(t0))
    ref = jax.vmap(lambda o: jdyn.linearize(jprob.dynamics, spec, o))(jop)
    op, _, op_bm, lamS, lamC, mu_bm = _port_operands(prob, xs, us, t0, lams,
                                                     mu)
    got = stage.lin_quad(prob.dynamics, prob.player_costs, prob.spec, op_bm,
                         lamS, lamC, mu_bm)
    A = got["A"].permute(3, 0, 1, 2).numpy()
    assert np.isfinite(np.asarray(ref.A)).all() and np.isfinite(A).all()
    assert all(bool(torch.isfinite(v).all()) for v in got.values())
    compare = abs(heading) <= 1e14
    tol = 1e-5 if abs(heading) <= 1e9 else 1e-2
    if compare:
        np.testing.assert_allclose(A, np.asarray(ref.A), rtol=tol, atol=tol)

    x0 = xs[:, 0]
    zero = JStrategy.zeros(spec)
    jroll = jax.vmap(lambda x, o: jdyn.rollout(jprob.dynamics, spec, x, o,
                                               zero))(jnp.asarray(x0), jop)
    st = convert.from_strategy(jax.vmap(lambda _: zero)(jnp.arange(B)))
    roll = sweep.rollout(prob.dynamics, prob.spec, torch.tensor(x0), op, st,
                         batch_block=B)
    assert np.isfinite(np.asarray(jroll.xs)).all()
    assert bool(torch.isfinite(roll.xs).all())
    if compare:
        pos = [0, 1, 6, 7]
        np.testing.assert_allclose(roll.xs[..., pos].numpy(),
                                   np.asarray(jroll.xs)[..., pos],
                                   rtol=tol, atol=tol * 10)


@pytest.mark.cuda
def test_stage_kernel_matches_plain_on_card(stage_in):
    """K1 on the card against its plain version on the same inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card via chip_smoke.py)")
    _, prob, xs, us, t0, lams, mu = stage_in
    _, _, op_bm, lamS, lamC, mu_bm = _port_operands(prob, xs, us, t0, lams,
                                                    mu)
    want = stage.lin_quad_plain(prob.dynamics, prob.player_costs, prob.spec,
                                op_bm, lamS, lamC, mu_bm)
    cu = lambda d: {k: v.cuda() for k, v in d.items()}
    got = stage.lin_quad(prob.dynamics, prob.player_costs, prob.spec,
                         cu(op_bm), lamS.cuda(), None, mu_bm.cuda())
    for name in want:
        assert torch.equal(got[name].cpu(), want[name]), name
