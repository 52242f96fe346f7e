"""Port parity: the plain K4 candidate rollout and the merit sweep against
the JAX package's Pallas sweep kernels in interpret mode, on the same
numpy-made inputs at N=11, B=4, with per-lane step sizes."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ilqgames_tpu.costs import player_cost as jpc  # noqa: E402
from ilqgames_tpu.dynamics import base as jdyn  # noqa: E402
from ilqgames_tpu.examples.three_player_intersection import \
    make_problem as jmake  # noqa: E402
from ilqgames_tpu.ops.pallas import sweep as jsweep  # noqa: E402
from ilqgames_tpu.solver.lq_feedback import solve_lq_feedback  # noqa: E402
from ilqgames_tpu.types import OperatingPoint, Strategy  # noqa: E402

from ilqgames_tpu_torch import convert  # noqa: E402
from ilqgames_tpu_torch.dynamics import base as dyn  # noqa: E402
from ilqgames_tpu_torch.examples.three_player_intersection import \
    make_problem  # noqa: E402
from ilqgames_tpu_torch.ops.cuda import sweep  # noqa: E402

torch.set_num_threads(1)

B, N = 4, 11


@pytest.fixture(scope="module")
def state():
    """A rolled-out operating point, the LQ strategy at it, and AL
    multipliers with live constraints: both packages' containers."""
    jprob = jmake(num_time_steps=N)
    dynj, costs, spec = jprob.dynamics, jprob.player_costs, jprob.spec
    rng = np.random.RandomState(1)
    x0 = (np.tile(np.asarray(jprob.x0)[None], (B, 1))
          + 0.1 * rng.randn(B, spec.xdim)).astype(np.float32)
    al1 = jpc.ALState.init(costs, spec)
    warm_op, warm_st = OperatingPoint.zeros(spec), Strategy.zeros(spec)

    def one(x):
        last = warm_op.replace(xs=warm_op.xs.at[0].set(x))
        op = jdyn.rollout(dynj, spec, x, last, warm_st)
        quad = jpc.quadraticize(costs, spec, op, al1,
                                jnp.zeros((spec.num_players,), jnp.int32))
        lin = jdyn.linearize(dynj, spec, op)
        return op, solve_lq_feedback(spec, lin, quad, x - op.xs[0]).strategy

    op, st = jax.vmap(one)(jnp.asarray(x0))
    al = jax.vmap(lambda _: al1)(jnp.arange(B))
    al = al.replace(
        state_lambdas=tuple(
            jnp.asarray(np.abs(rng.randn(*l.shape)).astype(np.float32))
            for l in al.state_lambdas),
        mu=jnp.full((B,), 11.0, jnp.float32))
    scal = jnp.asarray([0.1, 0.05, 0.3, 1.0], jnp.float32)
    tp = make_problem(num_time_steps=N)
    ported = (torch.tensor(x0), convert.from_operating_point(op),
              convert.from_strategy(st), convert.from_al_state(al),
              torch.tensor(np.asarray(scal)))
    return jprob, (jnp.asarray(x0), op, st, al, scal), tp, ported


def test_rollout_vs_pallas_interpret(state):
    jprob, (x0, op, st, _, scal), tp, (tx0, top, tst, _, tscal) = state
    ref = jsweep.rollout_pallas(jprob.dynamics, jprob.spec, x0, op, st,
                                scal=scal, batch_block=4, interpret=True)
    got = sweep.rollout(tp.dynamics, tp.spec, tx0, top, tst, scal=tscal,
                        batch_block=4)
    np.testing.assert_allclose(got.xs.numpy(), np.asarray(ref.xs),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.us.numpy(), np.asarray(ref.us),
                               rtol=2e-4, atol=2e-4)


def test_plain_rollout_vs_reference_scan(state):
    """dynamics.base.rollout (unscaled strategy) against JAX's scan."""
    jprob, (x0, op, st, _, _), tp, (tx0, top, tst, _, _) = state
    ref = jax.vmap(lambda x, o, s: jdyn.rollout(
        jprob.dynamics, jprob.spec, x, o, s))(x0, op, st)
    got = dyn.rollout(tp.dynamics, tp.spec, tx0, top, tst)
    np.testing.assert_allclose(got.xs.numpy(), np.asarray(ref.xs),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("per_lane", [False, True],
                         ids=["shared-scalings", "per-lane-scalings"])
def test_sweep_merits_vs_pallas_interpret(state, per_lane):
    jprob, (x0, op, st, al, _), tp, (tx0, top, tst, tal, _) = state
    ladder = 0.1 * 0.5 ** np.arange(4, dtype=np.float32)
    if per_lane:
        scalings = ladder[None] * np.array([[1.0], [0.5], [2.0], [0.25]],
                                           np.float32)
    else:
        scalings = ladder
    gate = jnp.ones((B, N, jprob.spec.num_players), jnp.float32)
    ref = jsweep.sweep_merits_pallas(
        jprob.dynamics, jprob.player_costs, jprob.spec, x0, op, st,
        jnp.asarray(scalings), al, gate, batch_block=4, interpret=True)
    got = sweep.sweep_merits(tp.dynamics, tp.player_costs, tp.spec, tx0, top,
                             tst, torch.tensor(scalings), tal, batch_block=4)
    assert np.isfinite(np.asarray(ref)).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_rollout_wrapper_takes_plain_on_cpu(state):
    """On CPU tensors K4's wrapper runs the plain version and launches
    nothing; a model without a device ODE is refused before any launch."""
    _, _, tp, (tx0, top, tst, _, tscal) = state
    before = sweep.rollout_bm.launches
    sweep.rollout(tp.dynamics, tp.spec, tx0, top, tst, scal=tscal,
                  batch_block=4)
    assert sweep.rollout_bm.launches == before
    no_ode = tp.dynamics.models[0].__class__(
        name="custom", xdim=6, udim=2, ode=tp.dynamics.models[0].ode)
    with pytest.raises(NotImplementedError, match="custom"):
        sweep._device_table(tp.dynamics.__class__(
            name="d", xdims=(6,), udims=(2,), ode=None, models=(no_ode,)),
            tp.spec)


@pytest.mark.cuda
def test_rollout_kernel_matches_plain_on_card(state):
    """K4 on the card against its plain version on the same inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card via chip_smoke.py)")
    _, _, tp, (tx0, top, tst, _, tscal) = state
    cpu = sweep.rollout(tp.dynamics, tp.spec, tx0, top, tst, scal=tscal,
                        batch_block=4)
    cu = lambda c: c.__class__(**{k: v.cuda() for k, v in vars(c).items()})
    gpu = sweep.rollout(tp.dynamics, tp.spec, tx0.cuda(), cu(top), cu(tst),
                        scal=tscal.cuda(), batch_block=4)
    np.testing.assert_allclose(gpu.xs.cpu().numpy(), cpu.xs.numpy(),
                               rtol=2e-4, atol=2e-4)
