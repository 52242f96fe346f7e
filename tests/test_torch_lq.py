"""Port parity: the plain K2/K3 LQ sweeps (what the CUDA kernels are held
against on the card) against the JAX package's Pallas kernels in
interpret mode and its XLA scan solver, on the same inputs at N=11, B=4.
Tolerances are those of tests/test_pallas_lq.py (LU with pivoting vs
linalg.solve differ in op order, not semantics)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ilqgames_tpu.costs import player_cost as jpc  # noqa: E402
from ilqgames_tpu.dynamics import base as jdyn  # noqa: E402
from ilqgames_tpu.examples.three_player_intersection import \
    make_problem as jmake  # noqa: E402
from ilqgames_tpu.ops.pallas.lq import solve_lq_feedback_pallas  # noqa: E402
from ilqgames_tpu.solver.lq_feedback import solve_lq_feedback as jsolve  # noqa: E402
from ilqgames_tpu.types import OperatingPoint, Strategy  # noqa: E402

from ilqgames_tpu_torch.examples.three_player_intersection import \
    make_problem  # noqa: E402
from ilqgames_tpu_torch.ops.cuda import lq  # noqa: E402
from ilqgames_tpu_torch.types import LinearDynamics, QuadraticCosts  # noqa: E402

torch.set_num_threads(1)

B, N = 4, 11


@pytest.fixture(scope="module")
def lq_inputs():
    """LQ operands at the first rollout of perturbed x0 (as
    tests/test_pallas_lq.py builds them), in both packages' containers."""
    problem = jmake(num_time_steps=N)
    dyn, costs, spec = problem.dynamics, problem.player_costs, problem.spec
    rng = np.random.RandomState(0)
    x0b = jnp.asarray(np.tile(np.asarray(problem.x0)[None], (B, 1))
                      + 0.1 * rng.randn(B, spec.xdim).astype(np.float32))
    al0 = jpc.ALState.init(costs, spec)
    warm_op, warm_st = OperatingPoint.zeros(spec), Strategy.zeros(spec)

    def init_one(x0):
        last_op = warm_op.replace(xs=warm_op.xs.at[0].set(x0))
        op = jdyn.rollout(dyn, spec, x0, last_op, warm_st)
        _, ek = jpc.total_costs(costs, spec, op)
        return (jdyn.linearize(dyn, spec, op),
                jpc.quadraticize(costs, spec, op, al0, ek), x0 - op.xs[0])

    lin, quad, dx0 = jax.vmap(init_one)(x0b)
    t = lambda a: torch.tensor(np.asarray(a))
    tlin = LinearDynamics(A=t(lin.A), Bs=t(lin.Bs))
    tquad = QuadraticCosts(Q=t(quad.Q), l=t(quad.l), R=t(quad.R), r=t(quad.r))
    return spec, (lin, quad, dx0), (tlin, tquad, t(dx0))


def _assert_lq(got, Ps, alphas, dxs, n=B):
    np.testing.assert_allclose(got.strategy.Ps.numpy(), np.asarray(Ps)[:n],
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.strategy.alphas.numpy(),
                               np.asarray(alphas)[:n], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.delta_xs.numpy(), np.asarray(dxs)[:n],
                               rtol=5e-4, atol=5e-4)


def test_lq_vs_pallas_interpret(lq_inputs):
    spec, (lin, quad, dx0), (tlin, tquad, tdx0) = lq_inputs
    ref = solve_lq_feedback_pallas(spec, lin, quad, dx0, batch_block=4,
                                   interpret=True)
    got = lq.solve_lq_feedback(make_problem(num_time_steps=N).spec, tlin,
                               tquad, tdx0, batch_block=4)
    _assert_lq(got, ref.strategy.Ps, ref.strategy.alphas, ref.delta_xs)


def test_lq_vs_xla_scan(lq_inputs):
    spec, (lin, quad, dx0), (tlin, tquad, tdx0) = lq_inputs
    ref = jax.vmap(lambda l, q, d: jsolve(spec, l, q, d))(lin, quad, dx0)
    got = lq.solve_lq_feedback(make_problem(num_time_steps=N).spec, tlin,
                               tquad, tdx0, batch_block=4)
    _assert_lq(got, ref.strategy.Ps, ref.strategy.alphas, ref.delta_xs)


def test_lq_batch_padding(lq_inputs):
    """Three lanes padded to a block of four: padded lanes must not leak,
    and the result matches the unpadded JAX reference."""
    spec, (lin, quad, dx0), (tlin, tquad, tdx0) = lq_inputs
    tspec = make_problem(num_time_steps=N).spec
    trim = lambda c: c.__class__(**{k: v[:3] for k, v in vars(c).items()})
    got3 = lq.solve_lq_feedback(tspec, trim(tlin), trim(tquad), tdx0[:3],
                                batch_block=4)
    got4 = lq.solve_lq_feedback(tspec, tlin, tquad, tdx0, batch_block=4)
    np.testing.assert_array_equal(got3.strategy.alphas.numpy(),
                                  got4.strategy.alphas[:3].numpy())
    ref = jax.vmap(lambda l, q, d: jsolve(spec, l, q, d))(lin, quad, dx0)
    _assert_lq(got3, ref.strategy.Ps, ref.strategy.alphas, ref.delta_xs,
               n=3)


def test_lq_wrappers_take_plain_on_cpu(lq_inputs):
    """On CPU tensors the K2/K3 wrappers run the plain versions and launch
    nothing; bad operands raise."""
    _, _, (tlin, tquad, tdx0) = lq_inputs
    tspec = make_problem(num_time_steps=N).spec
    before = (lq.lq_backward.launches, lq.lq_forward.launches)
    lq.solve_lq_feedback(tspec, tlin, tquad, tdx0, batch_block=4)
    assert (lq.lq_backward.launches, lq.lq_forward.launches) == before
    ops = {"A": torch.zeros(N, 16, 16, 4), "Bf": torch.zeros(N, 16, 6, 4),
           "Qf": torch.zeros(N, 48, 16, 4), "lf": torch.zeros(N, 48, 4),
           "Rf": torch.zeros(N, 18, 2, 4), "rf": torch.zeros(N, 18, 4)}
    with pytest.raises(ValueError, match="shape"):
        lq.lq_backward(tspec, {**ops, "lf": torch.zeros(N, 47, 4)})
    with pytest.raises(TypeError, match="float32"):
        lq.lq_backward(tspec, {**ops, "A": ops["A"].double()})
    with pytest.raises(ValueError, match="device"):
        lq.lq_backward(tspec, {k: v.to("meta") for k, v in ops.items()})


@pytest.mark.cuda
def test_lq_kernels_match_plain_on_card(lq_inputs):
    """K2/K3 on the card against their plain versions on the same inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card via chip_smoke.py)")
    _, _, (tlin, tquad, tdx0) = lq_inputs
    tspec = make_problem(num_time_steps=N).spec
    cpu = lq.solve_lq_feedback(tspec, tlin, tquad, tdx0, batch_block=4)
    to = lambda c: c.__class__(**{k: v.cuda() for k, v in vars(c).items()})
    gpu = lq.solve_lq_feedback(tspec, to(tlin), to(tquad), tdx0.cuda(),
                               batch_block=4)
    _assert_lq(cpu, gpu.strategy.Ps.cpu(), gpu.strategy.alphas.cpu(),
               gpu.delta_xs.cpu())
