"""Port parity: the plain K2/K3 LQ sweeps (what the CUDA kernels are held
against on the card) against the JAX package's Pallas kernels in
interpret mode and its XLA scan solver, on the same inputs at N=11, B=4.
Tolerances are those of tests/test_pallas_lq.py (LU with pivoting vs
linalg.solve differ in op order, not semantics). K2's and K3's build
defines and shared memory; on the card, K2 and K3 bitwise against their
plain versions.

The JAX package is imported inside the fixture that uses it, so that the
card's tests collect where only the port's dependencies are installed."""

import types

import numpy as np
import pytest
import torch

from ilqgames_tpu_torch.dynamics import base as dyn_base
from ilqgames_tpu_torch.examples.three_player_intersection import \
    make_problem
from ilqgames_tpu_torch.ops.cuda import lq
from ilqgames_tpu_torch.solver import batched
from ilqgames_tpu_torch.types import GameSpec, LinearDynamics, \
    QuadraticCosts

torch.set_num_threads(1)

B, N = 4, 11


@pytest.fixture(scope="module")
def jx():
    """The JAX package's pieces these parity tests use."""
    jax = pytest.importorskip("jax")
    return types.SimpleNamespace(
        jax=jax, jnp=pytest.importorskip("jax.numpy"),
        jpc=pytest.importorskip("ilqgames_tpu.costs.player_cost"),
        jdyn=pytest.importorskip("ilqgames_tpu.dynamics.base"),
        jmake=pytest.importorskip(
            "ilqgames_tpu.examples.three_player_intersection").make_problem,
        pallas=pytest.importorskip(
            "ilqgames_tpu.ops.pallas.lq").solve_lq_feedback_pallas,
        jsolve=pytest.importorskip(
            "ilqgames_tpu.solver.lq_feedback").solve_lq_feedback,
        jtypes=pytest.importorskip("ilqgames_tpu.types"))


@pytest.fixture(scope="module")
def lq_inputs(jx):
    """LQ operands at the first rollout of perturbed x0 (as
    tests/test_pallas_lq.py builds them), in both packages' containers."""
    jax, jnp = jx.jax, jx.jnp
    problem = jx.jmake(num_time_steps=N)
    dyn, costs, spec = problem.dynamics, problem.player_costs, problem.spec
    rng = np.random.RandomState(0)
    x0b = jnp.asarray(np.tile(np.asarray(problem.x0)[None], (B, 1))
                      + 0.1 * rng.randn(B, spec.xdim).astype(np.float32))
    al0 = jx.jpc.ALState.init(costs, spec)
    warm_op = jx.jtypes.OperatingPoint.zeros(spec)
    warm_st = jx.jtypes.Strategy.zeros(spec)

    def init_one(x0):
        last_op = warm_op.replace(xs=warm_op.xs.at[0].set(x0))
        op = jx.jdyn.rollout(dyn, spec, x0, last_op, warm_st)
        _, ek = jx.jpc.total_costs(costs, spec, op)
        return (jx.jdyn.linearize(dyn, spec, op),
                jx.jpc.quadraticize(costs, spec, op, al0, ek), x0 - op.xs[0])

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


def test_lq_vs_pallas_interpret(jx, lq_inputs):
    spec, (lin, quad, dx0), (tlin, tquad, tdx0) = lq_inputs
    ref = jx.pallas(spec, lin, quad, dx0, batch_block=4, interpret=True)
    got = lq.solve_lq_feedback(make_problem(num_time_steps=N).spec, tlin,
                               tquad, tdx0, batch_block=4)
    _assert_lq(got, ref.strategy.Ps, ref.strategy.alphas, ref.delta_xs)


def test_lq_vs_xla_scan(jx, lq_inputs):
    spec, (lin, quad, dx0), (tlin, tquad, tdx0) = lq_inputs
    ref = jx.jax.vmap(lambda l, q, d: jx.jsolve(spec, l, q, d))(lin, quad,
                                                                 dx0)
    got = lq.solve_lq_feedback(make_problem(num_time_steps=N).spec, tlin,
                               tquad, tdx0, batch_block=4)
    _assert_lq(got, ref.strategy.Ps, ref.strategy.alphas, ref.delta_xs)


def test_lq_batch_padding(jx, lq_inputs):
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
    ref = jx.jax.vmap(lambda l, q, d: jx.jsolve(spec, l, q, d))(lin, quad,
                                                                 dx0)
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


def test_k2_build_defines_and_shared_memory():
    """K2's library carries its lanes per block and the shared memory that
    csrc/lq.cu checks its layout against; the flagship fits a block at 8
    lanes with the operands double-buffered, and a build that would not
    fit a block even at one lane is refused before nvcc runs."""
    spec = make_problem().spec
    name, d = lq.library(spec)
    assert name == "lq" and d["LQ_G"] == lq.LQ_G == 8
    # 3,774 floats a lane, 5,000 with the operands' second buffer (each
    # part padded to 4 floats), padded to 4 more than a multiple of 32.
    assert d["LQ_SMEM"] == lq.backward_smem_bytes(spec) == 8 * 5028 * 4 \
        <= lq.SMEM_LIMIT == 232448
    with pytest.raises(ValueError, match="shared memory"):
        lq.library(GameSpec(xdims=(20,) + (0,) * 31, udims=(1,) * 32))


def test_k3_build_defines_and_shared_memory():
    """K3's library carries its lanes per block and the shared memory that
    csrc/lq.cu checks its layout against: a ring of three knots of A, Bf
    and alpha (358 floats a lane at the flagship's widths) and dx twice,
    for 16 lanes; a build that would not fit a block's shared memory is
    refused before nvcc runs."""
    spec = make_problem().spec
    name, d = lq.library(spec)
    assert name == "lq" and d["LQ_FWD_G"] == lq.FWD_G == 16
    assert lq.FWD_STAGES == 3
    knot = 16 * 16 + 16 * 6 + 6
    assert knot == 358
    assert d["LQ_FWD_SMEM"] == lq.forward_smem_bytes(spec) \
        == 4 * 16 * (3 * knot + 2 * 16) == 70784 <= lq.SMEM_LIMIT
    # 256 threads a block: one per (state row, lane).
    assert spec.xdim * lq.FWD_G == 256
    with pytest.raises(ValueError, match="K3"):
        lq.library(GameSpec(xdims=(64, 64), udims=(2, 2)))


def _port_operands(n, batch_block, nan_lane):
    """K2's operands at the first rollout of x0 near the flagship's start
    (N=11, from a seed), made by the port on the CPU, with a NaN in one
    entry of Qf at knot 5 of lane `nan_lane`."""
    problem = make_problem(num_time_steps=N)
    dyn, spec = problem.dynamics, problem.spec
    rng = np.random.RandomState(6)
    x0 = torch.tensor(np.tile(problem.x0.numpy()[None], (n, 1))
                      + 0.1 * rng.randn(n, spec.xdim).astype(np.float32))
    c = batched._fresh_init(dyn, problem.player_costs, spec, None, None, 128,
                            False)(x0).c
    ops = lq.lq_operands(spec, dyn_base.linearize(dyn, spec, c.op), c.quad,
                         batch_block)
    ops["Qf"][5, 3, 2, nan_lane] = float("nan")
    return spec, ops


@pytest.mark.cuda
def test_k2_bitwise_on_card_ragged_group():
    """K2 against `lq_backward_plain` on the card, bit for bit, at B=12
    (lanes padded to a multiple of 4): a last group of 4 lanes at 8 lanes
    per block, and one lane with a NaN operand."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    spec, ops = _port_operands(12, 4, nan_lane=7)
    ops = {k: v.cuda() for k, v in ops.items()}
    assert ops["A"].shape[-1] == 12
    want = lq.lq_backward_plain(spec, ops)
    launches = lq.lq_backward.launches
    got = lq.lq_backward(spec, ops)
    torch.cuda.synchronize()
    assert lq.lq_backward.launches == launches + 1
    assert bool(want[0][:, :, :, 7].isnan().any())
    for g, w in zip(got, want):
        nan = w.isnan()
        assert torch.equal(g.isnan(), nan)
        # Bit patterns, so that -0.0 and +0.0 count as different.
        assert torch.equal(g.view(torch.int32)[~nan],
                           w.view(torch.int32)[~nan])


def _offset_view(t):
    """A contiguous copy of t that starts one float past its storage's
    start, so that its data pointer is 4 bytes off a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("B, offset", [(12, False), (11, False), (12, True)],
                         ids=["B12-16-byte", "B11-4-byte",
                              "B12-offset-4-byte"])
def test_k3_bitwise_on_card_ragged_group(B, offset):
    """K3 against `lq_forward_plain` on the card, bit for bit, at B=12
    (16-byte copies), B=11 (4-byte copies) and B=12 on views of A, Bf and
    alpha one float past a 16-byte boundary (4-byte copies): one block of
    16 lanes with its last 4 or 5 past B, NaN alphas on lane 7 (a NaN
    operand of K2) and a NaN entry of A on lane 10."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    spec, ops = _port_operands(12, 4, nan_lane=7)
    _, al = lq.lq_backward_plain(spec, ops)
    ops["A"][3, 2, 5, 10] = float("nan")
    dx0 = torch.tensor(0.1 * np.random.RandomState(7).randn(
        spec.xdim, 12).astype(np.float32))
    args = [t[..., :B].contiguous().cuda()
            for t in (ops["A"], ops["Bf"], al, dx0)]
    if offset:
        args[:3] = [_offset_view(t) for t in args[:3]]
    assert bool(al[:, :, 7].isnan().any())
    want = lq.lq_forward_plain(spec, *args)
    launches = lq.lq_forward.launches
    got = lq.lq_forward(spec, *args)
    torch.cuda.synchronize()
    assert lq.lq_forward.launches == launches + 1
    nan = want.isnan()
    assert bool(nan[:, :, 10].any()) and not bool(nan[:, :, 0].any())
    assert torch.equal(got.isnan(), nan)
    assert torch.equal(got.view(torch.int32)[~nan],
                       want.view(torch.int32)[~nan])
