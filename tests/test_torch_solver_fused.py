"""Port parity with fused stages (K1's plain version on the CPU): the
batched machine's trips against the JAX package's vmapped flat machine
(`fused._trip`) at N=11, B=4, and the batch-minor expected decrease
against the JAX package's. Decisions must be exactly equal; arrays agree
to the tolerances of tests/test_batched_pallas.py."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ilqgames_tpu.solver import batched as jbatched  # noqa: E402
from ilqgames_tpu.solver import fused as jfused  # noqa: E402
from ilqgames_tpu.solver.params import SolverParams as JParams  # noqa: E402

from ilqgames_tpu_torch import convert  # noqa: E402
from ilqgames_tpu_torch.ops.cuda import stage  # noqa: E402
from ilqgames_tpu_torch.solver import batched  # noqa: E402
from ilqgames_tpu_torch.solver.params import SolverParams  # noqa: E402

from test_torch_solver import B, N, PARAMS, _jax_carry0, setup  # noqa: E402,F401

torch.set_num_threads(1)


def test_fused_trip_parity(setup):
    """Six fused trips against six of the JAX machine from the same carry
    (lane 0 with a carried merit of 0, so it walks the deep ladder and
    the failure path); K1 runs in every trip."""
    jprob, prob, x0 = setup
    params = JParams(**PARAMS)
    tparams = SolverParams(**PARAMS)
    fc_ref = jax.jit(lambda x: _jax_carry0(jprob, x))(jnp.asarray(x0))
    fc_ref = fc_ref.replace(c=fc_ref.c.replace(
        last_merit=fc_ref.c.last_merit.at[0].set(0.0)))
    fc = convert.from_fused_carry(fc_ref)
    fc = fc.replace(c=fc.c.replace(quad=batched._empty_quad(B, "cpu")))
    trip_ref = jax.jit(jax.vmap(lambda x, f: jfused._trip(
        jprob.dynamics, jprob.player_costs, jprob.spec, params, x, f)))
    stats = batched.new_stats()
    for i in range(6):
        fc_ref = trip_ref(jnp.asarray(x0), fc_ref)
        fc = batched._trip_batched(prob.dynamics, prob.player_costs,
                                   prob.spec, tparams, torch.tensor(x0), fc,
                                   batch_block=4, stats=stats,
                                   fuse_stages=True)
        for name in ("failed", "converged"):
            np.testing.assert_array_equal(
                getattr(fc.c, name).numpy(),
                np.asarray(getattr(fc_ref.c, name)),
                err_msg=f"trip {i}: {name}")
        np.testing.assert_array_equal(fc.done.numpy(),
                                      np.asarray(fc_ref.done))
        np.testing.assert_allclose(fc.c.last_merit.numpy(),
                                   np.asarray(fc_ref.c.last_merit),
                                   rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(fc.c.op.xs.numpy(),
                                   np.asarray(fc_ref.c.op.xs),
                                   rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(fc.al.mu.numpy(), np.asarray(fc_ref.al.mu),
                                   rtol=1e-6)
        assert fc.c.quad.Q.numel() == 0
    assert bool(fc.c.failed[0]) and stats["deep_rounds"] >= 2


def test_fuse_stages_resolution(setup):
    """None means fused; dynamics without analytic Jacobians and open loop
    fall back to the unfused stages."""
    _, prob, _ = setup
    p = SolverParams(**PARAMS)
    assert batched._resolve_fuse_for(p, None, prob.dynamics) is True
    assert batched._resolve_fuse_for(p, False, prob.dynamics) is False
    nojac = prob.dynamics.__class__(**{**vars(prob.dynamics),
                                       "ode_jac": None})
    assert batched._resolve_fuse_for(p, True, nojac) is False
    ol = SolverParams(**PARAMS, open_loop=True)
    assert batched._resolve_fuse_for(ol, True, prob.dynamics) is False


def test_expected_decrease_bm(setup):
    """The batch-minor expected decrease against the JAX package's einsum
    form on random stage costs and LQ steps; and bit for bit the port's
    batch-major form on the same numbers."""
    jprob, prob, _ = setup
    spec = jprob.spec
    P, x, u = spec.num_players, spec.xdim, spec.umax
    rng = np.random.RandomState(5)
    r = lambda *s: rng.randn(*s, B).astype(np.float32)
    ops = {"Qf": r(N, P * x, x), "lf": r(N, P * x), "Rf": r(N, P * P * u, u),
           "rf": r(N, P * P * u)}
    al_r, dxs = r(N - 1, P * u), r(N, x)
    ref = jbatched._expected_decrease_bm(
        spec, {k: jnp.asarray(v) for k, v in ops.items()},
        jnp.asarray(al_r), jnp.asarray(dxs))
    tops = {k: torch.tensor(v) for k, v in ops.items()}
    got = batched._expected_decrease_bm(prob.spec, tops, torch.tensor(al_r),
                                        torch.tensor(dxs))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-4)
    quad = batched.ilq.QuadraticCosts(
        Q=tops["Qf"].permute(3, 0, 1, 2).reshape(B, N, P, x, x),
        l=tops["lf"].permute(2, 0, 1).reshape(B, N, P, x),
        R=tops["Rf"].permute(3, 0, 1, 2).reshape(B, N, P, P, u, u),
        r=tops["rf"].permute(2, 0, 1).reshape(B, N, P, P, u))
    alphas = torch.cat([torch.tensor(al_r).permute(2, 0, 1),
                        torch.zeros((B, 1, P * u))], 1).reshape(B, N, P, u)
    bmaj = batched.ilq._expected_decrease(
        prob.spec, quad, alphas, torch.tensor(dxs).permute(2, 0, 1))
    assert torch.equal(got, bmaj)
