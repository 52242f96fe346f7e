"""Port parity with fused stages, whole solves: the driver's default
(fused stages, K1's plain version on the CPU) against the JAX package's
`fused.make_host_batched_solver` at N=11, B=4, as test_full_solve_parity
holds the unfused path; and bit for bit the unfused port."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ilqgames_tpu.solver import fused as jfused  # noqa: E402
from ilqgames_tpu.solver.params import SolverParams as JParams  # noqa: E402

from ilqgames_tpu_torch.ops.cuda import stage  # noqa: E402
from ilqgames_tpu_torch.solver import batched  # noqa: E402
from ilqgames_tpu_torch.solver.params import SolverParams  # noqa: E402

from test_torch_solver import PARAMS, setup  # noqa: E402,F401

torch.set_num_threads(1)


def test_fused_full_solve_parity(setup):
    """The driver's default (fused stages) against the JAX machine; and
    bit for bit the unfused port on the CPU."""
    jprob, prob, x0 = setup
    run_ref = jfused.make_host_batched_solver(
        jprob.dynamics, jprob.player_costs, jprob.spec, JParams(**PARAMS),
        trips_per_call=10)
    run = batched.make_host_batched_solver(
        prob.dynamics, prob.player_costs, prob.spec, SolverParams(**PARAMS),
        batch_block=4)
    ref = run_ref(jnp.asarray(x0))
    before = stage.lin_quad.launches
    got = run(torch.tensor(x0))
    assert stage.lin_quad.launches == before   # CPU: the plain version
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(ref.converged))
    np.testing.assert_array_equal(got.cumulative_iterations.numpy(),
                                  np.asarray(ref.cumulative_iterations))
    np.testing.assert_allclose(got.total_costs.numpy(),
                               np.asarray(ref.total_costs), rtol=5e-3,
                               atol=5e-3)
    np.testing.assert_allclose(got.op.xs.numpy(), np.asarray(ref.op.xs),
                               rtol=5e-3, atol=5e-3)
    unfused = batched.make_host_batched_solver(
        prob.dynamics, prob.player_costs, prob.spec, SolverParams(**PARAMS),
        batch_block=4, fuse_stages=False)(torch.tensor(x0))
    assert torch.equal(got.op.xs, unfused.op.xs)
    assert torch.equal(got.total_costs, unfused.total_costs)
