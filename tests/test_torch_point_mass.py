"""The port's two-player point mass (examples/two_player_point_mass.py):
its constant-linear dynamics, built from one description of terms, agree
with themselves and with the JAX package's; its LQ game solved by the
port's Riccati sweep matches the reference test suite's independent
Lyapunov iterations (tests/test_lq_solver.py:79); and with full steps
(initial_alpha_scaling = 1) every lane converges in exactly 2
iterations, as the JAX package's does (bench_all.py:131-139)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ilqgames_tpu.examples import two_player_point_mass as jpm  # noqa: E402
from ilqgames_tpu.solver import batched as jbatched  # noqa: E402
from ilqgames_tpu.solver.params import SolverParams as JParams  # noqa: E402
from test_lq_solver import lyapunov_iterations  # noqa: E402

from ilqgames_tpu_torch.costs import player_cost as pcost  # noqa: E402
from ilqgames_tpu_torch.dynamics import base as dyn_base  # noqa: E402
from ilqgames_tpu_torch.examples import two_player_point_mass as pm  # noqa: E402
from ilqgames_tpu_torch.ops.cuda import lq, sweep  # noqa: E402
from ilqgames_tpu_torch.solver import batched  # noqa: E402
from ilqgames_tpu_torch.solver.params import SolverParams  # noqa: E402
from ilqgames_tpu_torch.types import OperatingPoint  # noqa: E402

torch.set_num_threads(1)

B = 6
FULL_STEP = dict(max_solver_iters=40, unconstrained_solver_max_iters=40,
                 max_backtracking_steps=100, initial_alpha_scaling=1.0,
                 convergence_tolerance=1.0, expected_decrease_fraction=0.001)


def _draw(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def test_linear_ode_jacobian_and_device_form_agree():
    """ode against the JAX example's ode on random states and controls
    (bitwise), ode_jac against finite differences of ode (exact: the
    field is linear), linearize against I + dt A, dt B from the JAX
    example's constants, and the kernels' device table and defines
    against the same terms."""
    prob, jprob = pm.make_problem(), jpm.make_problem()
    spec = prob.spec
    rng = np.random.RandomState(0)
    x, us = _draw(rng, 64, 2), _draw(rng, 64, 2, 1)
    got = prob.dynamics.ode(None, torch.tensor(x), torch.tensor(us))
    want = jax.vmap(lambda a, b: jprob.dynamics.ode(0.0, a, b))(
        jnp.asarray(x), jnp.asarray(us))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    jx, ju = prob.dynamics.ode_jac(None, None, None)
    jjx, jju = jprob.dynamics.ode_jac(0.0, None, None)
    assert jx == jjx and ju == jju

    op = OperatingPoint(xs=torch.tensor(_draw(rng, 1, spec.num_time_steps, 2)),
                        us=torch.tensor(_draw(rng, 1, spec.num_time_steps,
                                              2, 1)),
                        t0=torch.zeros(1))
    lin = dyn_base.linearize(prob.dynamics, spec, op)
    A = np.eye(2, dtype=np.float32) + np.float32(spec.dt) * pm.A_CONT
    np.testing.assert_allclose(lin.A[0, 0].numpy(), A, rtol=1e-7)
    np.testing.assert_allclose(lin.Bs[0, 0, :, :, 0].numpy(),
                               spec.dt * np.stack([pm.B1, pm.B2]),
                               rtol=1e-7)

    tab = sweep._device_table(prob.dynamics, spec)
    entries = {(bool(tab.lin_u[e]), tab.lin_row[e], tab.lin_col[e]):
               tab.lin_val[e] for e in range(tab.nlin)}
    # K1 starts from zeros and the identity; the table sets the rest.
    for r in range(2):
        for c in range(2):
            assert entries.get((False, r, c), float(r == c)) == float(
                lin.A[0, 0, r, c])
            assert entries[(True, r, c)] == float(lin.Bs[0, 0, c, r, 0])
    assert (tab.n, sweep._control_rows(tab, 0, spec)) == (1, (0, 2))
    _, defines = sweep.library(prob.dynamics, spec)
    assert defines["SW_NLIN"] == 5
    assert defines["SW_LIN_ROW"] == "".join(
        f"SW_ITEM({r})" for r in (0, 0, 0, 1, 1))
    # Sources: x1, then u of player 1 and 2 (X + flat control row).
    assert defines["SW_LIN_SRC"] == "".join(
        f"SW_ITEM({q})" for q in (1, 2, 3, 2, 3))
    coef = [float.fromhex(v[:-1]) for v in
            defines["SW_LIN_COEF"][len("SW_ITEM("):-1].split(")SW_ITEM(")]
    assert coef == [1.0, float(pm.B1[0]), float(pm.B2[0]), float(pm.B1[1]),
                    float(pm.B2[1])]


def test_lq_solve_matches_lyapunov_iterations():
    """The port's K2 plain version on the game's quadraticization at the
    zero operating point: the first knot's gains match the reference's
    Lyapunov fixed point to 1e-4 (the JAX package's bound)."""
    prob = pm.make_problem()
    spec, N = prob.spec, prob.spec.num_time_steps
    op = OperatingPoint(xs=torch.zeros((1, N, 2)), us=torch.zeros((1, N, 2, 1)),
                        t0=torch.zeros(1))
    lin = dyn_base.linearize(prob.dynamics, spec, op)
    al = pcost.ALState.init(prob.player_costs, spec, 1)
    quad = pcost.quadraticize(prob.player_costs, spec, op, al)
    sol = lq.solve_lq_feedback(spec, lin, quad, torch.ones((1, 2)),
                               adaptive_regularization=False,
                               batch_block=1)
    A = lin.A[0, 0].double().numpy()
    Bs = lin.Bs[0, 0].double().numpy()
    Q = quad.Q[0, 0].double().numpy()
    R = quad.R[0, 0].double().numpy()
    P1, P2 = lyapunov_iterations(A, Bs[0], Bs[1], Q[0], Q[1], R[0, 0],
                                 R[0, 1], R[1, 0], R[1, 1])
    Ps = sol.strategy.Ps[0, 0].numpy()
    assert np.max(np.abs(Ps[0] - P1)) < 1e-4
    assert np.max(np.abs(Ps[1] - P2)) < 1e-4


def test_full_step_converges_in_two_iterations():
    """With full steps the first iteration lands on the Nash equilibrium
    of this exactly LQ game and the second confirms it: every lane
    converges after exactly 2 iterations, in the port and in the JAX
    package (its Pallas kernels in interpret mode), at N=100 on bench_all
    config 1's sigma."""
    prob, jprob = pm.make_problem(), jpm.make_problem()
    rng = np.random.RandomState(0)
    x0 = (np.tile(prob.x0.numpy()[None], (B, 1))
          + 0.5 * _draw(rng, B, 2)).astype(np.float32)
    run = batched.make_host_batched_solver(
        prob.dynamics, prob.player_costs, prob.spec,
        SolverParams(**FULL_STEP), batch_block=B)
    res = run(torch.tensor(x0))
    assert res.converged.all()
    assert res.cumulative_iterations.tolist() == [2] * B
    jrun = jbatched.make_host_batched_solver(
        jprob.dynamics, jprob.player_costs, jprob.spec, JParams(**FULL_STEP),
        batch_block=B, interpret=True)
    jres = jrun(jnp.asarray(x0))
    np.testing.assert_array_equal(np.asarray(jres.cumulative_iterations),
                                  res.cumulative_iterations.numpy())
    np.testing.assert_array_equal(np.asarray(jres.converged),
                                  res.converged.numpy())
    np.testing.assert_allclose(res.total_costs.numpy(),
                               np.asarray(jres.total_costs), rtol=2e-3,
                               atol=2e-3)
    assert torch.isinf(res.max_violation).all() and (res.max_violation < 0).all()
