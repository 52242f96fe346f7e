"""Open-loop Nash in the port against the JAX package:

- `lq_open_loop_plain` through `solve_lq_open_loop` (the plain version of
  K7, which the CPU takes) against the JAX package's `solve_lq_open_loop`
  (XLA, vmapped): on random well-conditioned operands with padded controls
  (udims (2, 1, 2)) for three seeds and on dubins_origin's own
  linearization and quadraticization, alphas and δxs within rtol 1e-4 and
  atol 1e-5 (the LUs' pivoted eliminations against LAPACK's: float-level
  differences), Ps == 0 and the terminal rows zero exactly;
- K7's cache stride (`cache_floats`) is whole 16-byte copies;
- `fuse_stages=True` with open loop raises ValueError, as the JAX package's
  batched machine does, and the drivers resolve open loop to unfused
  stages;
- whole solves of dubins_origin at N=11, B=4 in both information patterns
  (open loop unfused, feedback fused) against the JAX package's batched
  machine (its Pallas kernels in interpret mode): converged and iterations
  exactly equal, trajectories within 1e-5; a lane may end on another
  step of the last iteration's linesearch only where the two final
  trajectories' merits are within KNIFE_ULPS of each other (a decision on
  the last bits of a ~4e5 merit), and its trajectory is then held at the
  per-trip class;
- the setting of tests/test_batched_pallas.py::test_open_loop_batched_parity
  (N=10, three lanes, the vmapped per-instance machine as the reference);
- two open-loop AL trips of the flagship at N=11, B=4 from the JAX
  machine's carry: decisions equal, arrays within the per-trip class;
- the ported `numerical_check_local_nash` on the reference's LQ test game
  (tests/test_lq_solver.py:134-166): the open-loop solution is a local
  open-loop Nash equilibrium and the feedback one is not, but is a
  closed-loop one.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ilqgames_tpu import types as jtypes  # noqa: E402
from ilqgames_tpu.costs import player_cost as jpc  # noqa: E402
from ilqgames_tpu.examples import dubins_origin as jdo  # noqa: E402
from ilqgames_tpu.examples import three_player_intersection as jfl  # noqa: E402
from ilqgames_tpu.solver import batched as jbatched  # noqa: E402
from ilqgames_tpu.solver import fused as jfused  # noqa: E402
from ilqgames_tpu.solver.lq_open_loop import \
    solve_lq_open_loop as jsolve_ol  # noqa: E402
from ilqgames_tpu.solver.params import SolverParams as JParams  # noqa: E402

from ilqgames_tpu_torch import convert  # noqa: E402
from ilqgames_tpu_torch.costs import atoms  # noqa: E402
from ilqgames_tpu_torch.costs import player_cost as pcost  # noqa: E402
from ilqgames_tpu_torch.dynamics import base as dyn_base  # noqa: E402
from ilqgames_tpu_torch.examples import dubins_origin as do  # noqa: E402
from ilqgames_tpu_torch.examples import three_player_intersection as fl  # noqa: E402
from ilqgames_tpu_torch.examples import two_player_point_mass as pm  # noqa: E402
from ilqgames_tpu_torch.ops.cuda import lq, lq_open_loop, sweep  # noqa: E402
from ilqgames_tpu_torch.solver import batched  # noqa: E402
from ilqgames_tpu_torch.solver.lq_open_loop import solve_lq_open_loop  # noqa: E402
from ilqgames_tpu_torch.solver.params import SolverParams  # noqa: E402
from ilqgames_tpu_torch.types import GameSpec, LinearDynamics, \
    OperatingPoint, QuadraticCosts, Strategy  # noqa: E402
from ilqgames_tpu_torch.utils.check_nash import \
    numerical_check_local_nash  # noqa: E402

torch.set_num_threads(1)

N, B = 11, 4
RTOL, ATOL = 1e-4, 1e-5      # the open-loop LQ solve against XLA's
XS_TOL = 1e-5                # whole solves' trajectories
TRIP_TOL = 2e-3              # per-trip arrays, test_batched_pallas.py:119
KNIFE_ULPS = 2               # a merit step this small decides on last bits
EXEC_KW = dict(max_solver_iters=100, unconstrained_solver_max_iters=10,
               max_backtracking_steps=100, initial_alpha_scaling=0.1,
               convergence_tolerance=1.0, expected_decrease_fraction=0.001)


def _jax_solve(spec_args, A, Bs, Q, l, R, r, dx0):
    jspec = jtypes.GameSpec(**spec_args)
    return jax.vmap(lambda a, b, q, ll, rr, rv, d: jsolve_ol(
        jspec, jtypes.LinearDynamics(A=a, Bs=b),
        jtypes.QuadraticCosts(Q=q, l=ll, R=rr, r=rv), d))(
            A, Bs, Q, l, R, r, dx0)


def _port_solve(spec_args, A, Bs, Q, l, R, r, dx0, batch_block=2):
    t = torch.tensor
    return solve_lq_open_loop(
        GameSpec(**spec_args), LinearDynamics(A=t(A), Bs=t(Bs)),
        QuadraticCosts(Q=t(Q), l=t(l), R=t(R), r=t(r)), t(dx0),
        batch_block=batch_block)


def _check_solution(sol, jsol, P, u):
    for name, got, want in (("alphas", sol.strategy.alphas,
                             jsol.strategy.alphas),
                            ("delta_xs", sol.delta_xs, jsol.delta_xs)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    assert torch.equal(sol.strategy.Ps, torch.zeros_like(sol.strategy.Ps))
    assert tuple(sol.strategy.Ps.shape[2:4]) == (P, u)
    assert torch.equal(sol.strategy.alphas[:, -1],
                       torch.zeros_like(sol.strategy.alphas[:, -1]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_open_loop_lq_matches_jax(seed):
    """Random time-varying operands of three players with udims (2, 1, 2)
    (player 2's second control padded: zero B column, R and r rows), SPD
    state and own control costs, cross control costs, at N=11, 3 lanes."""
    spec_args = dict(xdims=(2, 3, 2), udims=(2, 1, 2), dt=0.1,
                     num_time_steps=N)
    P, x, u, Bt = 3, 7, 2, 3
    rng = np.random.RandomState(seed)
    mask = np.asarray(jtypes.GameSpec(**spec_args).u_mask())

    def spd(n, *lead):
        G = rng.randn(*lead, n, n)
        return (G @ np.swapaxes(G, -1, -2) / n + np.eye(n)).astype(
            np.float32)

    A = (np.eye(x)[None, None] + 0.1 * rng.randn(Bt, N, x, x)).astype(
        np.float32)
    Bs = (0.1 * rng.randn(Bt, N, P, x, u)).astype(np.float32) * mask[
        None, None, :, None, :]
    Q = spd(x, Bt, N, P)
    l = rng.randn(Bt, N, P, x).astype(np.float32)
    R = (0.1 * rng.randn(Bt, N, P, P, u, u)).astype(np.float32)
    R = R * mask[None, None, None, :, :, None] * mask[None, None, None, :,
                                                      None, :]
    for i in range(P):
        R[:, :, i, i] = spd(u, Bt, N) * (mask[i][:, None] * mask[i][None])
    r = rng.randn(Bt, N, P, P, u).astype(np.float32) * mask[None, None,
                                                            None]
    dx0 = rng.randn(Bt, x).astype(np.float32)
    args = (A, Bs, Q, l, R, r, dx0)
    _check_solution(_port_solve(spec_args, *args),
                    _jax_solve(spec_args, *args), P, u)


def _dubins_stage(Bt=3):
    """dubins_origin's linearization and quadraticization at its first
    rollout from x0 draws (sigma 0.1) under a small random strategy, in
    both packages' containers (the port's made from the same numpy
    arrays)."""
    prob = do.make_problem(num_time_steps=N)
    spec = prob.spec
    rng = np.random.RandomState(7)
    x0 = (np.tile(prob.x0.numpy()[None], (Bt, 1))
          + 0.1 * rng.randn(Bt, spec.xdim)).astype(np.float32)
    op0 = OperatingPoint.zeros(spec)
    bc = lambda a: a[None].expand((Bt,) + a.shape).contiguous()
    wop = OperatingPoint(xs=bc(op0.xs), us=bc(op0.us), t0=bc(op0.t0))
    st = Strategy.zeros(spec)
    wst = st.replace(Ps=bc(st.Ps), alphas=torch.tensor(
        0.3 * rng.randn(Bt, N, 2, 1).astype(np.float32)))
    op = dyn_base.rollout(prob.dynamics, spec, torch.tensor(x0), wop, wst)
    lin = dyn_base.linearize(prob.dynamics, spec, op)
    al = pcost.ALState.init(prob.player_costs, spec, Bt)
    quad = pcost.quadraticize(prob.player_costs, spec, op, al)
    dx0 = (0.05 * rng.randn(Bt, spec.xdim)).astype(np.float32)
    n = lambda a: a.numpy()
    return (dict(xdims=spec.xdims, udims=spec.udims, dt=spec.dt,
                 num_time_steps=N),
            (n(lin.A), n(lin.Bs), n(quad.Q), n(quad.l), n(quad.R),
             n(quad.r), dx0))


def test_open_loop_lq_on_dubins_origin_matches_jax():
    spec_args, args = _dubins_stage()
    _check_solution(_port_solve(spec_args, *args, batch_block=4),
                    _jax_solve(spec_args, *args), 2, 1)


def test_k7_cache_stride_is_whole_16_byte_copies():
    """K7's per-knot, per-lane cache stride (`cache_floats`, the kernel's
    FS) is the cache's floats padded to a multiple of 4: the forward pass
    copies a lane's cache in 16-byte pieces. dubins_origin's 140 floats
    need no pad; the flagship's 1,190 take 1,192."""
    for prob, floats in ((do.make_problem(), 140), (fl.make_problem(), 1190)):
        spec = prob.spec
        P, x, u = spec.num_players, spec.xdim, spec.umax
        assert P * u * (x + 1) + x * (x + 1) + P * x * x + P * x == floats
        stride = lq_open_loop.cache_floats(spec)
        assert stride % 4 == 0 and 0 <= stride - floats < 4
    assert lq_open_loop.cache_floats(fl.make_problem().spec) == 1192


def test_fuse_stages_with_open_loop_raises():
    """`iteration_step_batched(fuse_stages=True)` refuses open loop with the
    JAX package's ValueError; the drivers' default resolves it unfused."""
    prob = do.make_problem(num_time_steps=N)
    params = SolverParams(open_loop=True, **EXEC_KW)
    fc = batched._fresh_init(prob.dynamics, prob.player_costs, prob.spec,
                             None, None, 2, False)(prob.x0[None])
    with pytest.raises(ValueError, match="feedback LQ only"):
        batched.iteration_step_batched(
            prob.dynamics, prob.player_costs, prob.spec, params,
            prob.x0[None], fc.al, fc.c, fuse_stages=True)
    assert not batched._resolve_fuse_for(params, None, prob.dynamics)
    assert not batched._resolve_fuse_for(params, True, prob.dynamics)
    fb = dataclasses.replace(params, open_loop=False)
    assert batched._resolve_fuse_for(fb, None, prob.dynamics)


def _x0(prob, sigma=0.1, n=B, seed=0):
    rng = np.random.RandomState(seed)
    return (np.tile(prob.x0.numpy()[None], (n, 1))
            + sigma * rng.randn(n, prob.spec.xdim)).astype(np.float32)


@pytest.fixture(scope="module")
def dubins_solves():
    """pattern -> (port result, JAX result) of dubins_origin at N=11, B=4
    with the exec main's parameters, each solved once for this module."""
    cache = {}

    def get(open_loop):
        if open_loop not in cache:
            prob = do.make_problem(num_time_steps=N)
            jprob = jdo.make_problem(num_time_steps=N)
            x0 = _x0(prob)
            res = batched.make_host_batched_solver(
                prob.dynamics, prob.player_costs, prob.spec,
                SolverParams(open_loop=open_loop, **EXEC_KW),
                warm_op=prob.initial_operating_point(),
                warm_strategy=prob.initial_strategy(), trips_per_call=20,
                batch_block=B)(torch.tensor(x0))
            jres = jbatched.make_host_batched_solver(
                jprob.dynamics, jprob.player_costs, jprob.spec,
                JParams(open_loop=open_loop, **EXEC_KW),
                warm_op=jprob.initial_operating_point(),
                warm_strategy=jprob.initial_strategy(), trips_per_call=20,
                batch_block=B, interpret=True, fuse_stages=not open_loop)(
                    jnp.asarray(x0))
            cache[open_loop] = (prob, res, jres)
        return cache[open_loop]

    return get


def _final_merits(prob, op):
    """The port's plain merits [B] of a result's trajectories (either
    package's), as the linesearch computes a candidate's."""
    spec = prob.spec
    xs = torch.tensor(np.asarray(op.xs))
    us = torch.tensor(np.asarray(op.us))
    Bn = xs.shape[0]
    al = pcost.ALState.init(prob.player_costs, spec, Bn)
    return sweep.merit_plain(
        prob.player_costs, spec, xs.permute(1, 2, 0)[:, :, None],
        us.reshape(Bn, N, -1).permute(1, 2, 0)[:, :, None],
        torch.zeros(1, Bn), None, None, al.mu[None])[0].numpy()


@pytest.mark.parametrize("open_loop", [True, False])
def test_dubins_origin_solves_match_jax(dubins_solves, open_loop):
    prob, res, jres = dubins_solves(open_loop)
    np.testing.assert_array_equal(res.converged.numpy(),
                                  np.asarray(jres.converged))
    np.testing.assert_array_equal(res.cumulative_iterations.numpy(),
                                  np.asarray(jres.cumulative_iterations))
    xs, jxs = res.op.xs.numpy(), np.asarray(jres.op.xs)
    close = np.isclose(xs, jxs, rtol=XS_TOL, atol=XS_TOL).all(axis=(1, 2))
    if not close.all():
        m, jm = _final_merits(prob, res.op), _final_merits(prob, jres.op)
        gap = np.abs(m - jm) / np.spacing(np.abs(jm))
        assert (gap[~close] <= KNIFE_ULPS).all(), (close, gap)
        np.testing.assert_allclose(xs, jxs, rtol=TRIP_TOL, atol=TRIP_TOL)
    if open_loop:
        assert torch.equal(res.strategy.Ps,
                           torch.zeros_like(res.strategy.Ps))
    else:
        assert float(res.strategy.Ps.abs().max()) > 0.0


def test_open_loop_batched_parity_setting():
    """tests/test_batched_pallas.py::test_open_loop_batched_parity's
    setting on the port: dubins_origin at N=10, three lanes drawn with
    sigma 0.05 from RandomState(5), 8 iterations of at most 10
    backtracking steps from alpha 0.5, against the JAX package's vmapped
    per-instance machine (`fused.make_host_batched_solver`)."""
    prob = do.make_problem(num_time_steps=10)
    jprob = jdo.make_problem(num_time_steps=10)
    kw = dict(max_solver_iters=8, max_backtracking_steps=10,
              initial_alpha_scaling=0.5, convergence_tolerance=1.0,
              expected_decrease_fraction=0.001, open_loop=True)
    rng = np.random.RandomState(5)
    Bt = 3
    x0 = (np.tile(prob.x0.numpy()[None], (Bt, 1))
          + 0.05 * rng.randn(Bt, prob.spec.xdim)).astype(np.float32)
    jres = jfused.make_host_batched_solver(
        jprob.dynamics, jprob.player_costs, jprob.spec, JParams(**kw),
        trips_per_call=8)(jnp.asarray(x0))
    res = batched.make_host_batched_solver(
        prob.dynamics, prob.player_costs, prob.spec, SolverParams(**kw),
        trips_per_call=8, batch_block=3)(torch.tensor(x0))
    np.testing.assert_array_equal(res.converged.numpy(),
                                  np.asarray(jres.converged))
    np.testing.assert_array_equal(res.cumulative_iterations.numpy(),
                                  np.asarray(jres.cumulative_iterations))
    np.testing.assert_allclose(res.op.xs.numpy(), np.asarray(jres.op.xs),
                               rtol=XS_TOL, atol=XS_TOL)
    assert float(res.strategy.Ps.abs().max()) == 0.0


def test_flagship_open_loop_trips_from_the_jax_carry():
    """Two open-loop AL trips (`_trip_batched`, unfused) of the flagship at
    N=11, B=4 from the JAX machine's carry before each: failed, converged,
    done and AL mu exactly equal, merits, trajectories and the carried
    quadraticization within the per-trip class, Ps == 0."""
    prob, jprob = fl.make_problem(num_time_steps=N), jfl.make_problem(
        num_time_steps=N)
    kw = dict(EXEC_KW, max_solver_iters=12, unconstrained_solver_max_iters=5,
              max_backtracking_steps=20)
    x0 = _x0(prob)
    steps, _, constrained = jbatched._driver_parts(
        jprob.dynamics, jprob.player_costs, jprob.spec,
        JParams(open_loop=True, **kw), 1, 2, True, fuse_stages=False)
    assert constrained
    steps = jax.jit(steps)
    trip, _ = batched._driver_parts(prob.dynamics, prob.player_costs,
                                    prob.spec,
                                    SolverParams(open_loop=True, **kw), 2,
                                    False)
    spec = jprob.spec
    bc = lambda t: jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a[None], (B,) + a.shape), t)
    al0 = jax.vmap(lambda _: jpc.ALState.init(jprob.player_costs, spec))(
        jnp.arange(B))
    fcj = jbatched._carry0(jprob.dynamics, jprob.player_costs, spec,
                           jnp.asarray(x0), bc(jtypes.OperatingPoint.zeros(
                               spec)), bc(jtypes.Strategy.zeros(spec)), al0,
                           2, True, fuse_stages=False)
    for i in range(2):
        fc = convert.from_fused_carry(fcj)
        fcj = steps(jnp.asarray(x0), fcj)
        fc = trip(torch.tensor(x0), fc)
        for name, got, want in (("failed", fc.c.failed, fcj.c.failed),
                                ("converged", fc.c.converged,
                                 fcj.c.converged),
                                ("done", fc.done, fcj.done),
                                ("AL mu", fc.al.mu, fcj.al.mu)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f"trip {i}: {name}")
        np.testing.assert_allclose(fc.c.last_merit.numpy(),
                                   np.asarray(fcj.c.last_merit),
                                   rtol=TRIP_TOL, atol=TRIP_TOL)
        np.testing.assert_allclose(fc.c.op.xs.numpy(),
                                   np.asarray(fcj.c.op.xs), rtol=TRIP_TOL,
                                   atol=TRIP_TOL)
        for name in ("Q", "l", "R", "r"):
            np.testing.assert_allclose(
                getattr(fc.c.quad, name).numpy(),
                np.asarray(getattr(fcj.c.quad, name)), rtol=TRIP_TOL,
                atol=TRIP_TOL, err_msg=f"trip {i}: quad {name}")
        assert float(fc.c.strategy.Ps.abs().max()) == 0.0


def _lq_game(nominal):
    """The reference's LQ test game (tests/test_lq_solver.py:27-96): the
    two-player 1D point mass, every cost a quadratic over all dims about
    `nominal`, quadraticized at the zero operating point, N=100, x0 = 1;
    its feedback and open-loop solutions."""
    scale = 0.1
    q = lambda w: atoms.quadratic(w, None, nominal)
    costs = (pcost.PlayerCost(state_costs=(q(1.0),),
                              control_costs=((0, q(1.0)), (1, q(scale)))),
             pcost.PlayerCost(state_costs=(q(scale),),
                              control_costs=((0, q(scale)), (1, q(1.0)))))
    prob = pm.make_problem(dt=0.1, num_time_steps=100)
    dyn, spec = prob.dynamics, prob.spec
    op = OperatingPoint.zeros(spec)
    one = lambda a: a[None]
    op1 = OperatingPoint(xs=one(op.xs), us=one(op.us), t0=one(op.t0))
    lin = dyn_base.linearize(dyn, spec, op1)
    quad = pcost.quadraticize(costs, spec, op1,
                              pcost.ALState.init(costs, spec, 1))
    x0 = torch.ones((1, 2))
    fb = lq.solve_lq_feedback(spec, lin, quad, x0,
                              adaptive_regularization=False, batch_block=1)
    ol = solve_lq_open_loop(spec, lin, quad, x0, batch_block=1)
    first = lambda s: s.replace(Ps=s.Ps[0], alphas=s.alphas[0])
    return dyn, spec, costs, op, x0[0], first(fb.strategy), first(
        ol.strategy)


def test_open_loop_solution_is_open_loop_nash():
    dyn, spec, costs, op, x0, _, ol = _lq_game(0.5)
    assert numerical_check_local_nash(dyn, costs, spec, ol, op, x0, 0.1,
                                      open_loop=True)


def test_feedback_solution_is_closed_loop_nash_not_open_loop():
    dyn, spec, costs, op, x0, fb, _ = _lq_game(0.0)
    assert numerical_check_local_nash(dyn, costs, spec, fb, op, x0, 0.1,
                                      open_loop=False)
    assert not numerical_check_local_nash(dyn, costs, spec, fb, op, x0, 0.1,
                                          open_loop=True)
