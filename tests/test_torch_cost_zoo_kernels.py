"""The rest of the cost layer through the kernels' plain versions, on the
two zoo games of chip_smoke.py (the flagship with one of each new piece:
`chip_smoke.zoo_player_costs`, built here from the port's and from the
JAX package's modules with the same parameters), at N=11:

- K1's plain version `lin_quad_plain` on the fused zoo game against the
  JAX package's pure-XLA `linearize_entries` and
  `stage_quadraticize_entries` (its fused stage's per-knot math) at each
  lane's absolute times t0 + k dt, within 1e-5;
- K5's and K6's plain versions (`rollout_merits_plain`, `merit_plain`)
  on both games against the JAX package's merit fold (`_xla_merits`,
  over `stage_gradient_sq_tuple`), within 1e-5 relative;
- three trips of each game on the port, and at each trip's operating
  point and multipliers its stage (fused: K1's plain version; unfused:
  `quadraticize` at relative times) and its candidates' merits against
  the JAX package's, in the per-trip class (2e-3). The JAX package's
  batched trips themselves, with their decisions, are held in
  tests/test_torch_cost_zoo_trips.py (their compiles would pass this
  file's time);
- final_time over a dense atom (semiquadratic_norm, a convex proximity):
  K1's wrapper raises the JAX fused stage's ValueError, the table row is
  gated, and K5's and K6's plain versions equal the JAX merit fold;
- the refusals: the merit kernels' flags and table refuse the unfused
  game's dense-only constraints;
- on the card (`cuda`, skipped here): K1 on the fused game within 1e-5
  of its plain version, K5 and K6 bitwise on both games' atoms.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import chip_smoke
from ilqgames_tpu_torch import bench
from ilqgames_tpu_torch.costs import player_cost as pc
from ilqgames_tpu_torch.ops.cuda import stage, sweep
from ilqgames_tpu_torch.solver import batched
from ilqgames_tpu_torch.solver.al import constraint_violations
from ilqgames_tpu_torch.solver.params import SolverParams

torch.set_num_threads(1)

N, B, C = 11, 4, 2
TRIP_TOL = 2e-3
PARAMS_KW = dict(max_solver_iters=3, unconstrained_solver_max_iters=10,
                 max_backtracking_steps=100, initial_alpha_scaling=0.1,
                 convergence_tolerance=1.0, expected_decrease_fraction=0.001)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's pieces (imported here, not with the module, so
    that the card's tests run where JAX is absent)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from ilqgames_tpu.costs import atoms, constraints, player_cost
    from ilqgames_tpu.dynamics import base
    from ilqgames_tpu.examples import three_player_intersection
    from ilqgames_tpu.ops.pallas import sweep as jsweep
    from ilqgames_tpu.types import OperatingPoint

    class Pieces:  # hashable by identity, for the caches below
        pass

    out = Pieces()
    out.__dict__.update(
        jax=jax, jnp=jnp, atoms=atoms, cons=constraints, pc=player_cost,
        dyn=base, ti=three_player_intersection, sweep=jsweep,
        Op=OperatingPoint)
    return out


@functools.lru_cache(maxsize=None)
def _game(fused):
    """The port's zoo game."""
    return chip_smoke.zoo_problem(fused, N)


@functools.lru_cache(maxsize=None)
def _jax_game(jx, fused):
    """The JAX package's twin of the zoo game."""
    jp = jx.ti.make_problem(num_time_steps=N)
    return dataclasses.replace(jp, player_costs=chip_smoke.zoo_player_costs(
        jp, jx.atoms, jx.cons, fused))


def _games(jx, fused):
    """(the port's zoo game, the JAX package's twin)."""
    return _game(fused), _jax_game(jx, fused)


def _atoms_only(prob):
    """The game without its dense-only constraints (no device form)."""
    return dataclasses.replace(prob, player_costs=tuple(
        dataclasses.replace(p, state_constraints=tuple(
            c for c in p.state_constraints if c.al_quad_pairs_fn is not None))
        for p in prob.player_costs))


def _operands(prob, seed, b=B, device="cpu"):
    """Batch-minor operands from a seed: states near x0, controls, a small
    strategy, multipliers (half of them zero), mu and the lanes' times."""
    spec = prob.spec
    x, P, u = spec.xdim, spec.num_players, spec.umax
    nS = sum(len(p.state_constraints) for p in prob.player_costs)
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    t = lambda a: torch.tensor(np.ascontiguousarray(a, np.float32),
                               device=device)
    xs = prob.x0.numpy()[None, :, None] + np.cumsum(0.3 * f(N, x, b), 0)
    op = {"xs": t(xs), "us": t(0.3 * f(N, P * u, b)),
          "t0": t(rng.rand(1, b))}
    st = {"Ps": t(0.05 * f(N, P * u, x, b)),
          "alphas": t(0.1 * f(N, P * u, b))}
    lam = np.abs(f(N, nS, b)) * (rng.rand(N, nS, b) < 0.5)
    x0m = t(prob.x0.numpy()[:, None] + 0.1 * f(x, b))
    return x0m, op, st, t(lam), t(np.full((1, b), 10.0))


@functools.lru_cache(maxsize=None)
def _jax_stage_fn(jx, jp):
    """The JAX package's fused-stage math (pure XLA) at each lane's
    absolute knot times, as the port's batch-minor LQ operand dict:
    (op_bm, lamS, mu) -> dict, compiled once."""
    spec = jp.spec
    X, P, U = spec.xdim, spec.num_players, spec.umax
    n_sc = [len(p.state_constraints) for p in jp.player_costs]
    off = np.cumsum([0] + n_sc)
    dt = spec.dt

    def knot(t, x, us, lam, m):
        u3 = us.reshape(P, U)
        lamS = tuple(lam[off[i]:off[i + 1]] for i in range(P))
        lamC = tuple(jx.jnp.zeros((0,), jx.jnp.float32) for _ in range(P))
        e = jx.dyn.linearize_entries(jp.dynamics, dt, U, t, x, u3)
        e.update(jx.pc.stage_quadraticize_entries(
            jp.player_costs, spec, lamS, lamC, m, t, x, u3,
            jx.jnp.ones((P,), jx.jnp.float32)))
        zero = jx.jnp.zeros_like(x[0])
        A = jx.jnp.stack([jx.jnp.stack([e.get(("A", r, c), zero)
                                  for c in range(X)]) for r in range(X)])
        Bf = jx.jnp.stack([jx.jnp.stack([e.get(("Bf", r, c), zero)
                                   for c in range(P * U)])
                        for r in range(X)])
        Q = jx.jnp.stack([jx.jnp.stack([jx.jnp.stack([e.get(("Q", i, r, c), zero)
                                             for c in range(X)])
                                  for r in range(X)]) for i in range(P)])
        l = jx.jnp.stack([jx.jnp.stack([e.get(("l", i, r), zero)
                                  for r in range(X)]) for i in range(P)])
        R = jx.jnp.stack([jx.jnp.stack([jx.jnp.stack([jx.jnp.stack(
            [e.get(("R", i, j, a, bb), zero) for bb in range(U)])
            for a in range(U)]) for j in range(P)]) for i in range(P)])
        r_ = jx.jnp.stack([jx.jnp.stack([jx.jnp.stack([e.get(("r", i, j, a), zero)
                                              for a in range(U)])
                                   for j in range(P)]) for i in range(P)])
        return A, Bf, Q.reshape(P * X, X), l.reshape(P * X), \
            R.reshape(P * P * U, U), r_.reshape(P * P * U)

    fn = jx.jax.jit(jx.jax.vmap(jx.jax.vmap(knot, in_axes=(0, -1, -1, -1, 0),
                                   out_axes=-1),
                          in_axes=(0, 0, 0, 0, None), out_axes=0))

    def run(op, lamS, mu):
        t0 = jx.jnp.asarray(op["t0"].numpy())[0]
        ts = t0[None, :] + jx.jnp.arange(N, dtype=jx.jnp.float32)[:, None] * dt
        outs = fn(ts, jx.jnp.asarray(op["xs"].numpy()),
                  jx.jnp.asarray(op["us"].numpy()), jx.jnp.asarray(lamS.numpy()),
                  jx.jnp.asarray(mu.numpy())[0])
        return dict(zip(("A", "Bf", "Qf", "lf", "Rf", "rf"), outs))

    return run


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, equal_nan=True, err_msg=what)


def test_k1_plain_matches_jax_on_the_fused_zoo(jx):
    prob, jp = _games(jx, True)
    _, op, _, lamS, mu = _operands(prob, 1)
    got = stage.lin_quad_plain(prob.dynamics, prob.player_costs, prob.spec,
                               op, lamS, None, mu)
    want = _jax_stage_fn(jx, jp)(op, lamS, mu)
    for k, w in want.items():
        _close(got[k].numpy(), w, 1e-5, k)
    # The gate and the new atoms are live: some knots before and after it.
    t = op["t0"][0][None] + torch.arange(N)[:, None] * prob.spec.dt
    gate = 0.5 * N * prob.spec.dt
    assert bool((t >= gate).any()) and bool((t < gate).any())


@functools.lru_cache(maxsize=None)
def _jax_merits_fn(jx, jp):
    """The JAX package's merit fold (its "xla" merit backend), raw:
    (xs_c, us_c, t0, lamS, mu) -> [C, B], compiled once per shape."""
    def fold(xs, us, t0_, lam, m):
        gate = jx.jnp.ones((N, jp.spec.num_players, xs.shape[-1]), jx.jnp.float32)
        return jx.sweep._xla_merits(jp.player_costs, jp.spec, xs, us, t0_,
                                  lam, None, m, gate)

    fn = jx.jax.jit(fold)
    return lambda *a: np.asarray(fn(*(jx.jnp.asarray(v.numpy()) for v in a)))


@pytest.mark.parametrize("fused", [True, False])
def test_merit_plain_versions_match_jax(jx, fused):
    """K5's and K6's plain versions on each zoo game (the unfused one with
    its dense atoms and dense-only constraints) against the JAX package's
    merit fold on the same candidates."""
    prob, jp = _games(jx, fused)
    dyn, costs, spec = prob.dynamics, prob.player_costs, prob.spec
    x0m, op, st, lamS, mu = _operands(prob, 2)
    scal = torch.tensor([[0.5], [0.25]]).expand(C, B).contiguous()
    m5 = sweep.rollout_merits_plain(dyn, costs, spec, x0m, op, st, scal,
                                    lamS, None, mu)
    xs_c = sweep.rollout_plain(dyn, spec, x0m, op, st, scal)
    us_c = sweep._us_from_xs(spec, xs_c, op, st, scal)
    m6 = sweep.merit_plain(costs, spec, xs_c, us_c, op["t0"], lamS, None, mu)
    assert torch.equal(m5, m6)
    want = _jax_merits_fn(jx, jp)(xs_c, us_c, op["t0"], lamS, mu)
    np.testing.assert_allclose(m6.numpy(), want, rtol=1e-5)


@functools.lru_cache(maxsize=None)
def _jax_quadraticize_fn(jx, jp):
    """The JAX package's unfused quadraticize per lane (relative times):
    (op, al) -> (Q, l, R, r), compiled once."""
    def one(xs, us, sl, m):
        jal = jx.pc.ALState(state_lambdas=tuple(sl), control_lambdas=tuple(
            jx.jnp.zeros((0, N), jx.jnp.float32) for _ in jp.player_costs), mu=m)
        q = jx.pc.quadraticize(jp.player_costs, jp.spec,
                             jx.Op(xs=xs, us=us, t0=jx.jnp.zeros(())), jal,
                             jx.jnp.zeros((jp.spec.num_players,), jx.jnp.int32))
        return q.Q, q.l, q.R, q.r

    fn = jx.jax.jit(jx.jax.vmap(one))
    return lambda op, al: fn(
        jx.jnp.asarray(op.xs.numpy()), jx.jnp.asarray(op.us.numpy()),
        [jx.jnp.asarray(s.numpy()) for s in al.state_lambdas],
        jx.jnp.asarray(al.mu.numpy()))


@pytest.mark.parametrize("fused", [True, False])
def test_trips_hold_each_stage_against_jax(jx, fused):
    """Three trips of each zoo game on the port (B=4 lanes of bench.py's
    draw, from the fresh carry); at each trip's operating point and AL
    state, the stage it quadraticizes and its candidates' merits against
    the JAX package's, in the per-trip class."""
    prob, jp = _games(jx, fused)
    dyn, costs, spec = prob.dynamics, prob.player_costs, prob.spec
    x0 = torch.tensor(bench.perturbed_x0(prob, B))
    params = SolverParams(**PARAMS_KW)
    fc = batched._fresh_init(dyn, costs, spec, None, None, B, fused)(x0)
    trip, _ = batched._driver_parts(dyn, costs, spec, params, B, fused)
    jstage = (_jax_stage_fn(jx, jp) if fused
              else _jax_quadraticize_fn(jx, jp))
    jmerits = _jax_merits_fn(jx, jp)
    for i in range(3):
        fc = trip(x0, fc)
        assert not bool(torch.isnan(fc.c.last_merit).any()), i
        op, al = fc.c.op, fc.al
        al1, _ = constraint_violations(costs, spec, op, al)
        lamS = torch.cat(al1.state_lambdas, dim=1).permute(2, 1, 0)
        mu = al1.mu[None].contiguous()
        op_bm, x0m = sweep._prep_op(spec, x0, op, B)
        lamS = lamS.contiguous()
        if fused:
            got = stage.lin_quad_plain(dyn, costs, spec, op_bm, lamS, None,
                                       mu)
            want = jstage(op_bm, lamS, mu)
            for k, w in want.items():
                _close(got[k].numpy(), w, TRIP_TOL, f"trip {i} {k}")
        else:
            q = pc.quadraticize(costs, spec, op, al1)
            for k, got, w in zip("QlRr", (q.Q, q.l, q.R, q.r),
                                 jstage(op, al1)):
                _close(got.numpy(), w, TRIP_TOL, f"trip {i} {k}")
        st = {"Ps": torch.zeros((N, spec.num_players * spec.umax, spec.xdim,
                                 B)),
              "alphas": torch.zeros((N, spec.num_players * spec.umax, B))}
        xs_c = op_bm["xs"][:, :, None].contiguous()
        us_c = sweep._us_from_xs(spec, xs_c, op_bm, st,
                                 torch.zeros((1, B)))
        m = sweep.merit_plain(costs, spec, xs_c, us_c, op_bm["t0"], lamS,
                              None, mu)
        np.testing.assert_allclose(
            m.numpy(), jmerits(xs_c, us_c, op_bm["t0"], lamS, mu),
            rtol=TRIP_TOL)


def _gated_dense_game(A, PC, prob, inner):
    """The flagship's dynamics with small costs: P1 a final-time gate over
    half the horizon on a dense atom (`inner`) between P1 and P2, each
    player a quadratic on its speed and its controls."""
    gate = 0.5 * N * prob.spec.dt
    dense = {"semiquadratic_norm": lambda: A.semiquadratic_norm(
                 0.5, 0, 1, 40.0, False),
             "locally_convex_proximity": lambda: A.locally_convex_proximity(
                 0.5, (0, 1), (6, 7), 80.0)}[inner]()
    costs = [PC(state_costs=(A.quadratic(0.1, d, 5.0),),
                control_costs=((i, A.quadratic(1.0, None)),))
             for i, d in enumerate((4, 10, 15))]
    costs[0] = dataclasses.replace(costs[0], state_costs=costs[0].state_costs
                                   + (A.final_time(dense, gate),))
    return dataclasses.replace(prob, player_costs=tuple(costs))


@pytest.mark.parametrize("inner", ["semiquadratic_norm",
                                   "locally_convex_proximity"])
def test_final_time_over_a_dense_atom_in_k1_and_the_merits(jx, inner):
    """final_time over an atom with only a dense form: K1's wrapper raises
    the JAX fused stage's ValueError (no pairs: the JAX package's gated
    quad_fn); the table row is the inner atom's with the gate, and K5's
    and K6's plain versions equal the JAX package's merit fold."""
    from ilqgames_tpu_torch.costs import atoms
    from ilqgames_tpu_torch.ops.cuda import cost_table as ct

    base = chip_smoke.zoo_problem(True, N)
    prob = _gated_dense_game(atoms, pc.PlayerCost, base, inner)
    jbase = jx.ti.make_problem(num_time_steps=N)
    jp = _gated_dense_game(jx.atoms, jx.pc.PlayerCost, jbase, inner)
    dyn, costs, spec = prob.dynamics, prob.player_costs, prob.spec
    x0m, op, st, lamS, mu = _operands(prob, 5)
    with pytest.raises(ValueError, match="has no sparse quad_pairs"):
        stage.lin_quad(dyn, costs, spec, op, lamS, None, mu)
    assert ct.has_dense(costs)
    tab, _ = ct._build(costs, spec)
    row = next(tab.atom[n] for n in range(tab.n)
               if tab.atom[n].kind == ct.KIND[inner])
    assert (row.gated, row.tgate) == (1, np.float32(0.5 * N * spec.dt))
    scal = torch.tensor([[0.5], [0.25]]).expand(C, B).contiguous()
    m5 = sweep.rollout_merits_plain(dyn, costs, spec, x0m, op, st, scal,
                                    lamS, None, mu)
    xs_c = sweep.rollout_plain(dyn, spec, x0m, op, st, scal)
    us_c = sweep._us_from_xs(spec, xs_c, op, st, scal)
    m6 = sweep.merit_plain(costs, spec, xs_c, us_c, op["t0"], lamS, None, mu)
    assert torch.equal(m5, m6)
    want = _jax_merits_fn(jx, jp)(xs_c, us_c, op["t0"], lamS, mu)
    np.testing.assert_allclose(m6.numpy(), want, rtol=1e-5)


def test_dense_only_constraints_are_refused_by_the_merit_kernels():
    prob = _game(False)
    costs, spec = prob.player_costs, prob.spec
    with pytest.raises(NotImplementedError):
        sweep.merit_features(costs, spec)
    with pytest.raises(ValueError, match="has no sparse quad"):
        pc.check_sparse(costs)
    libs = bench.kernel_libraries(prob.dynamics, spec, costs)
    assert [name for name, _ in libs] == ["lq", "sweep"]
    atoms = _atoms_only(prob)
    mf = sweep.merit_features(atoms.player_costs, spec)
    assert mf["zoo"] and mf["norms"]
    fused = _game(True)
    feats = stage.features(fused.dynamics, fused.player_costs, spec)
    assert feats["zoo"]


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")


def _same_bits(a, b):
    a, b = a.cpu(), b.cpu()
    nan = torch.isnan(b)
    assert torch.equal(torch.isnan(a), nan)
    assert torch.equal(a.view(torch.int32)[~nan], b.view(torch.int32)[~nan])


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False])
def test_zoo_kernels_on_card(fused):
    """K1 (the fused game) within 1e-5 of its plain version, K5 and K6
    bitwise on the game's atoms, and K5 == K4 + K6; the unfused game's
    dense-only constraints refused by K5 and K6."""
    _needs_card()
    prob = _game(fused)
    if not fused:
        full = prob
        x0m, op, st, lamS, mu = _operands(full, 3, 37, "cuda")
        scal = torch.full((C, 37), 0.5, device="cuda")
        with pytest.raises(NotImplementedError):
            sweep.rollout_merits(full.dynamics, full.player_costs,
                                 full.spec, x0m, op, st, scal, lamS, None,
                                 mu)
        prob = _atoms_only(prob)
    dyn, costs, spec = prob.dynamics, prob.player_costs, prob.spec
    bench.build_kernels(dyn, spec, costs)
    x0m, op, st, lamS, mu = _operands(prob, 3, 37, "cuda")
    if fused:
        got = stage.lin_quad(dyn, costs, spec, op, lamS, None, mu)
        want = stage.lin_quad_plain(dyn, costs, spec, op, lamS, None, mu)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=1e-5,
                                       atol=1e-5, equal_nan=True)
    scal = torch.full((C, 37), 0.5, device="cuda")
    m5 = sweep.rollout_merits(dyn, costs, spec, x0m, op, st, scal, lamS,
                              None, mu)
    _same_bits(m5, sweep.rollout_merits_plain(dyn, costs, spec, x0m, op, st,
                                              scal, lamS, None, mu))
    xs = sweep.rollout_bm(dyn, spec, x0m, op, st, scal)
    us_c = sweep._us_from_xs(spec, xs, op, st, scal)
    m6 = sweep.consumer_merits(costs, spec, xs, us_c, op["t0"], lamS, None,
                               mu)
    _same_bits(m6, sweep.merit_plain(costs, spec, xs, us_c, op["t0"], lamS,
                                     None, mu))
    _same_bits(m5, m6)
