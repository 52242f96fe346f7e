"""The port's per-instance entry points (`ilqgames_tpu_torch/problem.py`:
Problem.solve, solve_unconstrained, solve_logged, is_constrained) and its
SolverLog (`utils/solver_log.py`) against the JAX package's on the CPU.

Two games: `skeleton` at N=20 with tests/test_utils.py's parameters (one
player, unconstrained: every entry point is one iLQ run there), and the
flagship three-player intersection at N=11 with
tests/test_torch_receding_horizon.py's budgets, whose one JAX solve here
is solve_logged (the bare iLQ run with its record; the flagship's AL
solve through Problem.solve is held by tests/test_torch_cli.py, through
the CLI). The port runs each instance as a batch of one on the batched
machine (one lane in a block of 8); these games have no MAX or MIN
player, so the JAX package's per-instance result is its own.

Classes (ROADMAP Queue 3): decisions (converged, failed, iteration
counts, the log's converged flags) exactly equal; arrays within the
per-trip class, 2e-3 (tests/test_batched_pallas.py:119-140); the saved
text files of both logs hold the same files with the same values within
that class, t0 and the runtimes exactly.
"""

import os

import numpy as np
import pytest
import torch

import ilqgames_tpu.examples as jexamples
from ilqgames_tpu.solver.params import SolverParams as JParams
import ilqgames_tpu_torch.examples as examples
from ilqgames_tpu_torch.solver.params import SolverParams

torch.set_num_threads(1)

TRIP_TOL = 2e-3
# tests/test_utils.py's parameters (skeleton at N=20).
SKELETON_KW = dict(max_solver_iters=5, max_backtracking_steps=10,
                   initial_alpha_scaling=0.5, convergence_tolerance=0.1,
                   expected_decrease_fraction=0.1)
# tests/test_torch_receding_horizon.py's budgets (the flagship at N=11).
FLAGSHIP_KW = dict(max_solver_iters=12, unconstrained_solver_max_iters=5,
                   max_backtracking_steps=20, initial_alpha_scaling=0.1,
                   convergence_tolerance=1.0,
                   expected_decrease_fraction=0.001)
GAMES = {"skeleton": (20, SKELETON_KW),
         "three_player_intersection": (11, FLAGSHIP_KW)}
# The bare runs' budgets (solve_unconstrained's and solve_logged's
# max_iterations): the skeleton's whole budget, four flagship iterations
# (about a second each for the port's plain versions on one thread).
BARE_ITERS = {"skeleton": None, "three_player_intersection": 4}


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=TRIP_TOL, atol=TRIP_TOL, err_msg=what)


@pytest.fixture(scope="module")
def runs():
    """Per game, the port's entry points on the CPU and the JAX package's:
    solve (the skeleton's only), solve_unconstrained and solve_logged,
    the bare runs with a budget of BARE_ITERS[game]. The JAX package's
    solve_logged is its one bare run here: its ILQResult is
    solve_unconstrained's (the same ilq.solve iterations, recorded)."""
    out = {}
    for name, (n, kw) in GAMES.items():
        prob = examples.get(name)(num_time_steps=n)
        jprob = jexamples.get(name)(num_time_steps=n)
        p, jp = SolverParams(**kw), JParams(**kw)
        bare = dict(max_iterations=BARE_ITERS[name])
        port = {"unconstrained": prob.solve_unconstrained(p, device="cpu",
                                                          **bare),
                "logged": prob.solve_logged(p, device="cpu", **bare)}
        jres, jlog = jprob.solve_logged(jp, **bare)
        jax_ = {"logged": (jres, jlog), "unconstrained": jres}
        if name == "skeleton":
            port["solve"] = prob.solve(p, device="cpu")
            jax_["solve"] = jprob.solve(jp)
        out[name] = (prob, jprob, port, jax_)
    return out


def test_solve_matches_jax(runs):
    _, _, port, jax_ = runs["skeleton"]
    res, jres = port["solve"], jax_["solve"]
    assert bool(res.converged) == bool(jres.converged)
    assert int(res.cumulative_iterations) == int(jres.cumulative_iterations)
    assert float(res.max_violation) == float(jres.max_violation) == -np.inf
    _close(res.total_costs, jres.total_costs, "total_costs")
    _close(res.op.xs, jres.op.xs, "xs")
    _close(res.op.us, jres.op.us, "us")


@pytest.mark.parametrize("game", sorted(GAMES))
@pytest.mark.parametrize("entry", ["unconstrained", "logged"])
def test_bare_solve_matches_jax(runs, game, entry):
    """solve_unconstrained's and solve_logged's ILQResult: the iLQ run
    with the constraints' AL terms at the initial multipliers, never
    updated (the flagship's six constraints), with BARE_ITERS."""
    _, _, port, jax_ = runs[game]
    res = port[entry][0] if entry == "logged" else port[entry]
    jres = jax_["unconstrained"]
    for name in ("converged", "failed", "num_iterations"):
        assert np.asarray(getattr(res, name)).item() == \
            np.asarray(getattr(jres, name)).item(), name
    for name in ("total_costs", "merit"):
        _close(getattr(res, name), getattr(jres, name), name)
    _close(res.op.xs, jres.op.xs, "xs")
    _close(res.strategy.alphas, jres.strategy.alphas, "alphas")


@pytest.mark.parametrize("game", sorted(GAMES))
def test_log_matches_jax(runs, game):
    """The log's iterates (the initial rollout, then one per iteration),
    their states, controls, costs and converged flags; its last iterate is
    the result's, bitwise."""
    _, _, port, jax_ = runs[game]
    res, log = port["logged"]
    _, jlog = jax_["logged"]
    assert log.num_iterates == jlog.num_iterates
    assert log.was_converged == jlog.was_converged
    for i in range(log.num_iterates):
        _close(log.operating_points[i].xs, jlog.operating_points[i].xs,
               f"xs of iterate {i}")
        _close(log.operating_points[i].us, jlog.operating_points[i].us,
               f"us of iterate {i}")
        _close(log.total_costs[i], jlog.total_costs[i],
               f"costs of iterate {i}")
        _close(log.strategies[i].alphas, jlog.strategies[i].alphas,
               f"alphas of iterate {i}")
    assert np.array_equal(log.final_operating_point.xs, res.op.xs.numpy())
    assert isinstance(log.final_operating_point.xs, np.ndarray)


@pytest.mark.parametrize("game", sorted(GAMES))
def test_log_save_matches_jax(runs, game, tmp_path):
    """`save` writes the JAX log's files in the reference's layout, with
    its values."""
    _, _, port, jax_ = runs[game]
    base = port["logged"][1].save("exp", log_dir=str(tmp_path / "port"))
    jbase = jax_["logged"][1].save("exp", log_dir=str(tmp_path / "jax"))
    files = sorted(os.path.relpath(os.path.join(d, f), base)
                   for d, _, fs in os.walk(base) for f in fs)
    jfiles = sorted(os.path.relpath(os.path.join(d, f), jbase)
                    for d, _, fs in os.walk(jbase) for f in fs)
    assert files == jfiles and files
    for f in files:
        got = np.loadtxt(os.path.join(base, f))
        want = np.loadtxt(os.path.join(jbase, f))
        assert got.shape == want.shape, f
        if f.endswith(("t0.txt", "cumulative_runtimes.txt")):
            assert np.array_equal(got, want), f
        else:
            _close(got, want, f)


def test_log_npz_and_accessors_match_jax(runs, tmp_path):
    """`to_npz`'s keys and shapes, and the interpolation accessors, as the
    JAX log's."""
    prob, _, port, jax_ = runs["three_player_intersection"]
    log, jlog = port["logged"][1], jax_["logged"][1]
    log.to_npz(str(tmp_path / "port.npz"))
    jlog.to_npz(str(tmp_path / "jax.npz"))
    got, want = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].shape == want[k].shape, k
    dt = prob.spec.dt
    it = log.num_iterates - 1
    for t in (0.0, 0.35 * dt, 2.5 * dt, 9.7 * dt, 20 * dt):
        _close(log.interpolate_state(it, t), jlog.interpolate_state(it, t),
               f"state at {t}")
        _close(log.interpolate_control(it, t, 1),
               jlog.interpolate_control(it, t, 1), f"control at {t}")
    assert log.was_converged_overall() == jlog.was_converged_overall()
    _close(log.P(it, 3, 2), jlog.P(it, 3, 2), "P")
    _close(log.alpha(it, 3, 2), jlog.alpha(it, 3, 2), "alpha")


def test_is_constrained_matches_jax():
    for name in ("three_player_intersection", "skeleton", "air_3d",
                 "two_player_point_mass", "three_player_overtaking"):
        assert examples.get(name)(num_time_steps=5).is_constrained == \
            jexamples.get(name)(num_time_steps=5).is_constrained, name


def test_warm_started_solve_is_the_warm_solvers(runs):
    """Problem.solve from a warm start and multipliers is one lane of
    make_host_batched_warm_solver, bitwise."""
    from ilqgames_tpu_torch.solver import batched
    from ilqgames_tpu_torch.types import tree_map

    prob, _, port, _ = runs["skeleton"]
    first = port["unconstrained"]
    params = SolverParams(**SKELETON_KW)
    al = prob.initial_al_state(1)
    res = prob.solve(params, x0=first.op.xs[2], warm_op=first.op,
                     warm_strategy=first.strategy,
                     al_state=tree_map(lambda a: a[0], al), device="cpu")
    lane = lambda t: tree_map(lambda a: a[None], t)
    want = batched.make_host_batched_warm_solver(
        prob.dynamics, prob.player_costs, prob.spec, params,
        batch_block=8)(first.op.xs[2][None], lane(first.op),
                       lane(first.strategy), al)
    assert torch.equal(res.op.xs, want.op.xs[0])
    assert int(res.cumulative_iterations) == int(
        want.cumulative_iterations[0])


def test_entry_points_need_a_card_by_default():
    """Without a CUDA device, the default device raises: no fallback to
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    prob = examples.get("skeleton")(num_time_steps=5)
    params = SolverParams(**SKELETON_KW)
    for call in (prob.solve, prob.solve_unconstrained, prob.solve_logged):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(params)
