"""The port's utilities against the JAX package's on the CPU:
`utils/timing.LoopTimer`, `utils/cost_cache.PlayerCostCache`,
`viz_html.render_html` and `utils/check_nash`'s `change_cost_coordinates`
and `check_sufficient_local_nash`; `viz`'s plots as smoke tests.

The cache and the HTML page are held on the same log: the port's
solve_logged of `skeleton` (N=20, tests/test_utils.py's parameters),
copied into a JAX package SolverLog. The cost values agree within 1e-5
relative (the same atoms' float32 values, one op order apart); the
page's embedded data within 2e-3 (its numbers are rounded to 3 and 5
decimals, so a last-bit difference may move the last digit). The Nash
check runs on the flat three-player intersection at N=11 (a flat system:
its state Hessians are carried back to the nonlinear coordinates) at an
operating point drawn from RandomState(0): the verdicts equal, the
carried Hessians and gradients within 1e-4 of the largest entry
(torch.func's derivatives of fmath's trigonometry against jax's of
XLA's), the smallest eigenvalues within 1e-3.
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ilqgames_tpu.examples as jexamples
from ilqgames_tpu import viz_html as jviz_html
from ilqgames_tpu.costs import player_cost as jpcost
from ilqgames_tpu.types import OperatingPoint as JOp
from ilqgames_tpu.types import Strategy as JStrategy
from ilqgames_tpu.utils import check_nash as jcheck_nash
from ilqgames_tpu.utils.cost_cache import PlayerCostCache as JCache
from ilqgames_tpu.utils.solver_log import SolverLog as JLog
from ilqgames_tpu.utils.timing import LoopTimer as JLoopTimer
import ilqgames_tpu_torch.examples as examples
from ilqgames_tpu_torch import viz_html
from ilqgames_tpu_torch.costs import player_cost as pcost
from ilqgames_tpu_torch.solver.params import SolverParams
from ilqgames_tpu_torch.types import OperatingPoint
from ilqgames_tpu_torch.utils import check_nash
from ilqgames_tpu_torch.utils.cost_cache import PlayerCostCache
from ilqgames_tpu_torch.utils.timing import LoopTimer

torch.set_num_threads(1)

SKELETON_KW = dict(max_solver_iters=5, max_backtracking_steps=10,
                   initial_alpha_scaling=0.5, convergence_tolerance=0.1,
                   expected_decrease_fraction=0.1)
N_NASH = 11


@pytest.fixture(scope="module")
def logs():
    """The port's log of a skeleton solve and the same iterates in a JAX
    package SolverLog."""
    prob = examples.get("skeleton")(num_time_steps=20)
    jprob = jexamples.get("skeleton")(num_time_steps=20)
    _, log = prob.solve_logged(SolverParams(**SKELETON_KW), device="cpu")
    jlog = JLog(spec=jprob.spec)
    for op, st, c, conv in zip(log.operating_points, log.strategies,
                               log.total_costs, log.was_converged):
        jlog.add_iterate(JOp(xs=jnp.asarray(op.xs), us=jnp.asarray(op.us),
                             t0=jnp.asarray(op.t0)),
                         JStrategy(Ps=jnp.asarray(st.Ps),
                                   alphas=jnp.asarray(st.alphas)),
                         c, converged=conv)
    return prob, jprob, log, jlog


def test_loop_timer_matches_jax():
    for timer in (LoopTimer(max_samples=3, initial_guess_s=0.5),
                  JLoopTimer(max_samples=3, initial_guess_s=0.5)):
        assert timer.runtime_upper_bound() == 0.5
        samples = []
        for _ in range(4):
            timer.tic()
            samples.append(timer.toc())
        window = samples[-3:]
        mean = sum(window) / 3
        var = sum((s - mean) ** 2 for s in window) / 3
        assert timer.runtime_upper_bound() == pytest.approx(
            mean + 3.0 * var ** 0.5)
        assert 0.0 <= timer.runtime_upper_bound() < 0.5
    with pytest.raises(RuntimeError):
        LoopTimer().toc()


def test_cost_cache_matches_jax(logs):
    prob, jprob, log, jlog = logs
    cache, jcache = PlayerCostCache(prob, log), JCache(jprob, jlog)
    assert cache.names(0) == jcache.names(0) == ("GoalX", "GoalY",
                                                 "Control")
    for it in range(log.num_iterates):
        for name in cache.names(0):
            got = cache.evaluate(it, 0, name)
            assert got.shape == (20,) and isinstance(got, np.ndarray)
            np.testing.assert_allclose(got, jcache.evaluate(it, 0, name),
                                       rtol=1e-5, atol=1e-6)


def _html_data(path):
    return json.loads(re.search(r"const D = (.*);\n",
                                open(path).read()).group(1))


def test_html_data_matches_jax(logs, tmp_path):
    prob, jprob, log, jlog = logs
    out = viz_html.render_html(prob, log, str(tmp_path / "port.html"))
    jout = jviz_html.render_html(jprob, jlog, str(tmp_path / "jax.html"))
    got, want = _html_data(out), _html_data(jout)
    assert sorted(got) == sorted(want)
    for key in ("converged", "dt", "lanes"):
        assert got[key] == want[key], key
    for key in ("lo", "hi"):
        assert got[key] == pytest.approx(want[key], abs=2e-3)
    np.testing.assert_allclose(got["costs"], want["costs"], rtol=2e-3)
    for g_it, w_it in zip(got["tracks"], want["tracks"]):
        for g, w in zip(g_it, w_it):
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_allclose(g[k], w[k], atol=2e-3)
    assert len(got["stage_costs"]) == log.num_iterates
    for g_it, w_it in zip(got["stage_costs"], want["stage_costs"]):
        for g, w in zip(g_it, w_it):
            assert list(g) == list(w)
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=2e-3,
                                           atol=2e-3)


def _nash_point(name):
    """The game at N_NASH and an operating point near its x0 from
    RandomState(0): (port problem, JAX problem, op, JAX op)."""
    prob = examples.get(name)(num_time_steps=N_NASH)
    jprob = jexamples.get(name)(num_time_steps=N_NASH)
    spec = prob.spec
    rng = np.random.RandomState(0)
    xs = (prob.x0.numpy()[None] + 0.3 * rng.randn(N_NASH, spec.xdim)
          ).astype(np.float32)
    us = (0.5 * rng.randn(N_NASH, spec.num_players, spec.umax)
          * spec.u_mask().numpy()).astype(np.float32)
    op = OperatingPoint(xs=torch.tensor(xs), us=torch.tensor(us),
                        t0=torch.tensor(0.0))
    jop = JOp(xs=jnp.asarray(xs), us=jnp.asarray(us), t0=jnp.float32(0.0))
    return prob, jprob, op, jop


@pytest.fixture(scope="module")
def nash():
    """The flat intersection's quadraticization at an operating point near
    its x0, carried to the nonlinear coordinates, and the sufficient
    check's verdict, by both packages (the JAX package's in one jitted
    program)."""
    prob, jprob, op, jop = _nash_point("three_player_flat_intersection")

    def jax_side(o):
        al = jpcost.ALState.init(jprob.player_costs, jprob.spec)
        _, ks = jpcost.total_costs(jprob.player_costs, jprob.spec, o)
        q = jpcost.quadraticize(jprob.player_costs, jprob.spec, o, al, ks)
        Qx, lx = jcheck_nash.change_cost_coordinates(jprob.dynamics, q.Q,
                                                     q.l, o.xs)
        return Qx, lx, q.R, jcheck_nash.check_sufficient_local_nash(
            jprob.player_costs, jprob.spec, o, dyn=jprob.dynamics)

    jQx, jlx, jR, jverdict = jax.jit(jax_side)(jop)
    al = pcost.ALState.init(prob.player_costs, prob.spec, 1)
    lane = OperatingPoint(xs=op.xs[None], us=op.us[None], t0=op.t0[None])
    q = pcost.quadraticize(prob.player_costs, prob.spec, lane, al)
    Qx, lx = check_nash.change_cost_coordinates(prob.dynamics, q.Q[0],
                                                q.l[0], op.xs)
    verdict = check_nash.check_sufficient_local_nash(
        prob.player_costs, prob.spec, op, dyn=prob.dynamics)
    return (Qx, lx, q.R[0], verdict), (np.asarray(jQx), np.asarray(jlx),
                                       np.asarray(jR), bool(jverdict))


def test_change_cost_coordinates_matches_jax(nash):
    (Qx, lx, _, _), (jQx, jlx, _, _) = nash
    for got, want in ((Qx, jQx), (lx, jlx)):
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=1e-4 * np.abs(want).max())


def test_check_sufficient_local_nash_matches_jax(nash):
    """The verdict, and the smallest eigenvalues it rests on."""
    (Qx, _, R, verdict), (jQx, _, jR, jverdict) = nash
    assert verdict == jverdict
    for m, jm in ((Qx, jQx), (R, jR)):
        assert float(torch.linalg.eigvalsh(m).min()) == pytest.approx(
            float(np.linalg.eigvalsh(jm).min()), rel=1e-3, abs=1e-3)


def test_viz_plots(logs):
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ilqgames_tpu_torch import viz

    prob, _, log, _ = logs
    ax = viz.plot_top_down(prob, log)
    assert len(ax.lines) >= 1 and ax.get_title().endswith(
        f"iterate {log.num_iterates - 1}")
    ax = viz.plot_costs(prob, log, 0)
    assert [l.get_label() for l in ax.lines] == ["GoalX", "GoalY",
                                                 "Control"]
    plt.close("all")
    # A flat system's headings come through from_linear_state.
    fprob, _, op, _ = _nash_point("three_player_flat_intersection")
    tracks = viz._agent_xy_theta(fprob, op.xs.numpy())
    assert len(tracks) == 3 and all(th is not None for _, _, th in tracks)
