"""BENCH_ALL config 5's game solved by the port against the JAX package
(`make_host_batched_solver`, its Pallas kernels in interpret mode), in
the setting of tests/test_batched_pallas.py's
`test_fused_stage_extremal_problem` (N=9, B=3): the fused machine (the
stage's plain version with the extremal gates and the control
constraints' AL terms), the unfused one, and the queue driver; then the
receding-horizon runtime, two replanning cycles, against the JAX
package's `simulate_batched(backend="pallas")`.

Classes: per instance `converged` and `cumulative_iterations` exactly
equal, costs, violations and trajectories within the per-trip class
(2e-3); a decision may differ only with the knife-edge evidence of
tests/test_torch_flat_solve.py (iterations at most one apart and the two
final trajectories' merits within KNIFE_ULPS). The fused and unfused
machines of the port agree as the JAX package's do (decisions exactly,
arrays within 1e-6), and the queue driver's results are bitwise the
plain driver's.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ilqgames_tpu.examples import reachability as jreach  # noqa: E402
from ilqgames_tpu.runtime import receding_horizon as jrh  # noqa: E402
from ilqgames_tpu.solver import batched as jbatched  # noqa: E402
from ilqgames_tpu.solver.params import SolverParams as JParams  # noqa: E402

from ilqgames_tpu_torch.costs import player_cost as pcost  # noqa: E402
from ilqgames_tpu_torch.examples import reachability as reach  # noqa: E402
from ilqgames_tpu_torch.ops.cuda import sweep  # noqa: E402
from ilqgames_tpu_torch.runtime import receding_horizon as rh  # noqa: E402
from ilqgames_tpu_torch.solver import batched  # noqa: E402
from ilqgames_tpu_torch.solver.params import SolverParams  # noqa: E402

torch.set_num_threads(1)

N, B = 9, 3
PARAMS_KW = dict(max_solver_iters=12, unconstrained_solver_max_iters=4,
                 max_backtracking_steps=12, initial_alpha_scaling=0.5,
                 convergence_tolerance=1.0, expected_decrease_fraction=0.001)
TRIP_TOL = 2e-3   # per-trip arrays, tests/test_batched_pallas.py:119-140
KNIFE_ULPS = 2    # a merit step this small decides on the last bits


def _x0(prob):
    rng = np.random.RandomState(3)
    return (np.tile(prob.x0.numpy()[None], (B, 1))
            + 0.05 * rng.randn(B, prob.spec.xdim).astype(np.float32)
            ).astype(np.float32)


@pytest.fixture(scope="module")
def shared_trip():
    """Memoize the JAX package's `_driver_parts` while this module runs,
    so that its plain solves and simulate_batched's two solvers share the
    compiled trip programs (one problem and one params here: the rest of
    the call is the key)."""
    parts = {}
    driver_parts = jbatched._driver_parts

    def shared(dyn, costs, spec, params, *args, **kwargs):
        key = (args, tuple(sorted(kwargs.items())))
        if key not in parts:
            parts[key] = driver_parts(dyn, costs, spec, params, *args,
                                      **kwargs)
        return parts[key]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbatched, "_driver_parts", shared)
        yield


@pytest.fixture(scope="module")
def runs(shared_trip):
    """The port's plain driver fused and unfused and its queue driver,
    and the JAX package's plain driver fused and unfused, on one x0."""
    prob = reach.make_problem(num_time_steps=N)
    jprob = jreach.make_problem(num_time_steps=N)
    x0 = _x0(prob)
    args = (prob.dynamics, prob.player_costs, prob.spec,
            SolverParams(**PARAMS_KW))
    jargs = (jprob.dynamics, jprob.player_costs, jprob.spec,
             JParams(**PARAMS_KW))
    out = {}
    for fuse in (True, False):
        out["port", fuse] = batched.make_host_batched_solver(
            *args, batch_block=B, fuse_stages=fuse)(torch.tensor(x0))
        out["jax", fuse] = jbatched.make_host_batched_solver(
            *jargs, batch_block=B, interpret=True, fuse_stages=fuse)(
                jnp.asarray(x0))
    out["queue"] = batched.make_host_batched_queue_solver(
        *args, device_batch=2, trips_per_call=3, batch_block=2)(
            torch.tensor(x0))
    return prob, out


def _final_merits(prob, res):
    """The port's plain merits [B] of a result's final trajectories
    (either package's), with its multipliers and its extremal gate, as
    the linesearch computes a candidate's."""
    from ilqgames_tpu_torch import convert

    spec = prob.spec
    op = convert.from_operating_point(res.op)
    al = convert.from_al_state(res.al_state)
    _, ks = pcost.total_costs(prob.player_costs, spec, op)
    gate = pcost.extreme_gate(prob.player_costs, spec, ks)
    lamS, lamC, mu, gate_bm = sweep._prep_al(spec, al, gate, 1)
    return sweep.merit_plain(
        prob.player_costs, spec, op.xs.permute(1, 2, 0)[:, :, None],
        op.us.reshape(B, N, -1).permute(1, 2, 0)[:, :, None],
        op.t0[None], lamS, lamC, mu, gate_bm)[0].numpy()


@pytest.mark.parametrize("which", ["fused", "unfused", "queue"])
def test_drivers_match_jax(runs, which):
    prob, out = runs
    res = out["queue"] if which == "queue" else out["port", which == "fused"]
    jres = out["jax", which != "unfused"]
    iters = res.cumulative_iterations.numpy()
    jiters = np.asarray(jres.cumulative_iterations)
    conv, jconv = res.converged.numpy(), np.asarray(jres.converged)
    differ = (iters != jiters) | (conv != jconv)
    if differ.any():
        m, jm = _final_merits(prob, res), _final_merits(prob, jres)
        gap = np.abs(m - jm) / np.spacing(np.abs(jm))
        assert (np.abs(iters - jiters)[differ] <= 1).all(), (iters, jiters)
        assert (gap[differ] <= KNIFE_ULPS).all(), (conv, jconv, gap)
    for name in ("total_costs", "max_violation"):
        np.testing.assert_allclose(getattr(res, name).numpy(),
                                   np.asarray(getattr(jres, name)),
                                   rtol=TRIP_TOL, atol=TRIP_TOL,
                                   err_msg=name)
    np.testing.assert_allclose(res.op.xs.numpy(), np.asarray(jres.op.xs),
                               rtol=TRIP_TOL, atol=TRIP_TOL)
    for got, want in zip(res.al_state.control_lambdas,
                         jres.al_state.control_lambdas):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TRIP_TOL, atol=TRIP_TOL)


def test_fused_matches_unfused_and_queue_matches_plain(runs):
    _, out = runs
    fused, unfused, queue = out["port", True], out["port", False], \
        out["queue"]
    for name in ("converged", "cumulative_iterations"):
        assert torch.equal(getattr(fused, name), getattr(unfused, name))
    for name in ("total_costs", "max_violation"):
        torch.testing.assert_close(getattr(fused, name),
                                   getattr(unfused, name), rtol=1e-6,
                                   atol=1e-6)
    torch.testing.assert_close(fused.op.xs, unfused.op.xs, rtol=1e-6,
                               atol=1e-6)
    for name in ("converged", "cumulative_iterations", "total_costs",
                 "max_violation"):
        assert torch.equal(getattr(queue, name), getattr(fused, name)), name
    assert torch.equal(queue.op.xs, fused.op.xs)


def test_simulate_batched_matches_jax(runs):
    """Two replanning cycles of three agents: the cold solve, then per
    cycle playback, warm-start shift, the warm solve and the splice, with
    fused stages (the JAX package's default)."""
    prob, _ = runs
    jprob = jreach.make_problem(num_time_steps=N)
    x0 = _x0(prob)
    states, times, state = rh.simulate_batched(
        prob, SolverParams(**PARAMS_KW), torch.tensor(x0), final_time=0.75,
        batch_block=B)
    jstates, jtimes, jstate = jrh.simulate_batched(
        jprob, JParams(**PARAMS_KW), jnp.asarray(x0), final_time=0.75,
        backend="pallas", batch_block=B, interpret=True)
    stats = rh.simulate_batched.last_stats
    assert len(stats["cycles"]) == 2
    np.testing.assert_array_equal(times.numpy(), np.asarray(jtimes))
    np.testing.assert_array_equal(state.t.numpy(), np.asarray(jstate.t))
    for name in ("converged", "num_replans"):
        np.testing.assert_array_equal(getattr(state, name).numpy(),
                                      np.asarray(getattr(jstate, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(state.splicer.length.numpy(),
                                  np.asarray(jstate.splicer.length))
    for name, got, want in (
            ("states", states, jstates),
            ("splicer xs", state.splicer.op.xs, jstate.splicer.op.xs),
            ("splicer us", state.splicer.op.us, jstate.splicer.op.us),
            ("splicer alphas", state.splicer.strategy.alphas,
             jstate.splicer.strategy.alphas)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TRIP_TOL, atol=TRIP_TOL,
                                   err_msg=name)
