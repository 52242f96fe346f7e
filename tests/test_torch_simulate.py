"""The port's per-instance receding-horizon simulator (`ilqgames_tpu_torch/
runtime/receding_horizon.simulate`), one agent's lane in a block of 8 on
the batched machine, against the JAX package's on the CPU:

- on `skeleton` (final time 1.5 s, as tests/test_receding_horizon.py:85-96;
  N=11) against the JAX package's simulate;
- on `dubins_origin` in the open-loop information pattern (N=11, 2
  cycles: K7's plain version warm-started in every cycle) against the
  JAX package's simulate with open_loop.

The minimally-invasive simulator is tests/test_torch_simulate_mi.py's.

Classes (ROADMAP Queue 3): decisions (converged, replans) and times
exactly equal; states and plans within the per-trip class, 2e-3.
"""

import numpy as np
import pytest
import torch

import ilqgames_tpu.examples as jexamples
from ilqgames_tpu.runtime import receding_horizon as jrh
from ilqgames_tpu.solver.params import SolverParams as JParams
import ilqgames_tpu_torch.examples as examples
from ilqgames_tpu_torch.runtime import receding_horizon as rh
from ilqgames_tpu_torch.solver import batched
from ilqgames_tpu_torch.solver.params import SolverParams

torch.set_num_threads(1)

TRIP_TOL = 2e-3
N = 11
SIM_KW = dict(max_solver_iters=4, unconstrained_solver_max_iters=4,
              max_backtracking_steps=20, initial_alpha_scaling=0.1,
              convergence_tolerance=1.0, expected_decrease_fraction=0.001)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=TRIP_TOL, atol=TRIP_TOL, err_msg=what)


@pytest.mark.parametrize("game,final_time,open_loop", [
    ("skeleton", 1.5, False), ("dubins_origin", 0.75, True)])
def test_simulate_matches_jax(game, final_time, open_loop, monkeypatch):
    prob = examples.get(game)(num_time_steps=N)
    jprob = jexamples.get(game)(num_time_steps=N)
    kw = dict(SIM_KW, open_loop=open_loop)
    lq_calls = []
    solve_ol = batched.solve_lq_open_loop
    monkeypatch.setattr(batched, "solve_lq_open_loop",
                        lambda *a, **k: lq_calls.append(1) or solve_ol(
                            *a, **k))
    xs, ts, state = rh.simulate(prob, SolverParams(**kw),
                                final_time=final_time, device="cpu")
    jxs, jts, jstate = jrh.simulate(jprob, JParams(**kw),
                                    final_time=final_time)
    n = int(final_time / 0.25) - 1
    assert xs.shape == (n + 1, prob.spec.xdim) and ts.shape == (n + 1,)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(jts))
    assert int(state.num_replans) == int(jstate.num_replans) == n
    assert bool(state.converged) == bool(jstate.converged)
    _close(xs, jxs, "states")
    _close(state.splicer.op.xs, jstate.splicer.op.xs, "plan xs")
    _close(state.splicer.strategy.alphas, jstate.splicer.strategy.alphas,
           "plan alphas")
    assert int(state.splicer.length) == int(jstate.splicer.length)
    # The open-loop pattern's every solve, the warm ones included, takes
    # the open-loop LQ solve (K7's plain version here).
    stats = rh.simulate.last_stats
    trips = stats["cold"]["trips"] + sum(c["trips"] for c in stats["cycles"])
    assert len(lq_calls) == (trips if open_loop else 0)
    # Each cycle's host seconds: its first half and its solves within it.
    for c in stats["cycles"]:
        assert 0.0 <= c["setup_s"] and 0.0 <= c["solve_s"]
        assert c["setup_s"] + c["solve_s"] <= c["wall_s"]
