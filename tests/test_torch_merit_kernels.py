"""Port parity: the plain version of the merit kernels K5 and K6
(`sweep.merit_plain` over K4's emitted candidates) against the JAX
package's Pallas merit consumer (`_pallas_merits`) and its rollout kernel
with in-kernel merit (`_run(compute_merit=True)`), both in interpret
mode, on a mid-solve state of the flagship at N=11, B=4 (two trips of the
fused machine and a real LQ strategy, as tests/test_batched_pallas.py
builds it: on random states the JAX package's own folds differ by up to
2.9%, docs/scaling.md). And the port's three merit backends on the CPU."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ilqgames_tpu.dynamics import base as jdyn  # noqa: E402
from ilqgames_tpu.examples.three_player_intersection import \
    make_problem as jmake  # noqa: E402
from ilqgames_tpu.ops.pallas import sweep as jsweep  # noqa: E402
from ilqgames_tpu.ops.pallas.lq import solve_lq_feedback_pallas  # noqa: E402
from ilqgames_tpu.solver import fused as jfused  # noqa: E402
from ilqgames_tpu.solver.params import SolverParams as JParams  # noqa: E402

from ilqgames_tpu_torch import convert  # noqa: E402
from ilqgames_tpu_torch.examples.three_player_intersection import \
    make_problem  # noqa: E402
from ilqgames_tpu_torch.ops.cuda import sweep  # noqa: E402

from test_torch_solver import PARAMS, _jax_carry0  # noqa: E402

torch.set_num_threads(1)

B, N = 4, 11
TOL = dict(rtol=1e-5, atol=1e-5)
SCALINGS = np.asarray([0.1, 0.05, 0.025, 0.0125], np.float32)


@pytest.fixture(scope="module")
def mid_solve():
    """Both packages' batch-minor sweep operands at a mid-solve state."""
    jprob = jmake(num_time_steps=N)
    dyn, costs, spec = jprob.dynamics, jprob.player_costs, jprob.spec
    rng = np.random.RandomState(0)
    x0 = jnp.asarray((np.tile(np.asarray(jprob.x0)[None], (B, 1))
                      + 0.1 * rng.randn(B, spec.xdim)).astype(np.float32))
    fc = jax.jit(lambda x: _jax_carry0(jprob, x))(x0)
    trip = jax.jit(jax.vmap(lambda x, f: jfused._trip(
        dyn, costs, spec, JParams(**PARAMS), x, f)))
    for _ in range(2):
        fc = trip(x0, fc)
    c = fc.c
    lin = jax.vmap(lambda o: jdyn.linearize(dyn, spec, o))(c.op)
    strategy = solve_lq_feedback_pallas(
        spec, lin, c.quad, x0 - c.op.xs[:, 0], batch_block=B,
        interpret=True).strategy
    gate = jnp.ones((B, N, spec.num_players), jnp.float32)
    jop, jst, jx0m = jsweep._prep_common(spec, x0, c.op, strategy, B)
    jlamS, jlamC, jmu, jgate = jsweep._prep_al(spec, fc.al, gate, B)
    jscal = jnp.broadcast_to(jnp.asarray(SCALINGS)[:, None], (4, B))
    ref = dict(x0m=jx0m, op=jop, st=jst, lamS=jlamS, lamC=jlamC, mu=jmu,
               gate=jgate, scal=jscal)

    prob = make_problem(num_time_steps=N)
    op, st, x0m = sweep._prep_common(
        prob.spec, torch.tensor(np.asarray(x0)),
        convert.from_operating_point(c.op), convert.from_strategy(strategy),
        B)
    lamS, lamC, mu, _ = sweep._prep_al(
        prob.spec, convert.from_al_state(fc.al), None, B)
    scal = torch.tensor(SCALINGS)[:, None].expand(4, B).contiguous()
    port = dict(x0m=x0m, op=op, st=st, lamS=lamS, lamC=lamC, mu=mu,
                scal=scal)
    return jprob, ref, prob, port


def _port_merits(prob, port):
    xs = sweep.rollout_plain(prob.dynamics, prob.spec, port["x0m"],
                             port["op"], port["st"], port["scal"])
    us = sweep._us_from_xs(prob.spec, xs, port["op"], port["st"],
                           port["scal"])
    return sweep.merit_plain(prob.player_costs, prob.spec, xs, us,
                             port["op"]["t0"], port["lamS"], port["lamC"],
                             port["mu"]).numpy()


def _assert_close(got, ref):
    finite = np.isfinite(ref)
    assert finite.any()
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_allclose(got[finite], ref[finite], **TOL)


def test_merit_plain_vs_pallas_consumer(mid_solve):
    """K6's plain version against `_pallas_merits` (interpret) over the
    JAX package's own emitted candidates."""
    jprob, ref, prob, port = mid_solve
    spec = jprob.spec
    (xs,) = jsweep._run(
        jprob.dynamics, None, spec, ref["x0m"], ref["op"], ref["st"],
        ref["scal"], None, None, None, None, compute_merit=False,
        emit_traj="xs", batch_block=B, interpret=True)
    us = jsweep._us_from_xs(spec, xs, ref["op"], ref["st"], ref["scal"])
    want = jsweep._pallas_merits(
        jprob.player_costs, spec, xs, us, ref["op"]["t0"], ref["lamS"],
        ref["lamC"], ref["mu"], ref["gate"], B, True)
    _assert_close(_port_merits(prob, port), np.asarray(want))


def test_merit_plain_vs_in_kernel_merit(mid_solve):
    """K5's plain version against the rollout kernel with in-kernel merit,
    `_run(compute_merit=True)` (interpret)."""
    jprob, ref, prob, port = mid_solve
    (want,) = jsweep._run(
        jprob.dynamics, jprob.player_costs, jprob.spec, ref["x0m"],
        ref["op"], ref["st"], ref["scal"], ref["lamS"], ref["lamC"],
        ref["mu"], ref["gate"], compute_merit=True, emit_traj=False,
        batch_block=B, interpret=True)
    _assert_close(_port_merits(prob, port), np.asarray(want))


def test_merit_backends_equal_on_cpu(mid_solve):
    """The three backends compute the same operations in the same order:
    bitwise equal on the CPU, where K5's and K6's wrappers take their
    plain versions and launch nothing."""
    _, _, prob, port = mid_solve
    before = (sweep.rollout_merits.launches, sweep.consumer_merits.launches)
    out = {b: sweep.sweep_merits_bm(
        prob.dynamics, prob.player_costs, prob.spec, port["x0m"], port["op"],
        port["st"], port["scal"], port["lamS"], port["lamC"], port["mu"], b)
        for b in sweep.MERIT_BACKENDS}
    assert before == (sweep.rollout_merits.launches,
                      sweep.consumer_merits.launches)
    assert bool(torch.isfinite(out["xla"]).any())
    for b in ("kernel", "pallas"):
        assert torch.equal(out[b].nan_to_num(), out["xla"].nan_to_num()), b
    with pytest.raises(ValueError, match="merit_backend"):
        sweep.sweep_merits_bm(prob.dynamics, prob.player_costs, prob.spec,
                              port["x0m"], port["op"], port["st"],
                              port["scal"], port["lamS"], port["lamC"],
                              port["mu"], "triton")


@pytest.mark.cuda
def test_merit_kernels_match_plain_on_card(mid_solve):
    """K5 and K6 on the card against their plain versions, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card via chip_smoke.py)")
    _, _, prob, port = mid_solve
    cu = lambda v: ({k: a.cuda() for k, a in v.items()}
                    if isinstance(v, dict) else
                    None if v is None else v.cuda())
    g = {k: cu(v) for k, v in port.items()}
    want = sweep.sweep_merits_bm(
        prob.dynamics, prob.player_costs, prob.spec, port["x0m"], port["op"],
        port["st"], port["scal"], port["lamS"], port["lamC"], port["mu"])
    for b in ("kernel", "pallas"):
        got = sweep.sweep_merits_bm(
            prob.dynamics, prob.player_costs, prob.spec, g["x0m"], g["op"],
            g["st"], g["scal"], g["lamS"], g["lamC"], g["mu"], b)
        assert torch.equal(got.cpu().nan_to_num(), want.nan_to_num()), b
