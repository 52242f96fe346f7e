"""Port data: JAX-container round trips through the port's containers, and
the flagship problem rebuilt in the port from the same constants."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ilqgames_tpu.costs import player_cost as jpc  # noqa: E402
from ilqgames_tpu.examples import three_player_intersection as jex  # noqa: E402
from ilqgames_tpu.solver import fused as jfused  # noqa: E402
from ilqgames_tpu.solver import ilq as jilq  # noqa: E402
from ilqgames_tpu.solver.al import ALResult  # noqa: E402
from ilqgames_tpu.types import OperatingPoint, QuadraticCosts, Strategy  # noqa: E402

from ilqgames_tpu_torch import convert  # noqa: E402
from ilqgames_tpu_torch.costs import player_cost as pc  # noqa: E402
from ilqgames_tpu_torch.examples import three_player_intersection as ex  # noqa: E402

torch.set_num_threads(1)

B, N = 3, 7


def _containers():
    """Batched JAX containers of every kind filled from one numpy seed."""
    spec = jex.make_problem(num_time_steps=N).spec
    costs = jex.make_problem(num_time_steps=N).player_costs
    rng = np.random.RandomState(0)
    f = lambda *s: jnp.asarray(rng.randn(B, *s).astype(np.float32))
    P, x, u = spec.num_players, spec.xdim, spec.umax
    op = OperatingPoint(xs=f(N, x), us=f(N, P, u), t0=f())
    st = Strategy(Ps=f(N, P, u, x), alphas=f(N, P, u))
    quad = QuadraticCosts(Q=f(N, P, x, x), l=f(N, P, x), R=f(N, P, P, u, u),
                          r=f(N, P, P, u))
    al = jax.vmap(lambda _: jpc.ALState.init(costs, spec))(jnp.arange(B))
    al = al.replace(state_lambdas=tuple(f(*l.shape[1:])
                                        for l in al.state_lambdas), mu=f())
    ints = lambda *s: jnp.asarray(rng.randint(0, 9, (B,) + s), jnp.int32)
    bools = lambda: jnp.asarray(rng.rand(B) > 0.5)
    c = jilq._SolveCarry(op=op, strategy=st, quad=quad, extreme_ks=ints(P),
                         last_merit=f(), iteration=ints(), converged=bools(),
                         failed=bools())
    fc = jfused._FusedCarry(c=c, al=al, warm_op=op, warm_strategy=st,
                            inner_iters=ints(), cum_iters=ints(),
                            violation=f(), success=bools(), done=bools())
    res = ALResult(op=op, strategy=st, total_costs=f(P), converged=bools(),
                   max_violation=f(), cumulative_iterations=ints(),
                   al_state=al)
    return {"operating_point": op, "strategy": st, "quadratic_costs": quad,
            "al_state": al, "solve_carry": c, "fused_carry": fc,
            "al_result": res}


@pytest.mark.parametrize("kind", ["operating_point", "strategy",
                                  "quadratic_costs", "al_state",
                                  "solve_carry", "fused_carry", "al_result"])
def test_round_trip(kind):
    src = _containers()[kind]
    got = convert.to_numpy(getattr(convert, "from_" + kind)(src))
    ref = jax.tree_util.tree_leaves(src)
    leaves = []
    convert.tree_map(lambda a: leaves.append(a), got)
    assert len(leaves) == len(ref)
    for g, r in zip(leaves, ref):
        assert g.dtype == np.asarray(r).dtype
        np.testing.assert_array_equal(g, np.asarray(r))


def test_flagship_constants_equal():
    for name in ("INTER_AXLE_LENGTH", "STATE_REG", "CONTROL_REG",
                 "OMEGA_COST_WEIGHT", "JERK_COST_WEIGHT", "A_COST_WEIGHT",
                 "NOMINAL_V_COST_WEIGHT", "LANE_COST_WEIGHT", "MIN_PROXIMITY",
                 "P1_NOMINAL_V", "P2_NOMINAL_V", "P3_NOMINAL_V",
                 "P1_INITIAL", "P2_INITIAL", "P3_INITIAL"):
        assert getattr(ex, name) == getattr(jex, name), name
    for a, b in zip(ex.lane_polylines(), jex.lane_polylines()):
        np.testing.assert_array_equal(a, b)
    jprob, prob = jex.make_problem(), ex.make_problem()
    np.testing.assert_array_equal(prob.x0.numpy(), np.asarray(jprob.x0))
    assert prob.spec.xdims == jprob.spec.xdims
    assert prob.spec.udims == jprob.spec.udims
    assert prob.spec.dt == jprob.spec.dt
    assert prob.spec.num_time_steps == jprob.spec.num_time_steps
    for p, jp in zip(prob.player_costs, jprob.player_costs):
        assert p.state_regularization == jp.state_regularization
        assert p.control_regularization == jp.control_regularization
        assert [c.name for c in p.state_costs] == \
            [c.name for c in jp.state_costs]
        assert [c.name for c in p.state_constraints] == \
            [c.name for c in jp.state_constraints]
        assert [(j, c.name) for j, c in p.control_costs] == \
            [(j, c.name) for j, c in jp.control_costs]


def test_flagship_total_costs_equal():
    """Weights, lanes and nominal speeds act the same on one shared
    operating point."""
    jprob, prob = jex.make_problem(), ex.make_problem()
    spec = jprob.spec
    rng = np.random.RandomState(3)
    xs = (np.asarray(jprob.x0)[None, None]
          + np.cumsum(rng.randn(2, spec.num_time_steps, spec.xdim), 1)
          ).astype(np.float32)
    us = rng.randn(2, spec.num_time_steps, spec.num_players,
                   spec.umax).astype(np.float32)
    jop = OperatingPoint(xs=jnp.asarray(xs), us=jnp.asarray(us),
                         t0=jnp.zeros((2,), jnp.float32))
    ref, _ = jax.vmap(lambda o: jpc.total_costs(
        jprob.player_costs, spec, o))(jop)
    got, _ = pc.total_costs(prob.player_costs, prob.spec,
                            convert.from_operating_point(jop))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
