"""Port parity: stage glue (linearize, quadraticize, cost totals,
constraint violations, polyline query) against the JAX package, on the
same numpy-made inputs at a small size (N=11, B=4)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ilqgames_tpu import geometry as jgeom  # noqa: E402
from ilqgames_tpu.costs import player_cost as jpc  # noqa: E402
from ilqgames_tpu.dynamics import base as jdyn  # noqa: E402
from ilqgames_tpu.examples import three_player_intersection as jex  # noqa: E402
from ilqgames_tpu.solver import al as jal  # noqa: E402
from ilqgames_tpu.types import OperatingPoint as JOp  # noqa: E402

from ilqgames_tpu_torch import convert, geometry  # noqa: E402
from ilqgames_tpu_torch.costs import player_cost as pc  # noqa: E402
from ilqgames_tpu_torch.dynamics import base as dyn  # noqa: E402
from ilqgames_tpu_torch.examples import three_player_intersection as ex  # noqa: E402
from ilqgames_tpu_torch.solver import al  # noqa: E402

torch.set_num_threads(1)

B, N = 4, 11
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def stage():
    """A batched operating point near the flagship's start (random states
    and controls) and AL multipliers with live constraints, from numpy."""
    jprob = jex.make_problem(num_time_steps=N)
    prob = ex.make_problem(num_time_steps=N)
    spec = jprob.spec
    rng = np.random.RandomState(0)
    x0 = np.asarray(jprob.x0)
    xs = (x0[None, None] + np.cumsum(
        0.5 * rng.randn(B, N, spec.xdim), axis=1)).astype(np.float32)
    us = rng.randn(B, N, spec.num_players, spec.umax).astype(np.float32)
    t0 = np.zeros((B,), np.float32)
    jop = JOp(xs=jnp.asarray(xs), us=jnp.asarray(us), t0=jnp.asarray(t0))
    jal0 = jax.vmap(lambda _: jpc.ALState.init(jprob.player_costs, spec))(
        jnp.arange(B))
    lams = tuple(jnp.asarray(np.abs(rng.randn(*l.shape)).astype(np.float32))
                 for l in jal0.state_lambdas)
    jals = jal0.replace(state_lambdas=lams,
                        mu=jnp.full((B,), 12.5, jnp.float32))
    return (jprob, prob, jop, convert.from_operating_point(jop), jals,
            convert.from_al_state(jals))


def test_linearize(stage):
    jprob, prob, jop, op, _, _ = stage
    ref = jax.vmap(lambda o: jdyn.linearize(jprob.dynamics, jprob.spec, o))(
        jop)
    got = dyn.linearize(prob.dynamics, prob.spec, op)
    np.testing.assert_allclose(got.A.numpy(), np.asarray(ref.A), **TOL)
    np.testing.assert_allclose(got.Bs.numpy(), np.asarray(ref.Bs), **TOL)


def test_quadraticize(stage):
    jprob, prob, jop, op, jals, als = stage
    ek = jnp.zeros((B, jprob.spec.num_players), jnp.int32)
    ref = jax.vmap(lambda o, a, e: jpc.quadraticize(
        jprob.player_costs, jprob.spec, o, a, e))(jop, jals, ek)
    got = pc.quadraticize(prob.player_costs, prob.spec, op, als)
    for name in ("Q", "l", "R", "r"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), **TOL,
                                   err_msg=name)


def test_total_costs(stage):
    jprob, prob, jop, op, _, _ = stage
    ref, ref_k = jax.vmap(lambda o: jpc.total_costs(
        jprob.player_costs, jprob.spec, o))(jop)
    got, got_k = pc.total_costs(prob.player_costs, prob.spec, op)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(ref_k))


def test_constraint_violations(stage):
    jprob, prob, jop, op, jals, als = stage
    ref_al, ref_v = jax.vmap(lambda o, a: jal.constraint_violations(
        jprob.player_costs, jprob.spec, o, a))(jop, jals)
    got_al, got_v = al.constraint_violations(prob.player_costs, prob.spec,
                                             op, als)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(ref_v), **TOL)
    for g, r in zip(got_al.state_lambdas, ref_al.state_lambdas):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
    ref_m = jax.vmap(lambda o: jal.max_constraint_violation(
        jprob.player_costs, jprob.spec, o))(jop)
    np.testing.assert_allclose(
        al.max_constraint_violation(prob.player_costs, prob.spec, op).numpy(),
        np.asarray(ref_m), **TOL)


@pytest.mark.parametrize("lane", [0, 1, 2])
def test_polyline_closest_point(lane):
    """Queries around every vertex, along the segments and past both
    ends, plus exact vertex hits."""
    pts = jex.lane_polylines()[lane]
    rng = np.random.RandomState(lane)
    near = pts[rng.randint(len(pts), size=256)] + rng.randn(256, 2) * 3.0
    far = np.array([pts[0] * 1.5, pts[-1] * 1.5])
    q = np.concatenate([near, far, pts]).astype(np.float32)
    ref = jgeom.polyline_closest_point_xy(
        jnp.asarray(pts), jnp.asarray(q[:, 0]), jnp.asarray(q[:, 1]),
        need_sign=False)
    got = geometry.polyline_closest_point_xy(
        ex.lane_polylines()[lane], torch.tensor(q[:, 0]),
        torch.tensor(q[:, 1]))
    for name in ref._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), **TOL,
                                   err_msg=name)
