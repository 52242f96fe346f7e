"""The driving games' modules in the port against the JAX package:

- `semiquadratic`: evaluate, its gradient pairs and its quadraticization's
  pairs bitwise, both orientations, on values below, at and above the
  threshold (and a NaN), and its device form;
- `geometry.polyline_point_at` (bitwise), `polyline_cumulative_lengths`
  (within 1e-6), `routes.roundabout_lane_center` (bitwise: the same
  numpy float32 points) and `routes.initialize_along_route` (bitwise);
- the five examples (`three_player_overtaking`, `roundabout_merging`,
  `modified_three_player_intersection`,
  `three_player_intersection_reachability`, `skeleton`): x0 bitwise, the
  spec, each player's atoms by name and device form, and (but for the
  roundabout's, held through the fused stage in
  tests/test_torch_driving_kernels.py) `quadraticize` at a random
  operating point within 1e-5 (the extremal gate of the MAX player from
  `total_costs`'s extreme knots);
- the registry: the JAX package's 18 names; the ported ones resolve, the
  others raise NotImplementedError that names them;
- solves of the overtaking (N=11, B=4) and of the skeleton (N=11, B=4) on
  the plain driver, fused, against the JAX package's batched solver in
  interpret mode: `converged` and `cumulative_iterations` exactly equal,
  costs and trajectories within the per-trip class (2e-3);
- fused trips of three_player_intersection_reachability (a MAX player
  beside two SUM drivers with semiquadratic speed bounds) from the JAX
  machine's carry before each, as tests/test_torch_driving_trips.py holds
  the roundabout's: decisions exactly equal, merits and trajectories
  within the per-trip class.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import ilqgames_tpu.examples as jex  # noqa: E402
from ilqgames_tpu import geometry as jgeom  # noqa: E402
from ilqgames_tpu.costs import atoms as jatoms  # noqa: E402
from ilqgames_tpu.costs import player_cost as jpc  # noqa: E402
from ilqgames_tpu.examples import routes as jroutes  # noqa: E402
from ilqgames_tpu.solver import batched as jbatched  # noqa: E402
from ilqgames_tpu.solver.params import SolverParams as JParams  # noqa: E402
from ilqgames_tpu.types import OperatingPoint as JOp  # noqa: E402

import ilqgames_tpu_torch.examples as ex  # noqa: E402
from ilqgames_tpu_torch import convert, geometry  # noqa: E402
from ilqgames_tpu_torch.costs import atoms  # noqa: E402
from ilqgames_tpu_torch.costs import player_cost as pcost  # noqa: E402
from ilqgames_tpu_torch.examples import routes  # noqa: E402
from ilqgames_tpu_torch.solver import batched  # noqa: E402
from ilqgames_tpu_torch.solver.params import SolverParams  # noqa: E402
from ilqgames_tpu_torch.types import OperatingPoint  # noqa: E402
from test_torch_driving_trips import _trips_match_jax  # noqa: E402

torch.set_num_threads(1)

N, B = 11, 4
DRIVING = ("three_player_overtaking", "roundabout_merging",
           "modified_three_player_intersection",
           "three_player_intersection_reachability", "skeleton")
TRIP_TOL = 2e-3


def _same_bits(got, want, msg=""):
    got = np.asarray(got, np.float32)
    want = np.broadcast_to(np.asarray(want, np.float32), got.shape)
    nan = np.isnan(want)
    assert (np.isnan(got) == nan).all(), msg
    assert (got.view(np.int32)[~nan] == want.view(np.int32)[~nan]).all(), (
        msg, got, want)


@pytest.mark.parametrize("oriented_right", [True, False])
def test_semiquadratic_matches_jax(oriented_right):
    thr, w, d = 1.5, 100.0, 2
    rng = np.random.RandomState(1)
    v = (rng.randn(64, 4) * 3).astype(np.float32)
    v[0, d] = thr                                  # at the threshold
    v[1, d] = np.nextafter(np.float32(thr), np.float32(9))
    v[2, d] = np.nextafter(np.float32(thr), np.float32(-9))
    v[3, d] = np.nan
    v[4, d] = 1e30
    c = atoms.semiquadratic(w, d, thr, oriented_right, "MaxV")
    jc = jatoms.semiquadratic(w, d, thr, oriented_right, "MaxV")
    tv = torch.tensor(v)
    _same_bits(c.evaluate(0.0, tv).numpy(),
               jax.vmap(lambda a: jc.evaluate(0.0, a))(v), "evaluate")
    (k, g), = c.gradient_pairs(0.0, tv)
    (jk, _), = jc.gradient_pairs(0.0, v[0])
    assert k == jk == d
    _same_bits(g.numpy(), jax.vmap(
        lambda a: jc.gradient_pairs(0.0, a)[0][1])(v), "gradient")
    (hk, h), = c.quad_pairs(0.0, tv)[0]
    (qk, q), = c.quad_pairs(0.0, tv)[1]
    jh, jq = jax.vmap(lambda a: (jc.quad_pairs(0.0, a)[0][0][1],
                                 jc.quad_pairs(0.0, a)[1][0][1]))(v)
    assert hk == (d, d) and qk == d
    _same_bits(h.numpy(), jh, "hessian")
    _same_bits(q.numpy(), jq, "quad gradient")
    on = g.numpy() != 0
    assert not on[0] and on[1] == oriented_right and on[2] != oriented_right
    assert c.device == ("semiquadratic", {"dim": d, "weight": w,
                                          "threshold": thr,
                                          "oriented_right": oriented_right})


def test_routes_match_jax():
    for i, dist in enumerate((25.0, 10.0)):
        a = np.pi / 4 + i * np.pi / 2
        lane = routes.roundabout_lane_center(a, a + np.pi, dist)
        jlane = jroutes.roundabout_lane_center(a, a + np.pi, dist)
        assert lane.dtype == np.float32 and lane.tobytes() == jlane.tobytes()
    pos = np.concatenate([np.linspace(-5.0, 80.0, 97),
                          [0.0, 1e5]]).astype(np.float32)
    _same_bits(geometry.polyline_point_at(lane, torch.tensor(pos)).numpy(),
               jax.vmap(lambda p: jgeom.polyline_point_at(
                   jnp.asarray(lane), p))(pos), "point_at")
    np.testing.assert_allclose(
        geometry.polyline_cumulative_lengths(lane).numpy(),
        np.asarray(jgeom.polyline_cumulative_lengths(jnp.asarray(lane))),
        rtol=1e-6, atol=1e-6)
    prob = ex.get("roundabout_merging")(num_time_steps=N)
    jprob = jex.get("roundabout_merging")(num_time_steps=N)
    op = routes.initialize_along_route(
        prob.spec, prob.initial_operating_point(), lane, 3.0, 10.0, (6, 7))
    jop = jroutes.initialize_along_route(
        jprob.spec, jprob.initial_operating_point(), lane, 3.0, 10.0, (6, 7))
    _same_bits(op.xs.numpy(), jop.xs, "initialize_along_route")


def _names(pc):
    return ([(c.name, c.device) for c in pc.state_costs],
            [(j, c.name, c.device) for j, c in pc.control_costs],
            pc.structure, pc.state_regularization,
            pc.control_regularization)


def _jnames(pc):
    return ([c.name for c in pc.state_costs],
            [(j, c.name) for j, c in pc.control_costs], pc.structure,
            pc.state_regularization, pc.control_regularization)


@pytest.mark.parametrize("name", DRIVING)
def test_example_matches_jax(name):
    """x0 bitwise, the spec, each player's atoms in order and every
    stage's quadraticization at a random operating point (the lanes'
    relative times, as the unfused stage). The roundabout's is held in
    tests/test_torch_driving_kernels.py instead, through the fused
    stage's plain version against the JAX package's stage kernel: its
    quadraticize alone takes the JAX package ~45 s to compile."""
    prob, jprob = ex.get(name)(num_time_steps=N), jex.get(name)(
        num_time_steps=N)
    spec = prob.spec
    assert prob.name == jprob.name == name
    assert prob.x0.numpy().tobytes() == np.asarray(jprob.x0).tobytes()
    assert (spec.xdims, spec.udims, spec.num_time_steps, spec.dt) == (
        jprob.spec.xdims, jprob.spec.udims, jprob.spec.num_time_steps,
        jprob.spec.dt)
    assert prob.dynamics.name == jprob.dynamics.name
    for pc, jpc_ in zip(prob.player_costs, jprob.player_costs):
        got = _names(pc)
        assert ([n for n, _ in got[0]], [(j, n) for j, n, _ in got[1]],
                *got[2:]) == _jnames(jpc_)
        assert all(d is not None for _, d in got[0])
    assert len(prob.player_costs) == len(jprob.player_costs)
    if name == "roundabout_merging":
        return
    rng = np.random.RandomState(7)
    xs = (prob.x0.numpy()[None, None] + np.cumsum(
        0.4 * rng.randn(B, N, spec.xdim), 1)).astype(np.float32)
    us = (0.3 * rng.randn(B, N, spec.num_players, spec.umax)).astype(
        np.float32)
    t0 = np.zeros((B,), np.float32)
    op = OperatingPoint(xs=torch.tensor(xs), us=torch.tensor(us),
                        t0=torch.tensor(t0))
    jop = JOp(xs=jnp.asarray(xs), us=jnp.asarray(us), t0=jnp.asarray(t0))
    al = pcost.ALState.init(prob.player_costs, spec, B)
    _, ks = pcost.total_costs(prob.player_costs, spec, op)
    gate = (None if pcost.all_sum(prob.player_costs)
            else pcost.extreme_gate(prob.player_costs, spec, ks))
    quad = pcost.quadraticize(prob.player_costs, spec, op, al, gate=gate)
    jal = jpc.ALState.init(jprob.player_costs, jprob.spec)

    def one(o):
        _, jks = jpc.total_costs(jprob.player_costs, jprob.spec, o)
        return jpc.quadraticize(jprob.player_costs, jprob.spec, o, jal, jks)

    jquad = jax.jit(jax.vmap(one))(jop)
    for nm in ("Q", "l", "R", "r"):
        np.testing.assert_allclose(getattr(quad, nm).numpy(),
                                   np.asarray(getattr(jquad, nm)),
                                   rtol=1e-5, atol=1e-5, err_msg=nm)


def test_registry_matches_jax():
    assert ex.names() == jex.names()
    assert len(ex.names()) == 18
    assert set(DRIVING) <= set(ex.ported())
    assert len(ex.ported()) == 18
    for name in ex.names():
        if name in ex.ported():
            assert ex.get(name)().name in (name, jex.get(name)().name)
        else:
            with pytest.raises(NotImplementedError, match=name):
                ex.get(name)
    with pytest.raises(KeyError):
        ex.get("no_such_game")


SOLVE_PARAMS = dict(max_solver_iters=6, max_backtracking_steps=8,
                    initial_alpha_scaling=0.75, convergence_tolerance=0.01,
                    expected_decrease_fraction=0.1)


@pytest.mark.parametrize("name", ["three_player_overtaking", "skeleton"])
def test_solve_matches_jax(name):
    """The golden runs' parameters (the linesearch from alpha 0.75,
    tolerance 0.01) with a short budget, fused stages, plain driver."""
    prob, jprob = ex.get(name)(num_time_steps=N), jex.get(name)(
        num_time_steps=N)
    rng = np.random.RandomState(2)
    x0 = (np.tile(prob.x0.numpy()[None], (B, 1))
          + 0.1 * rng.randn(B, prob.spec.xdim)).astype(np.float32)
    res = batched.make_host_batched_solver(
        prob.dynamics, prob.player_costs, prob.spec,
        SolverParams(**SOLVE_PARAMS), batch_block=B)(torch.tensor(x0))
    jres = jbatched.make_host_batched_solver(
        jprob.dynamics, jprob.player_costs, jprob.spec,
        JParams(**SOLVE_PARAMS), batch_block=B, interpret=True)(
            jnp.asarray(x0))
    jres = convert.from_al_result(jres)
    for nm in ("converged", "cumulative_iterations"):
        assert torch.equal(getattr(res, nm), getattr(jres, nm)), nm
    torch.testing.assert_close(res.total_costs, jres.total_costs,
                               rtol=TRIP_TOL, atol=TRIP_TOL)
    torch.testing.assert_close(res.op.xs, jres.op.xs, rtol=TRIP_TOL,
                               atol=TRIP_TOL)



def test_reachability_trips_from_the_jax_carry():
    """Four fused trips with the exec main's parameters, each from the JAX
    machine's carry before it."""
    _trips_match_jax("three_player_intersection_reachability")
