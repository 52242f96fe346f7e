"""The kernels at the shapes of the coupled reachability games
(two_player_reachability: two_player_unicycle_4d, x = 4, P = 2, u = 2;
air_3d: x = 3, P = 2, u = 1; both with a player who owns no state):

- the layout (no JAX): each game's subsystem table (one coupled
  subsystem at offset 0 with both speeds of air_3d in `length` and
  `param2`), K4's and K5's defines (one warp over the whole state that
  computes every player's control rows, the parameters as float32 hex
  literals), each game's cost table (the polyline signed-distance atoms
  with their nominals 0.0 and 1.0, both players extremal, air_3d's four
  single_dimension constraints with P2's on its control 0), and each
  game's flags (CT_COUPLED only where a game has a coupled system: the
  earlier games' libraries are unchanged);
- the plain version of K1 against the JAX package's fused stage kernel in
  interpret mode, within 1e-5, on both games with controls away from
  zero (so that air_3d's u-reading Jacobian entries count), live control
  multipliers and the MAX/MIN gate, at lane times t0 = 0.3;
- the port's two-player solve at N=100 with tests/test_golden_more.py's
  parameters (the exec main's, whose state and control regularization of
  1.0 nothing reads: `bench.GOLDEN_RUNS["two_player_reach"]`), one lane
  padded to bench.GOLDEN_BLOCK, on the CPU: the pin (not converged, at
  most 4 iterations, total costs [10.5441, 4.7601] within 2e-3), which
  the JAX package's batched machine meets too (2 iterations,
  [10.544106, 4.760082]);
- on the card (marker `cuda`, skipped here): K1 within 1e-5 (bitwise
  expected) and K2, K3, K4, K5 and K6 against their plain versions bit
  for bit, and K5 == K4 + K6, on operands made from a seed (queries at
  the circle's vertices and inside it, a NaN lane).
"""

import types

import numpy as np
import pytest
import torch

import ilqgames_tpu_torch.examples as ex
from ilqgames_tpu_torch import bench, geometry
from ilqgames_tpu_torch.costs import player_cost as pcost
from ilqgames_tpu_torch.dynamics import models
from ilqgames_tpu_torch.ops.cuda import cost_table as ct
from ilqgames_tpu_torch.ops.cuda import lq, stage, sweep
from ilqgames_tpu_torch.ops.cuda.layout import mb
from ilqgames_tpu_torch.solver import batched
from ilqgames_tpu_torch.solver.params import SolverParams
from ilqgames_tpu_torch.types import OperatingPoint

torch.set_num_threads(1)

N, B = 11, 4
TWO, AIR = "two_player_reachability", "air_3d"
RADIUS = {TWO: 1.0, AIR: 5.0}
# tests/test_golden_more.py:103-121.
PIN_PARAMS = dict(linesearch=True, initial_alpha_scaling=0.1,
                  expected_decrease_fraction=0.1, convergence_tolerance=0.01,
                  max_backtracking_steps=100, state_regularization=1.0,
                  control_regularization=1.0)
PIN_COSTS = (10.5441, 4.7601)


@pytest.mark.parametrize("name,kind,params,x,pu", [
    (TWO, models.KIND_TWO_PLAYER_UNICYCLE_4D, (0.0, 0.0), 4, 4),
    (AIR, models.KIND_AIR_3D, (1.0, 1.0), 3, 2)])
def test_coupled_layout(name, kind, params, x, pu):
    p = ex.get(name)()
    dyn, spec = p.dynamics, p.spec
    assert spec.xdims == (x, 0) and spec.xdim == x
    sub = sweep._device_table(dyn, spec)
    assert (sub.n, sub.kind[0], sub.xoff[0], sub.uoff[0]) == (1, kind, 0, 0)
    assert (sub.length[0], sub.param2[0]) == params
    assert sweep._control_rows(sub, 0, spec) == (0, pu)
    assert sweep._rows(sub, 0, spec) == x
    _, d = sweep.library(dyn, spec)
    assert (d["SW_NSUB"], d["SW_SUB_KIND"]) == (1, f"SW_ITEM({kind})")
    assert d["SW_SUB_DIM"] == f"SW_ITEM({x})"
    assert d["SW_SUB_UROWS"] == f"SW_ITEM({pu})"
    assert (d["SW_SUB_XOFF"], d["SW_SUB_UOFF"]) == ("SW_ITEM(0)",) * 2
    assert d["SW_SUB_LENGTH"] == f"SW_ITEM({sweep._hexf(params[0])})"
    assert d["SW_SUB_PARAM2"] == f"SW_ITEM({sweep._hexf(params[1])})"
    assert "SW_NLIN" not in d


def test_air_3d_speeds_in_their_fields():
    """The evader's speed in `length`, the pursuer's in `param2`, each as
    the defines' hex literals, and the run-time table's copy of them."""
    p = ex.get(AIR)(ve=0.75, vp=1.25)
    sub = sweep._device_table(p.dynamics, p.spec)
    assert (sub.length[0], sub.param2[0]) == (0.75, 1.25)
    _, d = sweep.library(p.dynamics, p.spec)
    assert d["SW_SUB_LENGTH"] == "SW_ITEM(0x1.8000000000000p-1f)"
    assert d["SW_SUB_PARAM2"] == "SW_ITEM(0x1.4000000000000p+0f)"
    names = [f[0] for f in sweep._SubsysTable._fields_]
    assert names.index("param2") == names.index("length") + 1


def test_a_coupled_kind_without_a_device_form_is_refused():
    import dataclasses

    p = ex.get(AIR)()
    for bad in (dataclasses.replace(p.dynamics, kind=models.KIND_CAR_6D),
                dataclasses.replace(p.dynamics, params=(1.0, 1.0, 1.0))):
        with pytest.raises(NotImplementedError, match="no device form"):
            sweep._device_table(bad, p.spec)


@pytest.mark.parametrize("name", [TWO, AIR])
def test_coupled_cost_table(name):
    p = ex.get(name)()
    tab, segs = ct.cost_table(p.player_costs, p.spec, "cpu")
    K = ct.KIND
    n_each = 4 if name == AIR else 3
    assert tab.n == 2 * n_each and tab.capacity == 32
    want = [K["polyline_signed_distance"], K["quadratic"]]
    if name == AIR:
        want += [K["single_dimension"]] * 2
    else:
        want += [K["quadratic"]]
    assert [tab.atom[n].kind for n in range(tab.n)] == want * 2
    circle = geometry.draw_circle((0.0, 0.0), RADIUS[name], 10)
    _, rows = geometry._static_segments(circle)
    seg_rows = [v for p1, p2, u, ln in rows for v in p1 + p2 + u + (ln,)]
    for i, nominal in enumerate((0.0, 1.0)):
        a = tab.atom[i * n_each]
        assert (a.player, a.on, a.dim[0], a.dim[1]) == (i, -1, 0, 1)
        assert (a.nseg, a.aux, a.aux2) == (10, 1.0, nominal)
        got = segs[7 * a.seg0:7 * (a.seg0 + 10)].tolist()
        assert got == torch.tensor(seg_rows, dtype=torch.float32).tolist()
        assert tab.extremal[i] == 1
        if name == AIR:
            cons = [tab.atom[i * n_each + j] for j in (2, 3)]
            assert [(c.player, c.on, c.dim[0], c.lam, c.aux)
                    for c in cons] == [(i, i, 0, 2 * i, 1.0),
                                       (i, i, 0, 2 * i + 1, -1.0)]
        else:
            ctl = [tab.atom[i * n_each + j] for j in (1, 2)]
            assert [(c.on, c.dim[0]) for c in ctl] == [(i, 0), (i, 1)]
    assert [pc.structure for pc in p.player_costs] == [
        pcost.STRUCTURE_MAX, pcost.STRUCTURE_MIN]


def test_libraries_and_flags():
    """CT_COUPLED in K1 only for the coupled games; the earlier games'
    libraries (the flagship's, config 5's, the first half of the
    reachability family's) are built without it."""
    base = dict(reach=True, diff=False, dubins=False, semi=False,
                car5d=False, atoms=32, polysd=True, coupled=True,
                route=False, zoo=False)
    for name in (TWO, AIR):
        g = ex.get(name)()
        assert stage.has_coupled(g.dynamics)
        assert stage.features(g.dynamics, g.player_costs, g.spec) == base
        libs = bench.kernel_libraries(g.dynamics, g.spec, g.player_costs)
        assert libs[0][1]["CT_COUPLED"] == 1
        assert all("CT_COUPLED" not in d for _, d in libs[1:])
    for game in ("three_player_intersection",
                 "three_player_collision_avoidance_reachability",
                 "one_player_reachability", "modified_air_3d",
                 "two_player_point_mass"):
        g = ex.get(game)()
        assert not stage.has_coupled(g.dynamics)
        for _, d in bench.kernel_libraries(g.dynamics, g.spec,
                                           g.player_costs):
            assert "CT_COUPLED" not in d, game
    for name, (x, p, u) in ((TWO, (4, 2, 2)), (AIR, (3, 2, 1))):
        _, d = lq.library(ex.get(name)().spec)
        assert (d["LQ_X"], d["LQ_P"], d["LQ_U"]) == (x, p, u)


def test_two_player_solve_meets_the_pin():
    """tests/test_golden_more.py:103-121's pin, the port alone (the run of
    `bench.run_golden("two_player_reach")` on the CPU)."""
    make, prm = bench.GOLDEN_RUNS["two_player_reach"]
    assert prm == PIN_PARAMS
    prob = make()
    res = batched.make_host_batched_solver(
        prob.dynamics, prob.player_costs, prob.spec, SolverParams(**prm),
        warm_op=prob.initial_operating_point(),
        warm_strategy=prob.initial_strategy(), trips_per_call=20,
        batch_block=bench.GOLDEN_BLOCK)(prob.x0[None])
    assert not bool(res.converged[0])
    assert int(res.cumulative_iterations[0]) <= 4
    np.testing.assert_allclose(res.total_costs[0].numpy(), PIN_COSTS,
                               atol=2e-3, rtol=0)


def _operands(name, n, b, device, seed, t0=None, nan=True):
    """Batch-minor operands of a game's kernels from a seed: states near
    its x0 with some knots at the circle's vertices and inside it (with
    `nan`, the last lane NaN from knot 3), controls away from zero, a
    small strategy, live control multipliers where the game has control
    constraints, mu, the lanes' times and the MAX/MIN gate."""
    prob = ex.get(name)(num_time_steps=n)
    spec = prob.spec
    x, P, u = spec.xdim, spec.num_players, spec.umax
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    t = lambda a: torch.tensor(np.ascontiguousarray(a, np.float32),
                               device=device)
    xs = prob.x0.numpy()[None, :, None] + np.cumsum(0.3 * f(n, x, b), 0)
    circle = geometry.draw_circle((0.0, 0.0), RADIUS[name], 10)
    xs[1, :2, :] = circle[np.arange(b) % 11].T
    xs[2, :2, :] = 0.5 * xs[2, :2, :] / np.abs(xs[2, :2, :]).max()
    if nan:
        xs[3:, :, -1] = np.nan
    us = 0.3 * f(n, P * u, b)
    us = us + np.where(us < 0, -0.2, 0.2).astype(np.float32)
    op = {"xs": t(xs), "us": t(us),
          "t0": t(np.full((1, b), t0, np.float32) if t0 is not None
                  else rng.rand(1, b))}
    st = {"Ps": t(0.05 * f(n, P * u, x, b)),
          "alphas": t(0.1 * f(n, P * u, b))}
    nC = sum(len(pc.control_constraints) for pc in prob.player_costs)
    lamC = (t(np.abs(f(n, nC, b)) * (rng.rand(n, nC, b) < 0.5)) if nC
            else None)
    ref = OperatingPoint(xs=mb(op["xs"], b), us=mb(op["us"], b).reshape(
        b, n, P, u), t0=op["t0"][0])
    _, ks = pcost.total_costs(prob.player_costs, spec, ref)
    gate = pcost.extreme_gate(prob.player_costs, spec, ks).permute(
        1, 2, 0).contiguous()
    x0m = t(prob.x0.numpy()[:, None] + 0.1 * f(x, b))
    return prob, x0m, op, st, lamC, t(np.full((1, b), 10.0)), gate


@pytest.fixture(scope="module")
def jx():
    """The JAX package's pieces these parity tests use."""
    pytest.importorskip("jax")
    return types.SimpleNamespace(
        jnp=pytest.importorskip("jax.numpy"),
        jex=pytest.importorskip("ilqgames_tpu.examples"),
        jstage=pytest.importorskip("ilqgames_tpu.ops.pallas.stage"))


@pytest.mark.parametrize("name", [TWO, AIR])
def test_lin_quad_plain_matches_jax(jx, name):
    """K1's plain version (linearize at the knot's state and controls,
    quadraticize at each lane's t0 + k dt) against the JAX package's fused
    stage kernel in interpret mode, within 1e-5."""
    jnp = jx.jnp
    prob, _, op, _, lamC, mu, gate = _operands(name, N, B, "cpu", 5,
                                               t0=0.3, nan=False)
    jprob = jx.jex.get(name)(num_time_steps=N)
    spec = prob.spec
    got = stage.lin_quad_plain(prob.dynamics, prob.player_costs, spec, op,
                               None, lamC, mu, gate)
    ref = jx.jstage.lin_quad_pallas(
        jprob.dynamics, jprob.player_costs, spec,
        {k: jnp.asarray(v.numpy()) for k, v in op.items()}, None,
        None if lamC is None else jnp.asarray(lamC.numpy()),
        jnp.asarray(mu.numpy()), jnp.asarray(gate.numpy()), batch_block=B,
        interpret=True)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    if name == AIR:
        # df/dx reads the evader's turn rate: A[0, 1] = dt * w1.
        w1 = op["us"][:, 0]
        np.testing.assert_allclose(got["A"][:, 0, 1].numpy(),
                                   (spec.dt * w1).numpy(), rtol=1e-6)
        assert (got["A"][:, 0, 1] != 0).all()


def _same_bits(got, want):
    nan = want.isnan()
    assert torch.equal(got.isnan(), nan)
    assert torch.equal(got.view(torch.int32)[~nan],
                       want.view(torch.int32)[~nan])


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")


@pytest.mark.cuda
@pytest.mark.parametrize("name,C,b", [(TWO, 1, 37), (TWO, 8, 5),
                                      (AIR, 8, 8), (AIR, 1, 40)])
def test_coupled_kernels_on_card(name, C, b):
    """K1 within 1e-5 of its plain version (bitwise expected), K2 and K3
    on its output, K4, K5 and K6 against their plain versions bit for
    bit, and K5 == K4 + K6."""
    _needs_card()
    prob, x0m, op, st, lamC, mu, gate = _operands(name, 100, b, "cuda",
                                                  C + b)
    dyn, costs, spec = prob.dynamics, prob.player_costs, prob.spec
    got = stage.lin_quad(dyn, costs, spec, op, None, lamC, mu, gate)
    want = stage.lin_quad_plain(dyn, costs, spec, op, None, lamC, mu, gate)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-5,
                                   equal_nan=True)
    Ps, al = lq.lq_backward(spec, want)
    wPs, wal = lq.lq_backward_plain(spec, want)
    _same_bits(Ps, wPs)
    _same_bits(al, wal)
    dx0 = (x0m - op["xs"][0]).contiguous()
    _same_bits(lq.lq_forward(spec, want["A"], want["Bf"], al, dx0),
               lq.lq_forward_plain(spec, want["A"], want["Bf"], al, dx0))
    scal = torch.full((C, b), 0.5, device="cuda")
    xs, us = sweep.rollout_bm(dyn, spec, x0m, op, st, scal, emit_us=True)
    ref = sweep.rollout_plain(dyn, spec, x0m, op, st, scal, emit_us=True)
    _same_bits(xs, ref[0])
    _same_bits(us, ref[1])
    m5 = sweep.rollout_merits(dyn, costs, spec, x0m, op, st, scal, None,
                              lamC, mu, gate)
    _same_bits(m5, sweep.rollout_merits_plain(dyn, costs, spec, x0m, op, st,
                                              scal, None, lamC, mu, gate))
    us_c = sweep._us_from_xs(spec, xs, op, st, scal)
    m6 = sweep.consumer_merits(costs, spec, xs, us_c, op["t0"], None, lamC,
                               mu, gate)
    torch.cuda.synchronize()
    _same_bits(m6, sweep.merit_plain(costs, spec, xs, us_c, op["t0"], None,
                                     lamC, mu, gate))
    _same_bits(m5, m6)
