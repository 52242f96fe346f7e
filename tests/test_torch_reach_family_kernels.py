"""The kernels at the shapes of the first half of the reachability
family (one-player reachability: x = 3, P = 1, u = 1; the two-car
collision-avoidance game: x = 10, P = 2, u = 2; modified_air_3d: x = 8,
P = 2, u = 2):

- the layout (no JAX): each game's cost table (the polyline
  signed-distance atom's kind, dims, segment rows, shortcut rows at
  `fix0` after the 7-float segment rows, flip and nominal; the shared
  signed distance once per player; the quadratic differences at +-1e6
  with the state regularization), the two point masses as one linear
  subsystem with its terms at their offsets (K4/K5's SW_LIN_* defines,
  K1's constant Jacobian entries), and each game's libraries and flags
  (CT_POLYSD only where a game has the atom: the flagship's and config
  5's libraries are unchanged);
- the plain version of K1 against the JAX package's fused stage kernel
  in interpret mode, within 1e-5, on the one-player game (with live
  control multipliers and its extremal gate), on the collision game and
  on modified_air_3d, at lane times t0 = 0.3;
- on the card (marker `cuda`, skipped here): K1 within 1e-5 (bitwise
  expected) and K2 (P = 1 at the one-player game), K3, K4, K5 and K6
  against their plain versions bit for bit, and K5 == K4 + K6, on
  operands made from a seed (queries at the circle's vertices and inside
  it, a NaN lane).
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
from ilqgames_tpu_torch.types import OperatingPoint

torch.set_num_threads(1)

N, B = 11, 4
ONE, COLL, AIR = ("one_player_reachability",
                  "two_player_collision_avoidance_reachability",
                  "modified_air_3d")


def test_one_player_cost_table():
    p = ex.get(ONE)()
    tab, segs = ct.cost_table(p.player_costs, p.spec, "cpu")
    K = ct.KIND
    assert tab.n == 4 and tab.capacity == 32
    assert [tab.atom[n].kind for n in range(4)] == [
        K["polyline_signed_distance"], K["quadratic"],
        K["single_dimension"], K["single_dimension"]]
    a = tab.atom[0]
    assert (a.player, a.on, a.dim[0], a.dim[1]) == (0, -1, 0, 1)
    assert (a.seg0, a.nseg, a.fix0, a.aux, a.aux2) == (0, 10, 70, 1.0, 1.0)
    circle = geometry.draw_circle((0.0, 0.0), 2.0, 10)
    _, rows = geometry._static_segments(circle)
    want = [v for p1, p2, u, ln in rows for v in p1 + p2 + u + (ln,)]
    want += [v for row in geometry.shortcut_segments(circle) for v in row]
    assert segs.shape == (150,)
    assert segs.tolist() == torch.tensor(want, dtype=torch.float32).tolist()
    assert [(tab.atom[n].on, tab.atom[n].lam, tab.atom[n].aux)
            for n in (2, 3)] == [(0, 0, 1.0), (0, 1, -1.0)]
    assert tab.extremal[0] == 1
    assert ct.has_polysd(p.player_costs) and ct.has_reach(p.player_costs)


def test_collision_reach_cost_table():
    p = ex.get(COLL)()
    tab, _ = ct.cost_table(p.player_costs, p.spec, "cpu")
    K = ct.KIND
    assert tab.n == 6
    for i in range(2):
        rows = [tab.atom[n] for n in range(3 * i, 3 * i + 3)]
        assert [a.kind for a in rows] == [K["signed_distance"]] + [
            K["quadratic"]] * 2
        assert [a.player for a in rows] == [i] * 3
        assert tuple(rows[0].dim) == (0, 1, 5, 6)
        assert rows[0].w == 1.0 and rows[0].group == 0
        nominal = p.player_costs[i].state_costs[0].device[1]["nominal"]
        assert rows[0].aux == np.float32(nominal)
        assert [(a.on, a.dim[0]) for a in rows[1:]] == [(i, 0), (i, 1)]
        assert tab.extremal[i] == 1
    assert not ct.has_polysd(p.player_costs)


def test_modified_air_3d_layout():
    p = ex.get(AIR)()
    tab, _ = ct.cost_table(p.player_costs, p.spec, "cpu")
    K = ct.KIND
    assert [tab.atom[n].kind for n in range(tab.n)] == [
        K["quadratic_difference"], K["quadratic"], K["quadratic"]] * 2
    assert [(tab.atom[n].w, tuple(tab.atom[n].dim)) for n in (0, 3)] == [
        (-1e6, (0, 1, 4, 5)), (1e6, (0, 1, 4, 5))]
    assert list(tab.state_reg)[:2] == [1.0, 1.0]
    assert list(tab.extremal)[:2] == [0, 0]
    dyn, spec = p.dynamics, p.spec
    sub = sweep._device_table(dyn, spec)
    assert (sub.n, sub.kind[0]) == (1, models.KIND_LINEAR)
    entries = {(sub.lin_u[e], sub.lin_row[e], sub.lin_col[e]): sub.lin_val[e]
               for e in range(sub.nlin)}
    dt = np.float32(spec.dt)
    want = {(0, d, d): 1.0 for d in range(8)}
    want.update({(0, o, o + 2): dt for o in (0, 1, 4, 5)})
    want.update({(1, o + 2 + c, 2 * i + c): dt
                 for i, o in enumerate((0, 4)) for c in (0, 1)})
    assert entries == pytest.approx(want) and len(entries) == sub.nlin == 16
    _, d = sweep.library(dyn, spec)
    assert d["SW_NSUB"] == 1 and d["SW_SUB_DIM"] == "SW_ITEM(8)"
    assert d["SW_SUB_UROWS"] == "SW_ITEM(4)" and d["SW_NLIN"] == 8
    assert d["SW_LIN_ROW"] == "".join(f"SW_ITEM({r})" for r in range(8))
    assert d["SW_LIN_SRC"] == "".join(
        f"SW_ITEM({s})" for s in (2, 3, 8, 9, 6, 7, 10, 11))
    assert d["SW_LIN_COEF"] == "SW_ITEM(0x1.0000000000000p+0f)" * 8
    assert d["SW_LIN_ZERO"] == 0 and "SW_MIN_BLOCKS" not in d


def test_libraries_and_flags():
    """Each game's K1, K5 and K6 flags; the polyline signed-distance atom
    compiles into no other game's kernels."""
    feats = {n: stage.features(g.dynamics, g.player_costs, g.spec)
             for n, g in ((n, ex.get(n)()) for n in (ONE, COLL, AIR))}
    base = dict(reach=False, diff=False, dubins=False, semi=False,
                car5d=False, atoms=32, polysd=False, coupled=False,
                route=False, zoo=False)
    assert feats[ONE] == dict(base, reach=True, dubins=True, polysd=True)
    assert feats[COLL] == dict(base, reach=True, car5d=True)
    assert feats[AIR] == dict(base, diff=True)
    one = ex.get(ONE)()
    mf = sweep.merit_features(one.player_costs, one.spec)
    assert (mf["reach"], mf["polysd"]) == (True, True)
    for name, d in bench.kernel_libraries(one.dynamics, one.spec,
                                          one.player_costs):
        if name in ("stage", "merit"):
            assert d["CT_POLYSD"] == 1
    for game in ("three_player_intersection",
                 "three_player_collision_avoidance_reachability",
                 "roundabout_merging", COLL, AIR):
        g = ex.get(game)()
        for _, d in bench.kernel_libraries(g.dynamics, g.spec,
                                           g.player_costs):
            assert "CT_POLYSD" not in d, game
    name, d = lq.library(one.spec)
    assert (d["LQ_X"], d["LQ_P"], d["LQ_U"]) == (3, 1, 1)


def _operands(name, n, b, device, seed, t0=None, nan=True):
    """Batch-minor operands of a game's kernels from a seed: states near
    its x0 (for the one-player game some knots at the circle's vertices
    and inside it; with `nan`, the last lane NaN from knot 3), controls, a
    small strategy, live control multipliers where the game has control
    constraints, mu, the lanes' times and, for a MAX game, its extremal
    gate."""
    prob = ex.get(name)(num_time_steps=n)
    spec = prob.spec
    x, P, u = spec.xdim, spec.num_players, spec.umax
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    t = lambda a: torch.tensor(np.ascontiguousarray(a, np.float32),
                               device=device)
    xs = prob.x0.numpy()[None, :, None] + np.cumsum(0.3 * f(n, x, b), 0)
    if name == ONE:
        circle = geometry.draw_circle((0.0, 0.0), 2.0, 10)
        xs[1, :2, :] = circle[np.arange(b) % 11].T
        xs[2, :2, :] = 0.5 * xs[2, :2, :] / np.abs(xs[2, :2, :]).max()
    if nan:
        xs[3:, :, -1] = np.nan
    op = {"xs": t(xs), "us": t(0.3 * f(n, P * u, b)),
          "t0": t(np.full((1, b), t0, np.float32) if t0 is not None
                  else rng.rand(1, b))}
    st = {"Ps": t(0.05 * f(n, P * u, x, b)),
          "alphas": t(0.1 * f(n, P * u, b))}
    nC = sum(len(pc.control_constraints) for pc in prob.player_costs)
    lamC = (t(np.abs(f(n, nC, b)) * (rng.rand(n, nC, b) < 0.5)) if nC
            else None)
    gate = None
    if not pcost.all_sum(prob.player_costs):
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


@pytest.mark.parametrize("name", [ONE, COLL, AIR])
def test_lin_quad_plain_matches_jax(jx, name):
    """K1's plain version (linearize and quadraticize at each lane's
    t0 + k dt) against the JAX package's fused stage kernel in interpret
    mode, within 1e-5."""
    jnp = jx.jnp
    prob, _, op, _, lamC, mu, gate = _operands(name, N, B, "cpu", 5,
                                               t0=0.3, nan=False)
    jprob = jx.jex.get(name)(num_time_steps=N)
    spec = prob.spec
    got = stage.lin_quad_plain(prob.dynamics, prob.player_costs, spec, op,
                               None, lamC, mu, gate)
    jgate = (jnp.ones((N, spec.num_players, B), jnp.float32) if gate is None
             else jnp.asarray(gate.numpy()))
    ref = jx.jstage.lin_quad_pallas(
        jprob.dynamics, jprob.player_costs, spec,
        {k: jnp.asarray(v.numpy()) for k, v in op.items()}, None,
        None if lamC is None else jnp.asarray(lamC.numpy()),
        jnp.asarray(mu.numpy()), jgate, batch_block=B, interpret=True)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def _same_bits(got, want):
    nan = want.isnan()
    assert torch.equal(got.isnan(), nan)
    assert torch.equal(got.view(torch.int32)[~nan],
                       want.view(torch.int32)[~nan])


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")


@pytest.mark.cuda
@pytest.mark.parametrize("name,C,b", [(ONE, 1, 37), (ONE, 8, 5),
                                      (COLL, 8, 8), (COLL, 1, 40),
                                      (AIR, 1, 8), (AIR, 8, 3)])
def test_reach_family_kernels_on_card(name, C, b):
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
