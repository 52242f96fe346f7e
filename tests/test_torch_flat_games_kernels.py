"""The kernels at the shapes of the flat driving games
(three_player_flat_overtaking: three flat car_6d, x = 18, P = 3, 24 cost
atoms; flat_roundabout_merging: four flat car_6d, x = 24, P = 4, 32 cost
atoms):

- the layout (no JAX): each game's constant linear system as one linear
  subsystem per player with its 36 and 48 constant Jacobian entries (six
  diagonal, four off it and two in B a car) in the SubsysTable, whose
  capacity MAX_LIN is 48 in the ctypes struct as in csrc/costs.cuh; K4's
  and K5's defines; each game's cost table with the route-progress atoms
  (their segment rows and start lengths as the host sums them); each
  game's flags (CT_ROUTE only where a game has a route-progress atom: the
  earlier games' libraries are unchanged); K1's plain version's A and Bf
  equal the constant linearization;
- the plain version of K1 against the JAX package's fused stage kernel in
  interpret mode, within 1e-5, on the flat overtaking at lane times t0 in
  [0, 1) (the route atoms read them);
- on the card (marker `cuda`, skipped here): K1 within 1e-5 (bitwise
  expected) and K2, K3, K4, K5 and K6 against their plain versions bit
  for bit, and K5 == K4 + K6, on operands made from a seed (positions at
  the routes' vertices, a NaN lane).
"""

import ctypes
import types

import numpy as np
import pytest
import torch

import ilqgames_tpu_torch.examples as ex
from ilqgames_tpu_torch import bench, geometry
from ilqgames_tpu_torch.dynamics import base as dyn_base
from ilqgames_tpu_torch.dynamics import flat
from ilqgames_tpu_torch.dynamics.models import KIND_LINEAR
from ilqgames_tpu_torch.ops.cuda import cost_table as ct
from ilqgames_tpu_torch.ops.cuda import lq, stage, sweep

torch.set_num_threads(1)

N, B = 11, 4
OVER, ROUND = "three_player_flat_overtaking", "flat_roundabout_merging"


@pytest.mark.parametrize("name,P,nlin", [(OVER, 3, 36), (ROUND, 4, 48)])
def test_flat_games_subsystem_tables(name, P, nlin):
    p = ex.get(name)()
    dyn, spec = p.dynamics, p.spec
    tab = sweep._device_table(dyn, spec)
    assert tab.n == P and tab.nlin == nlin <= sweep._MAX_LIN == 48
    assert [tab.kind[s] for s in range(P)] == [KIND_LINEAR] * P
    assert [tab.xoff[s] for s in range(P)] == [6 * s for s in range(P)]
    assert [sweep._control_rows(tab, s, spec) for s in range(P)] == [
        (2 * s, 2 * s + 2) for s in range(P)]
    a_acc, b_acc = dyn_base.constant_linearization(dyn, spec)
    entries = [(tab.lin_u[e], tab.lin_row[e], tab.lin_col[e], tab.lin_val[e])
               for e in range(tab.nlin)]
    f32 = lambda v: ctypes.c_float(v).value
    assert entries == ([(0, r, c, f32(v)) for (r, c), v in a_acc.items()]
                       + [(1, r, q * 2 + c, f32(v))
                          for (q, r, c), v in b_acc.items()])
    assert sum(1 for u, r, c, _ in entries if not u and r == c) == 6 * P
    assert sum(1 for u, *_ in entries if u) == 2 * P
    _, d = sweep.library(dyn, spec)
    assert d["SW_NSUB"] == P and d["SW_SUB_DIM"] == "SW_ITEM(6)" * P
    assert d["SW_SUB_UROWS"] == "SW_ITEM(2)" * P
    assert (d["SW_NLIN"], d["SW_LIN_ZERO"], d["SW_MIN_BLOCKS"]) == (
        6 * P, 1, 1)
    assert "CT_ROUTE" not in d


def test_subsys_table_holds_48_entries():
    """The ctypes SubsysTable is csrc/costs.cuh's: MAX_LIN = 48 entries of
    (lin_u, lin_row, lin_col, lin_val) after n, five per-subsystem fields
    and nlin; a system of more entries is refused."""
    names = [f[0] for f in sweep._SubsysTable._fields_]
    assert names == ["n", "kind", "xoff", "uoff", "length", "param2", "nlin",
                     "lin_u", "lin_row", "lin_col", "lin_val"]
    assert ctypes.sizeof(sweep._SubsysTable) == 4 + 5 * 8 * 4 + 4 + 4 * 48 * 4
    five = flat.concatenate_flat("five", [flat.flat_car_6d(4.0)] * 5)
    with pytest.raises(NotImplementedError, match="more than 48"):
        sweep._device_table(five, five.spec(num_time_steps=N))


@pytest.mark.parametrize("name,P,n_atoms", [(OVER, 3, 24), (ROUND, 4, 32)])
def test_route_cost_table(name, P, n_atoms):
    p = ex.get(name)()
    tab, segs = ct.cost_table(p.player_costs, p.spec, "cpu")
    assert tab.n == n_atoms and tab.capacity == ct.MAX_ATOMS
    assert ct.has_route(p.player_costs) and not ct.has_norms(p.player_costs)
    K = ct.KIND
    per = [K["polyline"], K["semiquadratic_polyline"],
           K["semiquadratic_polyline"], K["route_progress"],
           K["proximity_cost"], K["proximity_cost"], K["quadratic"],
           K["quadratic"]]
    assert [tab.atom[n].kind for n in range(tab.n)] == per * P
    for i, pc in enumerate(p.player_costs):
        a = tab.atom[8 * i + 3]
        prm = pc.state_costs[3].device[1]
        assert (a.player, a.on, a.dim[0], a.dim[1]) == (i, -1, 6 * i,
                                                        6 * i + 1)
        assert (a.w, a.aux, a.aux2) == (prm["weight"],
                                        prm["initial_route_pos"],
                                        prm["nominal_speed"])
        _, rows = geometry._static_segments(prm["points"])
        assert a.nseg == len(rows)
        want = [v for p1, p2, u, ln in rows for v in p1 + p2 + u + (ln,)]
        got = segs[7 * a.seg0:7 * (a.seg0 + a.nseg)]
        assert got.tolist() == torch.tensor(want).tolist()
        # The start lengths: a Python float sum of the float32 lengths,
        # rounded to float32 once, as polyline_point_at compares them.
        starts, cum = [], 0.0
        for *_, ln in rows:
            starts.append(cum)
            cum += ln
        assert segs[a.fix0:a.fix0 + a.nseg].tolist() == torch.tensor(
            starts).tolist()


def test_libraries_and_flags():
    """CT_ROUTE in K1, K5 and K6 of the flat games only; K4 and the earlier
    games' libraries are built without it."""
    for name in (OVER, ROUND):
        g = ex.get(name)()
        f = stage.features(g.dynamics, g.player_costs, g.spec)
        assert f == dict(reach=False, diff=False, dubins=False, semi=False,
                         car5d=False, atoms=32, polysd=False, coupled=False,
                         route=True, zoo=False)
        libs = bench.kernel_libraries(g.dynamics, g.spec, g.player_costs)
        assert [d.get("CT_ROUTE") for _, d in libs] == [1, None, 1, None, 1]
    for game in ("three_player_intersection", "three_player_flat_intersection",
                 "roundabout_merging", "three_player_overtaking",
                 "air_3d", "one_player_reachability"):
        g = ex.get(game)()
        assert not ct.has_route(g.player_costs)
        for _, d in bench.kernel_libraries(g.dynamics, g.spec,
                                           g.player_costs):
            assert "CT_ROUTE" not in d, game
    for name, (x, p, u) in ((OVER, (18, 3, 2)), (ROUND, (24, 4, 2))):
        _, d = lq.library(ex.get(name)().spec)
        assert (d["LQ_X"], d["LQ_P"], d["LQ_U"]) == (x, p, u)


def _operands(name, n, b, device, seed, nan=True):
    """Batch-minor operands of a game's kernels from a seed: positions
    near its x0 drifting over the knots with knot 1 on the lanes' vertices,
    controls, a small strategy, mu and the lanes' times in [0, 1) (with
    `nan`, the last lane NaN from knot 3)."""
    prob = ex.get(name)(num_time_steps=n)
    spec = prob.spec
    x, Pu = spec.xdim, len(spec.xdims) * spec.umax
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    t = lambda a: torch.tensor(np.ascontiguousarray(a, np.float32),
                               device=device)
    xs = prob.x0.numpy()[None, :, None] + np.cumsum(0.5 * f(n, x, b), 0)
    for i, pc in enumerate(prob.player_costs):
        pts = pc.state_costs[0].device[1]["points"]
        xs[1, 6 * i:6 * i + 2, :] = pts[np.arange(b) % len(pts)].T
    if nan:
        xs[3:, :, -1] = np.nan
    op = {"xs": t(xs), "us": t(2.0 * f(n, Pu, b)), "t0": t(rng.rand(1, b))}
    st = {"Ps": t(0.05 * f(n, Pu, x, b)), "alphas": t(0.1 * f(n, Pu, b))}
    x0m = t(prob.x0.numpy()[:, None] + 0.1 * f(x, b))
    return prob, x0m, op, st, t(np.full((1, b), 10.0))


def test_lin_quad_plain_linear_jacobian():
    """K1's plain version on a flat system: A and Bf the constant
    linearization at every knot and lane, whatever the state."""
    prob, _, op, _, mu = _operands(ROUND, N, B, "cpu", 1)
    spec = prob.spec
    got = stage.lin_quad_plain(prob.dynamics, prob.player_costs, spec, op,
                               None, None, mu)
    a_acc, b_acc = dyn_base.constant_linearization(prob.dynamics, spec)
    A = torch.zeros(spec.xdim, spec.xdim)
    Bf = torch.zeros(spec.xdim, 8)
    for (r, c), v in a_acc.items():
        A[r, c] = v
    for (q, r, c), v in b_acc.items():
        Bf[r, 2 * q + c] = v
    assert torch.equal(got["A"], A[None, :, :, None].expand_as(got["A"]))
    assert torch.equal(got["Bf"], Bf[None, :, :, None].expand_as(got["Bf"]))


@pytest.fixture(scope="module")
def jx():
    """The JAX package's pieces these parity tests use."""
    pytest.importorskip("jax")
    return types.SimpleNamespace(
        jnp=pytest.importorskip("jax.numpy"),
        jex=pytest.importorskip("ilqgames_tpu.examples"),
        jstage=pytest.importorskip("ilqgames_tpu.ops.pallas.stage"))


def test_lin_quad_plain_matches_jax(jx):
    """K1's plain version (the constant linearization, quadraticize at
    each lane's t0 + k dt) against the JAX package's fused stage kernel in
    interpret mode, within 1e-5, on the flat overtaking."""
    jnp = jx.jnp
    prob, _, op, _, mu = _operands(OVER, N, B, "cpu", 5, nan=False)
    jprob = jx.jex.get(OVER)(num_time_steps=N)
    spec = prob.spec
    got = stage.lin_quad_plain(prob.dynamics, prob.player_costs, spec, op,
                               None, None, mu)
    ref = jx.jstage.lin_quad_pallas(
        jprob.dynamics, jprob.player_costs, spec,
        {k: jnp.asarray(v.numpy()) for k, v in op.items()}, None, None,
        jnp.asarray(mu.numpy()), jnp.ones((N, 3, B), jnp.float32),
        batch_block=B, interpret=True)
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
@pytest.mark.parametrize("name,C,b", [(OVER, 1, 37), (OVER, 8, 8),
                                      (ROUND, 8, 8), (ROUND, 1, 40)])
def test_flat_game_kernels_on_card(name, C, b):
    """K1 within 1e-5 of its plain version (bitwise expected), K2 and K3
    on its output, K4, K5 and K6 against their plain versions bit for
    bit, and K5 == K4 + K6."""
    _needs_card()
    prob, x0m, op, st, mu = _operands(name, 100, b, "cuda", C + b)
    dyn, costs, spec = prob.dynamics, prob.player_costs, prob.spec
    got = stage.lin_quad(dyn, costs, spec, op, None, None, mu)
    want = stage.lin_quad_plain(dyn, costs, spec, op, None, None, mu)
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
                              None, mu)
    _same_bits(m5, sweep.rollout_merits_plain(dyn, costs, spec, x0m, op, st,
                                              scal, None, None, mu))
    us_c = sweep._us_from_xs(spec, xs, op, st, scal)
    m6 = sweep.consumer_merits(costs, spec, xs, us_c, op["t0"], None, None,
                               mu)
    torch.cuda.synchronize()
    _same_bits(m6, sweep.merit_plain(costs, spec, xs, us_c, op["t0"], None,
                                     None, mu))
    _same_bits(m5, m6)
