"""The kernels at the driving games' shapes:

- the layout (no JAX): K2's library at the roundabout (x = 24, P = 4:
  W = 33 columns, 4 lanes a block, its shared memory the layout's), the
  flagship's K2 and cost-table defines unchanged, the cost table's
  capacity and bytes at 44 atoms (a build for 48), the semiquadratic atom
  in the table, K1's car_5d Jacobian outside CT_REACH, every game's
  libraries;
- the plain versions against the JAX package (its Pallas kernels in
  interpret mode, imported inside a fixture): `lin_quad_plain` (K1's) at
  the roundabout's and both modified games' dims within 1e-5 at lane
  times t0 = 0.3 (the reachability one with its extremal gate), and
  `lq_backward_plain` (K2's) at x = 24, P = 4 in the per-trip class of
  tests/test_torch_lq.py (the pivoted LU against the JAX kernel's);
- on the card (marker `cuda`, skipped here): K1 within 1e-5 and K2, K3,
  K4, K5 and K6 bit for bit against their plain versions at the
  roundabout's dims (B = 5 and 37: part-filled K2 blocks of 4 lanes),
  the modified intersection's (car_5d in K1 without CT_REACH) and the
  skeleton's (P = 1), on operands made from a seed with a NaN lane.
"""

import ctypes
import types

import numpy as np
import pytest
import torch

import ilqgames_tpu_torch.examples as ex
from ilqgames_tpu_torch import bench
from ilqgames_tpu_torch.costs import player_cost as pcost
from ilqgames_tpu_torch.ops.cuda import cost_table as ct
from ilqgames_tpu_torch.ops.cuda import lq, stage, sweep
from ilqgames_tpu_torch.ops.cuda.layout import mb
from ilqgames_tpu_torch.types import OperatingPoint

torch.set_num_threads(1)

N, B = 11, 4
FLAGSHIP_LQ = {"LQ_X": 16, "LQ_P": 3, "LQ_U": 2, "LQ_G": 8,
               "LQ_SMEM": 160896, "LQ_FWD_G": 16, "LQ_FWD_SMEM": 70784}


def test_k2_library_at_the_roundabout():
    """W = Pu + x + 1 = 33 columns; eight lanes need 429,184 B of shared
    memory, above a block's, so K2 runs four (the lane stride padded to 8
    more than a multiple of 32 floats for the staging's banks); the
    flagship's and the overtaking's stay at eight."""
    spec = ex.get("roundabout_merging")().spec
    assert spec.num_players * spec.umax + spec.xdim + 1 == 33
    assert lq.backward_smem_bytes(spec, 8) == 429184 > lq.SMEM_LIMIT
    name, d = lq.library(spec)
    assert (name, d["LQ_G"]) == ("lq", 4) == ("lq", lq.lanes_per_block(spec))
    assert d["LQ_SMEM"] == lq.backward_smem_bytes(spec, 4) == 4 * 4 * 13416
    assert 13416 % 32 == 8 and d["LQ_SMEM"] <= lq.SMEM_LIMIT
    assert d["LQ_FWD_SMEM"] == lq.forward_smem_bytes(spec) == 152064
    assert lq.library(ex.get("three_player_intersection")().spec) == (
        "lq", FLAGSHIP_LQ)
    for name in ("three_player_overtaking",
                 "modified_three_player_intersection", "skeleton"):
        assert lq.library(ex.get(name)().spec)[1]["LQ_G"] == 8


def test_cost_table_capacity():
    """The roundabout's 44 atoms in a table built for 48 (4,388 B), its
    MinV/MaxV semiquadratics with their dims, weights, thresholds and
    sides; the flagship's table and libraries as before (32 atoms, 2,980
    B, no CT_MAX_ATOMS); a table past the most a build takes is
    refused."""
    p = ex.get("roundabout_merging")()
    tab, segs = ct.cost_table(p.player_costs, p.spec, "cpu")
    assert (tab.n, tab.capacity, ctypes.sizeof(tab)) == (44, 48, 4388)
    assert ct.capacity(p.player_costs, p.spec) == 48
    assert type(tab) is ct.table_type(48)
    semi = [tab.atom[n] for n in range(tab.n)
            if tab.atom[n].kind == ct.KIND["semiquadratic"]]
    assert [(a.player, a.dim[0], a.w, a.aux, a.right) for a in semi] == [
        (i, 6 * i + 4, 1000.0, thr, right) for i in range(4)
        for thr, right in ((1.0, 0), (12.0, 1))]
    assert ct.has_semi(p.player_costs)
    f = ex.get("three_player_intersection")()
    ftab, _ = ct.cost_table(f.player_costs, f.spec, "cpu")
    assert (ftab.capacity, ctypes.sizeof(ftab)) == (32, 2980)
    assert type(ftab) is ct.CostTable
    for _, d in bench.kernel_libraries(f.dynamics, f.spec, f.player_costs):
        assert not {"CT_MAX_ATOMS", "CT_SEMI", "CT_CAR5D"} & set(d)
    for name, d in bench.kernel_libraries(p.dynamics, p.spec,
                                          p.player_costs):
        if name in ("stage", "merit"):
            assert (d["CT_MAX_ATOMS"], d["CT_SEMI"]) == (48, 1)
    assert ct._capacity_of(33) == 40 and ct._capacity_of(32) == 32
    with pytest.raises(NotImplementedError, match="at most 256"):
        ct._capacity_of(257)


def test_car_5d_jacobian_outside_reach():
    """The modified intersection (car_5d, a SUM game) builds K1 with
    car_5d's Jacobian and the semiquadratic atom but without the
    reachability features; its reachability counterpart with both."""
    m = ex.get("modified_three_player_intersection")()
    r = ex.get("three_player_intersection_reachability")()
    assert stage.has_car5d(m.dynamics) and not ct.has_reach(m.player_costs)
    assert stage.features(m.dynamics, m.player_costs, m.spec) == dict(
        reach=False, diff=False, dubins=False, semi=True, car5d=True,
        atoms=32, polysd=False, coupled=False, route=False, zoo=False)
    d = bench.kernel_libraries(m.dynamics, m.spec, m.player_costs)[0][1]
    assert (d["CT_CAR5D"], d["CT_SEMI"]) == (1, 1) and "CT_REACH" not in d
    d = bench.kernel_libraries(r.dynamics, r.spec, r.player_costs)[0][1]
    assert (d["CT_CAR5D"], d["CT_SEMI"], d["CT_REACH"]) == (1, 1, 1)
    o = ex.get("three_player_overtaking")()
    assert stage.features(o.dynamics, o.player_costs, o.spec) == dict(
        reach=False, diff=False, dubins=False, semi=False, car5d=False,
        atoms=32, polysd=False, coupled=False, route=False, zoo=False)


def _operands(name, n, b, device, seed, t0=None, nan=True):
    """Batch-minor operands of a game's kernels from a seed: states near
    its x0 (with `nan`, the last lane NaN from knot 3), controls, a small
    strategy, mu, the lanes' times and, for a MAX game, its extremal
    gate."""
    prob = ex.get(name)(num_time_steps=n)
    spec = prob.spec
    x, P, u = spec.xdim, spec.num_players, spec.umax
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    t = lambda a: torch.tensor(np.ascontiguousarray(a, np.float32),
                               device=device)
    xs = prob.x0.numpy()[None, :, None] + np.cumsum(0.3 * f(n, x, b), 0)
    if nan:
        xs[3:, :, -1] = np.nan
    op = {"xs": t(xs), "us": t(0.3 * f(n, P * u, b)),
          "t0": t(np.full((1, b), t0, np.float32) if t0 is not None
                  else rng.rand(1, b))}
    st = {"Ps": t(0.05 * f(n, P * u, x, b)), "alphas": t(0.1 * f(n, P * u,
                                                                   b))}
    gate = None
    if not pcost.all_sum(prob.player_costs):
        ref = OperatingPoint(xs=mb(op["xs"], b), us=mb(op["us"], b).reshape(
            b, n, P, u), t0=op["t0"][0])
        _, ks = pcost.total_costs(prob.player_costs, spec, ref)
        gate = pcost.extreme_gate(prob.player_costs, spec, ks).permute(
            1, 2, 0).contiguous()
    x0m = t(prob.x0.numpy()[:, None] + 0.1 * f(x, b))
    return prob, x0m, op, st, t(np.full((1, b), 10.0)), gate


@pytest.fixture(scope="module")
def jx():
    """The JAX package's pieces these parity tests use."""
    pytest.importorskip("jax")
    return types.SimpleNamespace(
        jnp=pytest.importorskip("jax.numpy"),
        jex=pytest.importorskip("ilqgames_tpu.examples"),
        jstage=pytest.importorskip("ilqgames_tpu.ops.pallas.stage"),
        jlq=pytest.importorskip("ilqgames_tpu.ops.pallas.lq"))


@pytest.mark.parametrize("name", ["roundabout_merging",
                                  "modified_three_player_intersection",
                                  "three_player_intersection_reachability"])
def test_lin_quad_plain_matches_jax(jx, name):
    """K1's plain version (linearize and quadraticize at each lane's
    t0 + k dt) against the JAX package's fused stage kernel in interpret
    mode, within 1e-5."""
    jnp = jx.jnp
    prob, _, op, _, mu, gate = _operands(name, N, B, "cpu", 5, t0=0.3,
                                         nan=False)
    jprob = jx.jex.get(name)(num_time_steps=N)
    spec = prob.spec
    got = stage.lin_quad_plain(prob.dynamics, prob.player_costs, spec, op,
                               None, None, mu, gate)
    jgate = (jnp.ones((N, spec.num_players, B), jnp.float32) if gate is None
             else jnp.asarray(gate.numpy()))
    ref = jx.jstage.lin_quad_pallas(
        jprob.dynamics, jprob.player_costs, spec,
        {k: jnp.asarray(v.numpy()) for k, v in op.items()}, None, None,
        jnp.asarray(mu.numpy()), jgate, batch_block=B, interpret=True)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_lq_backward_plain_matches_jax_at_the_roundabout(jx):
    """K2's plain version at x = 24, P = 4 (its LU over 8 rows of 33
    columns) against the JAX package's backward kernel in interpret mode,
    on the roundabout's LQ operands at a random operating point: the
    per-trip class (the pivoted LUs in their own orders)."""
    jnp = jx.jnp
    prob, _, op, _, mu, _ = _operands("roundabout_merging", N, B, "cpu", 6,
                                      nan=False)
    spec = prob.spec
    ops = stage.lin_quad_plain(prob.dynamics, prob.player_costs, spec, op,
                               None, None, mu)
    Ps, alphas = lq.lq_backward_plain(spec, ops)
    dx0 = torch.zeros((spec.xdim, B))
    jPs, jal, _ = jx.jlq.solve_lq_feedback_bm(
        spec, {k: jnp.asarray(v.numpy()) for k, v in ops.items()},
        jnp.asarray(dx0.numpy()), batch_block=B, interpret=True)
    assert Ps.shape == (N - 1, 8, 24, B)
    np.testing.assert_allclose(Ps.numpy(), np.asarray(jPs), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(alphas.numpy(), np.asarray(jal), rtol=2e-4,
                               atol=2e-4)


def _same_bits(got, want):
    nan = want.isnan()
    assert torch.equal(got.isnan(), nan)
    assert torch.equal(got.view(torch.int32)[~nan],
                       want.view(torch.int32)[~nan])


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")


@pytest.mark.cuda
@pytest.mark.parametrize("name,C,b", [
    ("roundabout_merging", 1, 37), ("roundabout_merging", 8, 5),
    ("modified_three_player_intersection", 8, 8), ("skeleton", 1, 8)])
def test_driving_kernels_on_card(name, C, b):
    """K1 within 1e-5 of its plain version (bitwise expected), K2 and K3
    on its output, K4, K5 and K6 against their plain versions bit for
    bit, and K5 == K4 + K6."""
    _needs_card()
    prob, x0m, op, st, mu, gate = _operands(name, 100, b, "cuda", C + b)
    dyn, costs, spec = prob.dynamics, prob.player_costs, prob.spec
    got = stage.lin_quad(dyn, costs, spec, op, None, None, mu, gate)
    want = stage.lin_quad_plain(dyn, costs, spec, op, None, None, mu, gate)
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
                              None, mu, gate)
    _same_bits(m5, sweep.rollout_merits_plain(dyn, costs, spec, x0m, op, st,
                                              scal, None, None, mu, gate))
    us_c = sweep._us_from_xs(spec, xs, op, st, scal)
    m6 = sweep.consumer_merits(costs, spec, xs, us_c, op["t0"], None, None,
                               mu, gate)
    torch.cuda.synchronize()
    _same_bits(m6, sweep.merit_plain(costs, spec, xs, us_c, op["t0"], None,
                                     None, mu, gate))
    _same_bits(m5, m6)
