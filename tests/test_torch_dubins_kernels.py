"""The kernel layout of dubins_origin and of K7, the open-loop LQ sweep:
dubins_car as two warps of three rows (its speed as the subsystem's
parameter), the quadratic_difference atom in the cost table, the
libraries built with CT_DIFF (K1, K5, K6) and CT_DUBINS (K1) and K7's
library (and the other games' without them), K7's cache size and its
wrapper's refusals. On the card (marker `cuda`, skipped here): K7 against
`lq_open_loop_plain` bit for bit on random operands at dubins_origin's
dims (B = 8, 37 and 1024; N = 100 and a single knot), with padded
controls and at the flagship's dims (a NaN lane among them); K1 against
`lin_quad_plain` (tolerance 1e-5, as chip_smoke.py holds it) and K4, K5
and K6 against their plain versions bit for bit on dubins_origin's
operands under feedback and open-loop (P == 0) strategies. This file
imports no JAX, so that it runs where the JAX package is not installed."""

import numpy as np
import pytest
import torch

from ilqgames_tpu_torch import bench
from ilqgames_tpu_torch.costs import atoms
from ilqgames_tpu_torch.costs.player_cost import PlayerCost
from ilqgames_tpu_torch.dynamics import models
from ilqgames_tpu_torch.examples import dubins_origin as do
from ilqgames_tpu_torch.examples import reachability as reach
from ilqgames_tpu_torch.examples import three_player_intersection as fl
from ilqgames_tpu_torch.ops.cuda import cost_table as ct
from ilqgames_tpu_torch.ops.cuda import lq, lq_open_loop, stage, sweep
from ilqgames_tpu_torch.types import GameSpec

torch.set_num_threads(1)


def test_dubins_layout_and_libraries():
    p = do.make_problem()
    tab = sweep._device_table(p.dynamics, p.spec)
    assert tab.n == 2
    assert [tab.kind[s] for s in range(2)] == [models.KIND_DUBINS] * 2
    assert [tab.xoff[s] for s in range(2)] == [0, 3]
    assert [tab.uoff[s] for s in range(2)] == [0, 1]
    assert [tab.length[s] for s in range(2)] == [do.SPEED] * 2
    name, d = sweep.library(p.dynamics, p.spec)
    assert name == "sweep"
    assert d["SW_SUB_KIND"] == "SW_ITEM(4)SW_ITEM(4)"
    assert d["SW_SUB_DIM"] == "SW_ITEM(3)SW_ITEM(3)"
    assert d["SW_SUB_UROWS"] == "SW_ITEM(1)SW_ITEM(1)"
    assert d["SW_SUB_LENGTH"] == "SW_ITEM(0x1.0000000000000p+0f)" * 2
    assert d["SW_MIN_BLOCKS"] == 1 and "CT_DIFF" not in d
    costs = p.player_costs
    assert ct.has_diff(costs) and not ct.has_reach(costs)
    assert not ct.has_norms(costs) and stage.has_dubins(p.dynamics)
    assert sweep.library(p.dynamics, p.spec, False, False, True)[1][
        "CT_DIFF"] == 1
    assert sweep.merit_library(p.spec, False, False, True)[1]["CT_DIFF"] == 1
    sd = stage.library(p.spec, False, True, True)[1]
    assert sd["CT_DIFF"] == 1 and sd["CT_DUBINS"] == 1
    libs = bench.kernel_libraries(p.dynamics, p.spec, costs, open_loop=True)
    assert libs[0] == stage.library(p.spec, False, True, True)
    assert libs[1] == lq.library(p.spec)
    assert libs[2] == sweep.merit_library(p.spec, False, False, True)
    assert libs[3] == sweep.library(p.dynamics, p.spec)
    assert libs[4] == sweep.library(p.dynamics, p.spec, False, False, True)
    assert libs[5] == ("lq_open_loop", {"OL_X": 6, "OL_P": 2, "OL_U": 1})
    # The other games' libraries are built as before.
    for other in (fl.make_problem(), reach.make_problem()):
        assert not ct.has_diff(other.player_costs)
        assert not stage.has_dubins(other.dynamics)
        for _, defines in bench.kernel_libraries(
                other.dynamics, other.spec, other.player_costs):
            assert "CT_DIFF" not in defines and "CT_DUBINS" not in defines


def test_quadratic_difference_cost_table():
    p = do.make_problem()
    tab, _ = ct._build(tuple(p.player_costs), p.spec)
    kinds = [tab.atom[n].kind for n in range(tab.n)]
    assert kinds == [ct.KIND["quadratic"]] * 3 + [
        ct.KIND["quadratic_difference"], ct.KIND["quadratic"]]
    a = tab.atom[3]
    assert (a.player, a.on, list(a.dim), a.w, a.gated) == (
        1, -1, [0, 1, 3, 4], 10.0, 0)
    gated = atoms.final_time(atoms.quadratic_difference(
        2.0, (0, 1), (3, 4)), 0.5)
    tab, _ = ct._build((PlayerCost(state_costs=(gated,)),),
                       GameSpec(xdims=(6,), udims=(1,)))
    assert (tab.atom[0].kind, tab.atom[0].gated, tab.atom[0].tgate) == (
        ct.KIND["quadratic_difference"], 1, 0.5)
    # One difference: a header row and a row for the difference.
    tab, _ = ct._build((PlayerCost(state_costs=(atoms.quadratic_difference(
        1.0, (0,), (3,)),)),), GameSpec(xdims=(6,), udims=(1,)))
    assert [tab.atom[n].kind for n in range(tab.n)] == [
        ct.KIND["quadratic_difference_n"],
        ct.KIND["quadratic_difference_member"]]
    assert (tab.atom[0].group, list(tab.atom[1].dim[:2])) == (1, [0, 3])


def test_k7_library_and_refusals():
    spec = do.make_problem().spec
    assert lq_open_loop.cache_floats(spec) == 2 * 7 + 6 * 7 + 2 * 36 + 12
    fspec = fl.make_problem().spec
    assert lq_open_loop.library(fspec)[1] == {"OL_X": 16, "OL_P": 3,
                                              "OL_U": 2}
    with pytest.raises(ValueError, match="<= 32"):
        lq_open_loop.library(GameSpec(xdims=(20, 20), udims=(1, 1)))
    ops, dx0 = _lq_operands(spec, 4, 0, "cpu")
    with pytest.raises(ValueError, match="want"):
        lq_open_loop.lq_open_loop(spec, ops, dx0[:, :3])
    meta = {k: v.to("meta") for k, v in ops.items()}
    with pytest.raises(ValueError, match="CPU or CUDA"):
        lq_open_loop.lq_open_loop(spec, meta, dx0.to("meta"))
    before = lq_open_loop.lq_open_loop.launches
    al, dxs = lq_open_loop.lq_open_loop(spec, ops, dx0)
    assert lq_open_loop.lq_open_loop.launches == before
    assert al.shape == (spec.num_time_steps - 1, 2, 4)
    assert torch.equal(dxs[0], dx0)


def _lq_operands(spec, B, seed, device):
    """K2's operand dict and dx0 of a random LQ game of `spec`'s dims:
    SPD state and own control costs (zero on padded controls, whose B
    columns are zero), cross control costs, at `device`."""
    N, P, x, u = spec.num_time_steps, spec.num_players, spec.xdim, spec.umax
    rng = np.random.RandomState(seed)
    mask = spec.u_mask().numpy().reshape(-1)            # [P*u]

    def spd(n):
        G = rng.randn(N, n, n, B)
        return (np.einsum("kabz,kcbz->kacz", G, G) / n
                + np.eye(n)[None, :, :, None])

    A = np.eye(x)[None, :, :, None] + 0.1 * rng.randn(N, x, x, B)
    Bf = 0.1 * rng.randn(N, x, P * u, B) * mask[None, None, :, None]
    Qf = np.concatenate([spd(x) for _ in range(P)], 1)
    lf = rng.randn(N, P * x, B)
    R = 0.1 * rng.randn(N, P, P, u, u, B)
    for i in range(P):
        m = mask[i * u:(i + 1) * u]
        R[:, i, i] = spd(u) * (m[:, None] * m[None, :])[None, :, :, None]
    r = rng.randn(N, P, P, u, B) * mask.reshape(P, u)[None, None, :, :, None]
    f = lambda a: torch.tensor(np.ascontiguousarray(a, np.float32),
                               device=device)
    ops = {"A": f(A), "Bf": f(Bf), "Qf": f(Qf), "lf": f(lf),
           "Rf": f(R.reshape(N, P * P * u, u, B)),
           "rf": f(r.reshape(N, P * P * u, B))}
    return ops, f(rng.randn(x, B))


def _same_bits(got, want):
    nan = want.isnan()
    assert torch.equal(got.isnan(), nan)
    assert torch.equal(got.view(torch.int32)[~nan],
                       want.view(torch.int32)[~nan])


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")


@pytest.mark.cuda
@pytest.mark.parametrize("xdims,udims,B,N", [
    ((3, 3), (1, 1), 37, 100),          # dubins_origin's dims, 4-byte rows
    ((2, 3, 2), (2, 1, 2), 12, 100),    # padded controls
    ((6, 6, 4), (2, 2, 2), 9, 100),     # the flagship's dims
    ((3, 3), (1, 1), 8, 100),           # the golden run's shape
    ((3, 3), (1, 1), 1024, 100),        # dubins_ol_1024's shape
    ((3, 3), (1, 1), 8, 2),             # a single knot
], ids=["dubins-37", "padded-12", "flagship-9", "dubins-8", "dubins-1024",
        "one-knot-8"])
def test_k7_on_card(xdims, udims, B, N):
    """K7 against its plain version bit for bit on random operands, the
    last lane NaN from knot 40 (knot 0 at N=2)."""
    _needs_card()
    spec = GameSpec(xdims=xdims, udims=udims, num_time_steps=N)
    ops, dx0 = _lq_operands(spec, B, B + N, "cuda")
    ops["A"][min(40, N - 2):, :, :, -1] = float("nan")
    al, dxs = lq_open_loop.lq_open_loop(spec, ops, dx0)
    want_al, want_dxs = lq_open_loop.lq_open_loop_plain(spec, ops, dx0)
    torch.cuda.synchronize()
    _same_bits(al, want_al)
    _same_bits(dxs, want_dxs)
    assert bool(dxs[-1, :, -1].isnan().all())


def _dubins_operands(N, C, B, seed, open_loop):
    """Batch-minor operands of dubins_origin's kernels from a seed: states
    near its x0 (the last lane's heading diverged), controls, a strategy
    (P == 0 under open loop), mu."""
    prob = do.make_problem(num_time_steps=N)
    spec = prob.spec
    x, Pu = spec.xdim, spec.num_players * spec.umax
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    t = lambda a: torch.tensor(a, device="cuda")
    x0 = prob.x0.numpy()[:, None] + 0.1 * f(x, B)
    xs = prob.x0.numpy()[None, :, None] + np.cumsum(0.3 * f(N, x, B), 0)
    xs[:, 2, -1] = 1e6
    op = {"xs": t(xs.astype(np.float32)), "us": t(0.2 * f(N, Pu, B)),
          "t0": t(rng.rand(1, B).astype(np.float32))}
    Ps = np.zeros((N, Pu, x, B), np.float32) if open_loop else 0.05 * f(
        N, Pu, x, B)
    st = {"Ps": t(Ps), "alphas": t(0.1 * f(N, Pu, B))}
    scal = t(np.repeat(0.5 ** np.arange(C, dtype=np.float32)[:, None], B,
                       1))
    mu = t(np.full((1, B), 10.0, np.float32))
    return prob, t(x0), op, st, scal, mu


@pytest.mark.cuda
@pytest.mark.parametrize("C,B,open_loop", [(1, 37, True), (8, 128, False)])
def test_dubins_kernels_on_card(C, B, open_loop):
    """K1 within 1e-5 of its plain version (bitwise expected), K4 (two
    dubins_car warps), K5 (quadratic_difference's terms) and K6 against
    their plain versions bit for bit, and K5 == K4 + K6."""
    _needs_card()
    prob, x0m, op, st, scal, mu = _dubins_operands(100, C, B, C + B,
                                                   open_loop)
    dyn, costs, spec = prob.dynamics, prob.player_costs, prob.spec
    got = stage.lin_quad(dyn, costs, spec, op, None, None, mu)
    want = stage.lin_quad_plain(dyn, costs, spec, op, None, None, mu)
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=1e-5,
                                   atol=1e-5, equal_nan=True)
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
