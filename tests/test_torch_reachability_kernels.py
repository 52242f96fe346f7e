"""The kernel layout of BENCH_ALL config 5's game, three-player
collision-avoidance reachability: car_5d as three warps of five rows,
its 27-atom cost table (per player an extremal group header and its two
signed-distance members, the two per-dim control quadratics and four
single-dimension control constraints on lamC rows 4i .. 4i+3), the
libraries built with CT_REACH (and the other games' without), the
kernels' refusals of reach operands for a game without the features, and
the tables copied into K1's library's constant memory once per problem. On
the card (marker `cuda`, skipped here):
K1 against `lin_quad_plain` (tolerance 1e-5, as chip_smoke.py holds it)
and K4, K5 and K6 against their plain versions bit for bit, on operands
made from a seed: live control multipliers, every player's extremal gate
at its extreme knot, lanes with coincident cars (the signed distance's
clamp) and a NaN lane. This file imports no JAX, so that it runs where
the JAX package is not installed."""

import ctypes

import numpy as np
import pytest
import torch

from ilqgames_tpu_torch.costs import player_cost as pcost
from ilqgames_tpu_torch.dynamics import models
from ilqgames_tpu_torch.examples import reachability as reach
from ilqgames_tpu_torch.examples import three_player_intersection as fl
from ilqgames_tpu_torch.ops.cuda import cost_table as ct
from ilqgames_tpu_torch.ops.cuda import stage, sweep
from ilqgames_tpu_torch.ops.cuda.layout import mb
from ilqgames_tpu_torch.types import OperatingPoint

torch.set_num_threads(1)


def test_car_5d_layout_and_libraries():
    p = reach.make_problem()
    tab = sweep._device_table(p.dynamics, p.spec)
    assert tab.n == 3
    assert [tab.kind[s] for s in range(3)] == [models.KIND_CAR_5D] * 3
    assert [tab.xoff[s] for s in range(3)] == [0, 5, 10]
    assert [tab.length[s] for s in range(3)] == [4.0] * 3
    name, d = sweep.library(p.dynamics, p.spec)
    assert d["SW_SUB_DIM"] == "SW_ITEM(5)" * 3
    assert d["SW_SUB_KIND"] == "SW_ITEM(3)" * 3
    assert "CT_REACH" not in d
    assert ct.has_reach(p.player_costs)
    assert sweep.library(p.dynamics, p.spec, False, True)[1]["CT_REACH"] == 1
    assert sweep.merit_library(p.spec, False, True)[1]["CT_REACH"] == 1
    assert stage.library(p.spec, True)[1]["CT_REACH"] == 1
    f = fl.make_problem()
    assert not ct.has_reach(f.player_costs)
    assert "CT_REACH" not in stage.library(f.spec)[1]


def test_reach_cost_table():
    p = reach.make_problem()
    tab, _ = ct.cost_table(p.player_costs, p.spec, "cpu")
    assert tab.n == 27 <= ct.MAX_ATOMS
    K = ct.KIND
    for i in range(3):
        rows = [tab.atom[n] for n in range(9 * i, 9 * i + 9)]
        assert all(a.player == i for a in rows)
        assert [a.kind for a in rows] == (
            [K["extreme"]] + [K["signed_distance"]] * 2 + [K["quadratic"]] * 2
            + [K["single_dimension"]] * 4)
        assert [a.group for a in rows[:3]] == [2, -1, -1]
        assert rows[0].right == 0                       # the maximum
        assert [(a.w, a.aux) for a in rows[1:3]] == [(1.0, 3.0)] * 2
        assert [a.on for a in rows[3:]] == [i] * 6
        cons = rows[5:]
        assert [a.lam for a in cons] == list(range(4 * i, 4 * i + 4))
        assert [(a.dim[0], round(a.w, 6), a.aux) for a in cons] == [
            (0, 1.0, 1.0), (0, -1.0, -1.0), (1, 0.1, 1.0), (1, -0.1, -1.0)]
        assert tab.extremal[i] == 1
    pairs = [tuple(tab.atom[n].dim) for n in (1, 2, 10, 11, 19, 20)]
    assert pairs == [(0, 1, 5, 6), (0, 1, 10, 11), (0, 1, 5, 6),
                     (5, 6, 10, 11), (5, 6, 10, 11), (0, 1, 10, 11)]


def test_tables_set_once_per_problem():
    """K1's library's constant tables are copied only when it holds
    another problem's (the structs are cached per problem, so their
    identity names it), per device; the CostTable's new fields sit at its
    end."""
    calls = []

    class Lib:
        def stage_set_tables(self, *args):
            calls.append(args)
            return 0

    lib = Lib()
    p, f = reach.make_problem(), fl.make_problem()
    tp = ct.cost_table(p.player_costs, p.spec, "cpu")[0]
    tf = ct.cost_table(f.player_costs, f.spec, "cpu")[0]
    assert tp is ct.cost_table(p.player_costs, p.spec, "cpu")[0]
    d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
    for tab, dev in ((tp, d0), (tp, d0), (tf, d0), (tf, d1), (tp, d0),
                     (tf, d1)):
        stage._set_tables(lib, (tab,), 7, dev)
    assert calls == [(ctypes.addressof(tp), 7), (ctypes.addressof(tf), 7),
                     (ctypes.addressof(tf), 7), (ctypes.addressof(tp), 7)]
    assert stage._subsys_table(p.dynamics, p.spec) is stage._subsys_table(
        p.dynamics, p.spec)
    assert ct.CostAtom.group.offset == ctypes.sizeof(ct.CostAtom) - 4
    assert ct.CostTable.extremal.offset + 4 * ct.MAX_PLAYERS == \
        ctypes.sizeof(ct.CostTable)


def test_reach_operands_refused_for_a_sum_game():
    """A game without the reachability features takes neither control
    multipliers nor a gate on the card (its kernels are built without
    them)."""
    f = fl.make_problem()
    lamC = torch.zeros((100, 1, 4))
    with pytest.raises(ValueError, match="control multipliers"):
        sweep._reach_operands(f.player_costs, lamC, None)
    assert sweep._reach_operands(f.player_costs, None, None) == (
        False, (None, 0, None))


def _operands(N, C, B, device, seed):
    """Batch-minor operands of the game's kernels from a seed: states near
    its x0 (lane 1 with cars 1 and 2 coincident, the last lane NaN from
    knot 3), controls near the box constraints, a small strategy, live
    control multipliers, mu, and the extremal gate of the reference
    operating point's extreme knots."""
    prob = reach.make_problem(num_time_steps=N)
    spec = prob.spec
    x, P, u = spec.xdim, spec.num_players, spec.umax
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    t = lambda a: torch.tensor(a, device=device)
    x0 = prob.x0.numpy()[:, None] + 0.25 * f(x, B)
    x0[5:7, 1] = x0[0:2, 1]
    xs = prob.x0.numpy()[None, :, None] + np.cumsum(0.3 * f(N, x, B), 0)
    xs[:, 5:7, 1] = xs[:, 0:2, 1]
    xs[3:, :, -1] = np.nan
    us = 0.12 * f(N, P * u, B)
    op = {"xs": t(xs.astype(np.float32)), "us": t(us),
          "t0": t(rng.rand(1, B).astype(np.float32))}
    st = {"Ps": t(0.05 * f(N, P * u, x, B)), "alphas": t(0.1 * f(N, P * u,
                                                                   B))}
    scal = t(np.repeat(0.5 ** np.arange(C, dtype=np.float32)[:, None], B,
                       1))
    lamC = t((np.abs(f(N, 12, B)) * (rng.rand(N, 12, B) < 0.5)).astype(
        np.float32))
    mu = t(np.full((1, B), 10.0, np.float32))
    ref = OperatingPoint(xs=mb(op["xs"], B), us=mb(op["us"], B).reshape(
        B, N, P, u), t0=op["t0"][0])
    _, ks = pcost.total_costs(prob.player_costs, spec, ref)
    gate = pcost.extreme_gate(prob.player_costs, spec, ks)
    gate_bm = gate.permute(1, 2, 0).contiguous()
    return prob, t(x0), op, st, scal, lamC, mu, gate_bm


def test_operands_hold_the_cases():
    """The seeded operands reach what the card's test relies on: a lane
    whose cars coincide (the clamp) and a NaN lane, whose NaN knot is every
    player's extreme."""
    prob, x0m, op, st, scal, lamC, mu, gate = _operands(11, 1, 8, "cpu", 3)
    assert torch.equal(op["xs"][:, 0:2, 1], op["xs"][:, 5:7, 1])
    assert (gate.sum(0) == 1).all()
    assert (gate[3, :, -1] == 1).all()


def _same_bits(got, want):
    nan = want.isnan()
    assert torch.equal(got.isnan(), nan)
    assert torch.equal(got.view(torch.int32)[~nan],
                       want.view(torch.int32)[~nan])


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")


@pytest.mark.cuda
@pytest.mark.parametrize("C,B", [(1, 37), (8, 128)])
def test_reach_kernels_on_card(C, B):
    """K1 within 1e-5 of its plain version (bitwise expected), K4 (three
    car_5d warps), K5 (each warp its player's gated terms and control
    constraints) and K6 against their plain versions bit for bit, and
    K5 == K4 + K6."""
    _needs_card()
    prob, x0m, op, st, scal, lamC, mu, gate = _operands(100, C, B, "cuda",
                                                       C + B)
    dyn, costs, spec = prob.dynamics, prob.player_costs, prob.spec
    got = stage.lin_quad(dyn, costs, spec, op, None, lamC, mu, gate)
    want = stage.lin_quad_plain(dyn, costs, spec, op, None, lamC, mu, gate)
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=1e-5,
                                   atol=1e-5, equal_nan=True)
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
