"""The kernel capabilities the two unconstrained games need: K2's
value-update tiles at x = 2 and 12 (beside the flagship's 16), the linear
subsystem kind and its player-to-warp map in K4 and K5, the new atoms and
the lane's time in K1, K5 and K6. On the CPU: the libraries' defines and
refusals. On the card (marker `cuda`, skipped here): each kernel against
its plain version bit for bit (K1 within 1e-5, as `chip_smoke.py` holds
it), on operands made from a seed, with t0 != 0 so that the collision's
goal gate opens at different knots on different lanes. This file imports
no JAX, so that the card's machine can run it."""

import numpy as np
import pytest
import torch

from ilqgames_tpu_torch.costs import player_cost as pcost
from ilqgames_tpu_torch.examples import three_player_intersection as fl
from ilqgames_tpu_torch.examples import two_player_collision as tc
from ilqgames_tpu_torch.examples import two_player_point_mass as pm
from ilqgames_tpu_torch.ops.cuda import lq, stage, sweep
from ilqgames_tpu_torch.types import GameSpec

torch.set_num_threads(1)

GAMES = {"point_mass": pm.make_problem, "collision": tc.make_problem,
         "flagship": fl.make_problem}
FLAGSHIP_LQ = {"LQ_X": 16, "LQ_P": 3, "LQ_U": 2, "LQ_G": 8,
               "LQ_SMEM": 160896, "LQ_FWD_G": 16, "LQ_FWD_SMEM": 70784}


def test_k2_library_takes_small_widths():
    """x=2 with Pu=2 and x=12 with Pu=4 build; the flagship's defines are
    unchanged; a game whose back-substitution needs more than a warp's
    threads (x + 1 > 32: one per column of [P | alpha]) is refused before
    nvcc runs."""
    assert lq.library(fl.make_problem().spec) == ("lq", FLAGSHIP_LQ)
    for make, x, pu in ((pm.make_problem, 2, 2), (tc.make_problem, 12, 4)):
        spec = make().spec
        assert (spec.xdim, spec.num_players * spec.umax) == (x, pu)
        name, d = lq.library(spec)
        assert (name, d["LQ_X"], d["LQ_G"]) == ("lq", x, 8)
        assert d["LQ_SMEM"] == lq.backward_smem_bytes(spec) <= lq.SMEM_LIMIT
    with pytest.raises(ValueError, match="x \\+ 1 = 33"):
        lq.library(GameSpec(xdims=(16, 16), udims=(2, 2)))


def test_player_warp_map_of_the_unconstrained_games():
    """The point mass is one linear subsystem whose warp computes both
    players' control rows and merit terms; the collision has one warp per
    car, as the flagship."""
    p = pm.make_problem()
    _, d = sweep.library(p.dynamics, p.spec)
    assert (d["SW_NSUB"], d["SW_SUB_UOFF"]) == (1, "SW_ITEM(0)")
    tab = sweep._device_table(p.dynamics, p.spec)
    assert (tab.kind[0], sweep._control_rows(tab, 0, p.spec)) == (2, (0, 2))
    c = tc.make_problem()
    _, d = sweep.library(c.dynamics, c.spec)
    assert (d["SW_NSUB"], d["SW_SUB_UOFF"]) == (2, "SW_ITEM(0)SW_ITEM(2)")
    assert "SW_NLIN" not in d


def test_cost_tables_of_the_unconstrained_games():
    """Every atom of both games has a device form: the collision's 22
    atoms fit the table, with its final-time gates and the shortcut rows
    of its semiquadratic polylines after the segments."""
    from ilqgames_tpu_torch.ops.cuda import cost_table as ct

    c = tc.make_problem()
    tab, segs = ct.cost_table(c.player_costs, c.spec, "cpu")
    assert tab.n == 22 <= ct.MAX_ATOMS
    gated = [tab.atom[n].tgate for n in range(tab.n) if tab.atom[n].gated]
    assert gated == [np.float32(9.5)] * 4
    semi = [tab.atom[n] for n in range(tab.n)
            if tab.atom[n].kind == ct.KIND["semiquadratic_polyline"]]
    assert len(semi) == 8
    n_seg = sum(tab.atom[n].nseg for n in range(tab.n))
    assert segs.numel() == 7 * n_seg + 8 * sum(a.nseg for a in semi)
    assert [a.fix0 for a in semi][:2] == [7 * n_seg, 7 * n_seg + 8]
    # The point mass's quadratics over all dims: one atom per dim.
    p = pm.make_problem()
    tab, _ = ct.cost_table(p.player_costs, p.spec, "cpu")
    assert [(tab.atom[n].on, tab.atom[n].dim[0]) for n in range(tab.n)] \
        == [(-1, 0), (-1, 1), (0, 0), (1, 0)] * 2


def _operands(game, N, C, B, device, seed):
    """Batch-minor operands of the game's kernels from a seed: states near
    its x0, random controls, a small random strategy, candidate scalings,
    and each lane's t0 in [0, 1] s."""
    prob = GAMES[game](num_time_steps=N)
    spec = prob.spec
    x, Pu = spec.xdim, spec.num_players * spec.umax
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    t = lambda a: torch.tensor(a, device=device)
    x0 = prob.x0.numpy()[:, None] + 0.3 * f(x, B)
    xs = prob.x0.numpy()[None, :, None] + np.cumsum(0.5 * f(N, x, B), 0)
    mask = np.array(sweep._umask_flat(spec), np.float32)[None, :, None]
    op = {"xs": t(xs.astype(np.float32)), "us": t(f(N, Pu, B) * mask),
          "t0": t(rng.rand(1, B).astype(np.float32))}
    st = {"Ps": t(0.05 * f(N, Pu, x, B)), "alphas": t(f(N, Pu, B))}
    scal = t((0.1 + rng.rand(C, B)).astype(np.float32))
    mu = t(np.full((1, B), 10.0, np.float32))
    return prob, t(x0.astype(np.float32)), op, st, scal, mu


def _same_bits(got, want):
    nan = want.isnan()
    assert torch.equal(got.isnan(), nan)
    assert torch.equal(got.view(torch.int32)[~nan],
                       want.view(torch.int32)[~nan])


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")


@pytest.mark.cuda
@pytest.mark.parametrize("game", list(GAMES))
def test_k2_bitwise_on_card_at_each_width(game):
    """K2 against `lq_backward_plain` at x = 2, 12 and 16, B=37 (a ragged
    last block), on K1's plain operands of the game."""
    _needs_card()
    prob, x0m, op, st, scal, mu = _operands(game, 100, 1, 37, "cuda", 1)
    lamS = None
    if pcost.is_constrained(prob.player_costs):
        nS = sum(len(c.state_constraints) for c in prob.player_costs)
        lamS = torch.rand((100, nS, 37), device="cuda")
    ops = stage.lin_quad_plain(prob.dynamics, prob.player_costs, prob.spec,
                               op, lamS, None, mu)
    want = lq.lq_backward_plain(prob.spec, ops)
    got = lq.lq_backward(prob.spec, ops)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        _same_bits(g, w)
    dx0 = x0m - op["xs"][0]
    _same_bits(lq.lq_forward(prob.spec, ops["A"], ops["Bf"], got[1], dx0),
               lq.lq_forward_plain(prob.spec, ops["A"], ops["Bf"], got[1],
                                   dx0))


@pytest.mark.cuda
@pytest.mark.parametrize("game", ["point_mass", "collision"])
def test_stage_kernel_on_card(game):
    """K1 with the linear Jacobian, the new atoms and the lanes' times
    against `lin_quad_plain` (within 1e-5)."""
    _needs_card()
    prob, _, op, _, _, mu = _operands(game, 100, 1, 50, "cuda", 2)
    got = stage.lin_quad(prob.dynamics, prob.player_costs, prob.spec, op,
                         None, None, mu)
    want = stage.lin_quad_plain(prob.dynamics, prob.player_costs, prob.spec,
                                op, None, None, mu)
    torch.cuda.synchronize()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("game", ["point_mass", "collision"])
@pytest.mark.parametrize("C,B", [(1, 37), (8, 128)])
def test_rollout_and_merit_kernels_on_card(game, C, B):
    """K4 (the linear kind; both players' rows in one warp), K5 (both
    players' merit terms in that warp; the goal gate at each lane's time)
    and K6 against their plain versions, bit for bit, and K5 == K4 + K6."""
    _needs_card()
    prob, x0m, op, st, scal, mu = _operands(game, 100, C, B, "cuda", C + B)
    dyn, costs, spec = prob.dynamics, prob.player_costs, prob.spec
    xs, us = sweep.rollout_bm(dyn, spec, x0m, op, st, scal, emit_us=True)
    want = sweep.rollout_plain(dyn, spec, x0m, op, st, scal, emit_us=True)
    _same_bits(xs, want[0])
    _same_bits(us, want[1])
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


def test_const_tensor_keys_on_types():
    """(0,) and (0.0,) are equal tuples: the point mass's empty segment
    table (0.0,) must not come back as the index column (0,) of its
    quadraticization, or the other way round."""
    from ilqgames_tpu_torch.types import const_tensor

    dev = torch.device("cpu")
    assert const_tensor((0.0,), dev).dtype == torch.float32
    assert const_tensor((0,), dev).dtype == torch.int64
    assert const_tensor((1.0, 1.0), dev).dtype == torch.float32
    assert const_tensor((1, 1), dev).dtype == torch.int64
