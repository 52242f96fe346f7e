"""K5's warp design, the rollout with in-kernel merit: its player -> warp
map from csrc/sweep.cu's layout (player i's merit terms are computed by
the warp of the subsystem that owns its controls), the refusal of a game
where a player's controls are not one subsystem's rows, and the premise of
the split: per-player terms at each knot, folded over the players left to
right and then over the knots, equal `rollout_merits_plain` bit for bit.
The premise of K6, the merit consumer: the same per-knot terms on each
knot's operands alone, folded in the same order, equal `merit_plain` bit
for bit. On the card, K5 against its plain version at chain counts that
are not a multiple of 32, and K6 against `merit_plain` at chain and knot
counts that do not fill a block. The JAX package is not imported: these
run on the card too."""

import numpy as np
import pytest
import torch

from ilqgames_tpu_torch.costs import player_cost as pcost
from ilqgames_tpu_torch.dynamics import base as dyn_base
from ilqgames_tpu_torch.dynamics import models
from ilqgames_tpu_torch.examples.three_player_intersection import \
    make_problem
from ilqgames_tpu_torch.ops.cuda import sweep

from test_torch_rollout_layout import _items, _operands

torch.set_num_threads(1)


def test_player_warp_map_of_the_flagship():
    """Warp s computes the terms of player SW_SUB_UOFF[s] / umax: in the
    flagship's library, player i's terms go to the warp of subsystem i,
    and every player has one warp."""
    prob = make_problem()
    dyn, spec = prob.dynamics, prob.spec
    defines = sweep.library(dyn, spec)[1]
    uoff = [int(v) for v in _items(defines["SW_SUB_UOFF"])]
    assert int(defines["SW_NSUB"]) == spec.num_players == 3
    assert [o // spec.umax for o in uoff] == [0, 1, 2]
    assert all(o % spec.umax == 0 for o in uoff)


def _models_for_players(models_, udims):
    """A joint system whose concatenated subsystems are `models_` but whose
    players are `udims`: the subsystems and the players disagree."""
    joint = dyn_base.concatenate("joint", models_)
    dyn = dyn_base.MultiPlayerDynamics(
        name="mismatched", xdims=(joint.xdim,) + (0,) * (len(udims) - 1),
        udims=udims, ode=joint.ode, ode_jac=joint.ode_jac,
        models=joint.models)
    return dyn, dyn.spec(num_time_steps=5)


@pytest.mark.parametrize("models_,udims,match", [
    ((models.car_6d(4.0), models.unicycle_4d()), (2, 2, 2),
     "player 2's merit terms"),
    ((models.car_6d(4.0), models.car_6d(4.0), models.unicycle_4d()), (2, 2),
     "3 subsystems for 2 players"),
], ids=["player-without-subsystem", "subsystem-without-player"])
def test_library_refuses_players_not_owning_one_subsystem(models_, udims,
                                                         match):
    """A game where a player's controls are not exactly one subsystem's
    rows is refused when the library is built, before nvcc runs."""
    dyn, spec = _models_for_players(models_, udims)
    with pytest.raises(ValueError, match=match):
        sweep.library(dyn, spec)


def _merit_operands(N, C, B, device="cpu", seed=0):
    """K5's operands: K4's (`_operands`: a heading of 1e14 rad on lane 1,
    3e5 on lane 2, NaN on lane 3) plus the flagship's costs, multipliers
    lamS [N, nS, B] and mu [1, B] from the same seed."""
    dyn, spec, (x0m, op, st, scal) = _operands(N, C, B, device, seed)
    costs = make_problem(num_time_steps=N).player_costs
    nS = sum(len(pc.state_constraints) for pc in costs)
    rng = np.random.RandomState(seed + 100)
    lamS = torch.tensor(rng.rand(N, nS, B).astype(np.float32), device=device)
    mu = torch.tensor(1.0 + 9.0 * rng.rand(1, B).astype(np.float32),
                      device=device)
    return dyn, costs, spec, (x0m, op, st, scal, lamS, None, mu)


def _knot_by_knot(costs, spec, xs, us, t0, lamS, mu):
    """The merit of emitted trajectories (xs [N, x, C, B], us [N, Pu, C,
    B]) one knot at a time: each knot's per-player (state_sq, ctrl_sq)
    from one call of `stage_gradient_sq_tuple` on that knot's operands
    alone, folded over the players left to right and then over the knots
    (control terms always, state terms for k > 0)."""
    N, P, u = spec.num_time_steps, spec.num_players, spec.umax
    _, _, C, B = xs.shape
    counts = [len(pc.state_constraints) for pc in costs]
    offs = np.cumsum([0] + counts)
    ts = t0[0] + torch.arange(N, dtype=torch.float32,
                              device=xs.device)[:, None] * spec.dt
    no_ctrl = tuple(xs.new_zeros((1, B, 0)) for _ in range(P))
    merit = None
    for k in range(N):
        lam = tuple(lamS[k, offs[i]:offs[i + 1]].T[None] for i in range(P))
        s, r = pcost.stage_gradient_sq_tuple(
            costs, spec, lam, no_ctrl, mu[0], ts[k][None],
            xs[k].permute(1, 2, 0),
            us[k].reshape(P, u, C, B).permute(2, 3, 0, 1))
        state, ctrl = s[0], r[0]
        for i in range(1, P):
            state = state + s[i]
            ctrl = ctrl + r[i]
        merit = ctrl if k == 0 else merit + (ctrl + state)
    return merit


def _emitted(dyn, spec, x0m, op, st, scal):
    """K4's emitted candidate states and their rebuilt controls."""
    xs = sweep.rollout_plain(dyn, spec, x0m, op, st, scal)
    return xs, sweep._us_from_xs(spec, xs, op, st, scal)


def _warp_decomposition(dyn, costs, spec, x0m, op, st, scal, lamS, lamC,
                        mu):
    """K5's order of operations in plain PyTorch: each knot's per-player
    (state_sq, ctrl_sq), as each warp computes them, folded over the
    players left to right and then over the knots."""
    xs, us = _emitted(dyn, spec, x0m, op, st, scal)
    return _knot_by_knot(costs, spec, xs, us, op["t0"], lamS, mu)


def _assert_same_bits(got, want):
    nan = want.isnan()
    assert torch.equal(got.isnan(), nan)
    assert torch.equal(got.view(torch.int32)[~nan],
                       want.view(torch.int32)[~nan])


@pytest.mark.parametrize("C,B", [(3, 7), (2, 37)])
def test_warp_decomposition_equals_plain_merits(C, B):
    """The split K5 computes (per player and knot, then folded) equals
    `rollout_merits_plain` bit for bit, NaN lane and huge headings
    included."""
    dyn, costs, spec, args = _merit_operands(N=11, C=C, B=B, seed=C + B)
    want = sweep.rollout_merits_plain(dyn, costs, spec, *args)
    got = _warp_decomposition(dyn, costs, spec, *args)
    assert bool(want.isnan().any()) and bool(want.isfinite().any())
    _assert_same_bits(got, want)


@pytest.mark.parametrize("C,B", [(3, 12), (1, 37)])
def test_knot_decomposition_equals_merit_plain(C, B):
    """The premise of K6's split: each knot's terms computed on that
    knot's operands alone, folded over the players left to right and then
    over the knots in ascending order, equal `merit_plain` bit for bit,
    NaN lane and huge headings included (nonzero lamS and mu)."""
    dyn, costs, spec, (x0m, op, st, scal, lamS, lamC, mu) = _merit_operands(
        N=11, C=C, B=B, seed=C + B)
    xs, us = _emitted(dyn, spec, x0m, op, st, scal)
    want = sweep.merit_plain(costs, spec, xs, us, op["t0"], lamS, lamC, mu)
    got = _knot_by_knot(costs, spec, xs, us, op["t0"], lamS, mu)
    assert bool(lamS.abs().min() > 0) and bool(mu.min() > 0)
    assert bool(want.isnan().any()) and bool(want.isfinite().any())
    _assert_same_bits(got, want)


def test_k5_wrapper_takes_plain_on_cpu():
    """On CPU tensors K5's wrapper takes its plain version and counts no
    launch."""
    dyn, costs, spec, args = _merit_operands(N=6, C=2, B=5)
    before = sweep.rollout_merits.launches
    got = sweep.rollout_merits(dyn, costs, spec, *args)
    _assert_same_bits(got, sweep.rollout_merits_plain(dyn, costs, spec,
                                                      *args))
    assert sweep.rollout_merits.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("C,B", [(3, 37), (1, 50), (8, 128)],
                         ids=["C3-B37-tail", "C1-B50-tail", "C8-B128"])
def test_merit_kernel_bitwise_on_card(C, B):
    """K5 (one warp per subsystem) against `rollout_merits_plain` on the
    card: bitwise equal, NaN in the same places, with chain counts that
    are not a multiple of 32 (tail threads compute on the last chain) and
    lanes beyond 8192 rad."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    dyn, costs, spec, args = _merit_operands(N=100, C=C, B=B, device="cuda",
                                             seed=C + B)
    want = sweep.rollout_merits_plain(dyn, costs, spec, *args)
    launches = sweep.rollout_merits.launches
    got = sweep.rollout_merits(dyn, costs, spec, *args)
    torch.cuda.synchronize()
    assert sweep.rollout_merits.launches == launches + 1
    assert bool(want.isnan().any())
    _assert_same_bits(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("N,C,B", [(11, 3, 12), (11, 1, 37), (100, 8, 128)],
                         ids=["N11-C3-B12", "N11-C1-B37", "N100-C8-B128"])
def test_consumer_kernel_bitwise_on_card(N, C, B):
    """K6 (the knots in parallel, the fold in order) against `merit_plain`
    on the card: bitwise equal, NaN in the same places, at chain and knot
    counts that do not fill a block, and at the deep rounds' shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    dyn, costs, spec, (x0m, op, st, scal, lamS, lamC, mu) = _merit_operands(
        N=N, C=C, B=B, device="cuda", seed=C + B)
    xs, us = _emitted(dyn, spec, x0m, op, st, scal)
    want = sweep.merit_plain(costs, spec, xs, us, op["t0"], lamS, lamC, mu)
    launches = sweep.consumer_merits.launches
    got = sweep.consumer_merits(costs, spec, xs, us, op["t0"], lamS, lamC,
                                mu)
    torch.cuda.synchronize()
    assert sweep.consumer_merits.launches == launches + 1
    assert bool(want.isnan().any())
    _assert_same_bits(got, want)
