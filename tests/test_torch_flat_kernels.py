"""The kernel layout of the three-player flat intersection: its constant
linear system as three linear subsystems, one warp each reading only its
player's control rows (the point mass keeps its one subsystem that reads
both players'), its 30-atom cost table with the norm atoms, the libraries
built with them (CT_NORMS) and the stage kernel's refusal. On the card
(marker `cuda`, skipped here): K4, K5 and K6 against their plain
versions bit for bit on operands made from a seed, some lanes starting
at an infinite or NaN state (the flat rows' x * 0 fold) and some with
speeds at the norm atoms' thresholds. This file imports no JAX, so that
the card's machine can run it."""

import numpy as np
import pytest
import torch

from ilqgames_tpu_torch.costs import atoms
from ilqgames_tpu_torch.examples import three_player_flat_intersection as ff
from ilqgames_tpu_torch.examples import three_player_intersection as fl
from ilqgames_tpu_torch.examples import two_player_point_mass as pm
from ilqgames_tpu_torch.ops.cuda import cost_table as ct
from ilqgames_tpu_torch.ops.cuda import stage, sweep

torch.set_num_threads(1)


def test_flat_system_is_three_linear_subsystems():
    """One linear subsystem per player (rows 6, 6, 4), each reading its
    own player's two control rows, with the 32 constant Jacobian entries
    (16 identity, 10 of A, 6 of B) in the table, which holds 48 (the four
    flat cars of flat_roundabout_merging); the rows fold from x * 0.
    The point mass keeps one subsystem over both rows reading every
    control row."""
    p = ff.make_problem()
    tab = sweep._device_table(p.dynamics, p.spec)
    assert tab.n == 3 and tab.nlin == 32 and sweep._MAX_LIN == 48
    assert [tab.kind[s] for s in range(3)] == [2, 2, 2]
    assert [tab.xoff[s] for s in range(3)] == [0, 6, 12]
    assert [sweep._control_rows(tab, s, p.spec) for s in range(3)] == [
        (0, 2), (2, 4), (4, 6)]
    _, d = sweep.library(p.dynamics, p.spec)
    assert d["SW_SUB_DIM"] == "SW_ITEM(6)SW_ITEM(6)SW_ITEM(4)"
    assert d["SW_SUB_UROWS"] == "SW_ITEM(2)" * 3
    assert (d["SW_NLIN"], d["SW_LIN_ZERO"]) == (16, 1)
    assert "CT_NORMS" not in d
    assert sweep.library(p.dynamics, p.spec, True)[1]["CT_NORMS"] == 1
    q = pm.make_problem()
    tab = sweep._device_table(q.dynamics, q.spec)
    assert (tab.n, sweep._control_rows(tab, 0, q.spec)) == (1, (0, 2))
    _, d = sweep.library(q.dynamics, q.spec)
    assert (d["SW_SUB_DIM"], d["SW_SUB_UROWS"], d["SW_LIN_ZERO"]) == (
        "SW_ITEM(2)", "SW_ITEM(2)", 0)


def test_linear_per_player_refuses_a_coupled_block():
    """A per-player linear system whose block reads another player's
    state or controls is refused."""
    from ilqgames_tpu_torch.dynamics import base as dyn_base

    with pytest.raises(ValueError, match="outside the block"):
        dyn_base.linear("coupled", (1, 1), (1, 1),
                        ((("u", (1, 0), 1.0),), (("x", 1, 1.0),)),
                        per_player=True)


def test_flat_cost_table_and_libraries():
    """30 atoms (8 state atoms and two per-dim control atoms a player), the
    norm atoms in their fields; the merit libraries of the flat game take
    CT_NORMS, the flagship's do not; K1 refuses the game."""
    p = ff.make_problem()
    tab, _ = ct.cost_table(p.player_costs, p.spec, "cpu")
    assert tab.n == 30 <= ct.MAX_ATOMS
    kinds = [tab.atom[n].kind for n in range(8)]
    assert kinds == [ct.KIND[k] for k in (
        "polyline", "semiquadratic_polyline", "semiquadratic_polyline",
        "semiquadratic_norm", "semiquadratic_norm", "quadratic_norm",
        "proximity_cost", "proximity_cost")]
    min_v, max_v, nom = (tab.atom[n] for n in (3, 4, 5))
    assert (min_v.dim[0], min_v.dim[1], min_v.w, min_v.aux, min_v.right) \
        == (2, 3, 10.0, 1.0, 0)
    assert (max_v.aux, max_v.right) == (12.0, 1)
    assert (nom.dim[0], nom.dim[1], nom.w, nom.aux) == (2, 3, 10.0, 8.0)
    assert ct.has_norms(p.player_costs)
    assert not ct.has_norms(fl.make_problem().player_costs)
    assert sweep.merit_library(p.spec, True)[1]["CT_NORMS"] == 1
    assert "CT_NORMS" not in sweep.merit_library(p.spec)[1]
    N, B = 5, 4
    op = {"xs": torch.zeros(N, 16, B), "us": torch.zeros(N, 6, B),
          "t0": torch.zeros(1, B)}
    with pytest.raises(ValueError, match="'MinV' has no sparse quad_pairs"):
        stage.lin_quad(p.dynamics, p.player_costs, p.spec, op, None, None,
                       torch.ones(1, B))


def test_dense_atom_gradient_falls_back_and_pairs_are_none():
    """A dense-only atom has no pairs; its gradient is its quad_fn's."""
    c = atoms.semiquadratic_norm(10.0, 2, 3, 12.0, True)
    v = torch.tensor(np.random.RandomState(0).randn(7, 16).astype(
        np.float32)) * 10
    assert c.gradient_pairs(0.0, v) is None and c.quad_pairs(0.0, v) is None
    assert torch.equal(c.gradient(0.0, v), c.quadraticize(0.0, v)[1])


def _operands(N, C, B, device, seed):
    """Batch-minor operands of the flat game's kernels from a seed: states
    near its x0, random controls and strategy, candidate scalings, lanes'
    t0 in [0, 1] s; lane 1 starts at an infinite state and lane 2 at a NaN
    one, lane 3 at player 1's MaxV threshold and lane 4 at player 3's
    MinV threshold exactly."""
    prob = ff.make_problem(num_time_steps=N)
    spec = prob.spec
    x, Pu = spec.xdim, spec.num_players * spec.umax
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    t = lambda a: torch.tensor(a, device=device)
    x0 = prob.x0.numpy()[:, None] + 0.3 * f(x, B)
    x0[5, 1], x0[13, 2] = np.inf, np.nan
    x0[2:4, 3] = (12.0, 0.0)
    x0[14:16, 4] = (0.0, 1.0)
    xs = prob.x0.numpy()[None, :, None] + np.cumsum(0.5 * f(N, x, B), 0)
    op = {"xs": t(xs.astype(np.float32)), "us": t(f(N, Pu, B)),
          "t0": t(rng.rand(1, B).astype(np.float32))}
    st = {"Ps": t(0.05 * f(N, Pu, x, B)), "alphas": t(f(N, Pu, B))}
    scal = t((0.1 + rng.rand(C, B)).astype(np.float32))
    mu = t(np.full((1, B), 10.0, np.float32))
    return prob, t(x0.astype(np.float32)), op, st, scal, mu


def test_operands_reach_the_edge_cases():
    """The operands' edge lanes: the plain rollout keeps NaN rows where the
    state is infinite or NaN (x * 0), and the threshold lanes sit on their
    atoms' thresholds."""
    prob, x0m, op, st, scal, mu = _operands(11, 1, 8, "cpu", 3)
    xs = sweep.rollout_plain(prob.dynamics, prob.spec, x0m, op, st, scal)
    assert torch.isnan(xs[1, 5, 0, 1]) and torch.isnan(xs[1, 13, 0, 2])
    assert torch.isfinite(xs[:, :, 0, 0]).all()
    assert (x0m[2:4, 3].tolist(), x0m[14:16, 4].tolist()) == (
        [12.0, 0.0], [0.0, 1.0])


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
def test_flat_rollout_and_merit_kernels_on_card(C, B):
    """K4 (three linear warps), K5 (each warp its player's terms, the norm
    atoms and the dense fold) and K6 against their plain versions, bit for
    bit, and K5 == K4 + K6."""
    _needs_card()
    prob, x0m, op, st, scal, mu = _operands(100, C, B, "cuda", C + B)
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
