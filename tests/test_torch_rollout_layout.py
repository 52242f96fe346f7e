"""K4's compile-time layout of subsystems and its one-warp-per-subsystem
design: the layout defines of csrc/sweep.cu's library, the build key they
give, and the premise of the split (each subsystem's RK4 step on its own
model equals its rows of the joint step, bit for bit). On the card, K4
against its plain version at tails and main-path shapes."""

import re

import numpy as np
import pytest
import torch

from ilqgames_tpu_torch import bench
from ilqgames_tpu_torch.dynamics import base as dyn_base
from ilqgames_tpu_torch.dynamics import models
from ilqgames_tpu_torch.examples.three_player_intersection import \
    make_problem
from ilqgames_tpu_torch.ops.cuda import build, sweep

torch.set_num_threads(1)


def _items(define: str) -> list:
    return re.findall(r"SW_ITEM\(([^)]*)\)", define)


def _game(*subsystems):
    dyn = dyn_base.concatenate("game", subsystems)
    return dyn, dyn.spec(num_time_steps=5)


def test_flagship_layout_defines():
    prob = make_problem()
    name, d = sweep.library(prob.dynamics, prob.spec)
    assert name == "sweep"
    assert (d["SW_X"], d["SW_PU"], d["SW_U"], d["SW_NSUB"]) == (16, 6, 2, 3)
    car, uni = models.KIND_CAR_6D, models.KIND_UNICYCLE_4D
    assert [int(v) for v in _items(d["SW_SUB_KIND"])] == [car, car, uni]
    assert [int(v) for v in _items(d["SW_SUB_XOFF"])] == [0, 6, 12]
    assert [int(v) for v in _items(d["SW_SUB_UOFF"])] == [0, 2, 4]
    lengths = _items(d["SW_SUB_LENGTH"])
    assert all(v.endswith("f") for v in lengths)
    bits = [np.float32(float.fromhex(v[:-1])).view(np.uint32)
            for v in lengths]
    want = np.array([4.0, 4.0, 0.0], np.float32).view(np.uint32)
    assert bits == list(want)


@pytest.mark.parametrize("length", [0.1, 2.7, 1e-3])
def test_length_define_is_the_exact_float32(length):
    """A length that float32 cannot hold is written as its float32
    rounding, exactly (the value `true_div` divides by)."""
    dyn, spec = _game(models.car_6d(length), models.unicycle_4d())
    hexlen = _items(sweep.library(dyn, spec)[1]["SW_SUB_LENGTH"])[0]
    got = float.fromhex(hexlen[:-1])
    assert got == float(np.float32(length))
    assert np.float32(got).view(np.uint32) == \
        np.float32(length).view(np.uint32)


def test_model_without_device_ode_is_refused():
    car = models.car_6d(4.0)
    no_ode = dyn_base.SinglePlayerModel(name="custom", xdim=6, udim=2,
                                        ode=car.ode)
    dyn, spec = _game(car, no_ode)
    with pytest.raises(NotImplementedError, match="custom"):
        sweep.library(dyn, spec)


def test_layouts_key_separate_builds():
    """The library path is keyed on the layout: two layouts of the same
    dims build two libraries; the same layout, one."""
    flag = make_problem()
    other, spec = _game(models.car_6d(3.0), models.car_6d(4.0),
                        models.unicycle_4d())
    assert (spec.xdims, spec.udims) == (flag.spec.xdims, flag.spec.udims)
    swapped, spec2 = _game(models.unicycle_4d(), models.car_6d(4.0),
                           models.car_6d(4.0))
    paths = {build._target(*sweep.library(d, s))[2]
             for d, s in ((flag.dynamics, flag.spec), (other, spec),
                          (swapped, spec2))}
    assert len(paths) == 3
    again = make_problem()
    assert build._target(*sweep.library(again.dynamics, again.spec))[2] in \
        paths


def test_subsystem_steps_equal_the_joint_step():
    """The premise of one warp per subsystem: on the flagship, each
    subsystem's RK4 step through dyn_base.integrate on its own model,
    concatenated, equals the joint step bit for bit, including a heading of
    1e14 rad and a NaN lane."""
    prob = make_problem()
    dyn, spec = prob.dynamics, prob.spec
    rng = np.random.RandomState(4)
    B = 64
    x = (np.tile(prob.x0.numpy()[None], (B, 1))
         + rng.randn(B, spec.xdim)).astype(np.float32)
    x[1, 2] = 1e14
    x[2, 9] = -3e5
    x[3, 15] = np.nan
    us = rng.randn(B, spec.num_players, spec.umax).astype(np.float32)
    xt, ut = torch.tensor(x), torch.tensor(us)
    joint = dyn_base.integrate(dyn, 0.0, spec.dt, xt, ut)
    parts, off = [], 0
    for i, m in enumerate(dyn.models):
        own = dyn_base.concatenate(m.name, [m])
        parts.append(dyn_base.integrate(own, 0.0, spec.dt,
                                        xt[:, off:off + m.xdim],
                                        ut[:, i:i + 1, :m.udim]))
        off += m.xdim
    split = torch.cat(parts, dim=1)
    assert torch.equal(split.isnan(), joint.isnan())
    assert joint.isnan().any() and (joint.abs() > 1e13).any()
    assert torch.equal(split.nan_to_num(), joint.nan_to_num())


def test_cpu_rollouts_take_plain_and_launch_nothing():
    """On CPU tensors K4's wrapper takes `rollout_plain` and counts no
    launch; resetting the bench's counters clears K4's per-shape counts."""
    dyn, spec, args = _operands(N=6, C=2, B=5)
    before = (sweep.rollout_bm.launches, dict(sweep.rollout_bm.by_shape))
    want = sweep.rollout_plain(dyn, spec, *args, emit_us=True)
    got = sweep.rollout_bm(dyn, spec, *args, emit_us=True)
    assert all(torch.equal(g.nan_to_num(), w.nan_to_num())
               for g, w in zip(got, want))
    assert (sweep.rollout_bm.launches,
            dict(sweep.rollout_bm.by_shape)) == before
    sweep.rollout_bm.by_shape[(1, 2, False)] += 1
    bench.reset_launches()
    assert not sweep.rollout_bm.by_shape


def _operands(N, C, B, device="cpu", seed=0):
    """The flagship's K4 operands from a seed: x0 near the flagship's start
    with a heading of 1e14 rad on lane 1, one of 3e5 on lane 2 and a NaN on
    lane 3; per-lane reference, feedback, alphas and step sizes."""
    prob = make_problem(num_time_steps=N)
    dyn, spec = prob.dynamics, prob.spec
    x, Pu = spec.xdim, spec.num_players * spec.umax
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    x0m = np.tile(prob.x0.numpy()[:, None], (1, B)) + 0.1 * f(x, B)
    x0m[2, 1 % B] = 1e14
    x0m[9, 2 % B] = 3e5
    x0m[5, 3 % B] = np.nan
    t = lambda a: torch.tensor(np.ascontiguousarray(a, np.float32),
                               device=device)
    op = {"xs": t(x0m[None] + 0.1 * f(N, x, B)), "us": t(f(N, Pu, B)),
          "t0": t(f(1, B))}
    st = {"Ps": t(0.05 * f(N, Pu, x, B)), "alphas": t(f(N, Pu, B))}
    scal = t(0.1 + rng.rand(C, B))
    return dyn, spec, (t(x0m), op, st, scal)


@pytest.mark.cuda
@pytest.mark.parametrize("C,B,emit_us", [(3, 37, True), (1, 2048, True),
                                         (8, 128, False)],
                         ids=["C3-B37-tail", "C1-B2048-emit_us", "C8-B128"])
def test_rollout_kernel_bitwise_on_card(C, B, emit_us):
    """K4 (one warp per subsystem) against `rollout_plain` on the card:
    every entry bitwise equal, NaN in the same places, with a tail of
    chains that is not a multiple of 32 and lanes beyond 8192 rad."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    dyn, spec, args = _operands(N=100, C=C, B=B, device="cuda", seed=C + B)
    want = sweep.rollout_plain(dyn, spec, *args, emit_us=True)
    want = want if emit_us else want[:1]
    launches = sweep.rollout_bm.launches
    got = sweep.rollout_bm(dyn, spec, *args, emit_us=emit_us)
    got = got if emit_us else (got,)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.isnan(), w.isnan())
        assert torch.equal(g.nan_to_num(), w.nan_to_num())
    assert sweep.rollout_bm.launches == launches + 1
