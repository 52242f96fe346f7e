"""Dynamics models (counterpart of ilqgames_tpu/dynamics/models.py:
`point_mass_2d` at :33, `dubins_car` at :47, `unicycle_4d` at :80, `car_5d` at :117 and `car_6d`
at :146; the coupled multi-player systems `two_player_unicycle_4d` at :215
and `air_3d` at :246).

Each model has a continuous vector field `ode(t, x, u)` over tensors
whose last axis is the state (or control) index, and analytic sparse
Jacobian entries `jac` in the JAX package's form. `kind` and `length`
name the model's device ODE for the rollout kernel (csrc/sweep.cu);
`length` is the model's one parameter there (a car's inter-axle length,
a Dubins car's speed). A coupled system is a MultiPlayerDynamics over the
whole state, `ode(t, x, us)` with `ode_jac` in joint coordinates, and its
own `kind` and `params` (air_3d's two speeds).
Trigonometry goes through `fmath`, which rounds the same on the CPU, in
PyTorch on the card and in the kernel.
"""

from __future__ import annotations

import torch

from ilqgames_tpu_torch import fmath
from ilqgames_tpu_torch.dynamics.base import MultiPlayerDynamics, \
    SinglePlayerModel, true_div

# Model kinds of the rollout kernel's device ODE table (csrc/sweep.cu);
# KIND_LINEAR is dynamics/base.linear's system.
KIND_CAR_6D = 0
KIND_UNICYCLE_4D = 1
KIND_LINEAR = 2
KIND_CAR_5D = 3
KIND_DUBINS = 4
KIND_TWO_PLAYER_UNICYCLE_4D = 5
KIND_AIR_3D = 6
# The coupled systems: one subsystem over the whole state in the kernels.
COUPLED_KINDS = (KIND_TWO_PLAYER_UNICYCLE_4D, KIND_AIR_3D)


def point_mass_2d() -> SinglePlayerModel:
    """[px py vx vy] / [ax ay]: a constant-linear model, each row one term
    of coefficient 1 (its ode copies x[2], x[3], u[0], u[1], as the JAX
    package's does), which `concatenate` joins into one linear system."""
    rows = ((("x", 2, 1.0),), (("x", 3, 1.0),), (("u", (0, 0), 1.0),),
            (("u", (0, 1), 1.0),))

    def ode(t, x, u):
        return torch.stack([x[..., 2], x[..., 3], u[..., 0], u[..., 1]],
                           dim=-1)

    def jac(t, x, u):
        return ([((0, 2), 1.0), ((1, 3), 1.0)],
                [((2, 0), 1.0), ((3, 1), 1.0)])

    return SinglePlayerModel("point_mass_2d", 4, 2, ode, position_dims=(0, 1),
                             jac=jac, linear_rows=rows)


def dubins_car(speed: float) -> SinglePlayerModel:
    """[px py theta] / [omega] at fixed speed."""

    def ode(t, x, u):
        return torch.stack([speed * fmath.cos(x[..., 2]),
                            speed * fmath.sin(x[..., 2]), u[..., 0]], dim=-1)

    def jac(t, x, u):
        return ([((0, 2), -speed * fmath.sin(x[..., 2])),
                 ((1, 2), speed * fmath.cos(x[..., 2]))],
                [((2, 0), 1.0)])

    return SinglePlayerModel("dubins_car", 3, 1, ode, position_dims=(0, 1),
                             jac=jac, kind=KIND_DUBINS, length=speed)


def unicycle_4d() -> SinglePlayerModel:
    """[px py theta v] / [omega a]."""

    def ode(t, x, u):
        return torch.stack([x[..., 3] * fmath.cos(x[..., 2]),
                            x[..., 3] * fmath.sin(x[..., 2]),
                            u[..., 0], u[..., 1]], dim=-1)

    def jac(t, x, u):
        s, c = fmath.sin(x[..., 2]), fmath.cos(x[..., 2])
        return ([((0, 2), -x[..., 3] * s), ((0, 3), c),
                 ((1, 2), x[..., 3] * c), ((1, 3), s)],
                [((2, 0), 1.0), ((3, 1), 1.0)])

    return SinglePlayerModel("unicycle_4d", 4, 2, ode, position_dims=(0, 1),
                             jac=jac, kind=KIND_UNICYCLE_4D)


def car_5d(inter_axle_distance: float) -> SinglePlayerModel:
    """Bicycle [px py theta phi v] / [omega a]."""
    L = inter_axle_distance

    def ode(t, x, u):
        return torch.stack([x[..., 4] * fmath.cos(x[..., 2]),
                            x[..., 4] * fmath.sin(x[..., 2]),
                            true_div(x[..., 4], L) * fmath.tan(x[..., 3]),
                            u[..., 0], u[..., 1]], dim=-1)

    def jac(t, x, u):
        s, c = fmath.sin(x[..., 2]), fmath.cos(x[..., 2])
        cos_phi = fmath.cos(x[..., 3])
        sec2 = 1.0 / (cos_phi * cos_phi)
        return ([((0, 2), -x[..., 4] * s), ((0, 4), c),
                 ((1, 2), x[..., 4] * c), ((1, 4), s),
                 ((2, 3), true_div(x[..., 4], L) * sec2),
                 ((2, 4), true_div(fmath.tan(x[..., 3]), L))],
                [((3, 0), 1.0), ((4, 1), 1.0)])

    return SinglePlayerModel("car_5d", 5, 2, ode, position_dims=(0, 1),
                             jac=jac, kind=KIND_CAR_5D, length=L)


def car_6d(inter_axle_distance: float) -> SinglePlayerModel:
    """Bicycle with acceleration state [px py theta phi v a] / [omega jerk]."""
    L = inter_axle_distance

    def ode(t, x, u):
        return torch.stack([x[..., 4] * fmath.cos(x[..., 2]),
                            x[..., 4] * fmath.sin(x[..., 2]),
                            true_div(x[..., 4], L) * fmath.tan(x[..., 3]),
                            u[..., 0], x[..., 5], u[..., 1]], dim=-1)

    def jac(t, x, u):
        s, c = fmath.sin(x[..., 2]), fmath.cos(x[..., 2])
        cos_phi = fmath.cos(x[..., 3])
        sec2 = 1.0 / (cos_phi * cos_phi)
        return ([((0, 2), -x[..., 4] * s), ((0, 4), c),
                 ((1, 2), x[..., 4] * c), ((1, 4), s),
                 ((2, 3), true_div(x[..., 4], L) * sec2),
                 ((2, 4), true_div(fmath.tan(x[..., 3]), L)),
                 ((4, 5), 1.0)],
                [((3, 0), 1.0), ((5, 1), 1.0)])

    return SinglePlayerModel("car_6d", 6, 2, ode, position_dims=(0, 1),
                             jac=jac, kind=KIND_CAR_6D, length=L)


def two_player_unicycle_4d() -> MultiPlayerDynamics:
    """A unicycle [px py theta v] that P1 drives with [omega a], and a
    velocity disturbance [dx dy] of P2's, which owns no state (xdims
    (4, 0)): rows 0 and 1 read P2's controls."""

    def ode(t, x, us):
        return torch.stack([
            x[..., 3] * fmath.cos(x[..., 2]) + us[..., 1, 0],
            x[..., 3] * fmath.sin(x[..., 2]) + us[..., 1, 1],
            us[..., 0, 0], us[..., 0, 1]], dim=-1)

    def ode_jac(t, x, us):
        s, c = fmath.sin(x[..., 2]), fmath.cos(x[..., 2])
        return ([((0, 2), -x[..., 3] * s), ((0, 3), c),
                 ((1, 2), x[..., 3] * c), ((1, 3), s)],
                [((2, 0, 0), 1.0), ((3, 0, 1), 1.0),
                 ((0, 1, 0), 1.0), ((1, 1, 1), 1.0)])

    return MultiPlayerDynamics(
        name="two_player_unicycle_4d", xdims=(4, 0), udims=(2, 2), ode=ode,
        position_dims=((0, 1), (0, 1)), ode_jac=ode_jac,
        kind=KIND_TWO_PLAYER_UNICYCLE_4D)


def air_3d(evader_speed: float, pursuer_speed: float) -> MultiPlayerDynamics:
    """Pursuit-evasion in relative coordinates [rx ry rtheta]: u1 the
    evader's turn rate, u2 the pursuer's (xdims (3, 0)). Every row reads
    the controls, and so do the Jacobian's entries: df/dx holds w1, df/du1
    holds x. The device form carries both speeds (`params`)."""
    ve, vp = evader_speed, pursuer_speed

    def ode(t, x, us):
        w1, w2 = us[..., 0, 0], us[..., 1, 0]
        return torch.stack([
            -ve + vp * fmath.cos(x[..., 2]) + w1 * x[..., 1],
            vp * fmath.sin(x[..., 2]) - w1 * x[..., 0],
            w2 - w1], dim=-1)

    def ode_jac(t, x, us):
        w1 = us[..., 0, 0]
        return ([((0, 1), w1), ((0, 2), -vp * fmath.sin(x[..., 2])),
                 ((1, 0), -w1), ((1, 2), vp * fmath.cos(x[..., 2]))],
                [((0, 0, 0), x[..., 1]), ((1, 0, 0), -x[..., 0]),
                 ((2, 0, 0), -1.0), ((2, 1, 0), 1.0)])

    return MultiPlayerDynamics(
        name="air_3d", xdims=(3, 0), udims=(1, 1), ode=ode,
        position_dims=((0, 1), (0, 1)), ode_jac=ode_jac, kind=KIND_AIR_3D,
        params=(float(ve), float(vp)))
