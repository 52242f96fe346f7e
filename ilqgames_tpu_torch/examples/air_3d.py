"""Air3D pursuit-evasion in relative coordinates (counterpart of
ilqgames_tpu/examples/air_3d.py, the reference's air_3d_example.cpp): the
classic Hamilton-Jacobi benchmark on one coupled system
(`models.air_3d`, xdims (3, 0)). The evader (P1) maximizes over time the
signed distance to a circle of radius 5 (10 segments) and the pursuer
(P2) minimizes it, with the constructor quirk's nominals 0.0 and 1.0;
each has a turn-rate quadratic of weight 0.1 and the box |omega| <= 1 as
two `single_dimension` constraints, P2's on its control index 0 (the
reference's P2-max-on-Omega1Idx quirk, which constrains u2[0] either
way: each player has one control)."""

from __future__ import annotations

import numpy as np
import torch

from ilqgames_tpu_torch import geometry
from ilqgames_tpu_torch.costs import atoms, constraints
from ilqgames_tpu_torch.costs.player_cost import STRUCTURE_MAX, \
    STRUCTURE_MIN, PlayerCost
from ilqgames_tpu_torch.dynamics import models
from ilqgames_tpu_torch.problem import Problem

OMEGA_COST_WEIGHT = 0.1
OMEGA_MAX = 1.0


def make_problem(dt=None, num_time_steps=None, rx0=4.0, ry0=3.0,
                 rtheta0=np.pi / 4, ve=1.0, vp=1.0) -> Problem:
    dyn = models.air_3d(ve, vp)
    spec = dyn.spec(dt=dt, num_time_steps=num_time_steps)

    x0 = np.zeros(spec.xdim, np.float32)
    x0[:3] = [rx0, ry0, rtheta0]

    circle = geometry.draw_circle((0.0, 0.0), 5.0, 10)

    def player(i, nominal, structure):
        return PlayerCost(
            state_costs=(atoms.polyline2_signed_distance(circle, 0, 1,
                                                         nominal=nominal,
                                                         name="Target"),),
            control_costs=((i, atoms.quadratic(OMEGA_COST_WEIGHT, None, 0.0,
                                               "ControlCost")),),
            control_constraints=(
                (i, constraints.single_dimension(0, OMEGA_MAX, True,
                                                 "OmegaMax")),
                (i, constraints.single_dimension(0, -OMEGA_MAX, False,
                                                 "OmegaMin")),
            ),
            structure=structure)

    return Problem(name="air_3d", dynamics=dyn,
                   player_costs=(player(0, 0.0, STRUCTURE_MAX),
                                 player(1, 1.0, STRUCTURE_MIN)),
                   x0=torch.tensor(x0), spec=spec)
