"""Two Dubins cars: player 1 wants player 2 at the origin, player 2 is
attracted to player 1 (counterpart of
ilqgames_tpu/examples/dubins_origin.py; the reference's
src/dubins_origin_example.cpp:63-141). The reference's example of the
open-loop and feedback information patterns: the same game solved both
ways (`SolverParams.open_loop`) gives different play.
"""

from __future__ import annotations

import numpy as np
import torch

from ilqgames_tpu_torch.costs import atoms
from ilqgames_tpu_torch.costs.player_cost import PlayerCost
from ilqgames_tpu_torch.dynamics import base as dyn_base
from ilqgames_tpu_torch.dynamics import models
from ilqgames_tpu_torch.problem import Problem

OMEGA_WEIGHT = 100.0
ATTRACTION_WEIGHT = 10.0
GOAL_WEIGHT = 10.0
SPEED = 1.0


def make_problem(dt=None, num_time_steps=None) -> Problem:
    dyn = dyn_base.concatenate(
        "dubins_origin", [models.dubins_car(SPEED), models.dubins_car(SPEED)])
    spec = dyn.spec(dt=dt, num_time_steps=num_time_steps)

    x1, y1 = 0, 1
    x2, y2 = 3, 4

    x0 = np.zeros(spec.xdim, np.float32)
    x0[[x1, y1, 2]] = [0.0, -10.0, np.pi - 0.01]
    x0[[x2, y2, 5]] = [0.0, 10.0, 1.5 * np.pi]

    pc1 = PlayerCost(
        state_costs=(atoms.quadratic(GOAL_WEIGHT, x2, 0.0, "GoalX"),
                     atoms.quadratic(GOAL_WEIGHT, y2, 0.0, "GoalY")),
        control_costs=((0, atoms.quadratic(OMEGA_WEIGHT, 0, 0.0,
                                           "Steering")),),
    )
    pc2 = PlayerCost(
        state_costs=(atoms.quadratic_difference(
            ATTRACTION_WEIGHT, (x1, y1), (x2, y2), "AttractionCost"),),
        control_costs=((1, atoms.quadratic(OMEGA_WEIGHT, 0, 0.0,
                                           "Steering")),),
    )
    return Problem(name="dubins_origin", dynamics=dyn,
                   player_costs=(pc1, pc2), x0=torch.tensor(x0), spec=spec)
