"""The skeleton example (counterpart of ilqgames_tpu/examples/skeleton.py;
the reference's src/skeleton_example.cpp): the template for a new game,
one player driving a unicycle_4d to a goal with a control-effort cost.

A new problem follows its steps: (1) pick each player's model from
`dynamics.models`, (2) concatenate them, (3) build each player's costs
from `costs.atoms` and `costs.constraints`, (4) return a Problem.
"""

from __future__ import annotations

import numpy as np
import torch

from ilqgames_tpu_torch.costs import atoms
from ilqgames_tpu_torch.costs.player_cost import PlayerCost
from ilqgames_tpu_torch.dynamics import base as dyn_base
from ilqgames_tpu_torch.dynamics import models
from ilqgames_tpu_torch.problem import Problem

GOAL = (10.0, 10.0)
GOAL_WEIGHT = 10.0
CONTROL_WEIGHT = 1.0


def make_problem(dt=None, num_time_steps=None) -> Problem:
    # 1-2. Dynamics: a single 4D unicycle.
    dyn = dyn_base.concatenate("skeleton", [models.unicycle_4d()])
    spec = dyn.spec(dt=dt, num_time_steps=num_time_steps)

    # 3. Costs: drive to the goal, penalize control effort.
    pc = PlayerCost(
        state_costs=(atoms.quadratic(GOAL_WEIGHT, 0, GOAL[0], "GoalX"),
                     atoms.quadratic(GOAL_WEIGHT, 1, GOAL[1], "GoalY")),
        control_costs=((0, atoms.quadratic(CONTROL_WEIGHT, None, 0.0,
                                           "Control")),))

    # 4. Initial state: at the origin, heading along +x at 1 m/s.
    x0 = np.array([0.0, 0.0, 0.0, 1.0], np.float32)
    return Problem(name="skeleton", dynamics=dyn, player_costs=(pc,),
                   x0=torch.from_numpy(x0), spec=spec)
