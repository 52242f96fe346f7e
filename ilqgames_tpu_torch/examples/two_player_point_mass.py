"""Two-player 1D point mass, an exactly LQ game (counterpart of
ilqgames_tpu/examples/two_player_point_mass.py): a double integrator
driven by both players' controls with asymmetric authority and coupled
quadratic costs, with the same constants, weights and x0. Player 2 owns
no state (xdims (2, 0)); the dynamics are one constant-linear system
(dynamics/base.linear) that reads every player's controls.
"""

from __future__ import annotations

import numpy as np
import torch

from ilqgames_tpu_torch.costs import atoms
from ilqgames_tpu_torch.costs.player_cost import PlayerCost
from ilqgames_tpu_torch.dynamics import base as dyn_base
from ilqgames_tpu_torch.problem import Problem

A_CONT = np.array([[0.0, 1.0], [0.0, 0.0]], np.float32)
B1 = np.array([0.05, 1.0], np.float32)
B2 = np.array([0.032, 0.11], np.float32)
COST_SCALE = 0.1


def make_problem(dt=None, num_time_steps=None, x0=(1.0, 0.0)) -> Problem:
    b10, b11 = float(B1[0]), float(B1[1])
    b20, b21 = float(B2[0]), float(B2[1])
    # x0' = x1 + b10 u1 + b20 u2, x1' = b11 u1 + b21 u2.
    dyn = dyn_base.linear(
        "two_player_point_mass", xdims=(2, 0), udims=(1, 1),
        rows=((("x", 1, 1.0), ("u", (0, 0), b10), ("u", (1, 0), b20)),
              (("u", (0, 0), b11), ("u", (1, 0), b21))))
    spec = dyn.spec(dt=dt, num_time_steps=num_time_steps)

    pc1 = PlayerCost(
        state_costs=(atoms.quadratic(1.0, None, 0.0, "State"),),
        control_costs=(
            (0, atoms.quadratic(1.0, None, 0.0, "OwnControl")),
            (1, atoms.quadratic(COST_SCALE, None, 0.0, "OtherControl")),
        ),
    )
    pc2 = PlayerCost(
        state_costs=(atoms.quadratic(COST_SCALE, None, 0.0, "State"),),
        control_costs=(
            (0, atoms.quadratic(COST_SCALE, None, 0.0, "OtherControl")),
            (1, atoms.quadratic(1.0, None, 0.0, "OwnControl")),
        ),
    )
    return Problem(name="two_player_point_mass", dynamics=dyn,
                   player_costs=(pc1, pc2),
                   x0=torch.tensor(np.asarray(x0, np.float32)), spec=spec)
