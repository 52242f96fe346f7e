"""Three-player collision-avoidance reachability (counterpart of
ilqgames_tpu/examples/reachability.py:103-157,
`make_three_player_collision_avoidance`; the reference's
three_player_collision_avoidance_reachability_example.cpp and BENCH_ALL's
config 5): three 5D cars on a collision course. Each player's cost is the
maximum over time (STRUCTURE_MAX) of the worse of its two pairwise
signed-distance margins (an extreme value with the maximum, buffer 3 m,
no weight), plus a control quadratic, under box constraints on its turn
rate (|omega| <= 1) and acceleration (|a| <= 0.1).
"""

from __future__ import annotations

import numpy as np
import torch

from ilqgames_tpu_torch.costs import atoms, constraints
from ilqgames_tpu_torch.costs.player_cost import STRUCTURE_MAX, PlayerCost
from ilqgames_tpu_torch.dynamics import base as dyn_base
from ilqgames_tpu_torch.dynamics import models
from ilqgames_tpu_torch.problem import Problem

INTER_AXLE_LENGTH = 4.0
OMEGA_MAX, A_MAX = 1.0, 0.1
CONTROL_WEIGHT = 0.1


def make_three_player_collision_avoidance(dt=None, num_time_steps=None,
                                          d0=5.0, v0=5.0,
                                          buffer=3.0) -> Problem:
    dyn = dyn_base.concatenate(
        "three_player_collision_avoidance_reachability",
        [models.car_5d(INTER_AXLE_LENGTH)] * 3)
    spec = dyn.spec(dt=dt, num_time_steps=num_time_steps)

    pert = 0.1
    x0 = np.zeros(spec.xdim, np.float32)
    x0[[0, 1, 2, 4]] = [d0, 0.0, -np.pi + pert, v0]
    x0[[5, 6, 7, 9]] = [-0.5 * d0, 0.5 * np.sqrt(3.0) * d0,
                        -np.pi / 3.0 + pert, v0]
    x0[[10, 11, 12, 14]] = [-0.5 * d0, -0.5 * np.sqrt(3.0) * d0,
                            np.pi / 3.0 + pert, v0]

    p = [(0, 1), (5, 6), (10, 11)]  # position dims per player
    sd12 = atoms.signed_distance(p[0], p[1], buffer, name="SD12")
    sd13 = atoms.signed_distance(p[0], p[2], buffer, name="SD13")
    sd23 = atoms.signed_distance(p[1], p[2], buffer, name="SD23")

    def box(player):
        return (
            (player, constraints.single_dimension(0, OMEGA_MAX, True,
                                                  "OmegaMax")),
            (player, constraints.single_dimension(0, -OMEGA_MAX, False,
                                                  "OmegaMin")),
            (player, constraints.single_dimension(1, A_MAX, True, "AMax")),
            (player, constraints.single_dimension(1, -A_MAX, False,
                                                  "AMin")),
        )

    def player(i, pair):
        return PlayerCost(
            state_costs=(atoms.extreme_value(pair, is_min=False,
                                             name="Proximity"),),
            control_costs=((i, atoms.quadratic(CONTROL_WEIGHT, None, 0.0,
                                               "ControlCost")),),
            control_constraints=box(i),
            structure=STRUCTURE_MAX)

    return Problem(
        name="three_player_collision_avoidance_reachability",
        dynamics=dyn,
        player_costs=(player(0, (sd12, sd13)), player(1, (sd12, sd23)),
                      player(2, (sd23, sd13))),
        x0=torch.tensor(x0), spec=spec)


def make_problem(dt=None, num_time_steps=None) -> Problem:
    """BENCH_ALL config 5's game."""
    return make_three_player_collision_avoidance(dt, num_time_steps)
