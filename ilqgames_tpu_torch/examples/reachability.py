"""Reachability examples (counterpart of ilqgames_tpu/examples/
reachability.py):

- `make_one_player` (:36-66, the reference's
  one_player_reachability_example.cpp): a Dubins car (speed 1) and a
  circular target of radius 2 (10 segments); its cost is the maximum
  over time (STRUCTURE_MAX) of the signed distance to the circle minus
  1.0, plus a control quadratic, under |omega| <= 1. The reference's
  constructor call passes its avoid flag where the float nominal sits and
  the name where the orientation sits, so the cost that ships is the
  signed distance - 1.0 with the default orientation: kept.
- `make_three_player_collision_avoidance` (:103-157, the reference's
  three_player_collision_avoidance_reachability_example.cpp and
  BENCH_ALL's config 5): three 5D cars on a collision course. Each
  player's cost is the maximum over time of the worse of its two pairwise
  signed-distance margins (an extreme value with the maximum, buffer 3 m,
  no weight), plus a control quadratic, under box constraints on its turn
  rate (|omega| <= 1) and acceleration (|a| <= 0.1).
- `make_two_player` (:69-100, the reference's
  two_player_reachability_example.cpp): a unicycle that P1 drives
  (STRUCTURE_MAX: it avoids the target) and a velocity disturbance of
  P2's (STRUCTURE_MIN: it reaches for it), one coupled system
  (`models.two_player_unicycle_4d`, xdims (4, 0)). Both players' costs are
  the signed distance to one circle of radius 1 (10 segments), with the
  constructor quirk's nominals 0.0 (P1) and 1.0 (P2), plus a control
  quadratic.
"""

from __future__ import annotations

import numpy as np
import torch

from ilqgames_tpu_torch import geometry
from ilqgames_tpu_torch.costs import atoms, constraints
from ilqgames_tpu_torch.costs.player_cost import STRUCTURE_MAX, \
    STRUCTURE_MIN, PlayerCost
from ilqgames_tpu_torch.dynamics import base as dyn_base
from ilqgames_tpu_torch.dynamics import models
from ilqgames_tpu_torch.problem import Problem

INTER_AXLE_LENGTH = 4.0
OMEGA_MAX, A_MAX = 1.0, 0.1
CONTROL_WEIGHT = 0.1


def make_one_player(dt=None, num_time_steps=None, px0=-5.0, py0=-5.0,
                    theta0=np.pi / 4) -> Problem:
    speed = 1.0
    dyn = dyn_base.concatenate("one_player_reachability",
                               [models.dubins_car(speed)])
    spec = dyn.spec(dt=dt, num_time_steps=num_time_steps)

    x0 = np.zeros(spec.xdim, np.float32)
    x0[:3] = [px0, py0, theta0]

    circle = geometry.draw_circle((0.0, 0.0), 2.0, 10)
    pc1 = PlayerCost(
        state_costs=(atoms.polyline2_signed_distance(circle, 0, 1,
                                                     nominal=1.0,
                                                     name="Target"),),
        control_costs=((0, atoms.quadratic(CONTROL_WEIGHT, None, 0.0,
                                           "ControlCost")),),
        control_constraints=(
            (0, constraints.single_dimension(0, OMEGA_MAX, True,
                                             "OmegaMax")),
            (0, constraints.single_dimension(0, -OMEGA_MAX, False,
                                             "OmegaMin")),
        ),
        structure=STRUCTURE_MAX)
    return Problem(name="one_player_reachability", dynamics=dyn,
                   player_costs=(pc1,), x0=torch.tensor(x0), spec=spec)


def make_two_player(dt=None, num_time_steps=None, px0=0.0, py0=-10.0,
                    theta0=np.pi / 4, v0=5.0) -> Problem:
    dyn = models.two_player_unicycle_4d()
    spec = dyn.spec(dt=dt, num_time_steps=num_time_steps)

    x0 = np.zeros(spec.xdim, np.float32)
    x0[:4] = [px0, py0, theta0, v0]

    circle = geometry.draw_circle((0.0, 0.0), 1.0, 10)

    def player(i, nominal, structure):
        return PlayerCost(
            state_costs=(atoms.polyline2_signed_distance(circle, 0, 1,
                                                         nominal=nominal,
                                                         name="Target"),),
            control_costs=((i, atoms.quadratic(CONTROL_WEIGHT, None, 0.0,
                                               "ControlCost")),),
            structure=structure)

    return Problem(name="two_player_reachability", dynamics=dyn,
                   player_costs=(player(0, 0.0, STRUCTURE_MAX),
                                 player(1, 1.0, STRUCTURE_MIN)),
                   x0=torch.tensor(x0), spec=spec)


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
