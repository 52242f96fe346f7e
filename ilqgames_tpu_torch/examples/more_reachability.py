"""The other pursuit-evasion and reachability examples (counterpart of
ilqgames_tpu/examples/more_reachability.py):

- `make_modified_air_3d` (:27-55, the reference's
  modified_air_3d_example.cpp): two 2D point masses, one linear system of
  8 states (dynamics/base.concatenate); the evader's quadratic difference
  of the two positions carries the weight -1e6 (it maximizes the
  separation), the pursuer's +1e6, each player with a control quadratic
  and a state regularization of 1.0. P2 starts at the Air3D relative
  state (rx0, ry0) = (4, 3).
- `make_two_player_collision_avoidance` (:58-102, the reference's
  two_player_collision_avoidance_reachability_example.cpp): two 5D cars
  on crossing courses; both players share ONE signed-distance atom under
  STRUCTURE_MAX, whose nominal is the separation at mid-horizon of the
  two straight-line extrapolations, computed in float64 numpy as the JAX
  package computes it.
"""

from __future__ import annotations

import numpy as np
import torch

from ilqgames_tpu_torch.costs import atoms
from ilqgames_tpu_torch.costs.player_cost import STRUCTURE_MAX, PlayerCost
from ilqgames_tpu_torch.dynamics import base as dyn_base
from ilqgames_tpu_torch.dynamics import models
from ilqgames_tpu_torch.problem import Problem

CONTROL_WEIGHT = 0.1
INTER_AXLE_LENGTH = 4.0


def make_modified_air_3d(dt=None, num_time_steps=None, rx0=4.0,
                         ry0=3.0) -> Problem:
    dyn = dyn_base.concatenate(
        "modified_air_3d", [models.point_mass_2d(), models.point_mass_2d()])
    spec = dyn.spec(dt=dt, num_time_steps=num_time_steps)

    x0 = np.zeros(spec.xdim, np.float32)
    x0[[4, 5]] = [rx0, ry0]  # P2 at the relative offset

    evader_w, pursuer_w = -1e6, 1e6

    def player(i, weight):
        return PlayerCost(
            state_costs=(atoms.quadratic_difference(weight, (0, 1), (4, 5),
                                                    "Target"),),
            control_costs=((i, atoms.quadratic(CONTROL_WEIGHT, None, 0.0,
                                               "ControlCost")),),
            state_regularization=1.0)

    return Problem(name="modified_air_3d", dynamics=dyn,
                   player_costs=(player(0, evader_w), player(1, pursuer_w)),
                   x0=torch.tensor(x0), spec=spec)


def make_two_player_collision_avoidance(dt=None, num_time_steps=None,
                                        px0=0.0, py0=-5.0) -> Problem:
    p1_heading, p1_speed = 0.1, 5.0
    p2 = dict(x=0.0, y=0.0, heading=0.0, speed=5.0)

    dyn = dyn_base.concatenate(
        "two_player_collision_avoidance_reachability",
        [models.car_5d(INTER_AXLE_LENGTH), models.car_5d(INTER_AXLE_LENGTH)])
    spec = dyn.spec(dt=dt, num_time_steps=num_time_steps)
    horizon = spec.dt * spec.num_time_steps

    x0 = np.zeros(spec.xdim, np.float32)
    x0[[0, 1, 2, 4]] = [px0, py0, p1_heading, p1_speed]
    x0[[5, 6, 7, 9]] = [p2["x"], p2["y"], p2["heading"], p2["speed"]]

    # The straight-line extrapolations' separation at mid-horizon.
    t_mid = 0.5 * horizon
    p1_mid = np.array([px0, py0]) + t_mid * p1_speed * np.array(
        [np.cos(p1_heading), np.sin(p1_heading)])
    p2_mid = np.array([p2["x"], p2["y"]]) + t_mid * p2["speed"] * np.array(
        [np.cos(p2["heading"]), np.sin(p2["heading"])])
    nominal = float(np.linalg.norm(p1_mid - p2_mid))

    sd = atoms.signed_distance((0, 1), (5, 6), nominal,
                               name="CollisionAvoidance")

    def player(i):
        return PlayerCost(
            state_costs=(sd,),
            control_costs=((i, atoms.quadratic(CONTROL_WEIGHT, None, 0.0,
                                               "ControlCost")),),
            structure=STRUCTURE_MAX)

    return Problem(name="two_player_collision_avoidance_reachability",
                   dynamics=dyn, player_costs=(player(0), player(1)),
                   x0=torch.tensor(x0), spec=spec)
