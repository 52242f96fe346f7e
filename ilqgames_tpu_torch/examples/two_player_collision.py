"""Two-player collision avoidance (counterpart of
ilqgames_tpu/examples/two_player_collision.py): two 6D cars facing each
other in one lane, player 1 overtaking through an opening, with the same
weights, lane polylines, goal final-time costs and proximity costs;
unconstrained (proximity is a soft cost).
"""

from __future__ import annotations

import numpy as np
import torch

from ilqgames_tpu_torch.costs import atoms
from ilqgames_tpu_torch.costs.player_cost import PlayerCost
from ilqgames_tpu_torch.dynamics import base as dyn_base
from ilqgames_tpu_torch.dynamics import models
from ilqgames_tpu_torch.problem import Problem

INTER_AXLE_LENGTH = 4.0

OMEGA_WEIGHT = 5000.0
JERK_WEIGHT = 3250.0
P1_NOMINAL_V_WEIGHT = 10.0
P2_NOMINAL_V_WEIGHT = 1.0
LANE_WEIGHT = 250.0
LANE_BOUNDARY_WEIGHT = 50000.0
MIN_PROXIMITY = 7.5
PROX_WEIGHT = 5000.0
GOAL_WEIGHT = 1000.0
LANE_HALF_WIDTH = 2.5

P1_NOMINAL_V = 5.0
P2_NOMINAL_V = 5.0

P1_INITIAL = dict(x=2.5, y=-50.0, heading=np.pi / 2, speed=10.0)
P2_INITIAL = dict(x=2.5, y=50.0, heading=-np.pi / 2, speed=2.0)
P1_GOAL = (2.5, 50.0)
P2_GOAL = (2.5, -50.0)


def make_problem(dt=None, num_time_steps=None) -> Problem:
    dyn = dyn_base.concatenate(
        "two_player_collision",
        [models.car_6d(INTER_AXLE_LENGTH), models.car_6d(INTER_AXLE_LENGTH)])
    spec = dyn.spec(dt=dt, num_time_steps=num_time_steps)
    horizon = spec.dt * spec.num_time_steps

    x1, y1, v1 = 0, 1, 4
    x2, y2, v2 = 6, 7, 10

    x0 = np.zeros(spec.xdim, np.float32)
    x0[[x1, y1, 2, v1]] = [P1_INITIAL["x"], P1_INITIAL["y"],
                           P1_INITIAL["heading"], P1_INITIAL["speed"]]
    x0[[x2, y2, 8, v2]] = [P2_INITIAL["x"], P2_INITIAL["y"],
                           P2_INITIAL["heading"], P2_INITIAL["speed"]]

    lane_shared = np.array([[2.5, -50.0], [2.5, 50.0]], np.float32)
    e = 2.5 + LANE_HALF_WIDTH
    lane1_p1 = np.array([[e, -50.0], [e, -5.0]], np.float32)
    lane2_p1 = np.array([[e, 5.0], [e, 50.0]], np.float32)
    lane3_p1 = np.array([[10.0, -5.0], [10.0, 5.0]], np.float32)
    lane4_p1 = np.array([[e, 5.0], [25.0, 5.0]], np.float32)
    lane5_p1 = np.array([[e, -5.0], [25.0, -5.0]], np.float32)

    goal_window_start = horizon - 0.5  # the final-time costs' threshold

    def goal_costs(xi, yi, goal):
        return (
            atoms.final_time(atoms.quadratic(GOAL_WEIGHT, xi, goal[0]),
                             goal_window_start, "GoalX"),
            atoms.final_time(atoms.quadratic(GOAL_WEIGHT, yi, goal[1]),
                             goal_window_start, "GoalY"),
        )

    pc1 = PlayerCost(
        state_costs=(
            atoms.quadratic_polyline2(LANE_WEIGHT, lane_shared, x1, y1,
                                      "LaneCenter"),
            atoms.semiquadratic_polyline2(
                LANE_BOUNDARY_WEIGHT * 1000, lane_shared, x1, y1,
                -LANE_HALF_WIDTH, False, "LaneLeftBoundary"),
            atoms.semiquadratic_polyline2(
                LANE_BOUNDARY_WEIGHT, lane1_p1, x1, y1, 0.0, True,
                "LaneRightBoundary_lane1"),
            atoms.semiquadratic_polyline2(
                LANE_BOUNDARY_WEIGHT, lane2_p1, x1, y1, 0.0, True,
                "LaneRightBoundary_lane2"),
            atoms.semiquadratic_polyline2(
                LANE_BOUNDARY_WEIGHT, lane3_p1, x1, y1, 0.0, True,
                "LaneRightBoundary_lane3"),
            atoms.semiquadratic_polyline2(
                LANE_BOUNDARY_WEIGHT, lane4_p1, x1, y1, 0.0, False,
                "LaneLeftBoundary_lane4"),
            atoms.semiquadratic_polyline2(
                LANE_BOUNDARY_WEIGHT, lane5_p1, x1, y1, 0.0, True,
                "LaneRightBoundary_lane5"),
            atoms.quadratic(P1_NOMINAL_V_WEIGHT, v1, P1_NOMINAL_V,
                            "NominalV"),
            atoms.proximity(PROX_WEIGHT, (x1, y1), (x2, y2), MIN_PROXIMITY,
                            "ProximityP2"),
        ) + goal_costs(x1, y1, P1_GOAL),
        control_costs=(
            (0, atoms.quadratic(OMEGA_WEIGHT, 0, 0.0, "Steering")),
            (0, atoms.quadratic(JERK_WEIGHT, 1, 0.0, "Jerk")),
        ),
        state_regularization=1.0,
        control_regularization=0.0,
    )
    pc2 = PlayerCost(
        state_costs=(
            atoms.quadratic_polyline2(LANE_WEIGHT * 10, lane_shared, x2, y2,
                                      "LaneCenter"),
            atoms.semiquadratic_polyline2(
                LANE_BOUNDARY_WEIGHT * 10, lane_shared, x2, y2,
                -LANE_HALF_WIDTH, False, "LaneLeftBoundary"),
            atoms.semiquadratic_polyline2(
                LANE_BOUNDARY_WEIGHT, lane_shared, x2, y2, LANE_HALF_WIDTH,
                True, "LaneRightBoundary"),
            atoms.quadratic(P2_NOMINAL_V_WEIGHT, v2, P2_NOMINAL_V,
                            "NominalV"),
            atoms.proximity(PROX_WEIGHT, (x2, y2), (x1, y1), MIN_PROXIMITY,
                            "ProximityP1"),
        ) + goal_costs(x2, y2, P2_GOAL),
        control_costs=(
            (1, atoms.quadratic(OMEGA_WEIGHT, 0, 0.0, "Steering")),
            (1, atoms.quadratic(JERK_WEIGHT, 1, 0.0, "Jerk")),
        ),
        state_regularization=1.0,
        control_regularization=0.0,
    )
    return Problem(name="two_player_collision", dynamics=dyn,
                   player_costs=(pc1, pc2), x0=torch.tensor(x0), spec=spec)
