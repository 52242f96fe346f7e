"""Three-player intersection, the flagship (counterpart of
ilqgames_tpu/examples/three_player_intersection.py): two cars (6D
bicycle) and a pedestrian (4D unicycle), with the same constants,
initial state, weights, lane polylines and proximity constraints.
"""

from __future__ import annotations

import numpy as np
import torch

from ilqgames_tpu_torch.costs import atoms, constraints
from ilqgames_tpu_torch.costs.player_cost import PlayerCost
from ilqgames_tpu_torch.dynamics import base as dyn_base
from ilqgames_tpu_torch.dynamics import models
from ilqgames_tpu_torch.problem import Problem

INTER_AXLE_LENGTH = 4.0
STATE_REG = 1.0
CONTROL_REG = 5.0

OMEGA_COST_WEIGHT = 0.1
JERK_COST_WEIGHT = 0.1
A_COST_WEIGHT = 0.1
NOMINAL_V_COST_WEIGHT = 100.0
LANE_COST_WEIGHT = 25.0

MIN_PROXIMITY = 6.0

P1_NOMINAL_V = 8.0
P2_NOMINAL_V = 5.0
P3_NOMINAL_V = 1.5

P1_INITIAL = dict(x=-2.0, y=-30.0, heading=np.pi / 2, speed=4.0)
P2_INITIAL = dict(x=-10.0, y=45.0, heading=-np.pi / 2, speed=3.0)
P3_INITIAL = dict(x=-11.0, y=16.0, heading=0.0, speed=1.25)


def lane_polylines():
    """The three lane center polylines."""
    p1x, p2x, p3y = P1_INITIAL["x"], P2_INITIAL["x"], P3_INITIAL["y"]
    lane1 = np.array([[p1x, -1000.0], [p1x, 1000.0]], np.float32)
    lane2 = np.array(
        [
            [p2x, 1000.0],
            [p2x, 18.0],
            [p2x + 0.5, 15.0],
            [p2x + 1.0, 14.0],
            [p2x + 3.0, 12.5],
            [p2x + 6.0, 12.0],
            [1000.0, 12.0],
        ],
        np.float32,
    )
    lane3 = np.array([[-1000.0, p3y], [1000.0, p3y]], np.float32)
    return lane1, lane2, lane3


def make_problem(dt=None, num_time_steps=None) -> Problem:
    dyn = dyn_base.concatenate(
        "three_player_intersection",
        [models.car_6d(INTER_AXLE_LENGTH), models.car_6d(INTER_AXLE_LENGTH),
         models.unicycle_4d()],
    )
    spec = dyn.spec(dt=dt, num_time_steps=num_time_steps)

    # Joint-state indices: car6d = [px py theta phi v a], unicycle = [px py theta v].
    x1, y1, v1 = 0, 1, 4
    x2, y2, v2 = 6, 7, 10
    x3, y3, v3 = 12, 13, 15

    x0 = np.zeros(spec.xdim, np.float32)
    x0[[x1, y1, 2, v1]] = [P1_INITIAL["x"], P1_INITIAL["y"],
                           P1_INITIAL["heading"], P1_INITIAL["speed"]]
    x0[[x2, y2, 8, v2]] = [P2_INITIAL["x"], P2_INITIAL["y"],
                           P2_INITIAL["heading"], P2_INITIAL["speed"]]
    x0[[x3, y3, 14, v3]] = [P3_INITIAL["x"], P3_INITIAL["y"],
                            P3_INITIAL["heading"], P3_INITIAL["speed"]]

    lane1, lane2, lane3 = lane_polylines()

    def player(lane, xi, yi, vi, nominal_v, u_costs, others) -> PlayerCost:
        return PlayerCost(
            state_costs=(
                atoms.quadratic_polyline2(LANE_COST_WEIGHT, lane, xi, yi,
                                          "LaneCenter"),
                atoms.quadratic(NOMINAL_V_COST_WEIGHT, vi, nominal_v,
                                "NominalV"),
            ),
            control_costs=u_costs,
            state_constraints=tuple(
                constraints.proximity((xi, yi), (ox, oy), MIN_PROXIMITY,
                                      keep_within=False,
                                      name=f"ProximityConstraint{name}")
                for ox, oy, name in others
            ),
            state_regularization=STATE_REG,
            control_regularization=CONTROL_REG,
        )

    pc1 = player(
        lane1, x1, y1, v1, P1_NOMINAL_V,
        ((0, atoms.quadratic(OMEGA_COST_WEIGHT, 0, 0.0, "Steering")),
         (0, atoms.quadratic(JERK_COST_WEIGHT, 1, 0.0, "Jerk"))),
        [(x2, y2, "P2"), (x3, y3, "P3")],
    )
    pc2 = player(
        lane2, x2, y2, v2, P2_NOMINAL_V,
        ((1, atoms.quadratic(OMEGA_COST_WEIGHT, 0, 0.0, "Steering")),
         (1, atoms.quadratic(JERK_COST_WEIGHT, 1, 0.0, "Jerk"))),
        [(x1, y1, "P1"), (x3, y3, "P3")],
    )
    pc3 = player(
        lane3, x3, y3, v3, P3_NOMINAL_V,
        ((2, atoms.quadratic(OMEGA_COST_WEIGHT, 0, 0.0, "Steering")),
         (2, atoms.quadratic(A_COST_WEIGHT, 1, 0.0, "Acceleration"))),
        [(x1, y1, "P1"), (x2, y2, "P2")],
    )

    return Problem(name="three_player_intersection", dynamics=dyn,
                   player_costs=(pc1, pc2, pc3), x0=torch.from_numpy(x0),
                   spec=spec)
