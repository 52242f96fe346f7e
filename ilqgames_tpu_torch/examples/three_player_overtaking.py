"""Three-player overtaking (counterpart of
ilqgames_tpu/examples/three_player_overtaking.py; the reference's
src/three_player_overtaking_example.cpp:75-334): three car_6d on a
two-lane road, P1 pulling into P2's lane to overtake. The reference's
shipped quirks are kept: P1's lane-center costs track lane1 (P2's lane,
the overtaking path), and P3's proximity costs are built upstream but
never added, so P3 has none.
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
OMEGA_WEIGHT = 500000.0
JERK_WEIGHT = 500.0
P1_NOMINAL_V_WEIGHT, P2_NOMINAL_V_WEIGHT, P3_NOMINAL_V_WEIGHT = 10.0, 1.0, 1.0
LANE_WEIGHT = 25.0
LANE_BOUNDARY_WEIGHT = 100.0
MIN_PROXIMITY = 5.0
PROX_WEIGHT = 100.0
LANE_HALF_WIDTH = 2.5
P1_NOMINAL_V, P2_NOMINAL_V, P3_NOMINAL_V = 15.0, 10.0, 10.0

P1_INITIAL = dict(x=2.5, y=-10.0, heading=np.pi / 2, speed=10.0)
P2_INITIAL = dict(x=-1.0, y=-10.0, heading=np.pi / 2, speed=2.0)
P3_INITIAL = dict(x=2.5, y=10.0, heading=np.pi / 2, speed=2.0)


def make_problem(dt=None, num_time_steps=None) -> Problem:
    dyn = dyn_base.concatenate(
        "three_player_overtaking", [models.car_6d(INTER_AXLE_LENGTH)] * 3)
    spec = dyn.spec(dt=dt, num_time_steps=num_time_steps)

    x1, y1, v1 = 0, 1, 4
    x2, y2, v2 = 6, 7, 10
    x3, y3, v3 = 12, 13, 16

    x0 = np.zeros(spec.xdim, np.float32)
    for (xi, yi, hi, vi), init in [((x1, y1, 2, v1), P1_INITIAL),
                                   ((x2, y2, 8, v2), P2_INITIAL),
                                   ((x3, y3, 14, v3), P3_INITIAL)]:
        x0[[xi, yi, hi, vi]] = [init["x"], init["y"], init["heading"],
                                init["speed"]]

    lane1 = np.array([[P2_INITIAL["x"], -1000.0], [P2_INITIAL["x"], 1000.0]],
                     np.float32)
    lane2 = np.array([[P3_INITIAL["x"], -1000.0], [P3_INITIAL["x"], 1000.0]],
                     np.float32)

    def lane_costs(lane, xi, yi):
        return (
            atoms.quadratic_polyline2(LANE_WEIGHT, lane, xi, yi,
                                      "LaneCenter"),
            atoms.semiquadratic_polyline2(
                LANE_BOUNDARY_WEIGHT, lane, xi, yi, LANE_HALF_WIDTH, True,
                "LaneRightBoundary"),
            atoms.semiquadratic_polyline2(
                LANE_BOUNDARY_WEIGHT, lane, xi, yi, -LANE_HALF_WIDTH, False,
                "LaneLeftBoundary"),
        )

    def controls(i):
        return ((i, atoms.quadratic(OMEGA_WEIGHT, 0, 0.0, "Steering")),
                (i, atoms.quadratic(JERK_WEIGHT, 1, 0.0, "Jerk")))

    pc1 = PlayerCost(
        state_costs=lane_costs(lane1, x1, y1) + (
            atoms.quadratic(P1_NOMINAL_V_WEIGHT, v1, P1_NOMINAL_V,
                            "NominalV"),
            atoms.proximity(PROX_WEIGHT, (x1, y1), (x2, y2), MIN_PROXIMITY,
                            "ProximityP2"),
            atoms.proximity(PROX_WEIGHT, (x1, y1), (x3, y3), MIN_PROXIMITY,
                            "ProximityP3"),
        ),
        control_costs=controls(0))
    pc2 = PlayerCost(
        state_costs=lane_costs(lane1, x2, y2) + (
            atoms.quadratic(P2_NOMINAL_V_WEIGHT, v2, P2_NOMINAL_V,
                            "NominalV"),
            atoms.proximity(PROX_WEIGHT, (x2, y2), (x1, y1), MIN_PROXIMITY,
                            "ProximityP1"),
            atoms.proximity(PROX_WEIGHT, (x2, y2), (x3, y3), MIN_PROXIMITY,
                            "ProximityP3"),
        ),
        control_costs=controls(1))
    # P3 has no proximity costs (the reference builds but never adds them).
    pc3 = PlayerCost(
        state_costs=lane_costs(lane2, x3, y3) + (
            atoms.quadratic(P3_NOMINAL_V_WEIGHT, v3, P3_NOMINAL_V,
                            "NominalV"),),
        control_costs=controls(2))

    return Problem(name="three_player_overtaking", dynamics=dyn,
                   player_costs=(pc1, pc2, pc3), x0=torch.from_numpy(x0),
                   spec=spec)
