"""Four-car roundabout merging (counterpart of
ilqgames_tpu/examples/roundabout_merging.py; the reference's
src/roundabout_merging_example.cpp:75-455): four car_6d entering a
roundabout of radius 12 m from four sides, x = 24, 4 players x 2
controls, 11 cost atoms each. The reference's shipped quirks are kept:
every player's acceleration cost acts on P1's acceleration state (:317-327
all use kP1AIdx); proximity costs are added only against the ring
neighbours (P1: P2, P4; P2: P1, P3; P3: P2, P4; P4: P1, P3); the initial
operating point is zero (InitializeAlongRoute is commented out upstream).
"""

from __future__ import annotations

import numpy as np
import torch

from ilqgames_tpu_torch.costs import atoms
from ilqgames_tpu_torch.costs.player_cost import PlayerCost
from ilqgames_tpu_torch.dynamics import base as dyn_base
from ilqgames_tpu_torch.dynamics import models
from ilqgames_tpu_torch.examples.routes import roundabout_lane_center
from ilqgames_tpu_torch.problem import Problem

OMEGA_WEIGHT = 500.0
A_WEIGHT = 50.0
JERK_WEIGHT = 5.0
MAX_V_WEIGHT = 1000.0
NOMINAL_V_WEIGHT = 10.0
LANE_WEIGHT = 25.0
LANE_BOUNDARY_WEIGHT = 100.0
MIN_PROXIMITY = 6.0
PROX_WEIGHT = 100.0
LANE_HALF_WIDTH = 2.5
MAX_V, MIN_V, NOMINAL_V = 12.0, 1.0, 10.0
INTER_AXLE = 4.0

DISTANCES = (25.0, 10.0, 25.0, 10.0)
SPEEDS = (3.0, 2.0, 3.0, 2.0)


def make_problem(dt=None, num_time_steps=None) -> Problem:
    dyn = dyn_base.concatenate("roundabout_merging",
                               [models.car_6d(INTER_AXLE)] * 4)
    spec = dyn.spec(dt=dt, num_time_steps=num_time_steps)

    angles = [np.pi / 4 + i * np.pi / 2 for i in range(4)]
    lanes = [roundabout_lane_center(angles[i], angles[i] + np.pi,
                                    DISTANCES[i]) for i in range(4)]

    # car_6d = [px py theta phi v a]: (px, py, heading, v, a) per player.
    xi = [(6 * i, 6 * i + 1, 6 * i + 2, 6 * i + 4, 6 * i + 5)
          for i in range(4)]

    x0 = np.zeros(spec.xdim, np.float32)
    for i, (px, py, hi, vi, _) in enumerate(xi):
        first, second = lanes[i][0], lanes[i][1]
        heading = np.arctan2(second[1] - first[1], second[0] - first[0])
        x0[[px, py, hi, vi]] = [first[0], first[1], heading, SPEEDS[i]]

    prox_pairs = {0: (1, 3), 1: (0, 2), 2: (1, 3), 3: (0, 2)}
    p1_a_idx = xi[0][4]  # every acceleration cost acts on P1's (shipped)

    pcs = []
    for i, (px, py, _, vi, _) in enumerate(xi):
        state_costs = [
            atoms.quadratic_polyline2(LANE_WEIGHT, lanes[i], px, py,
                                      "LaneCenter"),
            atoms.semiquadratic_polyline2(
                LANE_BOUNDARY_WEIGHT, lanes[i], px, py, LANE_HALF_WIDTH,
                True, "LaneRightBoundary"),
            atoms.semiquadratic_polyline2(
                LANE_BOUNDARY_WEIGHT, lanes[i], px, py, -LANE_HALF_WIDTH,
                False, "LaneLeftBoundary"),
            atoms.semiquadratic(MAX_V_WEIGHT, vi, MIN_V, False, "MinV"),
            atoms.semiquadratic(MAX_V_WEIGHT, vi, MAX_V, True, "MaxV"),
            atoms.quadratic(NOMINAL_V_WEIGHT, vi, NOMINAL_V, "NominalV"),
            atoms.quadratic(A_WEIGHT, p1_a_idx, 0.0, "Acceleration"),
        ]
        for j in prox_pairs[i]:
            state_costs.append(atoms.proximity(
                PROX_WEIGHT, (px, py), (xi[j][0], xi[j][1]), MIN_PROXIMITY,
                f"ProximityP{j + 1}"))
        pcs.append(PlayerCost(
            state_costs=tuple(state_costs),
            control_costs=(
                (i, atoms.quadratic(OMEGA_WEIGHT, 0, 0.0, "Steering")),
                (i, atoms.quadratic(JERK_WEIGHT, 1, 0.0, "Jerk")))))

    return Problem(name="roundabout_merging", dynamics=dyn,
                   player_costs=tuple(pcs), x0=torch.from_numpy(x0),
                   spec=spec)
