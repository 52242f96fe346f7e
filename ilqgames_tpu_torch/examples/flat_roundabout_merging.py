"""Four-car flat roundabout merging (counterpart of
ilqgames_tpu/examples/flat_roundabout_merging.py; the reference's
src/flat_roundabout_merging_example.cpp): four flat 6D cars in the
feedback-linearized coordinates xi, x = 24, 4 players x 2 auxiliary
controls. Route-progress atoms replace the nominal-speed quadratics, one
aux-input quadratic a car, proximity costs only against the ring
neighbours (P1: P2, P4; P2: P1, P3; P3: P2, P4; P4: P1, P3), and, unlike
the nonlinear roundabout, InitializeAlongRoute is active: the initial
operating point puts each car on its lane at its initial speed
(`Problem.op_initializer`).

Every atom has sparse pairs, so the game runs on fused stages, as the JAX
package's default machine runs it; its table holds 32 atoms once each
aux quadratic is split per dimension.
"""

from __future__ import annotations

import numpy as np
import torch

from ilqgames_tpu_torch.costs import atoms
from ilqgames_tpu_torch.costs.player_cost import PlayerCost
from ilqgames_tpu_torch.dynamics import flat
from ilqgames_tpu_torch.examples.routes import initialize_along_route, \
    roundabout_lane_center
from ilqgames_tpu_torch.problem import Problem

AUX_WEIGHT = 4.0
NOMINAL_V_WEIGHT = 10.0
LANE_WEIGHT = 25.0
LANE_BOUNDARY_WEIGHT = 100.0
MIN_PROXIMITY = 6.0
PROX_WEIGHT = 100.0
LANE_HALF_WIDTH = 2.5
NOMINAL_V = 10.0
INTER_AXLE = 4.0

DISTANCES = (25.0, 10.0, 25.0, 10.0)
SPEEDS = (3.0, 2.0, 3.0, 2.0)


def make_problem(dt=None, num_time_steps=None) -> Problem:
    dyn = flat.concatenate_flat("flat_roundabout_merging",
                                [flat.flat_car_6d(INTER_AXLE)] * 4)
    spec = dyn.spec(dt=dt, num_time_steps=num_time_steps)

    angles = [np.pi / 4 + i * np.pi / 2 for i in range(4)]
    lanes = [roundabout_lane_center(angles[i], angles[i] + np.pi,
                                    DISTANCES[i]) for i in range(4)]

    # xi layout per flat car: [px py vx vy ax ay].
    pos = [(6 * i, 6 * i + 1) for i in range(4)]

    x0_real = np.zeros(spec.xdim, np.float32)
    for i in range(4):
        first, second = lanes[i][0], lanes[i][1]
        heading = np.arctan2(second[1] - first[1], second[0] - first[0])
        o = 6 * i
        x0_real[[o, o + 1, o + 2, o + 4]] = [first[0], first[1], heading,
                                             SPEEDS[i]]
    x0 = dyn.to_linear_state(torch.tensor(x0_real))

    prox_pairs = {0: (1, 3), 1: (0, 2), 2: (1, 3), 3: (0, 2)}

    pcs = []
    for i, (px, py) in enumerate(pos):
        state_costs = [
            atoms.quadratic_polyline2(LANE_WEIGHT, lanes[i], px, py,
                                      "LaneCenter"),
            atoms.semiquadratic_polyline2(
                LANE_BOUNDARY_WEIGHT, lanes[i], px, py, LANE_HALF_WIDTH,
                True, "LaneRightBoundary"),
            atoms.semiquadratic_polyline2(
                LANE_BOUNDARY_WEIGHT, lanes[i], px, py, -LANE_HALF_WIDTH,
                False, "LaneLeftBoundary"),
            atoms.route_progress(NOMINAL_V_WEIGHT, lanes[i], px, py,
                                 NOMINAL_V, name="RouteProgress"),
        ]
        for j in prox_pairs[i]:
            state_costs.append(atoms.proximity(
                PROX_WEIGHT, (px, py), pos[j], MIN_PROXIMITY,
                f"ProximityP{j + 1}"))
        pcs.append(PlayerCost(
            state_costs=tuple(state_costs),
            control_costs=((i, atoms.quadratic(AUX_WEIGHT, None, 0.0,
                                               "Aux")),)))

    def op_initializer(spec_, op):
        for i, (px, py) in enumerate(pos):
            op = initialize_along_route(spec_, op, lanes[i], 0.0, SPEEDS[i],
                                        (px, py))
        return op

    return Problem(name="flat_roundabout_merging", dynamics=dyn,
                   player_costs=tuple(pcs), x0=x0, spec=spec,
                   op_initializer=op_initializer)
