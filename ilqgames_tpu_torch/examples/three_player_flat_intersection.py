"""Three-player flat intersection (counterpart of
ilqgames_tpu/examples/three_player_flat_intersection.py): two flat 6D
cars and a flat unicycle, costs authored in the feedback-linearized
coordinates xi, with the same constants, weights, lanes and atom order.
The initial state is given in real coordinates and mapped to xi
(`to_linear_state`). The dynamics are one constant-linear system, run by
the kernels as one linear subsystem per player.

The speed costs MinV and MaxV (`semiquadratic_norm`) have only a dense
quadraticization, so the game is solved with unfused stages, as the JAX
package solves it: its fused stage kernel refuses them.
"""

from __future__ import annotations

import numpy as np
import torch

from ilqgames_tpu_torch.costs import atoms
from ilqgames_tpu_torch.costs.player_cost import PlayerCost
from ilqgames_tpu_torch.dynamics import flat
from ilqgames_tpu_torch.examples.three_player_intersection import \
    lane_polylines
from ilqgames_tpu_torch.problem import Problem

INTER_AXLE_LENGTH = 4.0

UNICYCLE_AUX_WEIGHT = 500.0
CAR_AUX_WEIGHT = 500.0
MAX_V_WEIGHT = 10.0
NOMINAL_V_WEIGHT = 10.0
LANE_WEIGHT = 25.0
LANE_BOUNDARY_WEIGHT = 100.0
LANE_HALF_WIDTH = 2.5

MIN_PROXIMITY = 6.0
P1_PROX_WEIGHT = 100.0
P2_PROX_WEIGHT = 100.0
P3_PROX_WEIGHT = 10.0

P1_MAX_V, P2_MAX_V, P3_MAX_V, MIN_V = 12.0, 12.0, 2.0, 1.0
P1_NOMINAL_V, P2_NOMINAL_V, P3_NOMINAL_V = 8.0, 5.0, 1.5

# The flat example's initial speeds differ from the flagship's.
P1_INITIAL = dict(x=-2.0, y=-30.0, heading=np.pi / 2, speed=5.0)
P2_INITIAL = dict(x=-10.0, y=45.0, heading=-np.pi / 2, speed=5.0)
P3_INITIAL = dict(x=-11.0, y=16.0, heading=0.0, speed=1.25)


def make_problem(dt=None, num_time_steps=None) -> Problem:
    models = [flat.flat_car_6d(INTER_AXLE_LENGTH),
              flat.flat_car_6d(INTER_AXLE_LENGTH),
              flat.flat_unicycle_4d()]
    dyn = flat.concatenate_flat("three_player_flat_intersection", models)
    spec = dyn.spec(dt=dt, num_time_steps=num_time_steps)

    # xi indices: flat car_6d [px py vx vy ax ay], flat unicycle [px py vx vy].
    x1, y1, vx1, vy1 = 0, 1, 2, 3
    x2, y2, vx2, vy2 = 6, 7, 8, 9
    x3, y3, vx3, vy3 = 12, 13, 14, 15

    x0_real = np.zeros(spec.xdim, np.float32)
    for idx, init in (([0, 1, 2, 4], P1_INITIAL), ([6, 7, 8, 10], P2_INITIAL),
                      ([12, 13, 14, 15], P3_INITIAL)):
        x0_real[idx] = [init["x"], init["y"], init["heading"], init["speed"]]
    x0 = dyn.to_linear_state(torch.tensor(x0_real))

    lane1, lane2, lane3 = lane_polylines()

    def lane_costs(lane, xi, yi):
        return (
            atoms.quadratic_polyline2(LANE_WEIGHT, lane, xi, yi, "LaneCenter"),
            atoms.semiquadratic_polyline2(
                LANE_BOUNDARY_WEIGHT, lane, xi, yi, LANE_HALF_WIDTH, True,
                "LaneRightBoundary"),
            atoms.semiquadratic_polyline2(
                LANE_BOUNDARY_WEIGHT, lane, xi, yi, -LANE_HALF_WIDTH, False,
                "LaneLeftBoundary"),
        )

    def speed_costs(vxi, vyi, max_v, nominal_v):
        return (
            atoms.semiquadratic_norm(MAX_V_WEIGHT, vxi, vyi, MIN_V, False,
                                     "MinV"),
            atoms.semiquadratic_norm(MAX_V_WEIGHT, vxi, vyi, max_v, True,
                                     "MaxV"),
            atoms.quadratic_norm(NOMINAL_V_WEIGHT, vxi, vyi, nominal_v,
                                 "NominalV"),
        )

    def prox_costs(weight, xi, yi, others):
        return tuple(
            atoms.proximity(weight, (xi, yi), (ox, oy), MIN_PROXIMITY,
                            f"Proximity{name}")
            for ox, oy, name in others)

    def aux(player, weight):
        return ((player, atoms.quadratic(weight, None, 0.0, "Aux")),)

    pc1 = PlayerCost(
        state_costs=lane_costs(lane1, x1, y1)
        + speed_costs(vx1, vy1, P1_MAX_V, P1_NOMINAL_V)
        + prox_costs(P1_PROX_WEIGHT, x1, y1, [(x2, y2, "P2"), (x3, y3, "P3")]),
        control_costs=aux(0, CAR_AUX_WEIGHT))
    pc2 = PlayerCost(
        state_costs=lane_costs(lane2, x2, y2)
        + speed_costs(vx2, vy2, P2_MAX_V, P2_NOMINAL_V)
        + prox_costs(P2_PROX_WEIGHT, x2, y2, [(x1, y1, "P1"), (x3, y3, "P3")]),
        control_costs=aux(1, CAR_AUX_WEIGHT))
    pc3 = PlayerCost(
        state_costs=lane_costs(lane3, x3, y3)
        + speed_costs(vx3, vy3, P3_MAX_V, P3_NOMINAL_V)
        + prox_costs(P3_PROX_WEIGHT, x3, y3, [(x1, y1, "P1"), (x2, y2, "P2")]),
        control_costs=aux(2, UNICYCLE_AUX_WEIGHT))

    return Problem(name="three_player_flat_intersection", dynamics=dyn,
                   player_costs=(pc1, pc2, pc3), x0=x0, spec=spec)
