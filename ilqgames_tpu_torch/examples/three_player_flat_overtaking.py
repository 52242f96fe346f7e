"""Three-player flat overtaking (counterpart of
ilqgames_tpu/examples/three_player_flat_overtaking.py; the reference's
src/three_player_flat_overtaking_example.cpp): three flat 6D cars, costs
authored in the feedback-linearized coordinates xi, x = 18, 3 players x 2
auxiliary controls, with the same constants, weights, lanes and atom
order. Unlike the nonlinear overtaking, a route-progress atom replaces the
nominal-speed quadratic (P1's with initial route position kP1InitialY -
kP2InitialY = 0), one aux-input quadratic replaces the steering and jerk
costs, P3 has proximity costs too, and the initial speeds are (5, 5,
5.25). The initial state is given in real coordinates and mapped to xi.

Every atom has sparse pairs, so the game runs on fused stages, as the JAX
package's default machine runs it.
"""

from __future__ import annotations

import numpy as np
import torch

from ilqgames_tpu_torch.costs import atoms
from ilqgames_tpu_torch.costs.player_cost import PlayerCost
from ilqgames_tpu_torch.dynamics import flat
from ilqgames_tpu_torch.problem import Problem

INTER_AXLE = 4.0
CAR_AUX_WEIGHT = 5000.0
P1_NOMINAL_V_WEIGHT, P2_NOMINAL_V_WEIGHT, P3_NOMINAL_V_WEIGHT = 10.0, 1.0, 1.0
LANE_WEIGHT = 25.0
LANE_BOUNDARY_WEIGHT = 100.0
MIN_PROXIMITY = 5.0
PROX_WEIGHT = 100.0
LANE_HALF_WIDTH = 2.5
P1_NOMINAL_V, P2_NOMINAL_V, P3_NOMINAL_V = 15.0, 10.0, 10.0

P1_INITIAL = dict(x=2.5, y=-10.0, heading=np.pi / 2, speed=5.0)
P2_INITIAL = dict(x=-1.0, y=-10.0, heading=np.pi / 2, speed=5.0)
P3_INITIAL = dict(x=2.5, y=10.0, heading=np.pi / 2, speed=5.25)


def make_problem(dt=None, num_time_steps=None) -> Problem:
    models = [flat.flat_car_6d(INTER_AXLE)] * 3
    dyn = flat.concatenate_flat("three_player_flat_overtaking", models)
    spec = dyn.spec(dt=dt, num_time_steps=num_time_steps)

    # xi layout per flat car: [px py vx vy ax ay].
    x1, y1 = 0, 1
    x2, y2 = 6, 7
    x3, y3 = 12, 13

    x0_real = np.zeros(spec.xdim, np.float32)
    for idx, init in (([0, 1, 2, 4], P1_INITIAL), ([6, 7, 8, 10], P2_INITIAL),
                      ([12, 13, 14, 16], P3_INITIAL)):
        x0_real[idx] = [init["x"], init["y"], init["heading"], init["speed"]]
    x0 = dyn.to_linear_state(torch.tensor(x0_real))

    # The lanes start at the cars' initial y: route progress is measured
    # in arc length from a polyline's first point.
    lane1 = np.array([[P2_INITIAL["x"], P2_INITIAL["y"]],
                      [P2_INITIAL["x"], 1000.0]], np.float32)
    lane2 = np.array([[P3_INITIAL["x"], P3_INITIAL["y"]],
                      [P3_INITIAL["x"], 1000.0]], np.float32)

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

    def prox(xi, yi, others):
        return tuple(
            atoms.proximity(PROX_WEIGHT, (xi, yi), o, MIN_PROXIMITY,
                            f"Proximity{n}")
            for o, n in others)

    def aux(player):
        return ((player, atoms.quadratic(CAR_AUX_WEIGHT, None, 0.0, "Aux")),)

    pc1 = PlayerCost(
        state_costs=lane_costs(lane1, x1, y1) + (
            atoms.route_progress(
                P1_NOMINAL_V_WEIGHT, lane1, x1, y1, P1_NOMINAL_V,
                initial_route_pos=P1_INITIAL["y"] - P2_INITIAL["y"],
                name="RouteProgress"),
        ) + prox(x1, y1, [((x2, y2), "P2"), ((x3, y3), "P3")]),
        control_costs=aux(0))
    pc2 = PlayerCost(
        state_costs=lane_costs(lane1, x2, y2) + (
            atoms.route_progress(P2_NOMINAL_V_WEIGHT, lane1, x2, y2,
                                 P2_NOMINAL_V, name="RouteProgress"),
        ) + prox(x2, y2, [((x1, y1), "P1"), ((x3, y3), "P3")]),
        control_costs=aux(1))
    pc3 = PlayerCost(
        state_costs=lane_costs(lane2, x3, y3) + (
            atoms.route_progress(P3_NOMINAL_V_WEIGHT, lane2, x3, y3,
                                 P3_NOMINAL_V, name="RouteProgress"),
        ) + prox(x3, y3, [((x1, y1), "P1"), ((x2, y2), "P2")]),
        control_costs=aux(2))

    return Problem(name="three_player_flat_overtaking", dynamics=dyn,
                   player_costs=(pc1, pc2, pc3), x0=x0, spec=spec)
