"""The car_5d intersection pair (counterpart of
ilqgames_tpu/examples/modified_intersection.py): the soft-cost
`modified_three_player_intersection` and its safety counterpart
`three_player_intersection_reachability`, the problems that the
reference's minimally invasive receding-horizon example drives.

- make_problem (src/modified_three_player_intersection_example.cpp):
  car_5d + car_5d + unicycle_4d, x = 14, all soft costs (lane center and
  boundaries, semiquadratic minimum and maximum speeds, nominal speed,
  control quadratics), state and control regularization 10. The
  reference's proximity weight is 0.0 (shipped), so its proximity costs
  are no-ops and are left out, as in the JAX package.
- make_reachability (src/three_player_intersection_reachability_example
  .cpp): the same dynamics and initial state; P1 is a MAX player whose
  cost is the worse of its two signed-distance margins (an extreme value,
  nominal MIN_PROXIMITY) with small control costs; P2 and P3 keep their
  driving costs.
"""

from __future__ import annotations

import numpy as np
import torch

from ilqgames_tpu_torch.costs import atoms
from ilqgames_tpu_torch.costs.player_cost import STRUCTURE_MAX, PlayerCost
from ilqgames_tpu_torch.dynamics import base as dyn_base
from ilqgames_tpu_torch.dynamics import models
from ilqgames_tpu_torch.examples.three_player_intersection import \
    lane_polylines
from ilqgames_tpu_torch.problem import Problem

INTER_AXLE = 4.0
STATE_REG = 10.0
CONTROL_REG = 10.0
OMEGA_WEIGHT = 0.1
A_WEIGHT = 0.1
P1_CONTROL_WEIGHT = 0.1
LANE_WEIGHT = 25.0
LANE_BOUNDARY_WEIGHT = 100.0
MIN_PROXIMITY = 6.0
LANE_HALF_WIDTH = 2.5
MAX_V_WEIGHT = 100.0
NOMINAL_V_WEIGHT = 10.0
P1_MAX_V, P2_MAX_V, P3_MAX_V, MIN_V = 12.0, 12.0, 2.0, 1.0
P1_NOMINAL_V, P2_NOMINAL_V, P3_NOMINAL_V = 8.0, 6.0, 1.5

P1_INITIAL = dict(x=-2.0, y=-30.0, heading=np.pi / 2, speed=4.0)
P2_INITIAL = dict(x=-10.0, y=45.0, heading=-np.pi / 2, speed=3.0)
P3_INITIAL = dict(x=-11.0, y=16.0, heading=0.0, speed=1.25)

# car_5d = [px py theta phi v], unicycle_4d = [px py theta v].
IDX = dict(x1=0, y1=1, v1=4, x2=5, y2=6, v2=9, x3=10, y3=11, v3=13)


def _base(name, dt, num_time_steps):
    dyn = dyn_base.concatenate(
        name, [models.car_5d(INTER_AXLE), models.car_5d(INTER_AXLE),
               models.unicycle_4d()])
    spec = dyn.spec(dt=dt, num_time_steps=num_time_steps)
    x0 = np.zeros(spec.xdim, np.float32)
    for dims, init in (((0, 1, 2, 4), P1_INITIAL), ((5, 6, 7, 9), P2_INITIAL),
                       ((10, 11, 12, 13), P3_INITIAL)):
        x0[list(dims)] = [init["x"], init["y"], init["heading"],
                          init["speed"]]
    return dyn, spec, torch.from_numpy(x0)


def _driving_costs(lane, xi, yi, vi, max_v, nominal_v):
    return (
        atoms.quadratic_polyline2(LANE_WEIGHT, lane, xi, yi, "LaneCenter"),
        atoms.semiquadratic_polyline2(
            LANE_BOUNDARY_WEIGHT, lane, xi, yi, LANE_HALF_WIDTH, True,
            "LaneRightBoundary"),
        atoms.semiquadratic_polyline2(
            LANE_BOUNDARY_WEIGHT, lane, xi, yi, -LANE_HALF_WIDTH, False,
            "LaneLeftBoundary"),
        atoms.semiquadratic(MAX_V_WEIGHT, vi, MIN_V, False, "MinV"),
        atoms.semiquadratic(MAX_V_WEIGHT, vi, max_v, True, "MaxV"),
        atoms.quadratic(NOMINAL_V_WEIGHT, vi, nominal_v, "NominalV"),
    )


def _driver(lane, n, max_v, nominal_v) -> PlayerCost:
    """Player n's (1 or 2 from 0) driving costs and control quadratics."""
    i = IDX
    return PlayerCost(
        state_costs=_driving_costs(lane, i[f"x{n + 1}"], i[f"y{n + 1}"],
                                   i[f"v{n + 1}"], max_v, nominal_v),
        control_costs=(
            (n, atoms.quadratic(OMEGA_WEIGHT, 0, 0.0, "Steering")),
            (n, atoms.quadratic(A_WEIGHT, 1, 0.0, "Acceleration"))),
        state_regularization=STATE_REG,
        control_regularization=CONTROL_REG)


def make_problem(dt=None, num_time_steps=None) -> Problem:
    """modified_three_player_intersection."""
    name = "modified_three_player_intersection"
    dyn, spec, x0 = _base(name, dt, num_time_steps)
    lane1, lane2, lane3 = lane_polylines()
    return Problem(
        name=name, dynamics=dyn,
        player_costs=(_driver(lane1, 0, P1_MAX_V, P1_NOMINAL_V),
                      _driver(lane2, 1, P2_MAX_V, P2_NOMINAL_V),
                      _driver(lane3, 2, P3_MAX_V, P3_NOMINAL_V)),
        x0=x0, spec=spec)


def make_reachability(dt=None, num_time_steps=None) -> Problem:
    """three_player_intersection_reachability."""
    name = "three_player_intersection_reachability"
    dyn, spec, x0 = _base(name, dt, num_time_steps)
    _, lane2, lane3 = lane_polylines()
    i = IDX
    sd12 = atoms.signed_distance((i["x1"], i["y1"]), (i["x2"], i["y2"]),
                                 MIN_PROXIMITY, name="ProxCostP2")
    sd13 = atoms.signed_distance((i["x1"], i["y1"]), (i["x3"], i["y3"]),
                                 MIN_PROXIMITY, name="ProxCostP3")
    pc1 = PlayerCost(
        state_costs=(atoms.extreme_value((sd12, sd13), is_min=False,
                                         name="RelativeDistance"),),
        control_costs=(
            (0, atoms.quadratic(P1_CONTROL_WEIGHT, 0, 0.0, "Steering")),
            (0, atoms.quadratic(P1_CONTROL_WEIGHT, 1, 0.0, "Acceleration"))),
        structure=STRUCTURE_MAX,
        state_regularization=STATE_REG,
        control_regularization=CONTROL_REG)
    return Problem(
        name=name, dynamics=dyn,
        player_costs=(pc1, _driver(lane2, 1, P2_MAX_V, P2_NOMINAL_V),
                      _driver(lane3, 2, P3_MAX_V, P3_NOMINAL_V)),
        x0=x0, spec=spec)
