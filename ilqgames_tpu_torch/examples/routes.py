"""Route helpers (counterpart of ilqgames_tpu/examples/routes.py): the
roundabout's lane centers and an operating point laid along a route
(the reference's src/roundabout_lane_center.cpp:51-108 and
src/initialize_along_route.cpp:54-73). Points are made in numpy float32,
as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ilqgames_tpu_torch import geometry
from ilqgames_tpu_torch.types import GameSpec, OperatingPoint

ROUNDABOUT_RADIUS = 12.0
LANE_HALF_WIDTH = 2.5


def roundabout_lane_center(entrance_angle: float, exit_angle: float,
                           distance_from_roundabout: float) -> np.ndarray:
    """Entry lane, a 90-degree entry arc, the roundabout's arc and the exit
    ray: [16, 2] float32."""
    r = ROUNDABOUT_RADIUS
    w = LANE_HALF_WIDTH

    arc_center = np.array(
        [(r + w) * np.cos(entrance_angle), (r + w) * np.sin(entrance_angle)]
    )
    first_arc_angle = entrance_angle - np.pi / 2
    first_arc_point = arc_center + w * np.array(
        [np.cos(first_arc_angle), np.sin(first_arc_angle)]
    )

    points = [
        first_arc_point
        + distance_from_roundabout
        * np.array([np.cos(entrance_angle), np.sin(entrance_angle)]),
        first_arc_point,
    ]
    num_arc = 3
    for i in range(1, num_arc + 1):
        a = first_arc_angle - (np.pi / 2) * i / num_arc
        points.append(arc_center + w * np.array([np.cos(a), np.sin(a)]))

    num_round = 10
    for i in range(1, num_round + 1):
        a = entrance_angle + (exit_angle - entrance_angle) * i / num_round
        points.append(np.array([r * np.cos(a), r * np.sin(a)]))

    far = 1e4
    points.append(np.array([far * np.cos(exit_angle),
                            far * np.sin(exit_angle)]))
    return np.stack(points).astype(np.float32)


def initialize_along_route(spec: GameSpec, op: OperatingPoint, route,
                           initial_route_pos: float, nominal_speed: float,
                           position_dims) -> OperatingPoint:
    """`op` (one instance: xs [N, x]) with the position dims of every knot
    k on the route, initial_route_pos + nominal_speed * k * dt meters
    along it."""
    ks = torch.arange(spec.num_time_steps, dtype=torch.float32)
    route_pos = initial_route_pos + nominal_speed * ks * spec.dt
    xy = geometry.polyline_point_at(route, route_pos)
    xs = op.xs.clone()
    xs[:, position_dims[0]] = xy[:, 0].to(xs.device)
    xs[:, position_dims[1]] = xy[:, 1].to(xs.device)
    return op.replace(xs=xs)
