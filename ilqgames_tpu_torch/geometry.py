"""Polyline closest-point query and the shapes the examples draw
(counterpart of ilqgames_tpu/geometry.py).

Queries are elementwise over tensors of any shape; the polyline is a
static (M, 2) array whose segment constants are Python floats, computed
in float32 as the JAX package computes them. The sign-free query
(`need_sign=False`) returns |signed sq distance|; the signed one adds the
side of the segment (right positive) and the interior-vertex side fix
through the shortcut segment, as the JAX query does.

The winner is the first segment with the smallest |sq distance| (the
reference's strict-< scan), and an exactly collinear off-end candidate
has distance 0 (the reference's sgn(0) == 0), both as in the JAX query.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ilqgames_tpu_torch import fmath
from ilqgames_tpu_torch.types import SMALL_NUMBER

_EPS = 1e-12


class ClosestPointXY(NamedTuple):
    cpx: torch.Tensor
    cpy: torch.Tensor
    signed_sq_distance: torch.Tensor  # |ssd| under need_sign=False
    is_vertex: torch.Tensor
    is_endpoint: torch.Tensor
    p1x: torch.Tensor
    p1y: torch.Tensor
    ux: torch.Tensor
    uy: torch.Tensor


def _static_segments(points):
    """Per-segment Python-float constants: (p1, p2, unit, length)."""
    pts = np.asarray(points, np.float32)
    segs = []
    for s in range(pts.shape[0] - 1):
        p1 = pts[s]
        p2 = pts[s + 1]
        d = p2 - p1
        length = float(np.sqrt(np.float32(d @ d)))
        denom = np.float32(max(length, _EPS))
        ux, uy = (d / denom).tolist()
        segs.append(((float(p1[0]), float(p1[1])),
                     (float(p2[0]), float(p2[1])),
                     (float(ux), float(uy)),
                     length))
    return pts, segs


def shortcut_segments(points):
    """Per segment s, the constants of the interior-vertex side fix: the
    shortcut (x0, y0, ux, uy) used when the closest point is the segment's
    first point, spanning points s-1 and s+1, and the one used otherwise,
    spanning points s and s+2 (indices clamped), as the JAX query computes
    them."""
    pts = np.asarray(points, np.float32)
    S = pts.shape[0] - 1

    def sc(pa, pb):
        d = pb - pa
        ln = max(float(np.sqrt(d @ d)), _EPS)
        return float(pa[0]), float(pa[1]), float(d[0] / ln), float(d[1] / ln)

    return [sc(pts[max(s - 1, 0)], pts[min(s + 1, S)])
            + sc(pts[s], pts[min(s + 2, S)]) for s in range(S)]


def sign(x: torch.Tensor) -> torch.Tensor:
    """jnp.sign: -1, +1, or x itself at +-0 and NaN."""
    return torch.where(x > 0.0, 1.0, torch.where(x < 0.0, -1.0, x))


def polyline_cumulative_lengths(points) -> torch.Tensor:
    """[M] cumulative arc length at each vertex (first entry 0), float32:
    each segment's norm, then a running sum in vertex order."""
    pts = torch.as_tensor(np.asarray(points, np.float32))
    d = pts[1:] - pts[:-1]
    seg = fmath.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
    out = [torch.zeros((), dtype=torch.float32)]
    for s in range(seg.shape[0]):
        out.append(out[-1] + seg[s])
    return torch.stack(out)


def polyline_point_at(points, route_pos: torch.Tensor) -> torch.Tensor:
    """The point `route_pos` meters along the polyline, [..., 2] (the
    JAX package's polyline_point_at, the reference's Polyline2::PointAt):
    the last segment whose cumulative start length (a Python float sum of
    the float32 lengths) is <= route_pos wins, and a position past the end
    extrapolates the last segment."""
    _, segs = _static_segments(points)
    cum = 0.0
    px = py = None
    for s, (p1, _p2, (ux, uy), length) in enumerate(segs):
        rem = route_pos - cum
        cand_x = p1[0] + rem * ux
        cand_y = p1[1] + rem * uy
        if s == 0:
            px, py = cand_x, cand_y
        else:
            inside = route_pos >= cum
            px = torch.where(inside, cand_x, px)
            py = torch.where(inside, cand_y, py)
        cum += length
    return torch.stack([px, py], dim=-1)


def polyline_closest_point_xy(points, qx: torch.Tensor, qy: torch.Tensor,
                              need_sign: bool = False) -> ClosestPointXY:
    """Closest point on the polyline to (qx, qy), elementwise."""
    pts, segs = _static_segments(points)
    S = len(segs)
    fixes = shortcut_segments(points) if need_sign else None

    cand = []
    for s, (p1, p2, (ux, uy), length) in enumerate(segs):
        rx, ry = qx - p1[0], qy - p1[1]
        dot = rx * ux + ry * uy
        cross = rx * uy - ux * ry
        sq_p1 = rx * rx + ry * ry
        r2x, r2y = qx - p2[0], qy - p2[1]
        sq_p2 = r2x * r2x + r2y * r2y

        behind = dot < 0.0
        ahead = dot > length
        cpx = torch.where(behind, p1[0],
                          torch.where(ahead, p2[0], p1[0] + dot * ux))
        cpy = torch.where(behind, p1[1],
                          torch.where(ahead, p2[1], p1[1] + dot * uy))
        abs_raw = torch.where(behind, sq_p1,
                              torch.where(ahead, sq_p2, cross * cross))
        abs_ssd = torch.where(cross == 0.0, 0.0, abs_raw)
        ssd = abs_ssd
        if need_sign:
            ssd = sign(cross) * abs_ssd
            # The side of the shortcut segment decides the sign at an
            # interior vertex of the polyline.
            at_first = ~ahead
            ax0, ay0, aux, auy, bx0, by0, bux, buy = fixes[s]
            scx0 = torch.where(at_first, ax0, bx0)
            scy0 = torch.where(at_first, ay0, by0)
            scux = torch.where(at_first, aux, bux)
            scuy = torch.where(at_first, auy, buy)
            on_right = ((qx - scx0) * scuy - scux * (qy - scy0)) > 0.0
            fix = behind | ahead
            if s == 0:
                fix = fix & ~at_first
            if s == S - 1:
                fix = fix & at_first
            ssd = torch.where(fix, torch.where(on_right, torch.abs(ssd),
                                               -torch.abs(ssd)), ssd)
        cand.append((cpx, cpy, ssd, behind | ahead, p1, (ux, uy)))

    # First-occurrence winner as exclusive masks.
    absd = [torch.abs(c[2]) for c in cand]
    m = absd[0]
    for a in absd[1:]:
        m = torch.minimum(m, a)
    sel = []
    taken = torch.zeros_like(m, dtype=torch.bool)
    for a in absd:
        hit = (a <= m) & ~taken
        sel.append(hit)
        taken = taken | hit

    def pick(vals):
        acc = vals[0]
        for s in range(1, S):
            acc = torch.where(sel[s], vals[s], acc)
        return acc

    def const(v):
        return torch.full_like(qx, v)

    cpx = pick([c[0] for c in cand])
    cpy = pick([c[1] for c in cand])
    chosen_ssd = pick([c[2] for c in cand])
    chosen_is_vertex = pick([c[3] for c in cand])
    p1x = pick([const(c[4][0]) for c in cand])
    p1y = pick([const(c[4][1]) for c in cand])
    unx = pick([const(c[5][0]) for c in cand])
    uny = pick([const(c[5][1]) for c in cand])

    fx, fy = float(pts[0][0]), float(pts[0][1])
    lx, ly = float(pts[-1][0]), float(pts[-1][1])
    d_first = (cpx - fx) ** 2 + (cpy - fy) ** 2
    d_last = (cpx - lx) ** 2 + (cpy - ly) ** 2
    is_endpoint = (d_first < SMALL_NUMBER) | (d_last < SMALL_NUMBER)

    return ClosestPointXY(cpx=cpx, cpy=cpy, signed_sq_distance=chosen_ssd,
                          is_vertex=chosen_is_vertex,
                          is_endpoint=is_endpoint, p1x=p1x, p1y=p1y,
                          ux=unx, uy=uny)


def draw_square(center, side_length: float) -> np.ndarray:
    """Closed square polyline [5, 2] float32, counterclockwise from the
    top-left corner (the JAX package's draw_square, the reference's
    src/draw_shapes.cpp:51-63): each coordinate the center's float32 value
    minus or plus half the side, rounded to float32 as the JAX package's
    float32 arithmetic rounds it."""
    h = np.float32(0.5 * side_length)
    cx, cy = np.asarray(center, np.float32)[:2]
    return np.array([[cx - h, cy + h], [cx - h, cy - h], [cx + h, cy - h],
                     [cx + h, cy + h], [cx - h, cy + h]], np.float32)


def draw_circle(center, radius: float, num_segments: int) -> np.ndarray:
    """Closed circular polyline [num_segments + 1, 2] float32 (the JAX
    package's draw_circle, the reference's src/draw_shapes.cpp:65-75),
    with the JAX package's float32 values bit for bit at the reference's
    sizes. Its angles are `jnp.linspace(0, 2 pi, num_segments + 1)` as
    XLA compiles it: the division by num_segments becomes a product with
    its float32 reciprocal, folded into the constant stop, so angle i is
    (stop * (1 / num_segments)) * i in float32 and the last is stop
    itself. Its cosines and sines are XLA's float32 cos and sin, which at
    these angles equal the correctly rounded values (taken here in
    float64 and rounded) for every num_segments up to 33, the reference's
    10 among them (tests/test_torch_reach_family.py checks the points);
    then center + radius * cos (sin) in float32."""
    stop = np.float32(2.0 * np.pi)
    n = int(num_segments)
    step = stop * (np.float32(1.0) / np.float32(n))
    angles = np.append(step * np.arange(n, dtype=np.float32),
                       stop).astype(np.float32)
    c = np.asarray(center, np.float32)
    r = np.float32(radius)
    cos = np.cos(angles.astype(np.float64)).astype(np.float32)
    sin = np.sin(angles.astype(np.float64)).astype(np.float32)
    return np.stack([c[0] + r * cos, c[1] + r * sin], -1).astype(np.float32)
