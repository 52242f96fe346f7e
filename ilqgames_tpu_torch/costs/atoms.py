"""Cost atoms (counterpart of ilqgames_tpu/costs/atoms.py: `quadratic` at
:39, `semiquadratic` at :79, `quadratic_norm` at :103, `semiquadratic_norm` at :120,
`quadratic_difference` at :148, `signed_distance` at :178, `proximity` at
:213, `quadratic_polyline2` at :366, `semiquadratic_polyline2` at :433,
`polyline2_signed_distance` at :511, `route_progress` at :589,
`final_time` at :652 and `extreme_value` at :685).

Gradients and Hessians are the JAX package's sparse pairs, with the
reference's shipped branch semantics for the polyline costs: a vertex
branch (isotropic pull toward the vertex), an interior branch (quadratic
in the cross-track coordinate), and zero at the polyline's endpoints.
The proximity cost's quadraticization is the JAX package's autodiff over
its support, written out: its gradient with autodiff's operations, its
Hessian analytically (within float32 rounding of autodiff's). The signed
distance's is the operations of autodiff's forward-over-reverse Hessian
as XLA compiles them, within a few ulps of the JAX package's (XLA
simplifies each program on its own, so no written form is bitwise
equal to every one of them).

`t` is the knot time each caller passes: relative (k * dt) in total costs
and the unfused quadraticization, absolute (t0 + k * dt) in the stage
kernel's plain version and the merits, as in the JAX package; only
`final_time` and `route_progress` read it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ilqgames_tpu_torch import fmath, geometry
from ilqgames_tpu_torch.costs.base import Cost, assemble_matrix, \
    assemble_vector, extreme_index

_EPS = 1e-12


def quadratic(weight: float, dim: Optional[int], nominal: float = 0.0,
              name: str = "quadratic") -> Cost:
    """0.5*w*(v[dim]-nominal)^2, or over all dims when dim is None (the
    control padding dims included: w*I over every dim, as autodiff of the
    JAX package's evaluate gives)."""
    device = ("quadratic", {"dim": -1 if dim is None else dim,
                            "weight": weight, "nominal": nominal})
    if dim is None:
        def evaluate_all(t, v):
            d = v - nominal
            sq = d * d
            total = sq[..., 0]
            for k in range(1, v.shape[-1]):
                total = total + sq[..., k]
            return 0.5 * weight * total

        def grad_pairs_all(t, v):
            return [(k, weight * (v[..., k] - nominal))
                    for k in range(v.shape[-1])]

        def quad_pairs_all(t, v):
            return ([((k, k), torch.full_like(v[..., 0], weight))
                     for k in range(v.shape[-1])], grad_pairs_all(t, v))

        return Cost(name, evaluate_all, grad_pairs_all, quad_pairs_all,
                    device=device)

    def evaluate(t, v):
        d = v[..., dim] - nominal
        return 0.5 * weight * d * d

    def grad_pairs(t, v):
        return [(dim, weight * (v[..., dim] - nominal))]

    def quad_pairs(t, v):
        return ([((dim, dim), torch.full_like(v[..., 0], weight))],
                grad_pairs(t, v))

    return Cost(name, evaluate, grad_pairs, quad_pairs, device=device)


def semiquadratic(weight: float, dim: int, threshold: float,
                  oriented_right: bool, name: str = "semiquadratic") -> Cost:
    """0.5*w*(v[dim]-threshold)^2 above (oriented_right) or below the
    threshold, else 0: strictly beyond it (zero at the threshold), as the
    JAX package's `where`s select."""

    def active(v):
        diff = v[..., dim] - threshold
        return diff, (diff > 0.0) if oriented_right else (diff < 0.0)

    def evaluate(t, v):
        diff, on = active(v)
        return torch.where(on, 0.5 * weight * diff * diff, 0.0)

    def grad_pairs(t, v):
        diff, on = active(v)
        return [(dim, torch.where(on, weight * diff, 0.0))]

    def quad_pairs(t, v):
        _, on = active(v)
        return ([((dim, dim), torch.where(on, weight, 0.0))],
                grad_pairs(t, v))

    return Cost(name, evaluate, grad_pairs, quad_pairs,
                device=("semiquadratic", {"dim": dim, "weight": weight,
                                          "threshold": threshold,
                                          "oriented_right": oriented_right}))


def _norm_quad(weight: float, dim1: int, dim2: int, nominal: float, v):
    """What the JAX package's autodiff of 0.5*w*(||(v[d1], v[d2])|| -
    nominal)^2 (norm clamped at EPS, `_safe_hypot`) gives, written out:
    its gradient with autodiff's operations, (g1, g2), and its Hessian
    over (d1, d2) in closed form, (h11, h22, h12). With s the squared
    norm, n the norm, d = n - nominal and G the clamp's derivative (1
    above EPS, 1/2 at it, 0 below): the gradient is 2 ct a with
    ct = (w d (0.5 / n)) G, the Hessian w G d / n I + w G^2 nominal / n^3
    (a, b) (a, b)^T. Every division is of two tensors."""
    a, b = v[..., dim1], v[..., dim2]
    s = a * a + b * b
    n = fmath.sqrt(torch.clamp_min(s, _EPS))
    d = n - nominal
    clamp = torch.where(s > _EPS, 1.0, torch.where(s == _EPS, 0.5, 0.0))
    half = 0.5 * weight
    ct = ((half * (d + d)) * (torch.full_like(n, 0.5) / n)) * clamp
    k1 = weight * clamp * d / n
    k2 = weight * clamp * clamp * nominal / (n * n * n)
    g = (ct * a + ct * a, ct * b + ct * b)
    return g, (k1 + k2 * a * a, k1 + k2 * b * b, k2 * a * b)


def quadratic_norm(weight: float, dim1: int, dim2: int, nominal: float,
                   name: str = "quadratic_norm") -> Cost:
    """0.5*w*(||(v[d1], v[d2])|| - nominal)^2. Its gradient pairs are the
    JAX package's closed form (w (n - nominal) / n) (a, b); its
    quadraticization is what the JAX package's autodiff over the support
    (d1, d2) gives (`_norm_quad`)."""

    def norm(v):
        a, b = v[..., dim1], v[..., dim2]
        return fmath.sqrt(torch.clamp_min(a * a + b * b, _EPS))

    def evaluate(t, v):
        diff = norm(v) - nominal
        return 0.5 * weight * diff * diff

    def grad_pairs(t, v):
        n = norm(v)
        ct = weight * (n - nominal) / n
        return [(dim1, ct * v[..., dim1]), (dim2, ct * v[..., dim2])]

    def quad_pairs(t, v):
        (g1, g2), (h11, h22, h12) = _norm_quad(weight, dim1, dim2, nominal,
                                               v)
        return ([((dim1, dim1), h11), ((dim1, dim2), h12),
                 ((dim2, dim1), h12), ((dim2, dim2), h22)],
                [(dim1, g1), (dim2, g2)])

    return Cost(name, evaluate, grad_pairs, quad_pairs,
                device=("quadratic_norm", {"dims": (dim1, dim2),
                                           "weight": weight,
                                           "nominal": nominal}))


def semiquadratic_norm(weight: float, dim1: int, dim2: int,
                       threshold: float, oriented_right: bool,
                       name: str = "semiquadratic_norm") -> Cost:
    """One-sided quadratic_norm about `threshold`. Dense only, as in the
    JAX package (no pairs): its `quad_fn` is autodiff's over all of v,
    non-zero at d1 and d2 only, and switches on at >= (oriented right) or
    <= of the norm, where `evaluate` switches on > or < of norm -
    threshold (the reference's shipped quadraticize, ties included)."""

    def evaluate(t, v):
        a, b = v[..., dim1], v[..., dim2]
        diff = fmath.sqrt(torch.clamp_min(a * a + b * b, _EPS)) - threshold
        active = (diff > 0.0) if oriented_right else (diff < 0.0)
        return torch.where(active, 0.5 * weight * diff * diff, 0.0)

    def active(v):
        a, b = v[..., dim1], v[..., dim2]
        n = fmath.sqrt(torch.clamp_min(a * a + b * b, _EPS))
        return (n >= threshold) if oriented_right else (n <= threshold)

    def dense(v, g, h=None):
        """[..., d] (and [..., d, d]) zeros but at d1 and d2, gated."""
        on = active(v)
        grad = torch.zeros_like(v)
        grad[..., dim1] = torch.where(on, g[0], 0.0)
        grad[..., dim2] = torch.where(on, g[1], 0.0)
        if h is None:
            return grad
        hess = v.new_zeros(v.shape + (v.shape[-1],))
        for (i, j), e in (((dim1, dim1), h[0]), ((dim1, dim2), h[2]),
                          ((dim2, dim1), h[2]), ((dim2, dim2), h[1])):
            hess[..., i, j] = torch.where(on, e, 0.0)
        return hess, grad

    def grad_fn(t, v):
        g, _ = _norm_quad(weight, dim1, dim2, threshold, v)
        return dense(v, g)

    def quad_fn(t, v):
        return dense(v, *_norm_quad(weight, dim1, dim2, threshold, v))

    return Cost(name, evaluate, quad_fn=quad_fn, grad_fn=grad_fn,
                device=("semiquadratic_norm", {
                    "dims": (dim1, dim2), "weight": weight,
                    "threshold": threshold,
                    "oriented_right": oriented_right}))


def quadratic_difference(weight: float, dims1, dims2,
                         name: str = "quadratic_difference") -> Cost:
    """0.5*w*sum_i (v[dims1[i]] - v[dims2[i]])^2.

    The JAX package quadraticizes it by autodiff over its support
    dims1 + dims2 (`costs/base.py` `_restricted`), and the pairs here are
    what that gives, in support order: the gradient 0.0 + (p + p) at
    dims1[i] and 0.0 + -(p + p) at dims2[i], with p = (0.5 w) d_i and
    d_i = v[dims1[i]] - v[dims2[i]] (the 0.0 is the scatter into the
    support's zeros: a zero gradient is +0); the Hessian over every
    (support, support) pair, w on the diagonal, -w between dims1[i] and
    dims2[i], +0 elsewhere, whatever v is. Its device form at two
    differences (the position pairs of every reference game) is the
    kernels' CT_DIFF atom; at any other count a header row and a row per
    difference (CT_ZOO)."""
    d1, d2 = tuple(dims1), tuple(dims2)
    if len(d1) != len(d2):
        raise ValueError("dims1 and dims2 differ in length")
    half = 0.5 * weight
    support = d1 + d2
    n = len(d1)

    def evaluate(t, v):
        total = None
        for a, b in zip(d1, d2):
            diff = v[..., a] - v[..., b]
            sq = diff * diff
            total = sq if total is None else total + sq
        return half * total

    def grad_pairs(t, v):
        gs = []
        for a, b in zip(d1, d2):
            p = half * (v[..., a] - v[..., b])
            gs.append(p + p)
        return ([(a, 0.0 + g) for a, g in zip(d1, gs)]
                + [(b, 0.0 + -g) for b, g in zip(d2, gs)])

    def quad_pairs(t, v):
        like = v[..., 0]

        def entry(r, c):
            if r == c:
                return torch.full_like(like, weight)
            if r % n == c % n:
                return torch.full_like(like, -weight)
            return torch.zeros_like(like)

        hp = [((support[r], support[c]), entry(r, c))
              for r in range(2 * n) for c in range(2 * n)]
        return hp, grad_pairs(t, v)

    if n == 2:
        device = ("quadratic_difference", {"dims": support, "weight": weight})
    else:
        device = ("quadratic_difference_n", {"dims1": d1, "dims2": d2,
                                             "weight": weight})
    return Cost(name, evaluate, grad_pairs, quad_pairs, device=device)


def quadratic_polyline2(weight: float, points, xidx: int, yidx: int,
                        name: str = "quadratic_polyline2") -> Cost:
    """0.5*w*|signed sq distance to the polyline|, zeroed when the closest
    point is a polyline endpoint."""

    def evaluate(t, v):
        res = geometry.polyline_closest_point_xy(points, v[..., xidx],
                                                 v[..., yidx])
        ssd = torch.where(res.is_endpoint, 0.0, res.signed_sq_distance)
        return 0.5 * weight * torch.abs(ssd)

    def _scalars(v):
        qx, qy = v[..., xidx], v[..., yidx]
        res = geometry.polyline_closest_point_xy(points, qx, qy)

        dxv = weight * (qx - res.cpx)
        dyv = weight * (qy - res.cpy)

        ux, uy = res.ux, res.uy
        w_cross = weight * ((qx - res.p1x) * uy - (qy - res.p1y) * ux)
        dxi = w_cross * uy
        dyi = -w_cross * ux
        hi = (weight * uy * uy, weight * ux * ux, -weight * ux * uy)

        use_v = res.is_vertex
        gate = (~res.is_endpoint).to(torch.float32)
        dx = torch.where(use_v, dxv, dxi) * gate
        dy = torch.where(use_v, dyv, dyi) * gate
        ddx = torch.where(use_v, weight, hi[0]) * gate
        ddy = torch.where(use_v, weight, hi[1]) * gate
        dxdy = torch.where(use_v, 0.0, hi[2]) * gate
        return dx, dy, ddx, ddy, dxdy

    def grad_pairs(t, v):
        dx, dy, _, _, _ = _scalars(v)
        return [(xidx, dx), (yidx, dy)]

    def quad_pairs(t, v):
        dx, dy, ddx, ddy, dxdy = _scalars(v)
        return ([((xidx, xidx), ddx), ((yidx, yidx), ddy),
                 ((xidx, yidx), dxdy), ((yidx, xidx), dxdy)],
                [(xidx, dx), (yidx, dy)])

    return Cost(name, evaluate, grad_pairs, quad_pairs,
                device=("polyline", {"points": points, "xidx": xidx,
                                     "yidx": yidx, "weight": weight}))


def semiquadratic_polyline2(weight: float, points, xidx: int, yidx: int,
                            threshold: float, oriented_right: bool,
                            name: str = "semiquadratic_polyline2") -> Cost:
    """One-sided lane-boundary cost on the signed distance past a
    threshold: active where the signed sq distance is beyond the signed
    sq threshold on the oriented side, zero at the polyline's endpoints."""
    sst = (1.0 if threshold >= 0 else -1.0) * threshold * threshold

    def active(ssd):
        return ssd > sst if oriented_right else ssd < sst

    def evaluate(t, v):
        res = geometry.polyline_closest_point_xy(
            points, v[..., xidx], v[..., yidx], need_sign=True)
        ssd = res.signed_sq_distance
        sd = geometry.sign(ssd) * fmath.sqrt(
            torch.clamp_min(torch.abs(ssd), _EPS))
        diff = sd - threshold
        val = 0.5 * weight * diff * diff
        return torch.where(res.is_endpoint | ~active(ssd), 0.0, val)

    def _scalars(v):
        qx, qy = v[..., xidx], v[..., yidx]
        res = geometry.polyline_closest_point_xy(points, qx, qy,
                                                 need_sign=True)
        ssd = res.signed_sq_distance
        gate = (active(ssd) & ~res.is_endpoint).to(torch.float32)

        dist = fmath.sqrt(torch.clamp_min(torch.abs(ssd), _EPS))
        scaling = (dist - abs(threshold)) / dist
        dxv = weight * scaling * (qx - res.cpx)
        dyv = weight * scaling * (qy - res.cpy)

        ux, uy = res.ux, res.uy
        use_v = res.is_vertex
        h0 = torch.where(use_v, weight, weight * uy * uy)
        h1 = torch.where(use_v, weight, weight * ux * ux)
        h2 = torch.where(use_v, 0.0, -weight * ux * uy)
        # The interior branch takes the cross-track form.
        w_cross = weight * (
            (qx - res.p1x) * uy - (qy - res.p1y) * ux - threshold)
        dxi = w_cross * uy
        dyi = -w_cross * ux
        dx = torch.where(use_v, dxv, dxi) * gate
        dy = torch.where(use_v, dyv, dyi) * gate
        return dx, dy, h0 * gate, h1 * gate, h2 * gate

    def grad_pairs(t, v):
        dx, dy, _, _, _ = _scalars(v)
        return [(xidx, dx), (yidx, dy)]

    def quad_pairs(t, v):
        dx, dy, ddx, ddy, dxdy = _scalars(v)
        return ([((xidx, xidx), ddx), ((yidx, yidx), ddy),
                 ((xidx, yidx), dxdy), ((yidx, xidx), dxdy)],
                [(xidx, dx), (yidx, dy)])

    return Cost(name, evaluate, grad_pairs, quad_pairs,
                device=("semiquadratic_polyline", {
                    "points": points, "xidx": xidx, "yidx": yidx,
                    "weight": weight, "threshold": threshold,
                    "oriented_right": oriented_right}))


def polyline2_signed_distance(points, xidx: int, yidx: int,
                              nominal: float = 0.0,
                              oriented_same_as_polyline: bool = True,
                              name: str = "polyline2_signed_distance"
                              ) -> Cost:
    """sgn(ssd) * sqrt(max(|ssd|, EPS)) - nominal, with ssd the signed sq
    distance of (v[xidx], v[yidx]) to the polyline (right positive, the
    signed query with its interior-vertex side fix) times the orientation
    flip (-1 unless oriented the same as the polyline); sgn(0) is 0.

    Its pairs are the JAX package's written derivatives, operation by
    operation: at a vertex the true derivatives of s * distance (the
    gradient s * delta / dist, the Hessian delta delta^T over denom, with
    denom = ssd * dist where |ssd * dist| >= EPS, else EPS); in a
    segment's interior the gradient (uy, -ux) of the chosen segment's
    unit direction and a zero Hessian, the orientation flip NOT applied
    there (the reference's shipped quirk, kept)."""
    flip = 1.0 if oriented_same_as_polyline else -1.0

    def query(v):
        qx, qy = v[..., xidx], v[..., yidx]
        res = geometry.polyline_closest_point_xy(points, qx, qy,
                                                 need_sign=True)
        ssd = res.signed_sq_distance * flip
        dist = fmath.sqrt(torch.clamp_min(torch.abs(ssd), _EPS))
        return qx, qy, res, ssd, geometry.sign(ssd), dist

    def evaluate(t, v):
        _, _, _, ssd, s, dist = query(v)
        return s * dist - nominal

    def gradient(v):
        qx, qy, res, ssd, s, dist = query(v)
        dx = torch.where(res.is_vertex, s * (qx - res.cpx) / dist, res.uy)
        dy = torch.where(res.is_vertex, s * (qy - res.cpy) / dist, -res.ux)
        return dx, dy, qx, qy, res, ssd, dist

    def grad_pairs(t, v):
        dx, dy = gradient(v)[:2]
        return [(xidx, dx), (yidx, dy)]

    def quad_pairs(t, v):
        dx, dy, qx, qy, res, ssd, dist = gradient(v)
        delta_x = qx - res.cpx
        delta_y = qy - res.cpy
        sd = ssd * dist
        denom = torch.where(torch.abs(sd) < _EPS, _EPS, sd)
        ddx = torch.where(res.is_vertex, delta_y * delta_y / denom, 0.0)
        ddy = torch.where(res.is_vertex, delta_x * delta_x / denom, 0.0)
        dxdy = torch.where(res.is_vertex, -delta_x * delta_y / denom, 0.0)
        return ([((xidx, xidx), ddx), ((yidx, yidx), ddy),
                 ((xidx, yidx), dxdy), ((yidx, xidx), dxdy)],
                [(xidx, dx), (yidx, dy)])

    return Cost(name, evaluate, grad_pairs, quad_pairs,
                device=("polyline_signed_distance", {
                    "points": points, "xidx": xidx, "yidx": yidx,
                    "nominal": nominal, "flip": flip}))


def _distance_quad(coef: float, dims1, dims2, dx, dy, ssq):
    """What the JAX package's autodiff over the support (x1, y1, x2, y2)
    of coef * ||p1 - p2|| (the norm clamped at EPS) gives, as XLA
    compiles the forward-over-reverse pass: (Hessian pairs, gradient
    pairs) over every (support, support) pair in support order. With D,
    E the differences, m the clamped squared norm, w the clamp's
    derivative (1 above EPS, 1/2 at it, 0 below), q = 0.5 / sqrt(m) and
    c = (q * coef) * w, the gradient is 2 c (D, E) and the Hessian's
    block on one point 2 (c [Z == col] + Z t(col)) for row Z in (D, E),
    with t(col) = ((-((2 col w) q)) (0.5 / m)) (w * coef); -block across
    the points. Every division is of two tensors."""
    x1, y1 = dims1
    x2, y2 = dims2
    m = torch.clamp_min(ssq, _EPS)
    w = torch.where(ssq > _EPS, 1.0, torch.where(ssq == _EPS, 0.5, 0.0))
    q = torch.full_like(m, 0.5) / fmath.sqrt(m)
    half_inv = 0.5 * (torch.ones_like(m) / m)
    c = (q * coef) * w
    ws = w * coef

    def tc(z):
        return (-(((z + z) * w) * q) * half_inv) * ws

    tx, ty = tc(dx), tc(dy)
    a = c + dx * tx
    b = c + dy * ty
    h = {(0, 0): a + a, (1, 1): b + b, (0, 1): dx * ty + dx * ty,
         (1, 0): dy * tx + dy * tx}
    support = ((x1, 0, 1.0), (y1, 1, 1.0), (x2, 0, -1.0), (y2, 1, -1.0))
    hp = [((i, j), h[(ra, cb)] if si * sj > 0 else -h[(ra, cb)])
          for i, ra, si in support for j, cb, sj in support]
    gx = dx * c + dx * c
    gy = dy * c + dy * c
    return hp, [(x1, gx), (y1, gy), (x2, -gx), (y2, -gy)]


def signed_distance(dims1, dims2, nominal: float = 0.0,
                    less_is_positive: bool = True,
                    name: str = "signed_distance") -> Cost:
    """s * (nominal - ||p1 - p2||), s = +1 (less is positive) or -1; the
    norm clamped at EPS and no weight, as shipped.

    Its merit gradient is the JAX package's `grad_pairs`: autodiff's
    rounding, zero where the clamp is active or tied (`live` is
    ssq > EPS). Its quadraticization is the JAX package's autodiff over
    the support (x1, y1, x2, y2), which takes the clamp's derivative as
    1 above EPS, 1/2 at it and 0 below (w): with D, E the differences,
    m the clamped squared norm, q = 0.5 / sqrt(m) and c = (q * -s) * w,
    the gradient is 2 c (D, E) and the Hessian's block on one point
    2 (c [Z == col] + Z t(col)) for row Z in (D, E), with
    t(col) = ((-((2 col w) q)) (0.5 / m)) (w * -s), as XLA compiles the
    forward-over-reverse pass; -block across the points. Every division
    is of two tensors (`_distance_quad` with coef -s)."""
    s = 1.0 if less_is_positive else -1.0
    x1, y1 = dims1
    x2, y2 = dims2

    def _diff(v):
        dx = v[..., x1] - v[..., x2]
        dy = v[..., y1] - v[..., y2]
        return dx, dy, dx * dx + dy * dy

    def evaluate(t, v):
        _, _, ssq = _diff(v)
        return s * (nominal - fmath.sqrt(torch.clamp_min(ssq, _EPS)))

    def grad_pairs(t, v):
        dx, dy, ssq = _diff(v)
        d = fmath.sqrt(torch.clamp_min(ssq, _EPS))
        live = (ssq > _EPS).to(torch.float32)
        ct = torch.full_like(d, -s * 0.5) / d * live
        px = ct * dx
        py = ct * dy
        gx = px + px
        gy = py + py
        return [(x1, gx), (y1, gy), (x2, -gx), (y2, -gy)]

    def quad_pairs(t, v):
        return _distance_quad(-s, dims1, dims2, *_diff(v))

    return Cost(name, evaluate, grad_pairs, quad_pairs,
                device=("signed_distance", {"dims": (x1, y1, x2, y2),
                                            "nominal": nominal, "sign": s}))


def relative_distance(weight: float, dims1, dims2,
                      name: str = "relative_distance") -> Cost:
    """w * ||p1 - p2||, the norm clamped at EPS. The JAX package
    differentiates it by autodiff over the support (x1, y1, x2, y2), its
    merit gradient too: both are `_distance_quad`'s with coef w, as the
    signed distance's quadraticization is with coef -s."""
    x1, y1 = dims1
    x2, y2 = dims2

    def _diff(v):
        dx = v[..., x1] - v[..., x2]
        dy = v[..., y1] - v[..., y2]
        return dx, dy, dx * dx + dy * dy

    def evaluate(t, v):
        _, _, ssq = _diff(v)
        return weight * fmath.sqrt(torch.clamp_min(ssq, _EPS))

    def quad_pairs(t, v):
        return _distance_quad(weight, dims1, dims2, *_diff(v))

    def grad_pairs(t, v):
        return quad_pairs(t, v)[1]

    return Cost(name, evaluate, grad_pairs, quad_pairs,
                device=("relative_distance", {"dims": (x1, y1, x2, y2),
                                              "weight": weight}))


def extreme_value(costs, is_min: bool, name: str = "extreme_value") -> Cost:
    """The min or max over member costs: its value is the active member's
    (first wins, a NaN member wins, `extreme_index`), and its gradient and
    Hessian pairs are every member's pairs, in member order, each
    multiplied by the member's one-hot gate (1.0 when active, else 0.0:
    a multiply, so a member's NaN stays NaN). Its device form lists its
    members' forms."""
    costs = tuple(costs)

    def active(t, v):
        vals = torch.stack([c.evaluate(t, v) for c in costs], -1)
        return vals, extreme_index(vals, is_min)

    def gates(t, v):
        _, idx = active(t, v)
        return [(idx == ci).to(torch.float32) for ci in range(len(costs))]

    def evaluate(t, v):
        vals, idx = active(t, v)
        return vals.gather(-1, idx[..., None])[..., 0]

    def grad_pairs(t, v):
        g = gates(t, v)
        return [(dim, p * g[ci]) for ci, c in enumerate(costs)
                for dim, p in c.gradient_pairs(t, v)]

    def quad_pairs(t, v):
        g = gates(t, v)
        hp, gp = [], []
        for ci, c in enumerate(costs):
            chp, cgp = c.quad_pairs(t, v)
            hp += [(ij, h * g[ci]) for ij, h in chp]
            gp += [(dim, p * g[ci]) for dim, p in cgp]
        return hp, gp

    device = None
    if all(c.device is not None for c in costs):
        device = ("extreme", {"members": tuple(c.device for c in costs),
                              "is_min": is_min})
    return Cost(name, evaluate, grad_pairs, quad_pairs, device=device)


def proximity(weight: float, dims1, dims2, threshold: float,
              name: str = "proximity") -> Cost:
    """0.5*w*(threshold - ||p1 - p2||)^2 within the threshold, else 0.

    Its merit gradient is the JAX package's `grad_pairs` (live where
    EPS <= d^2 < threshold^2). Its quadraticization is what the JAX
    package's autodiff over the support (x1, y1, x2, y2) gives, written
    out: the gradient 2 * (-2 c gap / (2 s)) * d (c = w / 2; the clamp's
    derivative 1 above EPS, 1/2 at it, 0 below), the Hessian of the live
    branch w/s * (threshold n n^T - gap I) on each pair of points, with
    n = d / s, s the distance and gap = threshold - s. Every division is
    of two tensors, so that the card and the CPU round it alike."""
    x1, y1 = dims1
    x2, y2 = dims2
    threshold_sq = threshold * threshold
    c = 0.5 * weight

    def _geom(v):
        dx = v[..., x1] - v[..., x2]
        dy = v[..., y1] - v[..., y2]
        delta_sq = dx * dx + dy * dy
        dist = fmath.sqrt(torch.clamp_min(delta_sq, _EPS))
        return dx, dy, delta_sq, dist, threshold - dist

    def evaluate(t, v):
        _, _, delta_sq, _, gap = _geom(v)
        return torch.where(delta_sq >= threshold_sq, 0.0,
                           0.5 * weight * gap * gap)

    def grad_pairs(t, v):
        dx, dy, delta_sq, dist, gap = _geom(v)
        live = (delta_sq >= _EPS) & (delta_sq < threshold_sq)
        ct = torch.where(live, -weight * gap / dist, 0.0)
        px = ct * dx
        py = ct * dy
        return [(x1, px), (y1, py), (x2, -px), (y2, -py)]

    def quad_pairs(t, v):
        dx, dy, delta_sq, dist, gap = _geom(v)
        inside = (delta_sq < threshold_sq).to(torch.float32)
        clamp = torch.where(delta_sq > _EPS, 1.0,
                            torch.where(delta_sq == _EPS, 0.5, 0.0))
        cg = c * gap
        g = -(cg + cg) / (dist + dist) * clamp * inside
        gx = g * dx + g * dx
        gy = g * dy + g * dy
        k = weight * clamp * inside / dist
        nx = dx / dist
        ny = dy / dist
        hxx = k * (threshold * nx * nx - gap)
        hyy = k * (threshold * ny * ny - gap)
        hxy = k * (threshold * nx * ny)
        h = {(0, 0): hxx, (0, 1): hxy, (1, 0): hxy, (1, 1): hyy}
        support = ((x1, 0, 1.0), (y1, 1, 1.0), (x2, 0, -1.0), (y2, 1, -1.0))
        hp = [((i, j), h[(a, b)] if si * sj > 0 else -h[(a, b)])
              for i, a, si in support for j, b, sj in support]
        return hp, [(x1, gx), (y1, gy), (x2, -gx), (y2, -gy)]

    return Cost(name, evaluate, grad_pairs, quad_pairs,
                device=("proximity_cost", {"dims": (x1, y1, x2, y2),
                                           "weight": weight,
                                           "threshold": threshold}))


def route_progress(weight: float, points, xidx: int, yidx: int,
                   nominal_speed: float, initial_route_pos: float = 0.0,
                   name: str = "route_progress") -> Cost:
    """0.5*w*|(v[xidx], v[yidx]) - desired|^2, with the desired point
    initial_route_pos + t * nominal_speed meters along the polyline
    (`geometry.polyline_point_at`; the reference's RouteProgressCost).

    The JAX package quadraticizes it by autodiff over its support (xidx,
    yidx), the desired point held constant; the pairs here are what that
    gives, in support order: the gradient 0.0 + (p + p) with p = (0.5 w)
    * d (d the difference on that dim; the 0.0 the scatter into the
    support's zeros), the Hessian c + c (c = 0.5 w) on the diagonal and
    +0 across, whatever v is."""
    half = 0.5 * weight

    def diffs(t, v):
        t = torch.as_tensor(t, dtype=torch.float32, device=v.device)
        desired = geometry.polyline_point_at(
            points, initial_route_pos + t * nominal_speed)
        return v[..., xidx] - desired[..., 0], v[..., yidx] - desired[..., 1]

    def evaluate(t, v):
        dx, dy = diffs(t, v)
        return half * (dx * dx + dy * dy)

    def grad_pairs(t, v):
        return [(dim, 0.0 + (half * d + half * d))
                for dim, d in zip((xidx, yidx), diffs(t, v))]

    def quad_pairs(t, v):
        gp = grad_pairs(t, v)
        like = torch.broadcast_to(v[..., xidx], gp[0][1].shape)
        diag = torch.full_like(like, half) + half
        zero = torch.zeros_like(like)
        return ([((xidx, xidx), diag), ((xidx, yidx), zero),
                 ((yidx, xidx), zero), ((yidx, yidx), diag)], gp)

    return Cost(name, evaluate, grad_pairs, quad_pairs,
                device=("route_progress", {
                    "points": points, "xidx": xidx, "yidx": yidx,
                    "weight": weight, "nominal_speed": nominal_speed,
                    "initial_route_pos": initial_route_pos}))


def nominal_path_length(weight: float, dim: int, nominal_speed: float,
                        name: str = "nominal_path_length") -> Cost:
    """0.5*w*(v[dim] - t*v_nom)^2: a pull toward the path length that
    the nominal speed covers by time t. Its merit gradient is the JAX
    package's `grad_pairs`, w * delta; its quadraticization what the JAX
    package's autodiff over the support (dim,) gives: the gradient p + p
    with p = (0.5 w) * delta, the Hessian c + c (c = 0.5 w)."""
    half = 0.5 * weight

    def delta(t, v):
        return v[..., dim] - t * nominal_speed

    def evaluate(t, v):
        d = delta(t, v)
        return half * d * d

    def grad_pairs(t, v):
        return [(dim, weight * delta(t, v))]

    def quad_pairs(t, v):
        p = half * delta(t, v)
        return [((dim, dim), torch.full_like(p, half) + half)], [(dim, p + p)]

    return Cost(name, evaluate, grad_pairs, quad_pairs,
                device=("nominal_path_length", {
                    "dim": dim, "weight": weight,
                    "nominal_speed": nominal_speed}))


def curvature(weight: float, omega_idx: int, v_idx: int,
              name: str = "curvature") -> Cost:
    """0.5*w*(omega/v)^2. The JAX package differentiates it by autodiff
    over the support (omega_idx, v_idx); the pairs here are that pass's
    operations, as XLA compiles them. With q = omega / v, r = 1 / (v v)
    (integer_pow(v, -2)) and g = (0.5 w) q + (0.5 w) q, the gradient is
    g / v at omega and -((g r) omega) at v; the Hessian is the forward
    pass of those operations along each support direction, zero tangents
    included, so that where v is 0 every entry is NaN (0 / 0 and 0 * inf
    there) as in the JAX package."""
    half = 0.5 * weight

    def grad_terms(v):
        o, s = v[..., omega_idx], v[..., v_idx]
        q = o / s
        r = torch.ones_like(s) / (s * s)
        g = half * q + half * q
        return o, s, q, r, g

    def evaluate(t, v):
        c = v[..., omega_idx] / v[..., v_idx]
        return half * c * c

    def grad_pairs(t, v):
        o, s, _, r, g = grad_terms(v)
        return [(omega_idx, 0.0 + g / s), (v_idx, -((g * r) * o) + 0.0)]

    def quad_pairs(t, v):
        o, s, _, r, g = grad_terms(v)
        r3 = torch.ones_like(s) / (s * s * s)
        x = g * r

        def tangent(do, dv):
            """The forward pass of the gradient's operations along the
            support direction (do, dv)."""
            do = torch.full_like(s, do)
            dv = torch.full_like(s, dv)
            dq = do / s + ((-dv) * o) * r
            dg = half * dq + half * dq
            dr = dv * (-2.0 * r3)
            d_go = dg / s + ((-dv) * g) * r
            d_gv = -((dg * r + g * dr) * o + x * do)
            return d_go, d_gv

        (h00, h10), (h01, h11) = tangent(1.0, 0.0), tangent(0.0, 1.0)
        hp = [((omega_idx, omega_idx), h00), ((omega_idx, v_idx), h01),
              ((v_idx, omega_idx), h10), ((v_idx, v_idx), h11)]
        return hp, grad_pairs(t, v)

    return Cost(name, evaluate, grad_pairs, quad_pairs,
                device=("curvature", {"dims": (omega_idx, v_idx),
                                      "weight": weight}))


def orientation(weight: float, dim: int, nominal: float,
                name: str = "orientation") -> Cost:
    """0.5*w*wrap(v[dim] - nominal)^2, the angle wrapped by a C-style
    fmod: fmod((v - nominal) + pi, 2 pi) - pi in float32, as the JAX
    package computes it. Autodiff over the support (dim,) in the JAX
    package: the gradient p + p with p = (0.5 w) * wrap, the Hessian
    c + c (c = 0.5 w; fmod's derivative is 1)."""
    half = 0.5 * weight

    def wrap(v):
        return torch.fmod(v[..., dim] - nominal + math.pi,
                          2.0 * math.pi) - math.pi

    def evaluate(t, v):
        d = wrap(v)
        return half * d * d

    def grad_pairs(t, v):
        p = half * wrap(v)
        return [(dim, p + p)]

    def quad_pairs(t, v):
        p = half * wrap(v)
        return [((dim, dim), torch.full_like(p, half) + half)], [(dim, p + p)]

    return Cost(name, evaluate, grad_pairs, quad_pairs,
                device=("orientation", {"dim": dim, "weight": weight,
                                        "nominal": nominal}))


def _convex_branches(x1, y1, x2, y2, threshold, v):
    """The convex proximities' shared geometry: (dx, dy, inactive,
    delta_x, delta_y, is_x_active), as the JAX package computes it."""
    threshold_sq = threshold * threshold
    dx = v[..., x1] - v[..., x2]
    dy = v[..., y1] - v[..., y2]
    inactive = (dx * dx >= threshold_sq) | (dy * dy >= threshold_sq)
    delta_x = threshold - torch.abs(dx)
    delta_y = threshold - torch.abs(dy)
    return (dx, dy, inactive, delta_x, delta_y,
            delta_x * delta_x < delta_y * delta_y)


def _convex_dense(v, inactive, is_x, x_branch, y_branch, with_hess):
    """The convex proximities' dense forms from each axis's (gradient
    pairs, Hessian pairs), assembled in pair order: the x branch where
    is_x, else the y branch, then +0 where inactive, the JAX package's
    selects over whole vectors and matrices. The gradient, or (Hessian,
    gradient) `with_hess`."""
    d, like = v.shape[-1], v[..., 0]

    def sel(assemble, k):
        a, b = assemble(d, x_branch[k], like), assemble(d, y_branch[k], like)
        extra = (None,) * (a.dim() - is_x.dim())
        out = torch.where(is_x[(...,) + extra], a, b)
        return torch.where(inactive[(...,) + extra], 0.0, out)

    grad = sel(assemble_vector, 0)
    return (sel(assemble_matrix, 1), grad) if with_hess else grad


def locally_convex_proximity(weight: float, dims1, dims2, threshold: float,
                             name: str = "locally_convex_proximity") -> Cost:
    """0.5*w*min((threshold - |dx|)^2, (threshold - |dy|)^2) while both
    |dx| and |dy| are within the threshold, else 0: the min of the
    axis-aligned convex penalties. Dense only, as in the JAX package:
    its `quad_fn` is the shipped quadraticization, on the axis whose
    penalty is smaller (x where the x penalty is strictly smaller): the
    gradient -w delta at that axis's first dim and w delta at its second
    (the shipped form, without the sgn() factor), the Hessian w, w on
    their diagonal and -w across; zero where inactive. Its merit
    gradient is that gradient, as the JAX package's `Cost.gradient`
    falls to `quad_fn`."""
    x1, y1 = dims1
    x2, y2 = dims2

    def evaluate(t, v):
        _, _, inactive, delta_x, delta_y, _ = _convex_branches(
            x1, y1, x2, y2, threshold, v)
        val = 0.5 * weight * torch.minimum(delta_x * delta_x,
                                           delta_y * delta_y)
        return torch.where(inactive, 0.0, val)

    def branch_pairs(a, b, delta):
        dval = -weight * delta
        return ([(a, dval), (b, -dval)],
                [((a, a), weight), ((b, b), weight), ((a, b), -weight),
                 ((b, a), -weight)])

    def dense(v, with_hess):
        _, _, inactive, delta_x, delta_y, is_x = _convex_branches(
            x1, y1, x2, y2, threshold, v)
        return _convex_dense(v, inactive, is_x,
                             branch_pairs(x1, x2, delta_x),
                             branch_pairs(y1, y2, delta_y), with_hess)

    return Cost(name, evaluate, quad_fn=lambda t, v: dense(v, True),
                grad_fn=lambda t, v: dense(v, False),
                device=("locally_convex_proximity", {
                    "dims": (x1, y1, x2, y2), "weight": weight,
                    "threshold": threshold}))


def weighted_convex_proximity(weight: float, dims1, dims2, vidx1: int,
                              vidx2: int, threshold: float,
                              name: str = "weighted_convex_proximity"
                              ) -> Cost:
    """locally_convex_proximity times the speeds' squared norm
    vv = v[vidx1]^2 + v[vidx2]^2. Dense only, as in the JAX package: its
    `quad_fn` is the shipped quadraticization, deviations from the true
    derivatives included, on the active axis (a1, a2) with delta and
    diff that axis's: the gradient -w delta vv at a1 and its negation at
    a2, -w v[vidx] delta^2 at each speed; the Hessian w, -w on the axis
    block, w delta^2 on each speed's diagonal and -2 w v[vidx] sgn(diff)
    (sgn(0) = 0) between a1 and each speed, negated for a2; each vector
    and matrix assembled in the JAX package's pair order (duplicates
    add), zero where inactive. Its merit gradient is that gradient."""
    x1, y1 = dims1
    x2, y2 = dims2

    def speeds(v):
        s1, s2 = v[..., vidx1], v[..., vidx2]
        return s1, s2, s1 * s1 + s2 * s2

    def evaluate(t, v):
        _, _, inactive, delta_x, delta_y, _ = _convex_branches(
            x1, y1, x2, y2, threshold, v)
        vv = speeds(v)[2]
        val = 0.5 * weight * vv * torch.minimum(delta_x * delta_x,
                                                delta_y * delta_y)
        return torch.where(inactive, 0.0, val)

    def branch_pairs(a1, a2, delta, diff, v):
        s1, s2, vv = speeds(v)
        da1 = -weight * delta * vv
        dv1 = -weight * s1 * delta * delta
        dv2 = -weight * s2 * delta * delta
        ddv = weight * delta * delta
        sg = geometry.sign(diff)
        da1dv1 = -2.0 * weight * s1 * sg
        da1dv2 = -2.0 * weight * s2 * sg
        gp = [(a1, da1), (a2, -da1), (vidx1, dv1), (vidx2, dv2)]
        hp = [((a1, a1), weight), ((a1, a2), -weight),
              ((a2, a1), -weight), ((a2, a2), weight),
              ((a1, vidx1), da1dv1), ((a1, vidx2), da1dv2),
              ((a2, vidx1), -da1dv1), ((a2, vidx2), -da1dv2),
              ((vidx1, a1), da1dv1), ((vidx1, a2), -da1dv1),
              ((vidx1, vidx1), ddv),
              ((vidx2, a1), da1dv2), ((vidx2, a2), -da1dv2),
              ((vidx2, vidx2), ddv)]
        return gp, hp

    def dense(v, with_hess):
        dx, dy, inactive, delta_x, delta_y, is_x = _convex_branches(
            x1, y1, x2, y2, threshold, v)
        return _convex_dense(v, inactive, is_x,
                             branch_pairs(x1, x2, delta_x, dx, v),
                             branch_pairs(y1, y2, delta_y, dy, v), with_hess)

    return Cost(name, evaluate, quad_fn=lambda t, v: dense(v, True),
                grad_fn=lambda t, v: dense(v, False),
                device=("weighted_convex_proximity", {
                    "dims": (x1, y1, x2, y2), "speeds": (vidx1, vidx2),
                    "weight": weight, "threshold": threshold}))


def final_time(inner: Cost, threshold_time: float,
               name: str = "final_time") -> Cost:
    """`inner` gated on t >= threshold_time: each pair's value (or the
    dense form) times the gate (0.0 or 1.0), as the JAX package multiplies
    it (costs/atoms.py:652-682). The pairs where `inner` has pairs (the
    JAX fused stage takes it then), else the dense form, so that
    `check_sparse` refuses it as the JAX fused stage does. Its device form
    is the inner atom's with the gate time (none when the inner atom has
    no device form or a gate of its own)."""
    def gate(t):
        return (t >= threshold_time).to(torch.float32)

    def evaluate(t, v):
        return torch.where(t >= threshold_time, inner.evaluate(t, v), 0.0)

    def grad_pairs(t, v):
        g = gate(t)
        return [(i, s * g) for i, s in inner.gradient_pairs(t, v)]

    def quad_pairs(t, v):
        g = gate(t)
        hp, gp = inner.quad_pairs(t, v)
        return ([(ij, h * g) for ij, h in hp], [(i, s * g) for i, s in gp])

    def quad_fn(t, v):
        hess, grad = inner.quadraticize(t, v)
        g = gate(t)
        return hess * g[..., None, None], grad * g[..., None]

    def grad_fn(t, v):
        return inner.gradient(t, v) * gate(t)[..., None]

    device = None
    if inner.device is not None and "gate_time" not in inner.device[1]:
        kind, prm = inner.device
        device = (kind, dict(prm, gate_time=threshold_time))
    if inner.has_pairs:
        return Cost(name, evaluate, grad_pairs, quad_pairs, device=device)
    return Cost(name, evaluate, device=device, quad_fn=quad_fn,
                grad_fn=grad_fn)
