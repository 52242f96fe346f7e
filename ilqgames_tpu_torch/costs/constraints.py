"""Constraints (counterpart of ilqgames_tpu/costs/constraints.py:
`_mu_eff_ineq` at :24, `single_dimension` at :33, `affine_scalar` at
:59, `affine_vector` at :70, `proximity` at :103,
`polyline2_signed_distance` at :187 and `final_time` at :204).

`single_dimension` and `proximity` give sparse pairs (and device forms
in K1, K5 and K6), and so does `final_time` over either; the other three
have only a dense form, as in the JAX package, whose fused stage refuses
them (a game with them runs with fuse_stages=False) and whose merit
takes their dense gradients."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ilqgames_tpu_torch import fmath, geometry
from ilqgames_tpu_torch.costs.base import Constraint, assemble_matrix, \
    assemble_vector, mu_eff_ineq
from ilqgames_tpu_torch.types import const_tensor

_EPS = 1e-12


def single_dimension(dim: int, threshold: float, keep_below: bool,
                     name: str = "single_dimension") -> Constraint:
    """g = v[dim] - threshold (keep below) or threshold - v[dim]. Its AL
    gradient is ct = lam + mu_eff * g at dim (negated when keeping
    above), its Hessian mu_eff at (dim, dim)."""

    def g(t, v):
        return v[..., dim] - threshold if keep_below else threshold - v[..., dim]

    def al_grad_pairs(t, v, lam, mu):
        gval = g(t, v)
        ct = lam + mu_eff_ineq(gval, lam, mu) * gval
        return [(dim, ct if keep_below else -ct)]

    def al_quad_pairs(t, v, lam, mu):
        gval = g(t, v)
        mu_eff = mu_eff_ineq(gval, lam, mu)
        ct = lam + mu_eff * gval
        return [((dim, dim), mu_eff)], [(dim, ct if keep_below else -ct)]

    return Constraint(name, g, False, al_grad_pairs, al_quad_pairs,
                      device=("single_dimension", {
                          "dim": dim, "threshold": threshold,
                          "keep_below": keep_below}))


def proximity(dims1: Tuple[int, int], dims2: Tuple[int, int],
              threshold: float, keep_within: bool,
              name: str = "proximity_constraint") -> Constraint:
    """g = +/-(||p1 - p2|| - threshold). The derivatives are zero where
    the distance clamp is active (`live`), as autodiff through the clamp
    gives in the JAX package."""
    s = 1.0 if keep_within else -1.0
    x1, y1 = dims1
    x2, y2 = dims2

    def g(t, v):
        dx = v[..., x1] - v[..., x2]
        dy = v[..., y1] - v[..., y2]
        prox = fmath.sqrt(torch.clamp_min(dx * dx + dy * dy, _EPS))
        return s * (prox - threshold)

    def al_grad_pairs(t, v, lam, mu):
        dx = v[..., x1] - v[..., x2]
        dy = v[..., y1] - v[..., y2]
        ssq = dx * dx + dy * dy
        prox = fmath.sqrt(torch.clamp_min(ssq, _EPS))
        gval = s * (prox - threshold)
        live = (ssq >= _EPS).to(torch.float32)
        ct = (lam + mu_eff_ineq(gval, lam, mu) * gval) * s * live / prox
        px = ct * dx
        py = ct * dy
        return [(x1, px), (y1, py), (x2, -px), (y2, -py)]

    def al_quad_pairs(t, v, lam, mu):
        dx = v[..., x1] - v[..., x2]
        dy = v[..., y1] - v[..., y2]
        ssq = dx * dx + dy * dy
        prox = fmath.sqrt(torch.clamp_min(ssq, _EPS))
        gval = s * (prox - threshold)
        live = (ssq >= _EPS).to(torch.float32)
        mu_eff = mu_eff_ineq(gval, lam, mu)
        lam_t = lam + mu_eff * gval
        inv = 1.0 / prox
        gx = s * dx * inv
        gy = s * dy * inv
        ct = lam_t * live
        px = ct * gx
        py = ct * gy
        gp = [(x1, px), (y1, py), (x2, -px), (y2, -py)]
        nx = dx * inv
        ny = dy * inv
        hxx = (mu_eff * gx * gx + lam_t * s * (ny * ny) * inv) * live
        hyy = (mu_eff * gy * gy + lam_t * s * (nx * nx) * inv) * live
        hxy = (mu_eff * gx * gy - lam_t * s * (nx * ny) * inv) * live
        hp = [
            ((x1, x1), hxx), ((y1, y1), hyy),
            ((x1, y1), hxy), ((y1, x1), hxy),
            ((x2, x2), hxx), ((y2, y2), hyy),
            ((x2, y2), hxy), ((y2, x2), hxy),
            ((x1, x2), -hxx), ((x2, x1), -hxx),
            ((y1, y2), -hyy), ((y2, y1), -hyy),
            ((x1, y2), -hxy), ((y2, x1), -hxy),
            ((y1, x2), -hxy), ((x2, y1), -hxy),
        ]
        return hp, gp

    return Constraint(name, g, False, al_grad_pairs, al_quad_pairs,
                      device=("proximity", {"dims": (x1, y1, x2, y2),
                                            "threshold": threshold,
                                            "sign": s}))


def _mu_eff(is_equality: bool, gval, lam, mu):
    """mu for an equality; for an inequality, mu_eff_ineq (its inactive
    test on the value of g, not differentiated, as the JAX package's
    stop_gradient makes it)."""
    return mu if is_equality else mu_eff_ineq(gval, lam, mu)


def _f32(x) -> float:
    """x rounded to float32, as the JAX package stores a coefficient."""
    return float(np.float32(x))


def _batched(x, like):
    """A multiplier or mu (a tensor or a float) over `like`'s shape."""
    return torch.broadcast_to(torch.as_tensor(x, dtype=like.dtype,
                                              device=like.device),
                              like.shape)


def affine_scalar(a, b: float, is_equality: bool,
                  name: str = "affine_scalar") -> Constraint:
    """g = a^T v - b, the dot product folded left to right over every
    index with a fused multiply-add at each step (one rounding, as XLA's
    dot rounds it on a CPU; computed in float64 and rounded to float32).
    Dense only, as in the JAX package (no support: autodiff over all of
    v): the gradient (lam + mu_eff g) a, the Hessian mu_eff a a^T."""
    a = tuple(_f32(x) for x in a)

    def g(t, v):
        total = torch.zeros_like(v[..., 0])
        for i in range(len(a)):
            total = (a[i] * v[..., i].double() + total.double()).float()
        return total - b

    def forms(t, v, lam, mu, with_hess):
        gval = g(t, v)
        lam, mu = _batched(lam, gval), _batched(mu, gval)
        mu_eff = _mu_eff(is_equality, gval, lam, mu)
        dg = torch.broadcast_to(const_tensor(a, v.device), v.shape)
        grad = (lam + mu_eff * gval)[..., None] * dg
        if not with_hess:
            return grad
        return (mu_eff[..., None, None] * dg[..., :, None]) * \
            dg[..., None, :], grad

    return Constraint(name, g, is_equality,
                      quad_fn=lambda t, v, lam, mu: forms(t, v, lam, mu,
                                                          True),
                      grad_fn=lambda t, v, lam, mu: forms(t, v, lam, mu,
                                                          False))


def affine_vector(A, b, is_equality: bool,
                  name: str = "affine_vector") -> Constraint:
    """g = ||A v - b|| (clamped at EPS), A square, as its shipped Hessian
    needs. Dense only: the JAX package's `quad_fn`, the shipped one,
    whose lambda term holds A A^T where the true derivative has A^T A:
    the gradient (mu_eff + lam / g) A^T delta and the Hessian
    (lam / g) (A A^T - A^T delta delta^T A / g^2) + mu_eff A^T A, with
    delta = A v - b. Products are folded left to right over the inner
    index."""
    A = [[_f32(x) for x in row] for row in A]
    b = [_f32(x) for x in b]
    m, n = len(A), len(A[0])

    def matvec(rows, v, cols):
        out = []
        for row in rows:
            acc = row[0] * v[..., 0]
            for k in range(1, cols):
                acc = acc + row[k] * v[..., k]
            out.append(acc)
        return torch.stack(out, dim=-1)

    def prod(P, Q):
        return [[_sum_f32(P[i][k] * Q[k][j] for k in range(len(Q)))
                 for j in range(len(Q[0]))] for i in range(len(P))]

    At = [[A[i][j] for i in range(m)] for j in range(n)]
    AAT, ATA = prod(A, At), prod(At, A)

    def delta(v):
        return matvec(A, v, n) - const_tensor(tuple(b), v.device)

    def value(d):
        ssq = d[..., 0] * d[..., 0]
        for k in range(1, d.shape[-1]):
            ssq = ssq + d[..., k] * d[..., k]
        return fmath.sqrt(torch.clamp_min(ssq, _EPS))

    def g(t, v):
        return value(delta(v))

    def forms(t, v, lam, mu, with_hess):
        d = delta(v)
        val = value(d)
        lam, mu = _batched(lam, val), _batched(mu, val)
        mu_eff = _mu_eff(is_equality, val, lam, mu)
        at_d = matvec(At, d, m)
        grad = (mu_eff + lam / val)[..., None] * at_d
        if not with_hess:
            return grad
        dev = v.device
        aat = const_tensor(tuple(x for row in AAT for x in row),
                           dev).reshape(m, m)
        ata = const_tensor(tuple(x for row in ATA for x in row),
                           dev).reshape(n, n)
        outer = at_d[..., :, None] * at_d[..., None, :]
        hess = (lam / val)[..., None, None] * (
            aat - outer / (val * val)[..., None, None]) + \
            mu_eff[..., None, None] * ata
        return hess, grad

    return Constraint(name, g, is_equality,
                      quad_fn=lambda t, v, lam, mu: forms(t, v, lam, mu,
                                                          True),
                      grad_fn=lambda t, v, lam, mu: forms(t, v, lam, mu,
                                                          False))


def _sum_f32(terms) -> float:
    """A Python sum of float32 products, each rounded to float32 and
    added in float32, left to right (the coefficient products of
    `affine_vector`)."""
    total = None
    for x in terms:
        x = np.float32(x)
        total = x if total is None else np.float32(total + x)
    return float(total)


def polyline2_signed_distance(points, xidx: int, yidx: int,
                              threshold: float, keep_left: bool,
                              name: str = "polyline2_sd_constraint"
                              ) -> Constraint:
    """g = +/-(signed distance of (v[xidx], v[yidx]) to the polyline -
    threshold), + keeping left. The signed distance is the JAX package's
    geometry.signed_distance: in a segment's interior the cross product
    with the chosen segment's frame, at a vertex sgn(ssd) times the
    distance to the closest point (clamped at EPS). Dense only, as in the
    JAX package, which differentiates it by autodiff over all of v; here
    written out: dg = s (uy, -ux) in the interior, s sgn w (D, E) / n at
    a vertex (D, E the offset from the closest point, n the clamped
    distance, w the clamp's derivative: 1 above EPS, 1/2 at it, 0 below);
    d2g zero in the interior, s sgn w (I - w (D, E)(D, E)^T / n^2) / n at
    a vertex. The gradient keeps autodiff's operation order."""
    s = 1.0 if keep_left else -1.0

    def query(v):
        qx, qy = v[..., xidx], v[..., yidx]
        res = geometry.polyline_closest_point_xy(points, qx, qy,
                                                 need_sign=True)
        sgn = geometry.sign(res.signed_sq_distance)
        interior = (qx - res.p1x) * res.uy - res.ux * (qy - res.p1y)
        dx, dy = qx - res.cpx, qy - res.cpy
        ssq = dx * dx + dy * dy
        n = fmath.sqrt(torch.clamp_min(ssq, _EPS))
        sd = torch.where(res.is_vertex, sgn * n, interior)
        return res, sgn, dx, dy, ssq, n, sd

    def g(t, v):
        return s * (query(v)[-1] - threshold)

    def forms(t, v, lam, mu, with_hess):
        res, sgn, dx, dy, ssq, n, sd = query(v)
        gval = s * (sd - threshold)
        lam, mu = _batched(lam, gval), _batched(mu, gval)
        mu_eff = mu_eff_ineq(gval, lam, mu)
        # The AL gradient in the JAX package's autodiff order: the
        # cotangent of the signed distance into the selected branch, then
        # through the vertex branch's sqrt and clamp or the interior's
        # cross product, scattered into the zeros of v.
        ct = s * (lam + mu_eff * gval)
        vx = res.is_vertex
        ct_v = torch.where(vx, ct, 0.0)
        ct_i = torch.where(vx, 0.0, ct)
        w = torch.where(ssq > _EPS, 1.0, torch.where(ssq == _EPS, 0.5, 0.0))
        q = torch.full_like(n, 0.5) / n
        c = ((sgn * ct_v) * q) * w
        gx = 0.0 + (((c * dx + c * dx) + 0.0) + ct_i * res.uy)
        gy = ((c * dy + c * dy) + res.ux * (-ct_i)) + 0.0
        d = v.shape[-1]
        like = v[..., 0]
        grad = assemble_vector(d, [(xidx, gx), (yidx, gy)], like)
        if not with_hess:
            return grad
        # mu_eff dg dg^T + ct d2g, with dg = s (uy, -ux) in the interior
        # and s sgn w (D, E) / n at a vertex, d2g zero in the interior and
        # s sgn w (I - w (D, E)(D, E)^T / n^2) / n at a vertex.
        k = sgn * w / n
        ex = torch.where(vx, k * dx, res.uy) * s
        ey = torch.where(vx, k * dy, -res.ux) * s
        kk = w / (n * n)
        zero = torch.zeros_like(like)
        hk = ct * k
        hxx = mu_eff * ex * ex + torch.where(vx, hk * (1.0 - kk * dx * dx),
                                             zero)
        hyy = mu_eff * ey * ey + torch.where(vx, hk * (1.0 - kk * dy * dy),
                                             zero)
        hxy = mu_eff * ex * ey + torch.where(vx, -(hk * kk * dx * dy), zero)
        hess = assemble_matrix(d, [((xidx, xidx), hxx), ((xidx, yidx), hxy),
                                   ((yidx, xidx), hxy), ((yidx, yidx), hyy)],
                               like)
        return hess, grad

    return Constraint(name, g, False,
                      quad_fn=lambda t, v, lam, mu: forms(t, v, lam, mu,
                                                          True),
                      grad_fn=lambda t, v, lam, mu: forms(t, v, lam, mu,
                                                          False))


def final_time(inner: Constraint, threshold_time: float,
               name: str = "final_time_constraint") -> Constraint:
    """`inner` active only at times t >= threshold_time: g is 0 before,
    and each pair's value (or the dense form) is multiplied by the gate
    (0.0 or 1.0), as the JAX package multiplies it. The pairs where
    `inner` has pairs (the JAX fused stage takes it then), else the dense
    form. Its device form is the inner constraint's with the gate time
    (none when the inner one has none or a gate of its own)."""
    def gate(t):
        return (t >= threshold_time).to(torch.float32)

    def g(t, v):
        return torch.where(t < threshold_time, 0.0, inner.g(t, v))

    def al_grad_pairs(t, v, lam, mu):
        pairs = inner.gradient_al_pairs(t, v, lam, mu)
        if pairs is None:
            return None
        ga = gate(t)
        return [(i, p * ga) for i, p in pairs]

    def al_quad_pairs(t, v, lam, mu):
        qp = inner.quad_al_pairs(t, v, lam, mu)
        if qp is None:
            return None
        ga = gate(t)
        return ([(ij, h * ga) for ij, h in qp[0]],
                [(i, p * ga) for i, p in qp[1]])

    def quad_fn(t, v, lam, mu):
        hess, grad = inner.quadraticize_al(t, v, lam, mu)
        ga = gate(t)
        return hess * ga[..., None, None], grad * ga[..., None]

    def grad_fn(t, v, lam, mu):
        return inner.gradient_al(t, v, lam, mu) * gate(t)[..., None]

    sparse = inner.al_quad_pairs_fn is not None
    device = None
    if inner.device is not None and "gate_time" not in inner.device[1]:
        kind, prm = inner.device
        device = (kind, dict(prm, gate_time=threshold_time))
    return Constraint(name, g, inner.is_equality,
                      al_grad_pairs if sparse else None,
                      al_quad_pairs if sparse else None, device=device,
                      quad_fn=quad_fn, grad_fn=grad_fn)
