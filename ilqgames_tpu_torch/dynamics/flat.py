"""Feedback-linearizable ("flat") systems (counterpart of
ilqgames_tpu/dynamics/flat.py: `flat_unicycle_4d` at :60, `flat_car_6d`
at :97, `concatenate_flat` at :177 and `linear_controls_to_real` at
:287).

A flat system evolves exactly as a linear system in the coordinates xi
with auxiliary controls v, so the solver never re-linearizes: its
Jacobians are the constant forward-Euler A = I + dt * A_c, B_i = dt *
B_c,i of `dyn_base.constant_linearization`, and its costs are authored
in xi. The joint system is a `dyn_base.linear` system whose rows fold as
the JAX package's ode does (each from xi[r] * 0.0, every coefficient
multiplied), block-diagonal per player, so the kernels run it as one
linear subsystem per player. The maps between the real state x and xi
are kept for the examples' initial states; trigonometry and roots go
through `fmath`. Each model also keeps its vector field in real
coordinates (`ode`) and the map from auxiliary to real controls, u =
M_inv(x) (v - m(x)) (`inv_decoupling`, `affine_term`,
`linear_controls_to_real`), as the reference's flat systems do; no solve
calls them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence, Tuple

import torch

from ilqgames_tpu_torch import fmath
from ilqgames_tpu_torch.dynamics import base as dyn_base
from ilqgames_tpu_torch.dynamics.base import true_div


@dataclasses.dataclass(frozen=True, eq=False)
class FlatSinglePlayerModel:
    """One player's flat subsystem: xi and x share the dimension xdim; in
    xi it is xi_dot = A_c xi + B_c v (row-major tuples)."""

    name: str
    xdim: int
    udim: int
    cont_A: Tuple[Tuple[float, ...], ...]
    cont_B: Tuple[Tuple[float, ...], ...]
    ode: Callable            # (t, x [..., xdim], u [..., udim]) -> x_dot
    to_linear: Callable      # x [..., xdim] -> xi
    from_linear: Callable    # xi -> x
    inv_decoupling: Callable  # x -> M_inv [..., udim, udim]
    affine_term: Callable    # x -> m [..., udim]
    is_singular: Callable    # xi -> bool [...]
    position_dims: Tuple[int, ...] = (0, 1)


def _v_offset(v: torch.Tensor) -> torch.Tensor:
    """The reference's offset of a speed away from zero
    (single_player_flat_unicycle_4d.h:191-195), which keeps the
    decoupling matrix finite at v = 0: v + sgn(v + 1e-7) * 0.00011."""
    return v + torch.sign(v + 1e-7) * 0.00011


def _singular(xi: torch.Tensor) -> torch.Tensor:
    """The reference's singularity test of a flat model's velocity
    (xi[2], xi[3]): NaN, or both within 1e-2 of zero."""
    tol = 1e-2
    bad = torch.isnan(xi[..., 2]) | torch.isnan(xi[..., 3])
    return bad | ((torch.abs(xi[..., 2]) < tol) & (torch.abs(xi[..., 3]) < tol))


def _speed(xi: torch.Tensor) -> torch.Tensor:
    return fmath.sqrt(xi[..., 2] * xi[..., 2] + xi[..., 3] * xi[..., 3])


def flat_unicycle_4d() -> FlatSinglePlayerModel:
    """x = [px py theta v], xi = [px py vx vy]: a double integrator."""

    def ode(t, x, u):
        return torch.stack([x[..., 3] * fmath.cos(x[..., 2]),
                            x[..., 3] * fmath.sin(x[..., 2]), u[..., 0],
                            u[..., 1]], dim=-1)

    def to_linear(x):
        c, s = fmath.cos(x[..., 2]), fmath.sin(x[..., 2])
        return torch.stack([x[..., 0], x[..., 1], x[..., 3] * c,
                            x[..., 3] * s], dim=-1)

    def from_linear(xi):
        return torch.stack([xi[..., 0], xi[..., 1],
                            torch.atan2(xi[..., 3], xi[..., 2]),
                            _speed(xi)], dim=-1)

    def inv_decoupling(x):
        s, c = fmath.sin(x[..., 2]), fmath.cos(x[..., 2])
        v = _v_offset(x[..., 3])
        return torch.stack([torch.stack([c, s], dim=-1),
                            torch.stack([-s / v, c / v], dim=-1)], dim=-2)

    def affine_term(x):
        return x.new_zeros(x.shape[:-1] + (2,))

    A = ((0, 0, 1, 0), (0, 0, 0, 1), (0, 0, 0, 0), (0, 0, 0, 0))
    B = ((0, 0), (0, 0), (1, 0), (0, 1))
    return FlatSinglePlayerModel("flat_unicycle_4d", 4, 2, A, B, ode,
                                 to_linear, from_linear, inv_decoupling,
                                 affine_term, _singular)


def flat_car_6d(inter_axle_distance: float) -> FlatSinglePlayerModel:
    """x = [px py theta phi v a], xi = [px py vx vy ax ay]: a triple
    integrator."""
    L = inter_axle_distance

    def ode(t, x, u):
        return torch.stack([
            x[..., 4] * fmath.cos(x[..., 2]), x[..., 4] * fmath.sin(x[..., 2]),
            true_div(x[..., 4], L) * fmath.tan(x[..., 3]), u[..., 0],
            x[..., 5], u[..., 1]], dim=-1)

    def to_linear(x):
        s, c = fmath.sin(x[..., 2]), fmath.cos(x[..., 2])
        tan_phi = fmath.tan(x[..., 3])
        vv_over_l = true_div(x[..., 4] * x[..., 4], L)
        return torch.stack([
            x[..., 0], x[..., 1], x[..., 4] * c, x[..., 4] * s,
            x[..., 5] * c - vv_over_l * s * tan_phi,
            x[..., 5] * s + vv_over_l * c * tan_phi], dim=-1)

    def from_linear(xi):
        theta = torch.atan2(xi[..., 3], xi[..., 2])
        v = _speed(xi)
        c, s = xi[..., 2] / v, xi[..., 3] / v
        a = c * xi[..., 4] + s * xi[..., 5]
        phi = torch.atan((a * c - xi[..., 4]) * L / (v * v * s))
        return torch.stack([xi[..., 0], xi[..., 1], theta, phi, v, a],
                           dim=-1)

    def inv_decoupling(x):
        s, c = fmath.sin(x[..., 2]), fmath.cos(x[..., 2])
        v = _v_offset(x[..., 4])
        cos_phi_v = fmath.cos(x[..., 3]) / v
        scaling = L * cos_phi_v * cos_phi_v
        return torch.stack([torch.stack([-scaling * s, scaling * c], dim=-1),
                            torch.stack([c, s], dim=-1)], dim=-2)

    def affine_term(x):
        s, c = fmath.sin(x[..., 2]), fmath.cos(x[..., 2])
        tan_phi = fmath.tan(x[..., 3])
        v_over_l = true_div(x[..., 4], L)
        vvt = v_over_l * x[..., 4] * tan_phi
        return torch.stack([
            -v_over_l * tan_phi * (3.0 * x[..., 5] * s + vvt * c),
            v_over_l * tan_phi * (3.0 * x[..., 5] * c - vvt * s)], dim=-1)

    A = ((0, 0, 1, 0, 0, 0), (0, 0, 0, 1, 0, 0), (0, 0, 0, 0, 1, 0),
         (0, 0, 0, 0, 0, 1), (0, 0, 0, 0, 0, 0), (0, 0, 0, 0, 0, 0))
    B = ((0, 0), (0, 0), (0, 0), (0, 0), (1, 0), (0, 1))
    return FlatSinglePlayerModel("flat_car_6d", 6, 2, A, B, ode, to_linear,
                                 from_linear, inv_decoupling, affine_term,
                                 _singular)


def concatenate_flat(name: str, models: Sequence[FlatSinglePlayerModel]
                     ) -> dyn_base.MultiPlayerDynamics:
    """The joint flat system: block-diagonal constant linear dynamics in
    xi (row r's terms: its A_c entries by column, then its B_c entries by
    player and control column, as the JAX package's ode folds them), the
    stacked coordinate maps and the singularity test."""
    offsets, acc = [], 0
    for m in models:
        offsets.append(acc)
        acc += m.xdim
    rows = []
    for p, (m, o) in enumerate(zip(models, offsets)):
        for r in range(m.xdim):
            rows.append(
                tuple(("x", o + c, float(a))
                      for c, a in enumerate(m.cont_A[r]) if a != 0)
                + tuple(("u", (p, c), float(b))
                        for c, b in enumerate(m.cont_B[r]) if b != 0))
    dyn = dyn_base.linear(name, tuple(m.xdim for m in models),
                          tuple(m.udim for m in models), rows,
                          zero_start=True, per_player=True)

    def per_player(fn_name):
        def apply(z):
            return torch.cat([
                getattr(m, fn_name)(z[..., o:o + m.xdim])
                for m, o in zip(models, offsets)], dim=-1)
        return apply

    def linear_state_singular(xi):
        flags = [m.is_singular(xi[..., o:o + m.xdim])
                 for m, o in zip(models, offsets)]
        out = flags[0]
        for f in flags[1:]:
            out = out | f
        return out

    position_dims = tuple(tuple(o + d for d in m.position_dims)
                          for m, o in zip(models, offsets))
    return dataclasses.replace(
        dyn, position_dims=position_dims,
        to_linear_state=per_player("to_linear"),
        from_linear_state=per_player("from_linear"),
        linear_state_singular=linear_state_singular)


def linear_controls_to_real(models: Sequence[FlatSinglePlayerModel],
                            x: torch.Tensor, vs: torch.Tensor) -> torch.Tensor:
    """Every player's real controls u_i = M_inv_i(x_i) (v_i - m_i(x_i)),
    padded to vs's umax (the reference's
    MultiPlayerFlatSystem::LinearizingControl): x [..., xdim], vs [..., P,
    umax] -> [..., P, umax]. Each row of the product folds left to
    right."""
    out, off = [], 0
    umax = vs.shape[-1]
    for i, m in enumerate(models):
        xi = x[..., off:off + m.xdim]
        off += m.xdim
        w = vs[..., i, :m.udim] - m.affine_term(xi)
        M = m.inv_decoupling(xi)
        rows = []
        for r in range(m.udim):
            acc = M[..., r, 0] * w[..., 0]
            for c in range(1, m.udim):
                acc = acc + M[..., r, c] * w[..., c]
            rows.append(acc)
        rows += [torch.zeros_like(rows[0])] * (umax - m.udim)
        out.append(torch.stack(rows, dim=-1))
    return torch.stack(out, dim=-2)
