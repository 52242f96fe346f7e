"""Dynamics substrate (counterpart of ilqgames_tpu/dynamics/base.py:106-327).

A multi-player system is a frozen dataclass holding a continuous vector
field `ode(t, x, us)` over tensors with any leading batch axes (`x` is
[..., xdim], `us` the padded [..., P, umax] control stack). The discrete
linearization keeps the reference's forward-Euler convention
A = I + dt * Jx, B_i = dt * Ju_i, from the models' analytic Jacobians;
rollouts integrate with RK4 over 2 substeps.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch

from ilqgames_tpu_torch.types import (GameSpec, LinearDynamics,
                                      OperatingPoint, Strategy)


@dataclasses.dataclass(frozen=True, eq=False)
class SinglePlayerModel:
    """A single player's dynamics: xdot = ode(t, x_sub, u), with analytic
    sparse Jacobian entries `jac(t, x_sub, u) -> (jx, ju)`. `kind` and
    `length` select the model's device ODE in the rollout kernel
    (None: the model has none); `length` is its one parameter there (a
    car's inter-axle length, a Dubins car's speed). A constant-linear
    model has `linear_rows` instead, its terms in `linear`'s form over
    its own states and controls (control terms as ("u", (0, col),
    coef)), from which `concatenate` builds the joint system."""

    name: str
    xdim: int
    udim: int
    ode: Callable
    position_dims: Tuple[int, ...] = ()
    jac: Optional[Callable] = None
    kind: Optional[int] = None
    length: float = 0.0
    linear_rows: Optional[Tuple[Tuple[tuple, ...], ...]] = None


@dataclasses.dataclass(frozen=True, eq=False)
class MultiPlayerDynamics:
    """Joint dynamics: ode(t, x [..., xdim], us [..., P, umax])."""

    name: str
    xdims: Tuple[int, ...]
    udims: Tuple[int, ...]
    ode: Callable
    position_dims: Tuple[Tuple[int, ...], ...] = ()
    # (t, x, us) -> (jx entries ((row, col), v), ju entries
    # ((row, player, ucol), v)) in joint coordinates.
    ode_jac: Optional[Callable] = None
    # The concatenated subsystems, for the rollout kernel's device table.
    models: Tuple[SinglePlayerModel, ...] = ()
    # A constant-linear system's terms (`linear`), from which its ode,
    # ode_jac and device form are all built; its ode's fold (each row
    # from x[r] * 0.0, every coefficient multiplied: the JAX package's
    # flat systems), and whether the kernels run it as one linear
    # subsystem per player.
    linear_rows: Optional[Tuple[Tuple[tuple, ...], ...]] = None
    linear_zero_start: bool = False
    linear_per_player: bool = False
    # A flat system's coordinate maps (dynamics/flat.py).
    to_linear_state: Optional[Callable] = None
    from_linear_state: Optional[Callable] = None
    linear_state_singular: Optional[Callable] = None
    # A coupled system's device form (two_player_unicycle_4d, air_3d): its
    # kind in the kernels' ODE and Jacobian tables and its parameters
    # there (at most two). The kernels run it as one subsystem over the
    # whole state that reads every player's controls.
    kind: Optional[int] = None
    params: Tuple[float, ...] = ()

    @property
    def num_players(self) -> int:
        return len(self.udims)

    @property
    def xdim(self) -> int:
        return sum(self.xdims)

    def spec(self, dt=None, num_time_steps=None) -> GameSpec:
        kwargs = {}
        if dt is not None:
            kwargs["dt"] = dt
        if num_time_steps is not None:
            kwargs["num_time_steps"] = num_time_steps
        return GameSpec(xdims=self.xdims, udims=self.udims, **kwargs)


def concatenate(name: str,
                models: Sequence[SinglePlayerModel]) -> MultiPlayerDynamics:
    """Joint system from per-player subsystems: block-diagonal field. A
    concatenation of constant-linear models (each with `linear_rows`) is
    one `linear` system over the whole state, its rows the models' terms
    at their offsets: its ode takes each row's one term bare, as the
    models' own fields do, and the kernels run it as one linear
    subsystem (K1 from its constant Jacobian)."""
    xdims = tuple(m.xdim for m in models)
    udims = tuple(m.udim for m in models)
    offsets = []
    acc = 0
    for d in xdims:
        offsets.append(acc)
        acc += d
    position_dims = tuple(tuple(offsets[i] + d for d in m.position_dims)
                          for i, m in enumerate(models))

    if models and all(m.linear_rows is not None for m in models):
        def shift(i, src, idx, coef):
            o = offsets[i]
            return ((src, o + idx, coef) if src == "x"
                    else (src, (i, idx[1]), coef))

        rows = [tuple(shift(i, *term) for term in row)
                for i, m in enumerate(models) for row in m.linear_rows]
        return dataclasses.replace(
            linear(name, xdims, udims, rows), position_dims=position_dims,
            models=tuple(models))

    def ode(t, x, us):
        return torch.cat([
            m.ode(t, x[..., offsets[i]:offsets[i] + m.xdim],
                  us[..., i, :m.udim])
            for i, m in enumerate(models)], dim=-1)

    ode_jac = None
    if all(m.jac is not None for m in models):
        def ode_jac(t, x, us):
            jx_entries = []
            ju_entries = []
            for i, m in enumerate(models):
                o = offsets[i]
                jxe, jue = m.jac(t, x[..., o:o + m.xdim], us[..., i, :m.udim])
                jx_entries.extend(((o + r, o + c), v) for (r, c), v in jxe)
                ju_entries.extend(((o + r, i, c), v) for (r, c), v in jue)
            return jx_entries, ju_entries

    return MultiPlayerDynamics(name=name, xdims=xdims, udims=udims, ode=ode,
                               position_dims=position_dims, ode_jac=ode_jac,
                               models=tuple(models))


def linear(name: str, xdims: Sequence[int], udims: Sequence[int],
           rows, zero_start: bool = False,
           per_player: bool = False) -> MultiPlayerDynamics:
    """A constant-linear multi-player system xdot = A x + sum_i B_i u_i,
    from one description of its terms: `rows[r]` is state row r's terms in
    order, each ("x", col, coef) or ("u", (player, col), coef). Its ode
    folds a row's terms left to right: from the first term, a coefficient
    of 1.0 taking the value bare; or, with `zero_start`, from x[r] * 0.0
    with every coefficient multiplied (the JAX package's flat systems,
    dynamics/flat.py:221-230, whose rows stay NaN where x[r] is inf or
    NaN). Its ode_jac lists the coefficients row by row, and the kernels'
    device form (ops/cuda/sweep.py) reads the same terms: one subsystem
    over the whole state that reads every player's controls, or, with
    `per_player`, one per player over its own states, which may then read
    only that player's states and controls."""
    rows = tuple(tuple(r) for r in rows)
    if len(rows) != sum(xdims):
        raise ValueError(f"{len(rows)} rows of terms for {sum(xdims)} states")
    if per_player:
        off = 0
        for p, d in enumerate(xdims):
            for r in range(off, off + d):
                for src, idx, _ in rows[r]:
                    if not (off <= idx < off + d if src == "x"
                            else idx[0] == p):
                        raise ValueError(
                            f"row {r} of player {p}'s block reads "
                            f"{src} {idx}, outside the block")
            off += d

    def term(src, idx, coef, x, us):
        v = x[..., idx] if src == "x" else us[..., idx[0], idx[1]]
        return v if coef == 1.0 and not zero_start else coef * v

    def ode(t, x, us):
        out = []
        for r, terms in enumerate(rows):
            acc = x[..., r] * 0.0 if zero_start else None
            for src, idx, coef in terms:
                v = term(src, idx, coef, x, us)
                acc = v if acc is None else acc + v
            out.append(torch.zeros_like(x[..., 0]) if acc is None else acc)
        return torch.stack(out, dim=-1)

    def ode_jac(t, x, us):
        jx = [((r, idx), coef) for r, terms in enumerate(rows)
              for src, idx, coef in terms if src == "x"]
        ju = [((r,) + tuple(idx), coef) for r, terms in enumerate(rows)
              for src, idx, coef in terms if src == "u"]
        return jx, ju

    return MultiPlayerDynamics(name=name, xdims=tuple(xdims),
                               udims=tuple(udims), ode=ode, ode_jac=ode_jac,
                               linear_rows=rows,
                               linear_zero_start=zero_start,
                               linear_per_player=per_player)


def integrate(dyn: MultiPlayerDynamics, t, dt: float, x: torch.Tensor,
              us: torch.Tensor, num_substeps: int = 2) -> torch.Tensor:
    """One zero-order-hold control step: RK4 with `num_substeps`."""
    h = dt / num_substeps
    for i in range(num_substeps):
        ts = t + i * h
        k1 = h * dyn.ode(ts, x, us)
        k2 = h * dyn.ode(ts + 0.5 * h, x + 0.5 * k1, us)
        k3 = h * dyn.ode(ts + 0.5 * h, x + 0.5 * k2, us)
        k4 = h * dyn.ode(ts + h, x + k3, us)
        x = x + true_div(k1 + 2.0 * (k2 + k3) + k4, 6.0)
    return x


def true_div(a: torch.Tensor, c: float) -> torch.Tensor:
    """a / c rounded as IEEE division on every device (PyTorch's CUDA
    kernels multiply by the reciprocal of a host scalar divisor, which
    the CPU and the hand-written kernels do not). The divisor is made on
    the device by a fill, with no host-to-device copy."""
    return a / torch.full((), c, dtype=a.dtype, device=a.device)


def rollout(dyn: MultiPlayerDynamics, spec: GameSpec, x0: torch.Tensor,
            last_op: OperatingPoint, strategy: Strategy) -> OperatingPoint:
    """Batched forward integration under
    u_i(k) = u_ref_i(k) - P_i[k] (x - x_ref[k]) - alpha_i[k]:
    x0 [B, x], last_op and strategy batched. The plain counterpart of
    dynamics/base.rollout; the solver rolls out through the K4 kernel
    (ops/cuda/sweep.py)."""
    u_mask = spec.u_mask(x0.device)
    x = x0
    xs, us = [], []
    for k in range(spec.num_time_steps):
        delta = x - last_op.xs[:, k]
        u = (last_op.us[:, k]
             - torch.einsum("bpux,bx->bpu", strategy.Ps[:, k], delta)
             - strategy.alphas[:, k]) * u_mask
        t = last_op.t0 + k * spec.dt
        xs.append(x)
        us.append(u)
        x = integrate(dyn, t, spec.dt, x, u)
    return OperatingPoint(xs=torch.stack(xs, 1), us=torch.stack(us, 1),
                          t0=last_op.t0)


def _discrete_entries(dt: float, xd: int, jx, ju):
    """A = I + dt * Jx as {(row, col): value} and Bs = dt * Ju as
    {(player, row, col): value}, folded in entry order."""
    a_acc = {(d, d): 1.0 for d in range(xd)}
    for ij, v in jx:
        a_acc[ij] = a_acc[ij] + dt * v if ij in a_acc else dt * v
    b_acc = {}
    for (r, p, c), v in ju:
        key = (p, r, c)
        b_acc[key] = b_acc[key] + dt * v if key in b_acc else dt * v
    return a_acc, b_acc


def constant_linearization(dyn: MultiPlayerDynamics, spec: GameSpec):
    """A linear system's discrete Jacobian entries, Python floats exactly
    as `linearize` folds them before storing them in float32:
    ({(row, col): A value}, {(player, row, col): Bs value})."""
    if dyn.linear_rows is None:
        raise ValueError(f"dynamics {dyn.name!r} are not a linear system")
    return _discrete_entries(spec.dt, spec.xdim,
                             *dyn.ode_jac(None, None, None))


def linearize(dyn: MultiPlayerDynamics, spec: GameSpec,
              op: OperatingPoint) -> LinearDynamics:
    """A[b, k] = I + dt * df/dx, Bs[b, k, i] = dt * df/du_i at every knot
    of a batched operating point (xs [B, N, x], us [B, N, P, u], t0 [B]),
    from the models' analytic Jacobians."""
    if dyn.ode_jac is None:
        raise NotImplementedError(
            f"linearize: dynamics {dyn.name!r} have no analytic Jacobian; "
            "autodiff linearization is not ported yet")
    Bt, N, xd = op.xs.shape
    P, um, dt = spec.num_players, spec.umax, spec.dt
    t = op.t0[:, None] + torch.arange(N, dtype=torch.float32,
                                      device=op.xs.device) * dt
    a_acc, b_acc = _discrete_entries(dt, xd, *dyn.ode_jac(t, op.xs, op.us))
    A = op.xs.new_zeros((Bt, N, xd, xd))
    for (r, c), v in a_acc.items():
        A[:, :, r, c] = v
    Bs = op.xs.new_zeros((Bt, N, P, xd, um))
    for (p, r, c), v in b_acc.items():
        Bs[:, :, p, r, c] = v
    return LinearDynamics(A=A, Bs=Bs)
