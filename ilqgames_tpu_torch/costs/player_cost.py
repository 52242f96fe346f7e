"""Per-player cost aggregation and quadraticization (counterpart of
ilqgames_tpu/costs/player_cost.py).

Every function evaluates all lanes and knots at once: stage inputs carry
any leading batch axes, and the per-(index) values of the sparse pairs
are tensors of that batch shape. Pairs accumulate in the JAX package's
order (state costs, then constraints, then the extremal gate, then the
regularization; player_cost.py:278-386), which sets which sums match.
Atoms and constraints with only a dense form (`Cost.quad_fn`,
`Constraint.quad_fn`) are summed among themselves, the atoms and then
the constraints, each in order, and that sum is added to the assembled
pairs, before the regularization (player_cost.py:300-325); a player
with such a term squares and sums every entry of its gradient in the
merit (player_cost.py:212-215).

A player's cost is summed over the knots (STRUCTURE_SUM) or is its
largest or smallest stage cost (STRUCTURE_MAX, STRUCTURE_MIN; the
reference's reachability games): `total_costs` then also returns that
knot, and the state terms of the player's quadraticization and merit
count only there, through a one-hot gate over the knots (`extreme_gate`)
that multiplies them before the regularization; control terms are never
gated (player_cost.py:279-330, 526-545).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ilqgames_tpu_torch.costs.base import Constraint, Cost, \
    assemble_vector, extreme_index
from ilqgames_tpu_torch.solver.ilq import _fixed_order_sum
from ilqgames_tpu_torch.types import (DEFAULT_MU, GameSpec, OperatingPoint,
                                      QuadraticCosts, _Replace, const_tensor)

STRUCTURE_SUM = "sum"
STRUCTURE_MAX = "max"
STRUCTURE_MIN = "min"


@dataclasses.dataclass(frozen=True, eq=False)
class PlayerCost:
    """Static description of one player's cost: atoms + constraints."""

    state_costs: Tuple[Cost, ...] = ()
    # (which player's control, cost).
    control_costs: Tuple[Tuple[int, Cost], ...] = ()
    state_constraints: Tuple[Constraint, ...] = ()
    control_constraints: Tuple[Tuple[int, Constraint], ...] = ()
    structure: str = STRUCTURE_SUM
    state_regularization: float = 0.0
    control_regularization: float = 0.0

    @property
    def is_constrained(self) -> bool:
        return bool(self.state_constraints) or bool(self.control_constraints)

    def control_players(self) -> Tuple[int, ...]:
        js = {j for j, _ in self.control_costs}
        js |= {j for j, _ in self.control_constraints}
        return tuple(sorted(js))

    def evaluate_stage(self, t, x, us):
        """Instantaneous cost (constraints excluded)."""
        total = torch.zeros_like(x[..., 0])
        for c in self.state_costs:
            total = total + c.evaluate(t, x)
        for j, c in self.control_costs:
            total = total + c.evaluate(t, us[..., j, :])
        return total


@dataclasses.dataclass(frozen=True)
class ALState(_Replace):
    """Batched augmented-Lagrangian multipliers: per player, one lambda
    per constraint per knot ([B, n_i, N]), and mu [B]."""

    state_lambdas: Tuple[torch.Tensor, ...]
    control_lambdas: Tuple[torch.Tensor, ...]
    mu: torch.Tensor

    @classmethod
    def init(cls, player_costs, spec: GameSpec, batch: int, lam0: float = 0.0,
             mu0: float = DEFAULT_MU, device=None) -> "ALState":
        N = spec.num_time_steps

        def full(n):
            return torch.full((batch, n, N), lam0, dtype=torch.float32,
                              device=device)

        return cls(
            state_lambdas=tuple(full(len(pc.state_constraints))
                                for pc in player_costs),
            control_lambdas=tuple(full(len(pc.control_constraints))
                                  for pc in player_costs),
            mu=torch.full((batch,), mu0, dtype=torch.float32, device=device),
        )


def is_constrained(player_costs) -> bool:
    return any(pc.is_constrained for pc in player_costs)


def all_sum(player_costs) -> bool:
    """Whether every player's structure is SUM: then extreme_ks is
    identically 0 and no gate is made (the JAX package's `_all_sum`)."""
    return all(pc.structure == STRUCTURE_SUM for pc in player_costs)


def total_costs(player_costs, spec: GameSpec, op: OperatingPoint):
    """Per-player total costs of a batched operating point: (totals [B, P],
    extreme_ks [B, P] int32). A SUM player's total is a fixed-order fold
    over the knots (torch.sum's order depends on the device and on the
    batch size, and a lane's total must not) and its extreme_ks 0; a MAX
    (MIN) player's is its largest (smallest) stage cost, NaN if any is,
    and extreme_ks that knot, the first (or first NaN) as jnp.argmax
    (argmin) picks it."""
    ts = spec.horizon_times(op.xs.device)
    totals, ks = [], []
    for pc in player_costs:
        vals = pc.evaluate_stage(ts, op.xs, op.us)          # [B, N]
        if pc.structure == STRUCTURE_SUM:
            totals.append(_fixed_order_sum(vals))
            ks.append(torch.zeros(vals.shape[:-1], dtype=torch.int32,
                                  device=vals.device))
        else:
            is_min = pc.structure == STRUCTURE_MIN
            totals.append(vals.amin(-1) if is_min else vals.amax(-1))
            ks.append(extreme_index(vals, is_min).to(torch.int32))
    return torch.stack(totals, dim=-1), torch.stack(ks, dim=-1)


def extreme_gate(player_costs, spec: GameSpec, extreme_ks):
    """[B, N, P] state-term gates: 1 for SUM players, one-hot at the
    extreme knot extreme_ks [B, P] for MAX and MIN players (the JAX
    package's `_extreme_gate_b`)."""
    N = spec.num_time_steps
    ks = torch.arange(N, device=extreme_ks.device)
    cols = [torch.ones((extreme_ks.shape[0], N), device=extreme_ks.device)
            if pc.structure == STRUCTURE_SUM else
            (ks[None, :] == extreme_ks[:, i, None]).to(torch.float32)
            for i, pc in enumerate(player_costs)]
    return torch.stack(cols, dim=-1)


def _lam(lams, ci):
    return lams[..., ci]


def _player_gradient_terms(pc, i, t, x, us, lam_state, lam_ctrl, mu):
    """Player i's gradient terms: (state pairs, dense state sum or None,
    own-control pairs, dense own-control sum or None), in the JAX
    package's order (player_cost.py:125-188). A dense sum folds the dense
    gradients of the atoms, then of the constraints, in their order."""
    def add(dense, g):
        return g if dense is None else dense + g

    pairs, dense = [], None
    for c in pc.state_costs:
        pp = c.gradient_pairs(t, x)
        if pp is None:
            dense = add(dense, c.gradient(t, x))
        else:
            pairs.extend(pp)
    for ci, con in enumerate(pc.state_constraints):
        lam = _lam(lam_state[i], ci)
        pp = con.gradient_al_pairs(t, x, lam, mu)
        if pp is None:
            dense = add(dense, con.gradient_al(t, x, lam, mu))
        else:
            pairs.extend(pp)
    ui = us[..., i, :]
    upairs, udense = [], None
    for jj, c in pc.control_costs:
        if jj == i:
            pp = c.gradient_pairs(t, ui)
            if pp is None:
                udense = add(udense, c.gradient(t, ui))
            else:
                upairs.extend(pp)
    for ci, (jj, con) in enumerate(pc.control_constraints):
        if jj == i:
            lam = _lam(lam_ctrl[i], ci)
            pp = con.gradient_al_pairs(t, ui, lam, mu)
            if pp is None:
                udense = add(udense, con.gradient_al(t, ui, lam, mu))
            else:
                upairs.extend(pp)
    return pairs, dense, upairs, udense


def stage_gradients(player_costs, spec: GameSpec, lam_state, lam_ctrl, mu,
                    t, x, us):
    """Every player's dense stage gradients (l [..., P, xd], r_own
    [..., P, um]): the assembled pairs plus the dense sum (JAX
    stage_gradients_core, player_cost.py:125-188). Arguments as
    `stage_gradient_sq_tuple`'s."""
    ls, rs = [], []
    for i, pc in enumerate(player_costs):
        pairs, dense, upairs, udense = _player_gradient_terms(
            pc, i, t, x, us, lam_state, lam_ctrl, mu)
        g = assemble_vector(spec.xdim, pairs, x[..., 0])
        ls.append(g if dense is None else g + dense)
        ui = us[..., i, :]
        gu = assemble_vector(spec.umax, upairs, ui[..., 0])
        rs.append(gu if udense is None else gu + udense)
    return torch.stack(ls, dim=-2), torch.stack(rs, dim=-2)


def stage_gradient_sq_tuple(player_costs, spec: GameSpec, lam_state,
                            lam_ctrl, mu, t, x, us):
    """Per-player squared stage-gradient sums (state_sqs, ctrl_sqs), tuples
    of P tensors: the merit increments (JAX player_cost.py:191-266). From
    sparse pairs alone, per-dim accumulation follows pair order and the
    touched dims are squared and summed in ascending order; a player with
    a dense atom squares every entry of the assembled gradient plus the
    dense sum and sums them left to right over all dims.

    lam_state / lam_ctrl: per-player multipliers with the constraint index
    on the last axis; x [..., xd], us [..., P, um]."""
    def sq_of(pairs, dense, d, like):
        if dense is not None:
            vec = assemble_vector(d, pairs, like) + dense
            s = torch.zeros_like(like)
            for i_ in range(d):
                s = s + vec[..., i_] * vec[..., i_]
            return s
        acc = {}
        for i_, v in pairs:
            acc[i_] = acc[i_] + v if i_ in acc else v
        s = torch.zeros_like(like)
        for i_ in sorted(acc):
            s = s + acc[i_] * acc[i_]
        return s

    state_sqs = []
    ctrl_sqs = []
    for i, pc in enumerate(player_costs):
        pairs, dense, upairs, udense = _player_gradient_terms(
            pc, i, t, x, us, lam_state, lam_ctrl, mu)
        state_sqs.append(sq_of(pairs, dense, spec.xdim, x[..., 0]))
        ctrl_sqs.append(sq_of(upairs, udense, spec.umax, us[..., i, 0]))
    return tuple(state_sqs), tuple(ctrl_sqs)


def check_sparse(player_costs) -> None:
    """The stage kernel K1 assembles every player's terms from sparse
    pairs: raise the JAX package's ValueError (player_cost.py:440-495) for
    an atom or a constraint that has only a dense form, in the JAX
    package's order (each player's state costs, then its state
    constraints; then each player's control terms)."""
    for pc in player_costs:
        for c in pc.state_costs:
            if not c.has_pairs:
                raise ValueError(
                    f"stage_quadraticize_entries: state cost {c.name!r} "
                    "has no sparse quad_pairs (required for the fused "
                    "Pallas stage kernel; use fuse_stages=False)")
        for con in pc.state_constraints:
            if con.al_quad_pairs_fn is None:
                raise ValueError(
                    f"stage_quadraticize_entries: state constraint "
                    f"{con.name!r} has no sparse quad_al_pairs")
    for pc in player_costs:
        for j in pc.control_players():
            for jj, c in pc.control_costs:
                if jj == j and not c.has_pairs:
                    raise ValueError(
                        f"stage_quadraticize_entries: control cost "
                        f"{c.name!r} has no sparse quad_pairs")
            for jj, con in pc.control_constraints:
                if jj == j and con.al_quad_pairs_fn is None:
                    raise ValueError(
                        f"stage_quadraticize_entries: control constraint "
                        f"{con.name!r} has no sparse quad_al_pairs")


def _assemble(out, idx, entries, like):
    """Write accumulated sparse entries {key: value} into `out[..., idx,
    *key]` with one indexed store; missing cells stay zero."""
    if not entries:
        return
    keys = list(entries)
    vals = torch.stack([torch.broadcast_to(entries[k], like.shape)
                        for k in keys], dim=-1)
    cols = [const_tensor(tuple(k[d] for k in keys), out.device)
            for d in range(len(keys[0]))]
    out[(Ellipsis,) + idx + tuple(cols)] = vals


def quadraticize(player_costs, spec: GameSpec, op: OperatingPoint,
                 al: ALState, t=None, gate=None) -> QuadraticCosts:
    """Full-horizon quadratic approximation of every player's cost at a
    batched operating point (xs [B, N, x], us [B, N, P, u]): Q [B,N,P,x,x],
    l [B,N,P,x], R [B,N,P,P,u,u], r [B,N,P,P,u]. The atoms see the knot
    times `t` ([N] or [B, N]); by default the relative times k * dt, as
    the JAX package's unfused quadraticize (player_cost.py:563). `gate`
    ([B, N, P], `extreme_gate`) multiplies the state terms of the MAX and
    MIN players, before the regularization."""
    Bt, N, xd = op.xs.shape
    P, um = spec.num_players, spec.umax
    dev = op.xs.device
    if t is None:
        t = spec.horizon_times(dev)
    x, us = op.xs, op.us
    like = x[..., 0]
    mu = al.mu[:, None]
    u_mask = spec.u_mask("cpu").tolist()

    def acc_into(dacc, pairs):
        for key, v in pairs:
            dacc[key] = dacc[key] + v if key in dacc else v

    def atom_terms(costs, v):
        """The atoms' pairs folded per key, and their dense parts
        summed in atom order (None without any)."""
        hacc, gacc, hd, gd = {}, {}, None, None
        for c in costs:
            qp = c.quad_pairs(t, v)
            if qp is None:
                h, g = c.quadraticize(t, v)
                hd, gd = (h, g) if hd is None else (hd + h, gd + g)
            else:
                acc_into(hacc, qp[0])
                acc_into(gacc, qp[1])
        return hacc, gacc, hd, gd

    def store(H, g, idx, hacc, gacc, hd, gd, reg, gate_i=None):
        """Assemble the pairs into H[..., *idx, :, :] and g; then add the
        dense sum, multiply by the gate `gate_i` ([B, N] or None) and,
        after it, add the regularization `reg` (a diagonal of floats, or
        None). Without dense parts or a gate the regularization folds
        into the pairs, as before them."""
        if reg is not None and hd is None and gate_i is None:
            acc_into(hacc, (((d, d), torch.full_like(like, rv))
                            for d, rv in enumerate(reg)))
            reg = None
        _assemble(H, idx, hacc, like)
        _assemble(g, idx, {(k,): v for k, v in gacc.items()}, like)
        sel = (slice(None), slice(None)) + idx
        if hd is not None:
            H[sel] = H[sel] + hd
            g[sel] = g[sel] + gd
        if gate_i is not None:
            H[sel] = H[sel] * gate_i[..., None, None]
            g[sel] = g[sel] * gate_i[..., None]
        if reg is not None:
            for d, rv in enumerate(reg):
                H[sel + (d, d)] = H[sel + (d, d)] + rv

    Q = x.new_zeros((Bt, N, P, xd, xd))
    l = x.new_zeros((Bt, N, P, xd))
    R = x.new_zeros((Bt, N, P, P, um, um))
    r = x.new_zeros((Bt, N, P, P, um))

    def con_terms(con, v, lam, hacc, gacc, hd, gd):
        """A constraint's pairs folded in, or its dense form added to the
        dense sum: (hd, gd)."""
        qp = con.quad_al_pairs(t, v, lam, mu)
        if qp is None:
            h, g = con.quadraticize_al(t, v, lam, mu)
            return (h, g) if hd is None else (hd + h, gd + g)
        acc_into(hacc, qp[0])
        acc_into(gacc, qp[1])
        return hd, gd

    for i, pc in enumerate(player_costs):
        hacc, gacc, hd, gd = atom_terms(pc.state_costs, x)
        for ci, con in enumerate(pc.state_constraints):
            hd, gd = con_terms(con, x, al.state_lambdas[i][:, ci], hacc,
                               gacc, hd, gd)
        reg = ([pc.state_regularization] * xd
               if pc.state_regularization != 0.0 else None)
        gated = gate is not None and pc.structure != STRUCTURE_SUM
        store(Q, l, (i,), hacc, gacc, hd, gd, reg,
              gate[..., i] if gated else None)

        for j in pc.control_players():
            uj = us[..., j, :]
            hacc, gacc, hd, gd = atom_terms(
                [c for jj, c in pc.control_costs if jj == j], uj)
            for ci, (jj, con) in enumerate(pc.control_constraints):
                if jj == j:
                    hd, gd = con_terms(con, uj, al.control_lambdas[i][:, ci],
                                       hacc, gacc, hd, gd)
            reg = ([pc.control_regularization * u_mask[j][a]
                    for a in range(um)]
                   if pc.control_regularization != 0.0 else None)
            store(R, r, (i, j), hacc, gacc, hd, gd, reg)
    return QuadraticCosts(Q=Q, l=l, R=R, r=r)
