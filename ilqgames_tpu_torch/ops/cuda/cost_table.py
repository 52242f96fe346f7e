"""The problem description that the stage kernel K1 and the merit kernels
K5 and K6 read (csrc/costs.cuh): every player's atoms, with their kinds,
dims, weights, nominals, thresholds, signs, orientations, gate times,
polyline segments and extremal groups, its control constraints and its
cost structure, as a ctypes struct (`cost_table`), and the polyline
segments (and, for the signed query, their shortcut segments) as a
small device tensor. K1 holds the struct, with the SubsysTable, in its
library's constant memory (`stage._set_tables`: the two tables passed by
value came near the 4 KB of kernel parameters); K5, K6 and the probe P2
take it by value as a kernel parameter (in constant or shared memory,
ptxas spilled the flagship's K5).

An atom or constraint with no device form raises NotImplementedError, so
a kernel is never launched on a problem it cannot compute. The two norm
atoms have device forms in the merit kernels K5 and K6, in libraries
built with CT_NORMS=1 (`has_norms`); K1 takes quadratic_norm (CT_ZOO) and
never semiquadratic_norm, which has only a dense form.
The reachability games' features (`has_reach`: the signed-distance atom,
an extremal group of atoms, a control constraint, a MAX or MIN player)
are compiled into K1, K5 and K6 only with CT_REACH=1, so that the other
games' kernels are the same code; so is the quadratic_difference atom,
with CT_DIFF=1 (`has_diff`).

An extremal group (atoms.extreme_value) is a header atom (kind
"extreme", `group` its member count, `right` 1 for the minimum) followed
by its members (`group` -1), each of which the kernels multiply by its
one-hot gate. The semiquadratic atom is compiled into K1, K5 and K6 only
where a game's table holds one (`has_semi`: CT_SEMI=1), and so is the
polyline signed-distance atom (`has_polysd`: CT_POLYSD=1), which shares
the semiquadratic polyline's signed query and shortcut rows, and the
route-progress atom (`has_route`: CT_ROUTE=1), whose desired point walks
its polyline's segment rows with the segments' cumulative start lengths
(one float each, after the shortcut rows, at `fix0`). The rest of the
cost layer is compiled in with CT_ZOO=1 (`has_zoo`; `has_zoo_stage` for
K1): relative_distance, nominal_path_length, curvature, orientation,
quadratic_difference at other than two differences (a header row, its
`group` the count, then a row per difference), a state constraint's
single_dimension form and a final-time gate on a state constraint; the
two convex proximities' dense merit gradients (K5 and K6, with CT_NORMS
for the dense accumulator); and quadratic_norm in K1. The constraints
affine_scalar, affine_vector and polyline2_signed_distance have only a
dense form and no device form: a game with one is refused here.

The table's capacity is per build, as the other layout defines are
(`capacity`): MAX_ATOMS (32) atoms for a game with at most that many, so
that those games' table is the same 2,980 B struct and their kernels the
same code as before; else the game's count rounded up to 8, built with
CT_MAX_ATOMS (`table_type` makes the ctypes struct of each capacity).
88 B an atom: 4,388 B at 48 (the roundabout's 44 atoms), above the
classic 4 KB of kernel parameters that K5 and K6 take it in; CUDA 12.1
and later on sm_70 and later take 32,764 B.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ilqgames_tpu_torch import geometry
from ilqgames_tpu_torch.costs import player_cost as pcost
from ilqgames_tpu_torch.types import GameSpec, const_tensor

MAX_ATOMS = 32          # a table's capacity, where the game fits it
MAX_CAPACITY = 256      # 22,692 B: the most any build takes
MAX_PLAYERS = 8
KIND = {"quadratic": 0, "polyline": 1, "proximity": 2,
        "semiquadratic_polyline": 3, "proximity_cost": 4,
        "quadratic_norm": 5, "semiquadratic_norm": 6,
        "signed_distance": 7, "extreme": 8, "single_dimension": 9,
        "quadratic_difference": 10, "semiquadratic": 11,
        "polyline_signed_distance": 12, "route_progress": 13,
        "relative_distance": 14, "nominal_path_length": 15,
        "curvature": 16, "orientation": 17, "quadratic_difference_n": 18,
        "quadratic_difference_member": 19, "locally_convex_proximity": 20,
        "weighted_convex_proximity": 21}
NORM_KINDS = ("quadratic_norm", "semiquadratic_norm")
# The dense atoms whose merit gradients K5 and K6 fold apart.
CONVEX_KINDS = ("locally_convex_proximity", "weighted_convex_proximity")
# The atoms with only a dense form (none in K1).
DENSE_KINDS = ("semiquadratic_norm",) + CONVEX_KINDS
# The kinds compiled in only with CT_ZOO (`has_zoo`).
ZOO_KINDS = ("relative_distance", "nominal_path_length", "curvature",
             "orientation", "quadratic_difference_n") + CONVEX_KINDS
# The polyline atoms of the signed query, with shortcut rows at `fix0`.
SIGNED_KINDS = ("semiquadratic_polyline", "polyline_signed_distance")
REACH_KINDS = ("signed_distance", "extreme")


class CostAtom(ctypes.Structure):
    _fields_ = [("kind", ctypes.c_int), ("player", ctypes.c_int),
                ("on", ctypes.c_int), ("dim", ctypes.c_int * 4),
                ("seg0", ctypes.c_int), ("nseg", ctypes.c_int),
                ("lam", ctypes.c_int), ("w", ctypes.c_float),
                ("aux", ctypes.c_float), ("ends", ctypes.c_float * 4),
                ("fix0", ctypes.c_int), ("right", ctypes.c_int),
                ("gated", ctypes.c_int), ("tgate", ctypes.c_float),
                ("aux2", ctypes.c_float), ("group", ctypes.c_int)]


@functools.lru_cache(maxsize=None)
def table_type(atoms: int = MAX_ATOMS):
    """The ctypes CostTable of a build whose table holds `atoms` atoms
    (csrc/costs.cuh's, with CT_MAX_ATOMS = atoms)."""

    class CostTable(ctypes.Structure):
        _fields_ = [("n", ctypes.c_int), ("atom", CostAtom * atoms),
                    ("state_reg", ctypes.c_float * MAX_PLAYERS),
                    ("ctrl_reg", ctypes.c_float * MAX_PLAYERS),
                    ("ctrl_players", ctypes.c_int * MAX_PLAYERS),
                    ("udims", ctypes.c_int * MAX_PLAYERS),
                    ("extremal", ctypes.c_int * MAX_PLAYERS)]

    CostTable.capacity = atoms
    return CostTable


CostTable = table_type(MAX_ATOMS)


def _capacity_of(n: int) -> int:
    """The capacity of a table of n atoms: MAX_ATOMS, or n rounded up to
    8."""
    cap = MAX_ATOMS if n <= MAX_ATOMS else -(-n // 8) * 8
    if cap > MAX_CAPACITY:
        raise NotImplementedError(
            f"{n} cost atoms: a table takes at most {MAX_CAPACITY}")
    return cap


def _device_form(atom):
    if atom.device is None:
        raise NotImplementedError(
            f"{atom.name!r} has no device form in the stage and merit "
            "kernels (csrc/costs.cuh)")
    return atom.device


@functools.lru_cache(maxsize=None)
def _build(player_costs, spec: GameSpec):
    """(CostTable, flat segment floats) of a game: rows of 7 Python
    floats, p1x p1y p2x p2y ux uy length, as geometry computes them, then
    for each signed query its shortcut rows of 8 floats
    (geometry.shortcut_segments), then for each route-progress atom its
    segments' cumulative start lengths (a Python float sum of the float32
    lengths, as geometry.polyline_point_at compares and subtracts them),
    each at float offset `fix0`."""
    if len(player_costs) > MAX_PLAYERS:
        raise NotImplementedError(f"more than {MAX_PLAYERS} players")
    segs = []
    atoms = []
    lam_row = ctrl_row = 0
    def per_dim(form, n):
        """A quadratic over all n dims as n one-dim quadratics, in dim
        order: the same pairs in the same order; an extremal group as its
        header and its members."""
        kind, prm = form
        if kind == "extreme":
            members = prm["members"]
            if "gate_time" in prm or any(
                    m[0] != "signed_distance" or "gate_time" in m[1]
                    for m in members):
                raise NotImplementedError(
                    "an extremal group's device form takes ungated "
                    "signed-distance members only")
            return [(kind, dict(prm, group=len(members)))] + [
                (m[0], dict(m[1], group=-1)) for m in members]
        if kind == "quadratic_difference_n":
            d1, d2 = prm["dims1"], prm["dims2"]
            return [(kind, dict(prm, group=len(d1)))] + [
                ("quadratic_difference_member", {"dims": (a, b),
                                                 "group": -1})
                for a, b in zip(d1, d2)]
        if kind in CONVEX_KINDS:
            dims = prm["dims"] + prm.get("speeds", ())
            if len(set(dims)) != len(dims):
                raise NotImplementedError(
                    f"{kind}: the device form takes distinct dims, got "
                    f"{dims}")
        if kind != "quadratic" or prm["dim"] >= 0:
            return [form]
        return [(kind, dict(prm, dim=d)) for d in range(n)]

    for i, pc in enumerate(player_costs):
        for c in pc.state_costs:
            atoms += [(i, -1, f, None)
                      for f in per_dim(_device_form(c), spec.xdim)]
        for con in pc.state_constraints:
            form = _device_form(con)
            if form[0] not in ("proximity", "single_dimension"):
                raise NotImplementedError(
                    f"{con.name!r}: only proximity and single-dimension "
                    "state constraints have a device form")
            atoms.append((i, -1, form, lam_row))
            lam_row += 1
        for j, c in pc.control_costs:
            if _device_form(c)[0] != "quadratic":
                raise NotImplementedError(
                    f"{c.name!r}: only quadratic control costs have a "
                    "device form")
            atoms += [(i, j, f, None) for f in per_dim(c.device, spec.umax)]
        for j, con in pc.control_constraints:
            if _device_form(con)[0] != "single_dimension":
                raise NotImplementedError(
                    f"{con.name!r}: only single-dimension control "
                    "constraints have a device form")
            atoms.append((i, j, con.device, ctrl_row))
            ctrl_row += 1
    tab = table_type(_capacity_of(len(atoms)))()
    for i, pc in enumerate(player_costs):
        tab.state_reg[i] = pc.state_regularization
        tab.ctrl_reg[i] = pc.control_regularization
        tab.ctrl_players[i] = sum(1 << j for j in pc.control_players())
        tab.extremal[i] = int(pc.structure != pcost.STRUCTURE_SUM)
    for i, d in enumerate(spec.udims):
        tab.udims[i] = d

    fixes = []
    starts = []
    for n, (i, on, (kind, prm), lam) in enumerate(atoms):
        a = tab.atom[n]
        if kind not in KIND:
            raise NotImplementedError(f"atom kind {kind!r}")
        a.kind, a.player, a.on = KIND[kind], i, on
        if "gate_time" in prm:
            a.gated, a.tgate = 1, prm["gate_time"]
        a.group = prm.get("group", 0)
        if kind == "quadratic":
            a.dim[0], a.w, a.aux = prm["dim"], prm["weight"], prm["nominal"]
        elif kind in SIGNED_KINDS + ("polyline",):
            pts, rows = geometry._static_segments(prm["points"])
            a.dim[0], a.dim[1] = prm["xidx"], prm["yidx"]
            a.seg0, a.nseg = len(segs), len(rows)
            for p1, p2, unit, length in rows:
                segs.append(p1 + p2 + unit + (length,))
            a.ends[:] = [float(pts[0][0]), float(pts[0][1]),
                         float(pts[-1][0]), float(pts[-1][1])]
            if kind in SIGNED_KINDS:
                a.fix0 = len(fixes)
                fixes.extend(geometry.shortcut_segments(prm["points"]))
            if kind == "polyline_signed_distance":
                a.aux, a.aux2 = prm["flip"], prm["nominal"]
            else:
                a.w = prm["weight"]
            if kind == "semiquadratic_polyline":
                thr = prm["threshold"]
                a.aux, a.right = thr, int(prm["oriented_right"])
                a.aux2 = (1.0 if thr >= 0 else -1.0) * thr * thr
        elif kind == "route_progress":
            _, rows = geometry._static_segments(prm["points"])
            a.dim[0], a.dim[1] = prm["xidx"], prm["yidx"]
            a.seg0, a.nseg, a.fix0 = len(segs), len(rows), len(starts)
            cum = 0.0
            for p1, p2, unit, length in rows:
                segs.append(p1 + p2 + unit + (length,))
                starts.append(cum)
                cum += length
            a.w, a.aux = prm["weight"], prm["initial_route_pos"]
            a.aux2 = prm["nominal_speed"]
        elif kind == "proximity":
            a.dim[:] = list(prm["dims"])
            a.w, a.aux, a.lam = prm["threshold"], prm["sign"], lam
        elif kind == "proximity_cost":
            a.dim[:] = list(prm["dims"])
            a.w, a.aux = prm["weight"], prm["threshold"]
            a.aux2 = prm["threshold"] * prm["threshold"]
        elif kind == "quadratic_norm":
            a.dim[0], a.dim[1] = prm["dims"]
            a.w, a.aux = prm["weight"], prm["nominal"]
        elif kind == "semiquadratic_norm":
            a.dim[0], a.dim[1] = prm["dims"]
            a.w, a.aux = prm["weight"], prm["threshold"]
            a.right = int(prm["oriented_right"])
        elif kind == "signed_distance":
            a.dim[:] = list(prm["dims"])
            a.w, a.aux = prm["sign"], prm["nominal"]
        elif kind == "extreme":
            a.right = int(prm["is_min"])
        elif kind == "quadratic_difference":
            a.dim[:] = list(prm["dims"])
            a.w = prm["weight"]
        elif kind == "semiquadratic":
            a.dim[0], a.w, a.aux = prm["dim"], prm["weight"], prm["threshold"]
            a.right = int(prm["oriented_right"])
        elif kind == "single_dimension":
            a.dim[0], a.w, a.lam = prm["dim"], prm["threshold"], lam
            a.aux = 1.0 if prm["keep_below"] else -1.0
        elif kind == "relative_distance":
            a.dim[:] = list(prm["dims"])
            a.w = prm["weight"]
        elif kind in ("nominal_path_length", "orientation"):
            a.dim[0], a.w = prm["dim"], prm["weight"]
            a.aux = prm.get("nominal_speed", prm.get("nominal"))
        elif kind == "curvature":
            a.dim[0], a.dim[1] = prm["dims"]
            a.w = prm["weight"]
        elif kind == "quadratic_difference_n":
            a.w = prm["weight"]
        elif kind == "quadratic_difference_member":
            a.dim[0], a.dim[1] = prm["dims"]
        elif kind in CONVEX_KINDS:
            a.dim[:] = list(prm["dims"])
            a.w, a.aux = prm["weight"], prm["threshold"]
            a.aux2 = prm["threshold"] * prm["threshold"]
            if kind == "weighted_convex_proximity":
                a.seg0, a.nseg = prm["speeds"]
    tab.n = len(atoms)
    # The shortcut rows follow the segment rows, and the start lengths
    # follow them.
    for n in range(tab.n):
        if tab.atom[n].kind in [KIND[k] for k in SIGNED_KINDS]:
            tab.atom[n].fix0 = 7 * len(segs) + 8 * tab.atom[n].fix0
        elif tab.atom[n].kind == KIND["route_progress"]:
            tab.atom[n].fix0 = (7 * len(segs) + 8 * len(fixes)
                                + tab.atom[n].fix0)
    flat = tuple(v for row in segs for v in row) + tuple(
        v for row in fixes for v in row) + tuple(starts)
    return tab, flat or (0.0,)


def has_reach(player_costs) -> bool:
    """Whether a game needs the reachability games' features in its
    kernels (a signed-distance atom or an extremal group, a control
    constraint, or a MAX or MIN player): they are then built with
    CT_REACH=1."""
    return any(pc.structure != pcost.STRUCTURE_SUM or pc.control_constraints
               or any(c.device is not None and c.device[0] in REACH_KINDS
                      for c in pc.state_costs)
               for pc in player_costs)


def _has_state_atom(player_costs, kinds) -> bool:
    """Whether any player's state costs hold an atom of a device kind in
    `kinds`."""
    return any(c.device is not None and c.device[0] in kinds
               for pc in player_costs for c in pc.state_costs)


def has_diff(player_costs) -> bool:
    """Whether a game's table holds a quadratic_difference atom: its K1,
    K5 and K6 are then built with it (CT_DIFF=1)."""
    return _has_state_atom(player_costs, ("quadratic_difference",))


def has_semi(player_costs) -> bool:
    """Whether a game's table holds a semiquadratic atom: its K1, K5 and K6
    are then built with it (CT_SEMI=1)."""
    return _has_state_atom(player_costs, ("semiquadratic",))


def has_polysd(player_costs) -> bool:
    """Whether a game's table holds a polyline signed-distance atom: its
    K1, K5 and K6 are then built with it (CT_POLYSD=1)."""
    return _has_state_atom(player_costs, ("polyline_signed_distance",))


def has_route(player_costs) -> bool:
    """Whether a game's table holds a route-progress atom: its K1, K5 and
    K6 are then built with it (CT_ROUTE=1)."""
    return _has_state_atom(player_costs, ("route_progress",))


def has_zoo(player_costs) -> bool:
    """Whether a game's table holds an atom of ZOO_KINDS or a state
    constraint other than an ungated proximity (a single_dimension, a
    final-time gate): its K5 and K6 are then built with them
    (CT_ZOO=1)."""
    return _has_state_atom(player_costs, ZOO_KINDS) or any(
        con.device is not None and (con.device[0] != "proximity"
                                    or "gate_time" in con.device[1])
        for pc in player_costs for con in pc.state_constraints)


def has_zoo_stage(player_costs) -> bool:
    """`has_zoo` for the stage kernel K1, which also takes quadratic_norm
    under CT_ZOO: where a game holds one and K1 can launch on it (every
    atom and constraint with sparse pairs; a game with a dense one runs
    unfused, and its K1 is built without the flag)."""
    if has_zoo(player_costs):
        return True
    sparse = all(c.has_pairs for pc in player_costs for c in pc.state_costs)
    return sparse and _has_state_atom(player_costs, ("quadratic_norm",))


def has_table(player_costs, spec: GameSpec) -> bool:
    """Whether every atom and constraint of the game has a device form
    (else the stage and merit kernels refuse it: `cost_table` raises)."""
    try:
        _build(tuple(player_costs), spec)
    except NotImplementedError:
        return False
    return True


def capacity(player_costs, spec: GameSpec) -> int:
    """The atoms that the game's table holds room for, its kernels'
    CT_MAX_ATOMS (`table_type`)."""
    return _build(tuple(player_costs), spec)[0].capacity


def has_dense(player_costs) -> bool:
    """Whether a game's table holds a dense atom (semiquadratic_norm or a
    convex proximity, gated or not): K5 and K6 fold its dense gradient,
    and K1 has no form of it."""
    return _has_state_atom(player_costs, DENSE_KINDS)


def has_norms(player_costs) -> bool:
    """Whether a game's table holds a norm atom or a convex proximity: its
    merit kernels are then built with CT_NORMS=1 (the dense accumulator,
    and the norm atoms' forms)."""
    return _has_state_atom(player_costs, NORM_KINDS + CONVEX_KINDS)


def cost_table(player_costs, spec: GameSpec, device):
    """(CostTable, segments [n, 7] float32 on `device`) for the kernels."""
    tab, flat = _build(tuple(player_costs), spec)
    segs = const_tensor(flat, torch.device(device))
    return tab, segs

