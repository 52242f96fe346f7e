"""The problem description that the stage kernel K1 and the merit kernels
K5 and K6 read (csrc/costs.cuh): every player's atoms, with their kinds,
dims, weights, nominals, thresholds, signs, orientations, gate times and
polyline segments, as a ctypes struct passed by value, and the polyline
segments (and, for the signed query, their shortcut segments) as a small
device tensor.

An atom or constraint with no device form raises NotImplementedError, so
a kernel is never launched on a problem it cannot compute. The two norm
atoms have device forms in the merit kernels K5 and K6 only, in libraries
built with CT_NORMS=1 (`has_norms`); the stage kernel K1 refuses them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ilqgames_tpu_torch import geometry
from ilqgames_tpu_torch.costs import player_cost as pcost
from ilqgames_tpu_torch.types import GameSpec, const_tensor

MAX_ATOMS = 32
MAX_PLAYERS = 8
KIND = {"quadratic": 0, "polyline": 1, "proximity": 2,
        "semiquadratic_polyline": 3, "proximity_cost": 4,
        "quadratic_norm": 5, "semiquadratic_norm": 6}
NORM_KINDS = ("quadratic_norm", "semiquadratic_norm")


class CostAtom(ctypes.Structure):
    _fields_ = [("kind", ctypes.c_int), ("player", ctypes.c_int),
                ("on", ctypes.c_int), ("dim", ctypes.c_int * 4),
                ("seg0", ctypes.c_int), ("nseg", ctypes.c_int),
                ("lam", ctypes.c_int), ("w", ctypes.c_float),
                ("aux", ctypes.c_float), ("ends", ctypes.c_float * 4),
                ("fix0", ctypes.c_int), ("right", ctypes.c_int),
                ("gated", ctypes.c_int), ("tgate", ctypes.c_float),
                ("aux2", ctypes.c_float)]


class CostTable(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int), ("atom", CostAtom * MAX_ATOMS),
                ("state_reg", ctypes.c_float * MAX_PLAYERS),
                ("ctrl_reg", ctypes.c_float * MAX_PLAYERS),
                ("ctrl_players", ctypes.c_int * MAX_PLAYERS),
                ("udims", ctypes.c_int * MAX_PLAYERS)]


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
    (geometry.shortcut_segments), at float offset `fix0`."""
    pcost.check_structures(player_costs)
    if len(player_costs) > MAX_PLAYERS:
        raise NotImplementedError(f"more than {MAX_PLAYERS} players")
    tab = CostTable()
    segs = []
    atoms = []
    lam_row = 0
    def per_dim(form, n):
        """A quadratic over all n dims as n one-dim quadratics, in dim
        order: the same pairs in the same order."""
        kind, prm = form
        if kind != "quadratic" or prm["dim"] >= 0:
            return [form]
        return [(kind, dict(prm, dim=d)) for d in range(n)]

    for i, pc in enumerate(player_costs):
        if pc.control_constraints:
            raise NotImplementedError(
                f"player {i}: control constraints have no device form in "
                "the stage and merit kernels")
        for c in pc.state_costs:
            atoms += [(i, -1, f, None)
                      for f in per_dim(_device_form(c), spec.xdim)]
        for con in pc.state_constraints:
            atoms.append((i, -1, _device_form(con), lam_row))
            lam_row += 1
        for j, c in pc.control_costs:
            if _device_form(c)[0] != "quadratic":
                raise NotImplementedError(
                    f"{c.name!r}: only quadratic control costs have a "
                    "device form")
            atoms += [(i, j, f, None) for f in per_dim(c.device, spec.umax)]
        tab.state_reg[i] = pc.state_regularization
        tab.ctrl_reg[i] = pc.control_regularization
        tab.ctrl_players[i] = sum(1 << j for j in pc.control_players())
    for i, d in enumerate(spec.udims):
        tab.udims[i] = d
    if len(atoms) > MAX_ATOMS:
        raise NotImplementedError(f"more than {MAX_ATOMS} cost atoms")

    fixes = []
    for n, (i, on, (kind, prm), lam) in enumerate(atoms):
        a = tab.atom[n]
        if kind not in KIND:
            raise NotImplementedError(f"atom kind {kind!r}")
        a.kind, a.player, a.on = KIND[kind], i, on
        if "gate_time" in prm:
            a.gated, a.tgate = 1, prm["gate_time"]
        if kind == "quadratic":
            a.dim[0], a.w, a.aux = prm["dim"], prm["weight"], prm["nominal"]
        elif kind in ("polyline", "semiquadratic_polyline"):
            pts, rows = geometry._static_segments(prm["points"])
            a.dim[0], a.dim[1], a.w = prm["xidx"], prm["yidx"], prm["weight"]
            a.seg0, a.nseg = len(segs), len(rows)
            for p1, p2, unit, length in rows:
                segs.append(p1 + p2 + unit + (length,))
            a.ends[:] = [float(pts[0][0]), float(pts[0][1]),
                         float(pts[-1][0]), float(pts[-1][1])]
            if kind == "semiquadratic_polyline":
                thr = prm["threshold"]
                a.aux, a.right = thr, int(prm["oriented_right"])
                a.aux2 = (1.0 if thr >= 0 else -1.0) * thr * thr
                a.fix0 = len(fixes)
                fixes.extend(geometry.shortcut_segments(prm["points"]))
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
    tab.n = len(atoms)
    # The shortcut rows follow the segment rows.
    for n in range(tab.n):
        if tab.atom[n].kind == KIND["semiquadratic_polyline"]:
            tab.atom[n].fix0 = 7 * len(segs) + 8 * tab.atom[n].fix0
    flat = tuple(v for row in segs for v in row) + tuple(
        v for row in fixes for v in row)
    return tab, flat or (0.0,)


def has_norms(player_costs) -> bool:
    """Whether a game's table holds a norm atom: its merit kernels are then
    built with CT_NORMS=1."""
    return any(c.device is not None and c.device[0] in NORM_KINDS
               for pc in player_costs for c in pc.state_costs)


def cost_table(player_costs, spec: GameSpec, device):
    """(CostTable, segments [n, 7] float32 on `device`) for the kernels."""
    tab, flat = _build(tuple(player_costs), spec)
    segs = const_tensor(flat, torch.device(device))
    return tab, segs
