"""Candidate rollout (kernel K4), the rollout with in-kernel merit (K5),
the merit consumer (K6) and the linesearch merit sweep: counterpart of
ilqgames_tpu/ops/pallas/sweep.py with emit_us=False.

Each kernel's wrapper (`rollout_bm`: K4 and `rollout_merits`: K5, in
csrc/sweep.cu; `consumer_merits`: K6, in csrc/merit.cu) launches it on
CUDA tensors and takes its plain PyTorch version on CPU tensors; any
other device raises. Each keeps a launch count. csrc/sweep.cu is built
per game: its layout of subsystems is compile-time (`library`). K4 and K5
run one warp per subsystem over 32 chains; K5's warp s also computes the
merit terms of the players whose control rows it computes (each player's
in exactly one warp, checked by `library`: one each for the flagship's
cars and pedestrian and for the flat intersection's three linear blocks,
both players in the point mass's one linear subsystem and in the one
subsystem of a coupled system, two_player_unicycle_4d or air_3d), and one
warp folds the players' terms after each knot's barrier.

The sweep's `merit_backend` picks how a candidate's merit is computed,
as the JAX package's does:
- "xla" (default): K4 emits the candidates' states, `_us_from_xs`
  rebuilds their controls with the kernel's fold order, and `merit_plain`
  folds the squared stage gradients over the knots in ascending order
  (control terms always, state terms for k > 0) in plain PyTorch;
- "pallas": the same emission, folded by K6;
- "kernel": K5 rolls out and folds in one kernel, emitting only merits.
The three compute the same operations in the same order. Each player's
squared state gradient is multiplied by its extremal gate at each knot
(`gate` [N, P, B]: 1 for a SUM player, one-hot at the extreme knot for a
MAX or MIN one) when the game has a MAX or MIN player; a game of SUM
players has no gate (None), and nothing is multiplied.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from ilqgames_tpu_torch.costs import player_cost as pcost
from ilqgames_tpu_torch.dynamics import base as dyn_base
from ilqgames_tpu_torch.ops.cuda import build
from ilqgames_tpu_torch.ops.cuda.cost_table import MAX_ATOMS, capacity, \
    cost_table, has_diff, has_norms, has_polysd, has_reach, has_route, \
    has_semi, has_zoo, table_type
from ilqgames_tpu_torch.dynamics.models import COUPLED_KINDS, KIND_CAR_5D, \
    KIND_CAR_6D, KIND_DUBINS, KIND_LINEAR, KIND_UNICYCLE_4D
from ilqgames_tpu_torch.ops.cuda.layout import bm, mb, pad_batch
from ilqgames_tpu_torch.types import GameSpec, OperatingPoint, Strategy, \
    const_tensor

_MAX_SUBSYS = 8
_MAX_LIN = 48  # csrc/costs.cuh MAX_LIN: four flat car_6d's entries
MERIT_BACKENDS = ("xla", "kernel", "pallas")


class _SubsysTable(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int),
                ("kind", ctypes.c_int * _MAX_SUBSYS),
                ("xoff", ctypes.c_int * _MAX_SUBSYS),
                ("uoff", ctypes.c_int * _MAX_SUBSYS),
                ("length", ctypes.c_float * _MAX_SUBSYS),
                ("param2", ctypes.c_float * _MAX_SUBSYS),
                ("nlin", ctypes.c_int),
                ("lin_u", ctypes.c_int * _MAX_LIN),
                ("lin_row", ctypes.c_int * _MAX_LIN),
                ("lin_col", ctypes.c_int * _MAX_LIN),
                ("lin_val", ctypes.c_float * _MAX_LIN)]


def _linear_table(dyn, spec: GameSpec) -> _SubsysTable:
    """A linear system as one subsystem over the whole state that reads
    every control row, or (`linear_per_player`, a flat system) as one
    subsystem per player over its own rows, with the system's constant
    discrete Jacobian entries."""
    a_acc, b_acc = dyn_base.constant_linearization(dyn, spec)
    entries = ([(0, r, c, v) for (r, c), v in a_acc.items()]
               + [(1, r, p * spec.umax + c, v)
                  for (p, r, c), v in b_acc.items()])
    if len(entries) > _MAX_LIN:
        raise NotImplementedError(
            f"dynamics {dyn.name!r}: more than {_MAX_LIN} Jacobian entries")
    tab = _SubsysTable()
    if dyn.linear_per_player:
        if 0 in spec.xdims or len(spec.xdims) > _MAX_SUBSYS:
            raise NotImplementedError(
                f"dynamics {dyn.name!r}: one linear subsystem per player "
                f"needs 1-{_MAX_SUBSYS} players, each with states")
        tab.n = len(spec.xdims)
        for i in range(tab.n):
            tab.kind[i] = KIND_LINEAR
            tab.xoff[i] = sum(spec.xdims[:i])
            tab.uoff[i] = i * spec.umax
    else:
        tab.n = 1
        tab.kind[0] = KIND_LINEAR
    tab.nlin = len(entries)
    for e, (is_u, r, c, v) in enumerate(entries):
        tab.lin_u[e], tab.lin_row[e], tab.lin_col[e] = is_u, r, c
        tab.lin_val[e] = v
    return tab


def _device_table(dyn, spec: GameSpec) -> _SubsysTable:
    """The rollout kernel's per-subsystem ODE table; raises for a model
    with no device ODE. A coupled system (`dyn.kind`) is one subsystem at
    state and control offset 0, its parameters in `length` and `param2`."""
    if dyn.linear_rows is not None:
        return _linear_table(dyn, spec)
    if dyn.kind is not None:
        if dyn.kind not in COUPLED_KINDS or len(dyn.params) > 2:
            raise NotImplementedError(
                f"dynamics {dyn.name!r}: kind {dyn.kind} with "
                f"{len(dyn.params)} parameters has no device form")
        tab = _SubsysTable()
        tab.n = 1
        tab.kind[0] = dyn.kind
        tab.length[0], tab.param2[0] = (tuple(dyn.params) + (0.0, 0.0))[:2]
        return tab
    if not dyn.models or len(dyn.models) > _MAX_SUBSYS:
        raise NotImplementedError(
            f"dynamics {dyn.name!r}: the rollout kernel needs 1-"
            f"{_MAX_SUBSYS} concatenated models with device ODEs")
    tab = _SubsysTable()
    tab.n = len(dyn.models)
    off = 0
    for i, m in enumerate(dyn.models):
        if m.kind is None:
            raise NotImplementedError(
                f"model {m.name!r} has no device ODE in the rollout kernel")
        tab.kind[i] = m.kind
        tab.xoff[i] = off
        tab.uoff[i] = i * spec.umax
        tab.length[i] = m.length
        off += m.xdim
    return tab


def _whole(tab: _SubsysTable, s: int) -> bool:
    """Whether subsystem s is the whole system: a coupled one, or a linear
    system in one subsystem."""
    return tab.kind[s] in COUPLED_KINDS or (tab.kind[s] == KIND_LINEAR
                                            and tab.n == 1)


def _control_rows(tab: _SubsysTable, s: int, spec: GameSpec):
    """The flat control rows [lo, hi) that subsystem s reads: every
    player's for a whole system (`_whole`), else its own player's."""
    if _whole(tab, s):
        return tab.uoff[s], tab.uoff[s] + spec.num_players * spec.umax
    return tab.uoff[s], tab.uoff[s] + spec.umax


def _rows(tab: _SubsysTable, s: int, spec: GameSpec) -> int:
    """The count of state rows of subsystem s: the whole state for a
    whole system (`_whole`), else its player's."""
    if _whole(tab, s):
        return spec.xdim
    return spec.xdims[s]


def _umask_flat(spec: GameSpec):
    return tuple(1.0 if a < d else 0.0 for d in spec.udims
                 for a in range(spec.umax))


def _hexf(v: float) -> str:
    """An exact float32 hex literal of v (rounded to float32 first)."""
    return f"{float(ctypes.c_float(v).value).hex()}f"


def library(dyn, spec: GameSpec, norms: bool = False, reach: bool = False,
            diff: bool = False, semi: bool = False, atoms: int = MAX_ATOMS,
            polysd: bool = False, route: bool = False, zoo: bool = False):
    """(source name, defines) of csrc/sweep.cu (K4, K5) for this game: its
    dims, and its layout of subsystems from `_device_table`'s data (so a
    model with no device ODE raises): the count SW_NSUB and, per field, a
    list of SW_ITEM(v), one per subsystem (nvcc splits a define's value at
    commas): kinds, state offsets, control offsets, the models' first and
    second parameters (inter-axle lengths, speeds) as exact float32 hex
    literals, counts of state rows and of control rows. A linear system adds its terms, in row order: SW_NLIN, and per
    term its row, its source (a state index, or X plus a flat control row)
    and its coefficient, and SW_LIN_ZERO, whether its rows fold from
    x * 0. A layout with a car_5d or a dubins_car, or of more than 16
    states, and a library with `zoo`, add SW_MIN_BLOCKS=1 (K4's and K5's launch bounds ask for one
    block per SM at the least: ptxas's default register target spilled
    them). With `norms` (a game
    whose costs hold a norm atom), K5 is built with those atoms
    (CT_NORMS=1); with `reach`
    (`cost_table.has_reach`), with the reachability games' atoms, control
    constraints and extremal gates (CT_REACH=1); with `diff`
    (`cost_table.has_diff`), with the quadratic_difference atom
    (CT_DIFF=1); with `semi` (`cost_table.has_semi`), with the
    semiquadratic atom (CT_SEMI=1); for a table of more than MAX_ATOMS
    atoms, with its capacity `atoms` (CT_MAX_ATOMS); with `polysd`
    (`cost_table.has_polysd`), with the polyline signed-distance atom
    (CT_POLYSD=1); with `route` (`cost_table.has_route`), with the
    route-progress atom (CT_ROUTE=1); with `zoo` (`cost_table.has_zoo`),
    with the rest of the cost layer (CT_ZOO=1). K4 takes none of these:
    `merit_features` gives a game's flags for K5.

    Warp s computes the control rows from SW_SUB_UOFF[s] on (its player's
    for a model or a flat system's block, every player's for a coupled
    system or a linear system in one subsystem) and, in K5, the merit terms of the players
    whose rows those are; a game where a player's rows are not within
    exactly one subsystem's is refused here."""
    tab = _device_table(dyn, spec)
    n, u, pu = tab.n, spec.umax, spec.num_players * spec.umax
    rows = [_control_rows(tab, s, spec) for s in range(n)]
    for s in range(n):
        lo, hi = rows[s]
        if lo % u or hi % u or hi > pu:
            raise ValueError(
                f"K4 and K5 run one warp per subsystem on its players' "
                f"control rows; the game has {n} subsystems for "
                f"{spec.num_players} players, and subsystem {s}'s rows "
                f"{lo}-{hi - 1} are not whole players' among the {pu}")
    for i in range(spec.num_players):
        owners = sum(rows[s][0] <= i * u and i * u + u <= rows[s][1]
                     for s in range(n))
        if owners != 1:
            raise ValueError(
                f"K5 computes player {i}'s merit terms in the warp of the "
                f"subsystem whose control rows hold its own ({i * u}-"
                f"{i * u + u - 1}); {owners} of the game's {n} subsystems "
                "do, and it needs exactly one")
    items = lambda vals: "".join(f"SW_ITEM({v})" for v in vals)
    kinds = set(tab.kind[:n])
    if not kinds <= {KIND_CAR_6D, KIND_UNICYCLE_4D, KIND_LINEAR, KIND_CAR_5D,
                     KIND_DUBINS, *COUPLED_KINDS}:
        raise NotImplementedError(f"model kinds {sorted(kinds)}")
    defines = {
        "SW_X": spec.xdim, "SW_PU": spec.num_players * spec.umax,
        "SW_U": spec.umax, "SW_NSUB": n, "SW_SUB_KIND": items(tab.kind[:n]),
        "SW_SUB_XOFF": items(tab.xoff[:n]), "SW_SUB_UOFF": items(tab.uoff[:n]),
        "SW_SUB_LENGTH": items(_hexf(v) for v in tab.length[:n]),
        "SW_SUB_PARAM2": items(_hexf(v) for v in tab.param2[:n]),
        "SW_SUB_DIM": items(_rows(tab, s, spec) for s in range(n)),
        "SW_SUB_UROWS": items(hi - lo for lo, hi in rows)}
    if dyn.linear_rows is not None:
        terms = [(r, idx if src == "x" else
                  spec.xdim + idx[0] * u + idx[1], coef)
                 for r, row in enumerate(dyn.linear_rows)
                 for src, idx, coef in row]
        defines.update(
            SW_NLIN=len(terms), SW_LIN_ROW=items(t[0] for t in terms),
            SW_LIN_SRC=items(t[1] for t in terms),
            SW_LIN_COEF=items(_hexf(t[2]) for t in terms),
            SW_LIN_ZERO=int(dyn.linear_zero_start))
    if kinds & {KIND_CAR_5D, KIND_DUBINS} or spec.xdim > 16 or zoo:
        # ptxas's default register target spilled the car_5d warps' K4,
        # the dubins_car warps' K5, the K5 of the overtaking's and the
        # roundabout's car_6d warps (x = 18 and 24: 24 B of stack) and the
        # zoo game's K5 (64 registers, 16 spill stores).
        defines["SW_MIN_BLOCKS"] = 1
    _merit_defines(defines, norms, reach, diff, semi, atoms, polysd, route,
                   zoo)
    return "sweep", defines


def _merit_defines(defines, norms, reach, diff, semi, atoms, polysd,
                   route, zoo):
    """Add the merit's flags (K5's, K6's) to `defines`."""
    for flag, name in ((norms, "CT_NORMS"), (reach, "CT_REACH"),
                       (diff, "CT_DIFF"), (semi, "CT_SEMI"),
                       (polysd, "CT_POLYSD"), (route, "CT_ROUTE"),
                       (zoo, "CT_ZOO")):
        if flag:
            defines[name] = 1
    if atoms != MAX_ATOMS:
        defines["CT_MAX_ATOMS"] = atoms


def merit_features(player_costs, spec: GameSpec) -> dict:
    """The merit kernels' keyword arguments of `library`, `merit_library`
    and their loaders for a game."""
    return dict(norms=has_norms(player_costs), reach=has_reach(player_costs),
                diff=has_diff(player_costs), semi=has_semi(player_costs),
                atoms=capacity(player_costs, spec),
                polysd=has_polysd(player_costs),
                route=has_route(player_costs), zoo=has_zoo(player_costs))


def merit_library(spec: GameSpec, norms: bool = False, reach: bool = False,
                  diff: bool = False, semi: bool = False,
                  atoms: int = MAX_ATOMS, polysd: bool = False,
                  route: bool = False, zoo: bool = False):
    """(source name, defines) of csrc/merit.cu (K6); with `norms`, built
    with the norm atoms (CT_NORMS=1), with `reach`, with the reachability
    games' features (CT_REACH=1), with `diff`, with the
    quadratic_difference atom (CT_DIFF=1), with `semi`, with the
    semiquadratic atom (CT_SEMI=1); with `atoms`, a table of that
    capacity (CT_MAX_ATOMS, where above MAX_ATOMS); with `polysd`, with
    the polyline signed-distance atom (CT_POLYSD=1); with `route`, with
    the route-progress atom (CT_ROUTE=1); with `zoo`, with the rest of
    the cost layer (CT_ZOO=1)."""
    defines = {"MR_X": spec.xdim, "MR_P": spec.num_players,
               "MR_U": spec.umax}
    _merit_defines(defines, norms, reach, diff, semi, atoms, polysd, route,
                   zoo)
    return "merit", defines


@functools.lru_cache(maxsize=None)
def load_kernels(dyn, spec: GameSpec, norms: bool = False,
                 reach: bool = False, diff: bool = False, semi: bool = False,
                 atoms: int = MAX_ATOMS, polysd: bool = False,
                 route: bool = False, zoo: bool = False) -> ctypes.CDLL:
    """Build (once per game) and load csrc/sweep.cu (K4, K5)."""
    lib = build.load(*library(dyn, spec, norms, reach, diff, semi, atoms,
                              polysd, route, zoo))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sweep_rollout.argtypes = ([P] * 9 + [I] * 3 + [F, F, I, _SubsysTable,
                                                       P])
    lib.sweep_rollout.restype = I
    lib.sweep_rollout_merit.argtypes = ([P] * 8 + [I, P, I] + [P] * 4
                                        + [I] * 3 + [F, F, I, _SubsysTable,
                                                     table_type(atoms), P])
    lib.sweep_rollout_merit.restype = I
    return lib


@functools.lru_cache(maxsize=None)
def load_merit_kernel(spec: GameSpec, norms: bool = False,
                      reach: bool = False, diff: bool = False,
                      semi: bool = False, atoms: int = MAX_ATOMS,
                      polysd: bool = False, route: bool = False,
                      zoo: bool = False) -> ctypes.CDLL:
    """Build (once per shape) and load csrc/merit.cu (K6)."""
    lib = build.load(*merit_library(spec, norms, reach, diff, semi, atoms,
                                    polysd, route, zoo))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.merit_consumer.argtypes = ([P] * 4 + [I, P, I] + [P] * 4 + [I] * 3
                                   + [ctypes.c_float, table_type(atoms), P])
    lib.merit_consumer.restype = I
    return lib


def merit_operands(lamS, N: int, B: int, lamC=None, gate=None,
                   P: int = 0) -> list:
    """The multiplier and gate operands of a kernel, for
    build.check_operands."""
    out = [] if lamS is None else [("lamS", lamS, (N, lamS.shape[1], B))]
    if lamC is not None:
        out.append(("lamC", lamC, (N, lamC.shape[1], B)))
    if gate is not None:
        out.append(("gate", gate, (N, P, B)))
    return out


def _reach_operands(player_costs, lamC, gate):
    """The library flag and the (lamC, nC, gate) arguments of a merit or
    stage kernel: a game without the reachability features has neither
    operand."""
    reach = has_reach(player_costs)
    if not reach and (lamC is not None or gate is not None):
        raise ValueError("control multipliers or an extremal gate for a "
                         "game without control constraints or extremal "
                         "players")
    return reach, (None if lamC is None else lamC.data_ptr(),
                   0 if lamC is None else lamC.shape[1],
                   None if gate is None else gate.data_ptr())


def rollout_plain(dyn, spec: GameSpec, x0m, op_bm: dict, st_bm: dict,
                  scal_cb, emit_us: bool = False):
    """Plain PyTorch K4: xs [N, x, C, B] (and us [N, Pu, C, B] when
    `emit_us`) from x0m [x, B], op_bm {"xs" [N,x,B], "us" [N,Pu,B],
    "t0" [1,B]}, st_bm {"Ps" [N,Pu,x,B], "alphas" [N,Pu,B]} and
    scal_cb [C, B]."""
    N, x, dt = spec.num_time_steps, spec.xdim, spec.dt
    P, u = spec.num_players, spec.umax
    C, B = scal_cb.shape
    mask = const_tensor(_umask_flat(spec), x0m.device)[:, None, None]
    ts = op_bm["t0"][0] + torch.arange(N, dtype=torch.float32,
                                       device=x0m.device)[:, None] * dt
    xc = x0m.T[None].expand(C, B, x)                  # state index last
    xs_out, us_out = [], []
    for k in range(N):
        xs_out.append(xc.permute(2, 0, 1))
        delta = xc - op_bm["xs"][k].T                 # [C, B, x]
        Pk = st_bm["Ps"][k]                           # [Pu, x, B]
        acc = Pk[:, 0, None, :] * delta[..., 0]       # [Pu, C, B]
        for xx in range(1, x):
            acc = acc + Pk[:, xx, None, :] * delta[..., xx]
        row = ((op_bm["us"][k][:, None, :] - acc)
               - scal_cb * st_bm["alphas"][k][:, None, :]) * mask
        us_out.append(row)
        xc = dyn_base.integrate(dyn, ts[k], dt, xc,
                                row.permute(1, 2, 0).reshape(C, B, P, u))
    xs = torch.stack(xs_out)
    return (xs, torch.stack(us_out)) if emit_us else xs


def rollout_bm(dyn, spec: GameSpec, x0m, op_bm: dict, st_bm: dict, scal_cb,
               emit_us: bool = False):
    """K4 on batch-minor operands (see `rollout_plain`). CUDA tensors
    launch csrc/sweep.cu's rollout (one warp per subsystem); CPU tensors
    take `rollout_plain`. Launches are also counted per (C, B, emit_us) in
    `rollout_bm.by_shape`."""
    N, x = spec.num_time_steps, spec.xdim
    Pu = spec.num_players * spec.umax
    C, B = scal_cb.shape
    dev = build.check_operands([
        ("x0m", x0m, (x, B)), ("xs", op_bm["xs"], (N, x, B)),
        ("us", op_bm["us"], (N, Pu, B)), ("t0", op_bm["t0"], (1, B)),
        ("Ps", st_bm["Ps"], (N, Pu, x, B)),
        ("alphas", st_bm["alphas"], (N, Pu, B)), ("scal", scal_cb, (C, B))])
    if dev.type == "cpu":
        return rollout_plain(dyn, spec, x0m, op_bm, st_bm, scal_cb, emit_us)
    tab = _device_table(dyn, spec)
    lib = load_kernels(dyn, spec)
    xs = torch.empty((N, x, C, B), dtype=torch.float32, device=dev)
    us = (torch.empty((N, Pu, C, B), dtype=torch.float32, device=dev)
          if emit_us else None)
    umask = sum(1 << af for af, m in enumerate(_umask_flat(spec)) if m)
    rc = lib.sweep_rollout(
        x0m.data_ptr(), op_bm["xs"].data_ptr(), op_bm["us"].data_ptr(),
        st_bm["Ps"].data_ptr(), st_bm["alphas"].data_ptr(),
        op_bm["t0"].data_ptr(), scal_cb.data_ptr(), xs.data_ptr(),
        us.data_ptr() if emit_us else None, N, C, B, spec.dt, spec.dt / 2,
        umask, tab, build.stream(dev))
    build.check(rc, "sweep_rollout")
    rollout_bm.launches += 1
    rollout_bm.by_shape[(C, B, emit_us)] += 1
    return (xs, us) if emit_us else xs


rollout_bm.launches = 0
rollout_bm.by_shape = collections.Counter()


def rollout_merits_plain(dyn, player_costs, spec: GameSpec, x0m, op_bm: dict,
                         st_bm: dict, scal_cb, lamS, lamC, mu, gate=None):
    """Plain PyTorch K5: K4's rollout, the rebuilt controls and
    `merit_plain`'s fold: raw merits [C, B]."""
    xs = rollout_plain(dyn, spec, x0m, op_bm, st_bm, scal_cb)
    us = _us_from_xs(spec, xs, op_bm, st_bm, scal_cb)
    return merit_plain(player_costs, spec, xs, us, op_bm["t0"], lamS, lamC,
                       mu, gate)


def rollout_merits(dyn, player_costs, spec: GameSpec, x0m, op_bm: dict,
                   st_bm: dict, scal_cb, lamS, lamC, mu, gate=None):
    """K5: raw merits [C, B] of the candidates' rollouts (operands as
    `rollout_plain`'s, plus the batch-minor multipliers and gate of
    `_prep_al`). CUDA tensors launch csrc/sweep.cu's rollout with
    in-kernel merit (one warp per subsystem); CPU tensors take
    `rollout_merits_plain`."""
    N, x = spec.num_time_steps, spec.xdim
    P = spec.num_players
    Pu = P * spec.umax
    C, B = scal_cb.shape
    dev = build.check_operands([
        ("x0m", x0m, (x, B)), ("xs", op_bm["xs"], (N, x, B)),
        ("us", op_bm["us"], (N, Pu, B)), ("t0", op_bm["t0"], (1, B)),
        ("Ps", st_bm["Ps"], (N, Pu, x, B)),
        ("alphas", st_bm["alphas"], (N, Pu, B)), ("scal", scal_cb, (C, B)),
        ("mu", mu, (1, B))] + merit_operands(lamS, N, B, lamC, gate, P))
    if dev.type == "cpu":
        return rollout_merits_plain(dyn, player_costs, spec, x0m, op_bm,
                                    st_bm, scal_cb, lamS, lamC, mu, gate)
    _, (lamc_p, nC, gate_p) = _reach_operands(player_costs, lamC, gate)
    tab = _device_table(dyn, spec)
    costs, segs = cost_table(player_costs, spec, dev)
    lib = load_kernels(dyn, spec, **merit_features(player_costs, spec))
    merits = torch.empty((C, B), dtype=torch.float32, device=dev)
    umask = sum(1 << af for af, m in enumerate(_umask_flat(spec)) if m)
    rc = lib.sweep_rollout_merit(
        x0m.data_ptr(), op_bm["xs"].data_ptr(), op_bm["us"].data_ptr(),
        st_bm["Ps"].data_ptr(), st_bm["alphas"].data_ptr(),
        op_bm["t0"].data_ptr(), scal_cb.data_ptr(),
        None if lamS is None else lamS.data_ptr(),
        0 if lamS is None else lamS.shape[1], lamc_p, nC, gate_p,
        mu.data_ptr(), segs.data_ptr(), merits.data_ptr(), N, C, B, spec.dt,
        spec.dt / 2, umask, tab, costs, build.stream(dev))
    build.check(rc, "sweep_rollout_merit")
    rollout_merits.launches += 1
    return merits


rollout_merits.launches = 0


def _prep_op(spec: GameSpec, x0, last_op: OperatingPoint, Bb: int):
    """Batch-major x0 and operating point -> padded batch-minor
    ({"xs" [N,x,B], "us" [N,Pu,B], "t0" [1,B]}, x0m [x,B])."""
    N, P, u = spec.num_time_steps, spec.num_players, spec.umax
    Bt = x0.shape[0]
    pad = lambda a: pad_batch(bm(a), Bb).contiguous()
    op = {"xs": pad(last_op.xs),
          "us": pad(last_op.us.reshape(Bt, N, P * u)),
          "t0": pad(last_op.t0[:, None])}
    return op, pad(x0)


def _prep_common(spec: GameSpec, x0, last_op: OperatingPoint,
                 strategy: Strategy, Bb: int):
    """Batch-major containers -> padded batch-minor operand dicts."""
    N, P, x, u = spec.num_time_steps, spec.num_players, spec.xdim, spec.umax
    Bt = x0.shape[0]
    pad = lambda a: pad_batch(bm(a), Bb).contiguous()
    op, x0m = _prep_op(spec, x0, last_op, Bb)
    st = {"Ps": pad(strategy.Ps.reshape(Bt, N, P * u, x)),
          "alphas": pad(strategy.alphas.reshape(Bt, N, P * u))}
    return op, st, x0m


def _prep_al(spec: GameSpec, al_state: pcost.ALState, gate, Bb: int):
    """Batched ALState and extremal gate [Bt, N, P] (or None) -> padded
    batch-minor merit operands (lamS [N, nS, B] or None, lamC [N, nC, B]
    or None, mu [1, B], gate [N, P, B] or None)."""
    def lam(lams):
        cat = torch.cat(lams, dim=1)                  # [Bt, n, N]
        if cat.shape[1] == 0:
            return None
        return pad_batch(bm(cat).permute(1, 0, 2), Bb).contiguous()

    return (lam(al_state.state_lambdas), lam(al_state.control_lambdas),
            pad_batch(bm(al_state.mu[:, None]), Bb),
            None if gate is None else pad_batch(bm(gate), Bb).contiguous())


def _us_from_xs(spec: GameSpec, xs_cand, op_bm: dict, st_bm: dict, scal_cb):
    """Every candidate's controls [N, Pu, C, B] rebuilt from its emitted
    states [N, x, C, B], with the kernel's fold order."""
    x = spec.xdim
    mask = const_tensor(_umask_flat(spec), xs_cand.device)
    delta = xs_cand - op_bm["xs"][:, :, None, :]      # [N, x, C, B]
    Ps = st_bm["Ps"]                                  # [N, Pu, x, B]
    acc = Ps[:, :, 0, None, :] * delta[:, None, 0]
    for xx in range(1, x):
        acc = acc + Ps[:, :, xx, None, :] * delta[:, None, xx]
    row = ((op_bm["us"][:, :, None, :] - acc)
           - scal_cb[None, None] * st_bm["alphas"][:, :, None, :])
    return row * mask[None, :, None, None]


def merit_plain(player_costs, spec: GameSpec, xs_cand, us_cand, t0_bm,
                lamS, lamC, mu, gate=None):
    """Raw merits [C, B] of emitted candidate trajectories (xs [N,x,C,B],
    us [N,Pu,C,B]): per-knot squared stage gradients, control terms always
    and state terms for k > 0 (each player's times its gate [N, P, B],
    where there is one), folded over the knots in ascending order.
    Callers apply the 0.5 factor. The plain version of K5 and K6."""
    N, P, u = spec.num_time_steps, spec.num_players, spec.umax
    _, _, C, B = xs_cand.shape
    n_sc = [len(pc.state_constraints) for pc in player_costs]
    n_cc = [len(pc.control_constraints) for pc in player_costs]

    def per_player(lam, counts):
        # [N, n, B] -> per player [N, 1, B, n_i] (constraint index last).
        if lam is None:
            return tuple(xs_cand.new_zeros((N, 1, B, n)) for n in counts)
        lam = lam.permute(0, 2, 1)[:, None]
        offs = [sum(counts[:i]) for i in range(len(counts) + 1)]
        return tuple(lam[..., offs[i]:offs[i + 1]] for i in range(P))

    ts = t0_bm[0] + torch.arange(N, dtype=torch.float32,
                                 device=xs_cand.device)[:, None] * spec.dt
    s_cb, r_cb = pcost.stage_gradient_sq_tuple(
        player_costs, spec, per_player(lamS, n_sc), per_player(lamC, n_cc),
        mu[0], ts[:, None, :], xs_cand.permute(0, 2, 3, 1),
        us_cand.reshape(N, P, u, C, B).permute(0, 3, 4, 1, 2))
    if gate is not None:
        s_cb = tuple(s_cb[p_] * gate[:, None, p_] for p_ in range(P))
    state_term = s_cb[0]
    for p_ in range(1, P):
        state_term = state_term + s_cb[p_]
    ctrl_term = r_cb[0]
    for p_ in range(1, P):
        ctrl_term = ctrl_term + r_cb[p_]
    merit = ctrl_term[0]
    for k in range(1, N):
        merit = merit + (ctrl_term[k] + state_term[k])
    return merit


def consumer_merits(player_costs, spec: GameSpec, xs_cand, us_cand, t0_bm,
                    lamS, lamC, mu, gate=None):
    """K6: raw merits [C, B] of emitted candidate trajectories (operands
    as `merit_plain`'s). CUDA tensors launch csrc/merit.cu; CPU tensors
    take `merit_plain`."""
    N, x = spec.num_time_steps, spec.xdim
    P = spec.num_players
    Pu = P * spec.umax
    _, _, C, B = xs_cand.shape
    dev = build.check_operands([
        ("xs", xs_cand, (N, x, C, B)), ("us", us_cand, (N, Pu, C, B)),
        ("t0", t0_bm, (1, B)), ("mu", mu, (1, B))]
        + merit_operands(lamS, N, B, lamC, gate, P))
    if dev.type == "cpu":
        return merit_plain(player_costs, spec, xs_cand, us_cand, t0_bm, lamS,
                           lamC, mu, gate)
    _, (lamc_p, nC, gate_p) = _reach_operands(player_costs, lamC, gate)
    costs, segs = cost_table(player_costs, spec, dev)
    lib = load_merit_kernel(spec, **merit_features(player_costs, spec))
    merits = torch.empty((C, B), dtype=torch.float32, device=dev)
    rc = lib.merit_consumer(
        xs_cand.data_ptr(), us_cand.data_ptr(), t0_bm.data_ptr(),
        None if lamS is None else lamS.data_ptr(),
        0 if lamS is None else lamS.shape[1], lamc_p, nC, gate_p,
        mu.data_ptr(), segs.data_ptr(), merits.data_ptr(), N, C, B, spec.dt,
        costs, build.stream(dev))
    build.check(rc, "merit_consumer")
    consumer_merits.launches += 1
    return merits


consumer_merits.launches = 0


def rollout(dyn, spec: GameSpec, x0, last_op: OperatingPoint,
            strategy: Strategy, scal=None, batch_block: int = 128
            ) -> OperatingPoint:
    """Batched rollout under affine strategies through K4 (counterpart of
    rollout_pallas). With `scal` [Bt], rolls out
    `strategy.scale_alphas(scal)` per lane."""
    N, P, u, x = spec.num_time_steps, spec.num_players, spec.umax, spec.xdim
    Bt = x0.shape[0]
    op, st, x0m = _prep_common(spec, x0, last_op, strategy, batch_block)
    if scal is None:
        scal_cb = x0m.new_ones((1, x0m.shape[-1]))
    else:
        scal_cb = pad_batch(scal[None], batch_block).contiguous()
    xs_r, us_r = rollout_bm(dyn, spec, x0m, op, st, scal_cb, emit_us=True)
    return OperatingPoint(xs=mb(xs_r[:, :, 0], Bt),
                          us=mb(us_r[:, :, 0], Bt).reshape(Bt, N, P, u),
                          t0=last_op.t0)


def sweep_merits_bm(dyn, player_costs, spec: GameSpec, x0m, op_bm: dict,
                    st_bm: dict, scal_cb, lamS, lamC, mu,
                    merit_backend: str = "xla", gate=None):
    """Merits [C, B] (0.5 * the folded squared stage gradients) of the
    candidates scal_cb [C, B] on batch-minor operands, through the chosen
    `merit_backend` (see the module docstring)."""
    if merit_backend == "kernel":
        merits = rollout_merits(dyn, player_costs, spec, x0m, op_bm, st_bm,
                                scal_cb, lamS, lamC, mu, gate)
    elif merit_backend in ("xla", "pallas"):
        xs_cand = rollout_bm(dyn, spec, x0m, op_bm, st_bm, scal_cb)
        us_cand = _us_from_xs(spec, xs_cand, op_bm, st_bm, scal_cb)
        fold = consumer_merits if merit_backend == "pallas" else merit_plain
        merits = fold(player_costs, spec, xs_cand, us_cand, op_bm["t0"],
                      lamS, lamC, mu, gate)
    else:
        raise ValueError(f"merit_backend must be one of {MERIT_BACKENDS}, "
                         f"got {merit_backend!r}")
    return 0.5 * merits


def sweep_merits(dyn, player_costs, spec: GameSpec, x0, last_op, strategy,
                 scalings, al_state, batch_block: int = 128,
                 merit_backend: str = "xla", gate=None):
    """Merit of every candidate stepsize: [Bt, C] (0.5 * the folded
    squared stage gradients along each candidate's rollout, the state
    terms times the extremal gate [Bt, N, P] where there is one).
    `scalings` is [C] (shared) or [Bt, C] (per lane)."""
    Bt = x0.shape[0]
    op, st, x0m = _prep_common(spec, x0, last_op, strategy, batch_block)
    B = x0m.shape[-1]
    lamS, lamC, mu, gate_bm = _prep_al(spec, al_state, gate, batch_block)
    if scalings.ndim == 2:
        scal_cb = pad_batch(scalings.T, batch_block).contiguous()
    else:
        scal_cb = scalings[:, None].expand(-1, B).contiguous()
    merits = sweep_merits_bm(dyn, player_costs, spec, x0m, op, st, scal_cb,
                             lamS, lamC, mu, merit_backend, gate_bm)
    return mb(merits, Bt)
