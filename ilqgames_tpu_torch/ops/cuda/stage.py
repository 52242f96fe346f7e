"""Fused linearize + quadraticize: kernel K1, counterpart of
ilqgames_tpu/ops/pallas/stage.py (`lin_quad_pallas`, `_lin_quad_parts`).

`lin_quad` launches csrc/stage.cu on CUDA tensors and takes its plain
PyTorch version `lin_quad_plain` on CPU tensors; any other device raises.
It keeps a launch count. Both take the batch-minor operands of the fused
trip and return the LQ kernels' batch-minor operand dict (ops/cuda/lq.py),
so the trip feeds `lq.solve_lq_feedback_bm` with no transpose.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ilqgames_tpu_torch.costs import player_cost as pcost
from ilqgames_tpu_torch.dynamics import base as dyn_base
from ilqgames_tpu_torch.dynamics.models import COUPLED_KINDS, KIND_CAR_5D, \
    KIND_DUBINS
from ilqgames_tpu_torch.ops.cuda import build, lq
from ilqgames_tpu_torch.ops.cuda.cost_table import MAX_ATOMS, capacity, \
    cost_table, has_dense, has_diff, has_polysd, has_reach, has_route, \
    has_semi, has_zoo_stage
from ilqgames_tpu_torch.ops.cuda.layout import mb
from ilqgames_tpu_torch.ops.cuda.sweep import _device_table, \
    _reach_operands, merit_operands
from ilqgames_tpu_torch.types import GameSpec, OperatingPoint


def library(spec: GameSpec, reach: bool = False, diff: bool = False,
            dubins: bool = False, semi: bool = False, car5d: bool = False,
            atoms: int = MAX_ATOMS, polysd: bool = False,
            coupled: bool = False, route: bool = False, zoo: bool = False):
    """(source name, defines) of csrc/stage.cu for this game's dims; with
    `reach` (`cost_table.has_reach`), built with the reachability games'
    atoms, control constraints and extremal gates (CT_REACH=1); with
    `diff` (`cost_table.has_diff`), with the quadratic_difference atom
    (CT_DIFF=1); with `semi` (`cost_table.has_semi`), with the
    semiquadratic atom (CT_SEMI=1); with `dubins` and `car5d`
    (`has_dubins`, `has_car5d`), with the Jacobian of dubins_car
    (CT_DUBINS=1) and of car_5d (CT_CAR5D=1); for a table of more than
    MAX_ATOMS atoms, with its capacity `atoms` (CT_MAX_ATOMS,
    `cost_table.capacity`); with `polysd` (`cost_table.has_polysd`), with
    the polyline signed-distance atom (CT_POLYSD=1); with `coupled`
    (`has_coupled`), with the Jacobians of the coupled systems, which read
    the knot's controls (CT_COUPLED=1); with `route`
    (`cost_table.has_route`), with the route-progress atom (CT_ROUTE=1);
    with `zoo` (`cost_table.has_zoo_stage`), with the rest of the cost
    layer's sparse pieces (CT_ZOO=1). `features` gives a game's flags."""
    defines = {"ST_X": spec.xdim, "ST_P": spec.num_players,
               "ST_U": spec.umax}
    for flag, name in ((reach, "CT_REACH"), (diff, "CT_DIFF"),
                       (dubins, "CT_DUBINS"), (semi, "CT_SEMI"),
                       (car5d, "CT_CAR5D"), (polysd, "CT_POLYSD"),
                       (coupled, "CT_COUPLED"), (route, "CT_ROUTE"),
                       (zoo, "CT_ZOO")):
        if flag:
            defines[name] = 1
    if atoms != MAX_ATOMS:
        defines["CT_MAX_ATOMS"] = atoms
    return "stage", defines


def has_dubins(dyn) -> bool:
    """Whether the dynamics hold a dubins_car, whose Jacobian K1 has only
    in a library built with it."""
    return any(m.kind == KIND_DUBINS for m in dyn.models)


def has_car5d(dyn) -> bool:
    """Whether the dynamics hold a car_5d, whose Jacobian K1 has only in a
    library built with it."""
    return any(m.kind == KIND_CAR_5D for m in dyn.models)


def has_coupled(dyn) -> bool:
    """Whether the dynamics are a coupled system (two_player_unicycle_4d,
    air_3d), whose Jacobian K1 has only in a library built with it."""
    return dyn.kind in COUPLED_KINDS


def features(dyn, player_costs, spec: GameSpec) -> dict:
    """The keyword arguments of `library` and `load_kernels` for a game."""
    return dict(reach=has_reach(player_costs), diff=has_diff(player_costs),
                dubins=has_dubins(dyn), semi=has_semi(player_costs),
                car5d=has_car5d(dyn), atoms=capacity(player_costs, spec),
                polysd=has_polysd(player_costs), coupled=has_coupled(dyn),
                route=has_route(player_costs),
                zoo=has_zoo_stage(player_costs))


@functools.lru_cache(maxsize=None)
def load_kernels(spec: GameSpec, reach: bool = False, diff: bool = False,
                 dubins: bool = False, semi: bool = False,
                 car5d: bool = False, atoms: int = MAX_ATOMS,
                 polysd: bool = False, coupled: bool = False,
                 route: bool = False, zoo: bool = False) -> ctypes.CDLL:
    """Build (once per shape) and load csrc/stage.cu for this game's dims."""
    lib = build.load(*library(spec, reach, diff, dubins, semi, car5d, atoms,
                              polysd, coupled, route, zoo))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.stage_lin_quad.argtypes = ([P, P, P, P, I, P, I, P, P, P] + [P] * 6
                                   + [I, I, F, P])
    lib.stage_lin_quad.restype = I
    lib.stage_set_tables.argtypes = [P, P, P]
    lib.stage_set_tables.restype = I
    return lib


@functools.lru_cache(maxsize=None)
def _subsys_table(dyn, spec: GameSpec):
    """The game's SubsysTable, made once per game (its identity names it
    in `_set_tables`)."""
    return _device_table(dyn, spec)


def _set_tables(lib, structs, stream: int, device) -> None:
    """Make K1's library `lib` hold the tables `structs` (SubsysTable,
    CostTable: ctypes structs cached per problem, so that their identity
    names them) in its constant memory on `device`, on `stream`: a copy in
    stream order, made only when the library holds another problem's
    tables there."""
    key = tuple(id(s) for s in structs)
    resident = getattr(lib, "_resident_tables", None)
    if resident is None:
        resident = lib._resident_tables = {}
    if resident.get(device.index) == key:
        return
    rc = lib.stage_set_tables(*(ctypes.addressof(s) for s in structs),
                              stream)
    build.check(rc, "stage_set_tables")
    resident[device.index] = key


def _al_state(player_costs, spec: GameSpec, lamS, lamC, mu, Bt: int):
    """Batch-minor (lamS [N, nS, B], lamC [N, nC, B], mu [1, B]) -> the
    batched ALState."""
    N = spec.num_time_steps

    def split(lam, counts):
        rows = mb(lam, Bt).permute(0, 2, 1) if lam is not None else None
        out, off = [], 0
        for n in counts:
            out.append(rows[:, off:off + n] if n else
                       mu.new_zeros((Bt, 0, N)))
            off += n
        return tuple(out)

    return pcost.ALState(
        state_lambdas=split(lamS, [len(pc.state_constraints)
                                   for pc in player_costs]),
        control_lambdas=split(lamC, [len(pc.control_constraints)
                                     for pc in player_costs]),
        mu=mu[0, :Bt])


def lin_quad_plain(dyn, player_costs, spec: GameSpec, op_bm: dict, lamS,
                   lamC, mu, gate=None) -> dict:
    """Plain PyTorch K1: the batched `dyn_base.linearize` and
    `pcost.quadraticize` at the batch-minor operating point op_bm
    {"xs" [N,x,B], "us" [N,Pu,B], "t0" [1,B]} with multipliers lamS
    [N,nS,B] and lamC [N,nC,B] (or None), mu [1,B] and the extremal gate
    [N,P,B] (or None), as the LQ operand dict. The atoms see each lane's
    absolute knot times t0 + k * dt, as in the JAX package's stage kernel
    (ops/pallas/stage.py:141). A game with an atom that has only a dense
    form raises the JAX package's ValueError, as its fused stage does."""
    pcost.check_sparse(player_costs)
    N, P, u = spec.num_time_steps, spec.num_players, spec.umax
    B = op_bm["xs"].shape[-1]
    op = OperatingPoint(xs=mb(op_bm["xs"], B),
                        us=mb(op_bm["us"], B).reshape(B, N, P, u),
                        t0=op_bm["t0"][0])
    al = _al_state(player_costs, spec, lamS, lamC, mu, B)
    t = op.t0[:, None] + torch.arange(N, dtype=torch.float32,
                                      device=op.xs.device) * spec.dt
    return lq.lq_operands(
        spec, dyn_base.linearize(dyn, spec, op),
        pcost.quadraticize(player_costs, spec, op, al, t,
                           None if gate is None else mb(gate, B)))


def lin_quad(dyn, player_costs, spec: GameSpec, op_bm: dict, lamS, lamC,
             mu, gate=None) -> dict:
    """K1 on batch-minor operands (see `lin_quad_plain`). CUDA tensors
    launch csrc/stage.cu; CPU tensors take `lin_quad_plain`. A game with an
    atom that has only a dense form raises the JAX package's ValueError on
    both (semiquadratic_norm among them); on the card, a table row of a
    dense atom (no form in csrc/stage.cu) raises NotImplementedError."""
    pcost.check_sparse(player_costs)
    N, x = spec.num_time_steps, spec.xdim
    P = spec.num_players
    Pu = P * spec.umax
    B = op_bm["xs"].shape[-1]
    named = [("xs", op_bm["xs"], (N, x, B)), ("us", op_bm["us"], (N, Pu, B)),
             ("t0", op_bm["t0"], (1, B)), ("mu", mu, (1, B))]
    dev = build.check_operands(named + merit_operands(lamS, N, B, lamC,
                                                      gate, P))
    if dev.type == "cpu":
        return lin_quad_plain(dyn, player_costs, spec, op_bm, lamS, lamC, mu,
                              gate)
    if dyn.ode_jac is None:
        raise NotImplementedError(
            f"dynamics {dyn.name!r} have no analytic Jacobian")
    if has_dense(player_costs):
        raise NotImplementedError(
            "the stage kernel has no device form of the dense atoms "
            "(semiquadratic_norm, the convex proximities)")
    _, (lamc_p, nC, gate_p) = _reach_operands(player_costs, lamC, gate)
    costs, segs = cost_table(player_costs, spec, dev)
    lib = load_kernels(spec, **features(dyn, player_costs, spec))
    stream = build.stream(dev)
    _set_tables(lib, (_subsys_table(dyn, spec), costs), stream, dev)
    out = {k: torch.empty(s, dtype=torch.float32, device=dev)
           for k, s in lq._op_shapes(spec, B).items()}
    nS = 0 if lamS is None else lamS.shape[1]
    rc = lib.stage_lin_quad(
        op_bm["xs"].data_ptr(), op_bm["us"].data_ptr(),
        op_bm["t0"].data_ptr(),
        None if lamS is None else lamS.data_ptr(), nS, lamc_p, nC, gate_p,
        mu.data_ptr(), segs.data_ptr(),
        *(out[k].data_ptr() for k in ("A", "Bf", "Qf", "lf", "Rf", "rf")),
        N, B, spec.dt, stream)
    build.check(rc, "stage_lin_quad")
    lin_quad.launches += 1
    return out


lin_quad.launches = 0
