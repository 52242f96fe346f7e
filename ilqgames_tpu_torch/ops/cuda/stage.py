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
from ilqgames_tpu_torch.ops.cuda import build, lq
from ilqgames_tpu_torch.ops.cuda.cost_table import CostTable, cost_table, \
    has_norms
from ilqgames_tpu_torch.ops.cuda.layout import mb
from ilqgames_tpu_torch.ops.cuda.sweep import _device_table, _SubsysTable, \
    merit_operands
from ilqgames_tpu_torch.types import GameSpec, OperatingPoint


def library(spec: GameSpec):
    """(source name, defines) of csrc/stage.cu for this game's dims."""
    return "stage", {"ST_X": spec.xdim, "ST_P": spec.num_players,
                     "ST_U": spec.umax}


@functools.lru_cache(maxsize=None)
def load_kernels(spec: GameSpec) -> ctypes.CDLL:
    """Build (once per shape) and load csrc/stage.cu for this game's dims."""
    lib = build.load(*library(spec))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.stage_lin_quad.argtypes = ([P, P, P, P, I, P, P] + [P] * 6
                                   + [I, I, F, _SubsysTable, CostTable, P])
    lib.stage_lin_quad.restype = I
    return lib


def _al_state(player_costs, spec: GameSpec, lamS, mu, Bt: int):
    """Batch-minor (lamS [N, nS, B], mu [1, B]) -> the batched ALState."""
    N = spec.num_time_steps
    rows = mb(lamS, Bt).permute(0, 2, 1) if lamS is not None else None
    state, off = [], 0
    for pc in player_costs:
        n = len(pc.state_constraints)
        state.append(rows[:, off:off + n] if n else
                     mu.new_zeros((Bt, 0, N)))
        off += n
    return pcost.ALState(
        state_lambdas=tuple(state),
        control_lambdas=tuple(mu.new_zeros((Bt, 0, N)) for _ in player_costs),
        mu=mu[0, :Bt])


def lin_quad_plain(dyn, player_costs, spec: GameSpec, op_bm: dict, lamS,
                   lamC, mu) -> dict:
    """Plain PyTorch K1: the batched `dyn_base.linearize` and
    `pcost.quadraticize` at the batch-minor operating point op_bm
    {"xs" [N,x,B], "us" [N,Pu,B], "t0" [1,B]} with multipliers lamS
    [N,nS,B] (or None) and mu [1,B], as the LQ operand dict. The atoms
    see each lane's absolute knot times t0 + k * dt, as in the JAX
    package's stage kernel (ops/pallas/stage.py:141). A game with an atom
    that has only a dense form raises the JAX package's ValueError, as its
    fused stage does."""
    pcost.check_sparse(player_costs)
    if lamC is not None:
        raise NotImplementedError("control constraints are not ported yet")
    N, P, u = spec.num_time_steps, spec.num_players, spec.umax
    B = op_bm["xs"].shape[-1]
    op = OperatingPoint(xs=mb(op_bm["xs"], B),
                        us=mb(op_bm["us"], B).reshape(B, N, P, u),
                        t0=op_bm["t0"][0])
    al = _al_state(player_costs, spec, lamS, mu, B)
    t = op.t0[:, None] + torch.arange(N, dtype=torch.float32,
                                      device=op.xs.device) * spec.dt
    return lq.lq_operands(spec, dyn_base.linearize(dyn, spec, op),
                          pcost.quadraticize(player_costs, spec, op, al, t))


def lin_quad(dyn, player_costs, spec: GameSpec, op_bm: dict, lamS, lamC,
             mu) -> dict:
    """K1 on batch-minor operands (see `lin_quad_plain`). CUDA tensors
    launch csrc/stage.cu; CPU tensors take `lin_quad_plain`. A game with an
    atom that has only a dense form raises the JAX package's ValueError on
    both; the norm atoms have no device form in K1."""
    pcost.check_sparse(player_costs)
    N, x = spec.num_time_steps, spec.xdim
    Pu = spec.num_players * spec.umax
    B = op_bm["xs"].shape[-1]
    named = [("xs", op_bm["xs"], (N, x, B)), ("us", op_bm["us"], (N, Pu, B)),
             ("t0", op_bm["t0"], (1, B)), ("mu", mu, (1, B))]
    dev = build.check_operands(named + merit_operands(lamS, N, B))
    if dev.type == "cpu":
        return lin_quad_plain(dyn, player_costs, spec, op_bm, lamS, lamC, mu)
    if lamC is not None:
        raise NotImplementedError("control constraints are not ported yet")
    if dyn.ode_jac is None:
        raise NotImplementedError(
            f"dynamics {dyn.name!r} have no analytic Jacobian")
    if has_norms(player_costs):
        raise NotImplementedError(
            "the stage kernel has no device form of the norm atoms")
    tab = _device_table(dyn, spec)
    costs, segs = cost_table(player_costs, spec, dev)
    lib = load_kernels(spec)
    out = {k: torch.empty(s, dtype=torch.float32, device=dev)
           for k, s in lq._op_shapes(spec, B).items()}
    nS = 0 if lamS is None else lamS.shape[1]
    rc = lib.stage_lin_quad(
        op_bm["xs"].data_ptr(), op_bm["us"].data_ptr(),
        op_bm["t0"].data_ptr(),
        None if lamS is None else lamS.data_ptr(), nS, mu.data_ptr(),
        segs.data_ptr(), *(out[k].data_ptr() for k in
                           ("A", "Bf", "Qf", "lf", "Rf", "rf")),
        N, B, spec.dt, tab, costs, build.stream(dev))
    build.check(rc, "stage_lin_quad")
    lin_quad.launches += 1
    return out


lin_quad.launches = 0
