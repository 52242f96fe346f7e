"""Probe kernels P1-P3 (csrc/probes.cu): the card's counterparts of the
JAX package's TPU probe kernels under tools/, which time where a rollout
kernel's time goes.

- `fma_chain` (P1): the kernel_floor probe's chain of dependent
  multiply-adds, a floor of float32 latency.
- `probe_rollout` (P2): the one-thread-per-chain rollout with
  compile-time switches, one instantiated rung per entry of `RUNGS`, from
  the floor of one RK4 step (fixed controls, compile-time state offsets)
  up to the production control law with emission (the top rung,
  `"emit_xs_us"`, is K4's design before one warp per subsystem, with
  `emit_us=True`) or with the merit content of K5 folded in several ways.
- `smoke` (P3): o = x * 2 + 1.

Each wrapper launches its kernel on CUDA tensors and takes its plain
PyTorch version (`*_plain`, the same float32 operations in the same order)
on CPU tensors; any other device raises. Each keeps a launch count.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ilqgames_tpu_torch.costs import player_cost as pcost
from ilqgames_tpu_torch.dynamics import base as dyn_base
from ilqgames_tpu_torch.ops.cuda import build
from ilqgames_tpu_torch.ops.cuda.cost_table import CostTable, cost_table
from ilqgames_tpu_torch.ops.cuda.sweep import _device_table, _SubsysTable, \
    _umask_flat, merit_operands
from ilqgames_tpu_torch.types import GameSpec, const_tensor

FMA_CHAIN = 50          # dependent multiply-adds per step (P1)


@dataclasses.dataclass(frozen=True)
class Rung:
    """One instantiation of P2 (csrc/probes.cu PROBE_RUNGS, same order)."""

    id: int
    layout: str     # "static" (compile-time offsets) | "table" (run time)
    law: str        # "fixed_u" | "floor" | "plus" | "prod"
    lane_t: bool
    emit: str       # "none" | "xs" | "xs_us"
    merit: str      # "none" | "table" | "raw_nomv" | "raw_x6"
    gate: bool
    k0: str         # "select" | "hoist" | "mult"
    acc: str        # "reg" | "global"


def _rung(id_, layout, law, lane_t=False, emit="none", merit="none",
          gate=False, k0="select", acc="reg"):
    return Rung(id_, layout, law, lane_t, emit, merit, gate, k0, acc)


RUNGS = {
    "fixed_u": _rung(0, "static", "fixed_u"),
    "plus": _rung(1, "static", "plus"),
    "floor": _rung(2, "static", "floor"),
    "prod_static": _rung(3, "static", "prod"),
    "prod_table": _rung(4, "table", "prod"),
    "lane_t": _rung(5, "table", "prod", True),
    "emit_xs": _rung(6, "table", "prod", True, "xs"),
    "emit_xs_us": _rung(7, "table", "prod", True, "xs_us"),
    "raw_nomv": _rung(8, "table", "prod", True, merit="raw_nomv",
                      acc="global"),
    "raw_x6": _rung(9, "table", "prod", True, merit="raw_x6", acc="global"),
    "gate_select_global": _rung(10, "table", "prod", True, merit="table",
                                gate=True, acc="global"),
    "gate_select_reg": _rung(11, "table", "prod", True, merit="table",
                             gate=True),
    "select_global": _rung(12, "table", "prod", True, merit="table",
                           acc="global"),
    "gate_hoist_global": _rung(13, "table", "prod", True, merit="table",
                               gate=True, k0="hoist", acc="global"),
    "hoist_global": _rung(14, "table", "prod", True, merit="table",
                          k0="hoist", acc="global"),
    "gate_mult_global": _rung(15, "table", "prod", True, merit="table",
                              gate=True, k0="mult", acc="global"),
}


# The values of each switch, in the order of csrc/probes.cu's enums.
_ENUMS = {"layout": ("static", "table"),
          "law": ("fixed_u", "floor", "plus", "prod"),
          "emit": ("none", "xs", "xs_us"),
          "merit": ("none", "table", "raw_nomv", "raw_x6"),
          "k0": ("select", "hoist", "mult"), "acc": ("reg", "global")}


def template_args(r: Rung) -> tuple:
    """The template arguments of the rung's probe_rollout_kernel."""
    return (_ENUMS["layout"].index(r.layout), _ENUMS["law"].index(r.law),
            int(r.lane_t), _ENUMS["emit"].index(r.emit),
            _ENUMS["merit"].index(r.merit), int(r.gate),
            _ENUMS["k0"].index(r.k0), _ENUMS["acc"].index(r.acc))


class _ProbeOperands(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "x0", "xs", "us", "Ps", "al", "ufix", "t0", "scal", "gate", "lamS",
        "mu", "segs", "xf_out", "xs_out", "us_out", "merit_out")]
        + [(n, ctypes.c_int) for n in ("N", "C", "B", "nS", "umask_bits")]
        + [("dt", ctypes.c_float), ("h", ctypes.c_float),
           ("tab", _SubsysTable), ("cost", CostTable)])


def library(spec: GameSpec):
    """(source name, defines) of csrc/probes.cu (P1-P3)."""
    return "probes", {"PB_X": spec.xdim,
                      "PB_PU": spec.num_players * spec.umax,
                      "PB_U": spec.umax}


@functools.lru_cache(maxsize=None)
def load_kernels(spec: GameSpec) -> ctypes.CDLL:
    """Build (once per shape) and load csrc/probes.cu for this game's
    dims."""
    lib = build.load(*library(spec))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    lib.probe_fma_chain.argtypes = [P, P, L, I, P]
    lib.probe_fma_chain.restype = I
    lib.probe_smoke.argtypes = [P, P, L, P]
    lib.probe_smoke.restype = I
    lib.probe_rollout.argtypes = [I, ctypes.POINTER(_ProbeOperands), P]
    lib.probe_rollout.restype = I
    return lib


# ---- P1 ----

def fma_chain_plain(x, steps: int):
    """Plain P1: `steps` x 50 dependent x = x * 1.000001 + 0.000001."""
    for _ in range(steps):
        for _ in range(FMA_CHAIN):
            x = x * 1.000001 + 0.000001
    return x


def fma_chain(spec: GameSpec, x, steps: int):
    """P1 on x (any shape, float32, contiguous). CUDA tensors launch
    csrc/probes.cu; CPU tensors take `fma_chain_plain`."""
    dev = build.check_operands([("x", x, tuple(x.shape))])
    if dev.type == "cpu":
        return fma_chain_plain(x, steps)
    out = torch.empty_like(x)
    rc = load_kernels(spec).probe_fma_chain(
        x.data_ptr(), out.data_ptr(), x.numel(), steps, build.stream(dev))
    build.check(rc, "probe_fma_chain")
    fma_chain.launches += 1
    return out


fma_chain.launches = 0


# ---- P3 ----

def smoke_plain(x):
    """Plain P3: x * 2 + 1."""
    return x * 2.0 + 1.0


@functools.lru_cache(maxsize=None)
def _smoke_fn(spec: GameSpec):
    return load_kernels(spec).probe_smoke


def smoke(spec: GameSpec, x):
    """P3 on x (any shape, float32, contiguous). CUDA tensors launch
    csrc/probes.cu; CPU tensors take `smoke_plain`. The checks are inline
    and the library function is resolved once per game: the call is this
    wrapper's host time, which set P3's pace against `torch.add` (PERF.md,
    tools/launch_split)."""
    dev = x.device
    if x.dtype != torch.float32:
        raise TypeError(f"x: dtype {x.dtype}, want float32")
    if not x.is_contiguous():
        raise ValueError("x: not contiguous")
    if dev.type != "cuda":
        if dev.type != "cpu":
            raise ValueError(f"unsupported device {dev}: CPU or CUDA only")
        return smoke_plain(x)
    out = torch.empty_like(x)
    rc = _smoke_fn(spec)(x.data_ptr(), out.data_ptr(), x.numel(),
                         build.stream(dev))
    build.check(rc, "probe_smoke")
    smoke.launches += 1
    return out


smoke.launches = 0


# ---- P2 ----

def _require_flagship(dyn, spec: GameSpec, rung: Rung) -> None:
    """Static-layout rungs and raw merit terms hard-code the flagship's
    subsystems and state indices."""
    if rung.layout != "static" and not rung.merit.startswith("raw"):
        return
    tab = _device_table(dyn, spec)
    u = spec.umax
    if (tab.n, list(tab.kind)[:3], list(tab.xoff)[:3], list(tab.uoff)[:3],
            list(tab.length)[:2], spec.xdim) != (
            3, [0, 0, 1], [0, 6, 12], [0, u, 2 * u], [4.0, 4.0], 16):
        raise NotImplementedError(
            "static-layout and raw-merit probe rungs are built for the "
            "three-player intersection's subsystems only")


def _n_constraints(player_costs) -> int:
    return sum(len(pc.state_constraints) for pc in player_costs)


def _check(rung_name, dyn, player_costs, spec, x0c, op_bm, st_bm, scal_cb,
           ufix, gate, lamS, mu):
    """Validate P2's operands; returns (rung, device)."""
    if rung_name not in RUNGS:
        raise ValueError(f"unknown probe rung {rung_name!r}; one of "
                         f"{sorted(RUNGS)}")
    r = RUNGS[rung_name]
    _require_flagship(dyn, spec, r)
    N, X, P = spec.num_time_steps, spec.xdim, spec.num_players
    Pu = P * spec.umax
    C, B = scal_cb.shape
    named = [("x0c", x0c, (X, C, B)), ("xs", op_bm["xs"], (N, X, B)),
             ("us", op_bm["us"], (N, Pu, B)), ("t0", op_bm["t0"], (1, B)),
             ("Ps", st_bm["Ps"], (N, Pu, X, B)),
             ("alphas", st_bm["alphas"], (N, Pu, B)),
             ("scal", scal_cb, (C, B))]
    if r.law == "fixed_u":
        named.append(("ufix", ufix, (Pu, B)))
    if r.gate:
        named.append(("gate", gate, (N, P, B)))
    if r.merit == "table":
        if not pcost.all_sum(player_costs) or any(
                pc.control_constraints for pc in player_costs):
            raise NotImplementedError(
                "P2's table merit takes SUM players without control "
                "constraints (the flagship's)")
        nS = _n_constraints(player_costs)
        if (lamS is None) != (nS == 0) or (
                lamS is not None and lamS.shape[1] != nS):
            raise ValueError(f"lamS must hold the table's {nS} constraint "
                             "rows (None when there are none)")
        named += [("mu", mu, (1, B))] + merit_operands(lamS, N, B)
    return r, build.check_operands(named)


def probe_rollout_plain(rung_name: str, dyn, player_costs, spec: GameSpec,
                        x0c, op_bm: dict, st_bm: dict, scal_cb, ufix=None,
                        gate=None, lamS=None, mu=None) -> dict:
    """Plain P2 at rung `rung_name`: {"xf" [X, C, B]} plus "xs"
    [N, X, C, B] / "us" [N, Pu, C, B] (emitting rungs) and "merit" [C, B]
    (merit rungs). Operands: x0c [X, C, B] (one start per candidate),
    op_bm {"xs" [N,X,B], "us" [N,Pu,B], "t0" [1,B]}, st_bm {"Ps"
    [N,Pu,X,B], "alphas" [N,Pu,B]}, scal_cb [C, B], ufix [Pu, B] (fixed-u
    rung), gate [N, P, B] (gated rungs), lamS [N, nS, B] and mu [1, B]
    (table merit)."""
    r = RUNGS[rung_name]
    _require_flagship(dyn, spec, r)
    N, X, dt = spec.num_time_steps, spec.xdim, spec.dt
    P, u = spec.num_players, spec.umax
    Pu = P * u
    C, B = scal_cb.shape
    dev = x0c.device
    mask = const_tensor(_umask_flat(spec), dev)[:, None, None]
    ts = op_bm["t0"][0] + torch.arange(N, dtype=torch.float32,
                                       device=dev)[:, None] * dt
    xc = x0c.permute(1, 2, 0)                         # [C, B, X]
    xs_out, us_out = [], []
    merit = xc.new_zeros((C, B))
    if r.merit == "table":
        counts = [len(pc.state_constraints) for pc in player_costs]
        offs = [sum(counts[:i]) for i in range(P + 1)]
        no_lam = tuple(xc.new_zeros((B, 0)) for _ in range(P))
    for k in range(N):
        if r.emit != "none":
            xs_out.append(xc.permute(2, 0, 1))
        if r.law == "fixed_u":
            row = ufix[:, None, :].expand(Pu, C, B)
        else:
            delta = xc - op_bm["xs"][k].T
            Pk = st_bm["Ps"][k]                       # [Pu, X, B]
            acc = Pk[:, 0, None, :] * delta[..., 0]   # [Pu, C, B]
            for xx in range(1, X):
                acc = acc + Pk[:, xx, None, :] * delta[..., xx]
            a = st_bm["alphas"][k][:, None, :]
            if r.law == "prod":
                row = ((op_bm["us"][k][:, None, :] - acc)
                       - scal_cb * a) * mask
            elif r.law == "plus":
                row = acc + a
            else:
                row = -acc - a
        if r.emit == "xs_us":
            us_out.append(row)
        us_cb = row.permute(1, 2, 0).reshape(C, B, P, u)
        if r.merit != "none":
            if r.merit == "table":
                lam = (tuple(xc.new_zeros((B, n)) for n in counts)
                       if lamS is None else
                       tuple(lamS[k, offs[i]:offs[i + 1]].T
                             for i in range(P)))
                s_t, r_t = pcost.stage_gradient_sq_tuple(
                    player_costs, spec, lam, no_lam, mu[0], ts[k], xc,
                    us_cb)
                s_t = [s * gate[k, i][None, :] if r.gate else s
                       for i, s in enumerate(s_t)]
                state, ctrl = s_t[0], r_t[0]
                for i in range(1, P):
                    state = state + s_t[i]
                    ctrl = ctrl + r_t[i]
            else:
                if r.merit == "raw_nomv":
                    g = [100.0 * (xc[..., i] - v) for i, v in
                         ((4, 8.0), (10, 5.0), (15, 1.5))]
                    state = (g[0] * g[0] + g[1] * g[1]) + g[2] * g[2]
                else:
                    state = xc[..., 6] * xc[..., 6]
                ctrl = torch.zeros_like(state)
            if r.k0 == "hoist":
                merit = ctrl if k == 0 else merit + (ctrl + state)
            elif r.k0 == "mult":
                merit = merit + (ctrl + state * (1.0 if k > 0 else 0.0))
            else:
                merit = merit + (ctrl + (state if k > 0
                                         else torch.zeros_like(state)))
        t = ts[k] if r.lane_t else 0.1
        xc = dyn_base.integrate(dyn, t, dt, xc, us_cb)
    out = {"xf": xc.permute(2, 0, 1).contiguous()}
    if r.emit != "none":
        out["xs"] = torch.stack(xs_out)
    if r.emit == "xs_us":
        out["us"] = torch.stack(us_out)
    if r.merit != "none":
        out["merit"] = merit
    return out


def probe_rollout(rung_name: str, dyn, player_costs, spec: GameSpec, x0c,
                  op_bm: dict, st_bm: dict, scal_cb, ufix=None, gate=None,
                  lamS=None, mu=None) -> dict:
    """P2 at rung `rung_name` (operands and result as
    `probe_rollout_plain`'s). CUDA tensors launch csrc/probes.cu; CPU
    tensors take `probe_rollout_plain`."""
    r, dev = _check(rung_name, dyn, player_costs, spec, x0c, op_bm, st_bm,
                    scal_cb, ufix, gate, lamS, mu)
    if dev.type == "cpu":
        return probe_rollout_plain(rung_name, dyn, player_costs, spec, x0c,
                                   op_bm, st_bm, scal_cb, ufix, gate, lamS,
                                   mu)
    N, X = spec.num_time_steps, spec.xdim
    Pu = spec.num_players * spec.umax
    C, B = scal_cb.shape
    new = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    out = {"xf": new(X, C, B)}
    if r.emit != "none":
        out["xs"] = new(N, X, C, B)
    if r.emit == "xs_us":
        out["us"] = new(N, Pu, C, B)
    if r.merit != "none":
        out["merit"] = new(C, B)
    ptr = lambda t: None if t is None else t.data_ptr()
    o = _ProbeOperands()
    o.x0, o.xs, o.us = ptr(x0c), ptr(op_bm["xs"]), ptr(op_bm["us"])
    o.Ps, o.al, o.t0 = ptr(st_bm["Ps"]), ptr(st_bm["alphas"]), \
        ptr(op_bm["t0"])
    o.scal = ptr(scal_cb)
    o.ufix = ptr(ufix) if r.law == "fixed_u" else None
    o.gate = ptr(gate) if r.gate else None
    o.xf_out, o.xs_out = ptr(out["xf"]), ptr(out.get("xs"))
    o.us_out, o.merit_out = ptr(out.get("us")), ptr(out.get("merit"))
    o.N, o.C, o.B = N, C, B
    o.umask_bits = sum(1 << af for af, m in enumerate(_umask_flat(spec))
                       if m)
    o.dt, o.h = spec.dt, spec.dt / 2
    o.tab = _device_table(dyn, spec)
    segs = None
    if r.merit == "table":
        o.cost, segs = cost_table(player_costs, spec, dev)
        o.segs, o.mu, o.lamS = ptr(segs), ptr(mu), ptr(lamS)
        o.nS = 0 if lamS is None else lamS.shape[1]
    rc = load_kernels(spec).probe_rollout(r.id, ctypes.byref(o),
                                          build.stream(dev))
    build.check(rc, f"probe_rollout[{rung_name}]")
    probe_rollout.launches += 1
    return out


probe_rollout.launches = 0
