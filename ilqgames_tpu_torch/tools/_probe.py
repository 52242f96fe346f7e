"""What the probe modules share: the registry row, the context that holds
the flagship and the probes' operands, the TPU scripts' operand draws, the
player-cost filters of the cost-family probes, and the timers.

The operands are the TPU scripts' own: numpy RandomState(0) draws in each
script's order, so a case here runs on the same numbers as its TPU
counterpart. The scripts themselves are not imported (they reach for a
TPU at import).
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ilqgames_tpu_torch.costs import atoms
from ilqgames_tpu_torch.examples.three_player_intersection import (
    LANE_COST_WEIGHT, lane_polylines, make_problem)

N_KNOTS = 100           # every probe's horizon


@dataclasses.dataclass(frozen=True)
class Call:
    """One call that a case times: `fn` runs the counterpart. Where `fn`
    is one kernel launch, `plain` computes that kernel's plain version on
    the same operands, and `key` names the launch by kernel, cost table
    and shape, so that each distinct launch is held against its plain
    version once (`checks`)."""

    label: str
    fn: Callable
    plain: Optional[Callable] = None
    key: tuple = ()


@dataclasses.dataclass(frozen=True)
class Case:
    """One TPU probe case and the counterpart that runs it on the card.

    key: "<script tag>.<TPU case name>"; replaces: the TPU launch site
    ("tools/<script>.py:<line>"); counterpart: the port's kernel or path
    that runs it; run(ctx) -> [Call, ...], the first the case's
    measurement and the others measured beside it; note: where the TPU
    case probes a Mosaic lowering choice with no CUDA analogue, why, and
    the nearest rung; aliases: the case's other names in its script."""

    key: str
    replaces: str
    counterpart: str
    run: Callable
    note: str = ""
    aliases: Tuple[str, ...] = ()


def checks(cases, ctx, seen: set):
    """Every call of `cases` that carries a plain version and whose key is
    not in `seen` yet (added as it is yielded): each distinct (kernel,
    cost table, shape) that the cases launch, once."""
    for case in cases:
        for call in case.run(ctx):
            if call.plain is not None and call.key not in seen:
                seen.add(call.key)
                yield call


# Float32 arithmetic that `float_ops` counts, by aten op name: each output
# element is one operation (a reduction's, each input element).
_COUNTED = frozenset((
    "add", "sub", "rsub", "mul", "div", "sqrt", "rsqrt", "reciprocal",
    "minimum", "maximum", "clamp", "floor", "ceil", "round", "trunc", "pow",
    "exp", "log", "fmod", "remainder"))
_REDUCTIONS = frozenset(("sum", "prod", "amax", "amin"))


class _OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__.rstrip("_")
        if isinstance(out, torch.Tensor) and out.dtype == torch.float32:
            if name in _COUNTED:
                self.ops += out.numel()
            elif name in _REDUCTIONS:
                self.ops += args[0].numel()
        return out


def float_ops(fn):
    """(fn(), the float32 operations it ran): adds, subtracts, multiplies,
    divides, roots, min/max, roundings and reductions, one per output
    element (per input element for a reduction). Selects, compares, sign
    flips, copies and float64 work are not counted. Run on a plain version,
    which repeats its kernel's float32 operations in order, it counts the
    kernel's arithmetic on these operands."""
    with _OpCounter() as counter:
        out = fn()
    return out, counter.ops


def require_cuda() -> torch.device:
    """The probes measure on the card only."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probes measure on a CUDA device; none is "
                           "visible")
    return torch.device("cuda")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def _warm(fn) -> None:
    """At least 0.2 s of calls: the card idles at a low clock and takes a
    while to raise it."""
    until = time.perf_counter() + 0.2
    fn()
    torch.cuda.synchronize()
    while time.perf_counter() < until:
        fn()
        torch.cuda.synchronize()


def time_ms(fn, reps: int) -> float:
    """Mean device ms per call over `reps` calls (CUDA events), after the
    warm-up."""
    _warm(fn)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def split_ms(fn, reps: int):
    """(enqueue ms, total ms) per call on the host clock: `reps` calls
    issued back to back, then one synchronize."""
    _warm(fn)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enq = time.perf_counter() - t0
    torch.cuda.synchronize()
    tot = time.perf_counter() - t0
    return enq * 1e3 / reps, tot * 1e3 / reps


def emit(line: dict) -> dict:
    print(json.dumps(line), flush=True)
    return line


def player_costs_subset(player_costs, keep):
    """(player costs, kept constraint rows): every player's cost with only
    the atoms and constraints for which keep(player, kind, name) holds,
    kind one of "state", "sconstr", "ctrl", "cconstr" (the port's copy of
    tools/sweep_floor5b.py:169-187). The rows index the kept state
    constraints in the full lamS [N, nS, B]."""
    out, rows, row = [], [], 0
    for pi, pc in enumerate(player_costs):
        kept_sc = []
        for c in pc.state_constraints:
            if keep(pi, "sconstr", c.name):
                kept_sc.append(c)
                rows.append(row)
            row += 1
        out.append(dataclasses.replace(
            pc,
            state_costs=tuple(c for c in pc.state_costs
                              if keep(pi, "state", c.name)),
            state_constraints=tuple(kept_sc),
            control_costs=tuple((j, c) for j, c in pc.control_costs
                                if keep(pi, "ctrl", c.name)),
            control_constraints=tuple(
                (j, c) for j, c in pc.control_constraints
                if keep(pi, "cconstr", c.name))))
    return tuple(out), rows


def truncated_lane_costs(player_costs, nseg: int):
    """Player costs whose only atom is player index 1's lane cost on the
    first `nseg` segments of its lane (the flagship's 6-segment lane2):
    the polyline queries of tools/sweep_floor5h.py at 1, 2 and 6
    segments, as atoms the kernels have a device form for."""
    lane2 = lane_polylines()[1][:nseg + 1]
    lane = atoms.quadratic_polyline2(LANE_COST_WEIGHT, lane2, 6, 7,
                                     "LaneCenter")
    return tuple(dataclasses.replace(
        pc, state_costs=(lane,) if pi == 1 else (), state_constraints=(),
        control_costs=(), control_constraints=())
        for pi, pc in enumerate(player_costs))


def _f32(a):
    return a.astype(np.float32)


def floor_draws(spec, C: int, B: int) -> dict:
    """tools/kernel_floor.py's operands, in its order, at C candidates and
    B lanes: x0 [16, B], us_fix [3, 2, B], Ps, al, xs_ref, x0c [16, C, B]."""
    N, X, P, u = N_KNOTS, spec.xdim, spec.num_players, spec.umax
    rng = np.random.RandomState(0)
    d = {"x0": _f32(rng.randn(X, B))}
    d["ufix"] = 0.01 * _f32(rng.randn(P, u, B)).reshape(P * u, B)
    d["Ps"] = 0.01 * _f32(rng.randn(N, P * u, X, B))
    d["al"] = 0.01 * _f32(rng.randn(N, P * u, B))
    d["xs"] = _f32(rng.randn(N, X, B))
    d["x0c"] = _f32(rng.randn(X, C, B))
    return d


def sweep5_draws(spec, n_constraints: int, *, x0c1=False, lamS=False,
                 C: int = 8, B: int = 128) -> dict:
    """tools/sweep_floor5*.py's operands, in their order: x0c [x, C, B],
    (x0c1 [x, 1, B]: 5d), Ps, al, xs_t, us_t, (lamS [N, nS, B]: 5d, 5e,
    5j); scal 0.5, t0 0, gate 1, mu 10."""
    N, X, P = N_KNOTS, spec.xdim, spec.num_players
    Pu = P * spec.umax
    rng = np.random.RandomState(0)
    d = {"x0c": _f32(rng.randn(X, C, B))}
    if x0c1:
        d["x0c1"] = _f32(rng.randn(X, 1, B))
    d["Ps"] = 0.01 * _f32(rng.randn(N, Pu, X, B))
    d["al"] = 0.01 * _f32(rng.randn(N, Pu, B))
    d["xs"] = _f32(rng.randn(N, X, B))
    d["us"] = 0.01 * _f32(rng.randn(N, Pu, B))
    if lamS:
        d["lamS"] = 0.1 * _f32(rng.rand(N, n_constraints, B))
    d["scal"] = 0.5 * np.ones((C, B), np.float32)
    d["t0"] = np.zeros((1, B), np.float32)
    d["gate"] = np.ones((N, P, B), np.float32)
    d["mu"] = 10.0 * np.ones((1, B), np.float32)
    return d


def sweep5i_draws(spec, n_constraints: int) -> dict:
    """tools/sweep_floor5i.py's operands: three emit draws (x0m, Ps, al,
    xs_t, us_t at B=128 for i1, i2, i3), then xs_cand [N, x, 8, 1024],
    us_cand and lamS_all [N, nS, 1024]."""
    N, X, Pu = N_KNOTS, spec.xdim, spec.num_players * spec.umax
    rng = np.random.RandomState(0)
    d = {}
    for case, C in (("i1", 1), ("i2", 8), ("i3", 8)):
        d[case] = {"x0m": _f32(rng.randn(X, 128)),
                   "Ps": 0.01 * _f32(rng.randn(N, Pu, X, 128)),
                   "al": 0.01 * _f32(rng.randn(N, Pu, 128)),
                   "xs": _f32(rng.randn(N, X, 128)),
                   "us": 0.01 * _f32(rng.randn(N, Pu, 128)),
                   "scal": 0.5 * np.ones((C, 128), np.float32),
                   "t0": np.zeros((1, 128), np.float32)}
    d["i4"] = {"xs_cand": _f32(rng.randn(N, X, 8, 1024)),
               "us_cand": 0.01 * _f32(rng.randn(N, Pu, 8, 1024)),
               "t0": np.zeros((1, 1024), np.float32),
               "lamS": 0.1 * _f32(rng.rand(N, n_constraints, 1024)),
               "mu": 10.0 * np.ones((1, 1024), np.float32)}
    return d


def merit_chain_draws(spec, n_constraints: int, lam_first: bool) -> dict:
    """The merit-consumer probes' operands at C=8, B=128: xc0 [N, x, C, B],
    uc0, lamS (drawn first in kernel_profile6i.py, third in
    sweep_floor5k.py), then op xs, us, st Ps, alphas, x0m [x, B] and, in
    kernel_profile6i.py, x0c [x, C, B]; scal 0.1 * 0.5^c, mu 10, t0 0."""
    N, X, Pu = N_KNOTS, spec.xdim, spec.num_players * spec.umax
    C, B = 8, 128
    rng = np.random.RandomState(0)
    d = {}
    lam = lambda: 0.1 * _f32(rng.rand(N, n_constraints, B))
    if lam_first:
        d["lamS"] = lam()
    d["xc0"] = _f32(rng.randn(N, X, C, B))
    d["uc0"] = 0.01 * _f32(rng.randn(N, Pu, C, B))
    if not lam_first:
        d["lamS"] = lam()
    d["xs"] = _f32(rng.randn(N, X, B))
    d["us"] = 0.01 * _f32(rng.randn(N, Pu, B))
    d["Ps"] = 0.01 * _f32(rng.randn(N, Pu, X, B))
    d["al"] = 0.01 * _f32(rng.randn(N, Pu, B))
    d["x0m"] = _f32(rng.randn(X, B))
    if lam_first:
        d["x0c"] = _f32(rng.randn(X, C, B))
    d["scal"] = np.ascontiguousarray(np.broadcast_to(
        (0.1 * 0.5 ** np.arange(C, dtype=np.float32))[:, None], (C, B)))
    d["t0"] = np.zeros((1, B), np.float32)
    d["mu"] = 10.0 * np.ones((1, B), np.float32)
    return d


class Context:
    """The flagship at N=100 and the probes' operands on one device, each
    set drawn once and kept."""

    def __init__(self, device):
        self.dev = torch.device(device)
        self.problem = make_problem()
        self.dyn = self.problem.dynamics
        self.costs = self.problem.player_costs
        self.spec = self.problem.spec
        self.n_constraints = sum(len(pc.state_constraints)
                                 for pc in self.costs)
        self._cache = {}

    def cached(self, key, make):
        if key not in self._cache:
            self._cache[key] = make()
        return self._cache[key]

    def tensors(self, key, draw):
        """The numpy draws of `draw()` (a dict, possibly nested) as
        float32 tensors on the device, kept under `key`."""
        def conv(v):
            if isinstance(v, dict):
                return {k: conv(a) for k, a in v.items()}
            return torch.tensor(v, device=self.dev)

        return self.cached(key, lambda: conv(draw()))

    def subset(self, name, keep):
        """player_costs_subset of the flagship, kept under `name`."""
        return self.cached(("subset", name),
                           lambda: player_costs_subset(self.costs, keep))
