"""Open-loop Nash LQ sweep: kernel K7 (csrc/lq_open_loop.cu), the port's
form of the JAX package's XLA function
ilqgames_tpu/solver/lq_open_loop.py:solve_lq_open_loop.

`lq_open_loop` launches the hand-written CUDA kernel on CUDA tensors and
takes its plain PyTorch version `lq_open_loop_plain` (same operands,
layout and float32 operations in the same order) on CPU tensors; any
other device raises. It keeps a launch count.

Operands are K2's batch-minor dict (ops/cuda/lq.py `lq_operands`: A
[N,x,x,B], Bf [N,x,Pu,B], Qf [N,P*x,x,B], lf [N,P*x,B], Rf
[N,P*P*u,u,B], rf [N,P*P*u,B]) and dx0 [x, B]; the outputs are alphas
[N-1, Pu, B] and dxs [N, x, B]. Each knot's solves are LUs with K2's
pivot rule (`lq._lu_solve_rows`), so the kernel and its plain version
agree bit for bit, and both agree with the JAX package's LAPACK solves
at float level.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ilqgames_tpu_torch.ops.cuda import build
from ilqgames_tpu_torch.ops.cuda.lq import _lu_solve_rows, _op_shapes, \
    _pad_rows
from ilqgames_tpu_torch.types import GameSpec, const_tensor

_P = ctypes.c_void_p
_I = ctypes.c_int


def library(spec: GameSpec):
    """(source name, defines) of csrc/lq_open_loop.cu for this game's
    dims."""
    if spec.xdim > 32 or spec.umax > 32:
        raise ValueError("K7's LUs take a pivot row per thread of one warp: "
                         f"x = {spec.xdim} and u = {spec.umax} must be <= 32")
    return "lq_open_loop", {"OL_X": spec.xdim, "OL_P": spec.num_players,
                            "OL_U": spec.umax}


def cache_floats(spec: GameSpec) -> int:
    """Floats of one knot's cache of one lane, csrc/lq_open_loop.cu's FS:
    [W | w] [Pu, x+1], [L | l] [x, x+1], M [P, x, x], m [P, x], padded to
    a multiple of 4 (the kernel copies a lane's cache in 16-byte pieces)."""
    P, x, u = spec.num_players, spec.xdim, spec.umax
    floats = P * u * (x + 1) + x * (x + 1) + P * x * x + P * x
    return (floats + 3) // 4 * 4


@functools.lru_cache(maxsize=None)
def load_kernels(spec: GameSpec) -> ctypes.CDLL:
    """Build (once per shape) and load csrc/lq_open_loop.cu."""
    lib = build.load(*library(spec))
    lib.lq_open_loop.argtypes = [_P] * 10 + [_I] * 4 + [_P]
    lib.lq_open_loop.restype = _I
    return lib


def lq_open_loop_plain(spec: GameSpec, ops: dict, dx0: torch.Tensor):
    """Plain PyTorch K7, the kernel's operations on [.., B] slabs:
    (alphas [N-1, Pu, B], dxs [N, x, B])."""
    N, P, x, u = spec.num_time_steps, spec.num_players, spec.xdim, spec.umax
    Pu = P * u
    A, Bf, Qf, lf, Rf, rf = (ops[k] for k in ("A", "Bf", "Qf", "lf", "Rf",
                                              "rf"))
    B = A.shape[-1]
    dev = A.device
    pid = torch.arange(Pu, device=dev) // u
    pad = set(_pad_rows(spec))
    eye = torch.eye(x, device=dev)[:, :, None]
    M = Qf[N - 1].reshape(P, x, x, B)
    m = lf[N - 1].reshape(P, x, B)
    caches = [None] * (N - 1)
    for s in range(N - 2, -1, -1):
        As, Bs = A[s], Bf[s]                            # [x,x,B], [x,Pu,B]
        Rs = Rf[s].reshape(P, P, u, u, B)
        rs = rf[s].reshape(P, P, u, B)
        # [W_i | w_i] = R_ii^-1 [B_i^T | r_ii], the identity added on
        # padded controls (+0.0 on every other entry, as the JAX package's
        # pad_diag_u adds).
        Wrows = []
        for i in range(P):
            padm = const_tensor(tuple(
                tuple(1.0 if (c == a and i * u + a in pad) else 0.0
                      for c in range(u)) for a in range(u)), dev)
            Rd = Rs[i, i] + padm[:, :, None]
            rows = [torch.cat([Rd[a], Bs[:, i * u + a], rs[i, i, a][None]])
                    for a in range(u)]
            Wrows += _lu_solve_rows(rows, u)
        Wc = torch.stack(Wrows)                         # [Pu, x+1, B]
        WB, Wr = Wc[:, :x], Wc[:, x]
        Mg, mg = M[pid], m[pid]                         # [Pu,x,x,B], [Pu,x,B]
        WM = WB[:, 0, None, :] * Mg[:, 0]               # [Pu, x(c), B]
        for y in range(1, x):
            WM = WM + WB[:, y, None, :] * Mg[:, y]
        v = WB[:, 0] * mg[:, 0]                         # [Pu, B]
        for y in range(1, x):
            v = v + WB[:, y] * mg[:, y]
        v = v + Wr
        lam = Bs[:, 0, None, :] * WM[0][None]           # [x(r), x(c), B]
        for af in range(1, Pu):
            lam = lam + Bs[:, af, None, :] * WM[af][None]
        lam = eye + lam
        inter = Bs[:, 0] * v[0]                         # [x, B]
        for af in range(1, Pu):
            inter = inter + Bs[:, af] * v[af]
        inter = -inter
        Lc = torch.stack(_lu_solve_rows(
            list(torch.cat([lam, As, inter[:, None]], dim=1)), x))
        caches[s] = (Wc, Lc, M, m)
        LA, Li = Lc[:, :x], Lc[:, x]                    # [x(z), x(c), B]
        T = M[:, :, 0, None, :] * LA[0][None, None]     # [P, x(y), x(c), B]
        for z in range(1, x):
            T = T + M[:, :, z, None, :] * LA[z][None, None]
        w = M[:, :, 0] * Li[0]                          # [P, x, B]
        for z in range(1, x):
            w = w + M[:, :, z] * Li[z]
        w = m + w
        Mn = As[0][None, :, None, :] * T[:, 0][:, None]  # [P, x(r), x(c), B]
        for y in range(1, x):
            Mn = Mn + As[y][None, :, None, :] * T[:, y][:, None]
        mn = As[0][None] * w[:, 0][:, None]             # [P, x(r), B]
        for y in range(1, x):
            mn = mn + As[y][None] * w[:, y][:, None]
        M = Qf[s].reshape(P, x, x, B) + Mn
        m = lf[s].reshape(P, x, B) + mn

    dx = dx0
    dxs, als = [dx0], []
    for k in range(N - 1):
        Wc, Lc, Mk, mk = caches[k]
        dn = Lc[:, 0] * dx[0]                           # [x, B]
        for c in range(1, x):
            dn = dn + Lc[:, c] * dx[c]
        dn = dn + Lc[:, x]
        inner = Mk[:, :, 0] * dn[0]                     # [P, x, B]
        for z in range(1, x):
            inner = inner + Mk[:, :, z] * dn[z]
        inner = (inner + mk)[pid]                       # [Pu, x, B]
        alpha = Wc[:, 0] * inner[:, 0]                  # [Pu, B]
        for y in range(1, x):
            alpha = alpha + Wc[:, y] * inner[:, y]
        als.append(alpha + Wc[:, x])
        dx = dn
        dxs.append(dn)
    alphas = (torch.stack(als) if als else
              A.new_zeros((0, Pu, B)))
    return alphas, torch.stack(dxs)


def _run(fn, spec: GameSpec, ops: dict, dx0: torch.Tensor, *extra):
    """Launch K7's C function `fn` on checked CUDA operands, with `extra`
    arguments before the stream: (alphas, dxs)."""
    N, x = spec.num_time_steps, spec.xdim
    Pu = spec.num_players * spec.umax
    B = dx0.shape[-1]
    dev = dx0.device
    F = cache_floats(spec)
    al = torch.empty((N - 1, Pu, B), dtype=torch.float32, device=dev)
    dxs = torch.empty((N, x, B), dtype=torch.float32, device=dev)
    cache = torch.empty((N - 1, B, F), dtype=torch.float32, device=dev)
    pad_mask = sum(1 << af for af in _pad_rows(spec))
    args = [ops[k].data_ptr() for k in ("A", "Bf", "Qf", "lf", "Rf", "rf")]
    rc = fn(*args, dx0.data_ptr(), al.data_ptr(), dxs.data_ptr(),
            cache.data_ptr(), F, N, B, pad_mask, *extra, build.stream(dev))
    build.check(rc, "lq_open_loop")
    return al, dxs


def lq_open_loop(spec: GameSpec, ops: dict, dx0: torch.Tensor):
    """K7: (alphas [N-1, Pu, B], dxs [N, x, B]) from K2's batch-minor
    operand dict and dx0 [x, B]. CUDA tensors launch
    csrc/lq_open_loop.cu; CPU tensors take `lq_open_loop_plain`."""
    B = dx0.shape[-1]
    shapes = _op_shapes(spec, B)
    dev = build.check_operands([(k, ops[k], shapes[k]) for k in shapes]
                               + [("dx0", dx0, (spec.xdim, B))])
    if dev.type == "cpu":
        return lq_open_loop_plain(spec, ops, dx0)
    out = _run(load_kernels(spec).lq_open_loop, spec, ops, dx0)
    lq_open_loop.launches += 1
    return out


lq_open_loop.launches = 0
