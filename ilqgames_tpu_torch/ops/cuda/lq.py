"""Coupled feedback-LQ Nash sweeps: kernels K2 (backward Riccati sweep) and
K3 (δx forward pass), counterpart of ilqgames_tpu/ops/pallas/lq.py.

`lq_backward` and `lq_forward` launch the hand-written CUDA kernels of
csrc/lq.cu on CUDA tensors and take their plain PyTorch versions
(`lq_backward_plain`, `lq_forward_plain`, same operands and layout) on
CPU tensors; any other device raises. Each keeps a launch count.

Layout is batch-minor ([..., B]), the operand dict of the JAX package's
`solve_lq_feedback_bm`: A [N,x,x,B], Bf [N,x,Pu,B], Qf [N,P*x,x,B],
lf [N,P*x,B], Rf [N,P*P*u,u,B], rf [N,P*P*u,B].

K2 runs `lanes_per_block` lanes per block (8, or fewer where eight do not
fit a block's shared memory), one warp per lane. While a knot computes,
the block copies the next knot's operands of its lanes into a second
buffer of dynamic shared memory (cp.async, consecutive threads on
consecutive lanes, so the reads coalesce), and each warp works through its
lane's knot on its own, between `__syncwarp()`s; T = Z_i F and the value
update run in register tiles, and R_i P is formed once per knot.
`backward_smem_bytes` is the block's shared memory in csrc/lq.cu's
layout, which checks it at compile time.

K3 runs `FWD_G` lanes per block and one thread per (state row, lane), so
that its reads of A, Bf and alpha coalesce over the lanes; each knot's
operands of the block's lanes are copied by 16-byte cp.async copies into a
ring of `FWD_STAGES` shared-memory slots ahead of the knot that folds
them, and dx is double-buffered in shared memory (one barrier per knot).
`forward_smem_bytes` is its shared memory, checked the same way.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ilqgames_tpu_torch.ops.cuda import build
from ilqgames_tpu_torch.ops.cuda.layout import bm, mb, pad_batch
from ilqgames_tpu_torch.types import GameSpec, LinearDynamics, LQSolution, \
    QuadraticCosts, Strategy

_MIN_GERSHGORIN_EVAL = 1e-3

_P = ctypes.c_void_p
_I = ctypes.c_int


def _pad_rows(spec: GameSpec):
    """Flat control rows (player-major) that are padding."""
    return [i * spec.umax + a for i, d in enumerate(spec.udims)
            for a in range(d, spec.umax)]


LQ_G = 8                # K2's most lanes per block (one warp each)
SMEM_LIMIT = 232448     # shared memory a block may use on an H100, bytes
FWD_G = 16              # K3 lanes per block (one 64-byte read an element)
FWD_STAGES = 3          # K3's ring: the knot folded and two in flight


def backward_smem_bytes(spec: GameSpec, G: int = LQ_G) -> int:
    """K2's dynamic shared memory per block of G lanes, csrc/lq.cu's
    layout: per lane the value-function carry and the knot's temporaries,
    then two buffers of a knot's staged operands, each part padded to a
    multiple of 4 floats and the lane to 32 / G more than a multiple of 32
    (the staging's stores, G lanes of one element side by side, then fall
    in distinct banks)."""
    P, x, u = spec.num_players, spec.xdim, spec.umax
    Pu, Px = P * u, P * x
    pad4 = lambda n: -(-n // 4) * 4
    staged = x * x + x * Pu + Px * x + Px + P * P * u * u + P * P * u
    carry = Px * x + Px
    temps = (Pu * x + Pu * (Pu + x + 1) + Pu * (x + 1) + x * x + x + Pu
             + Px * x + Px + P * Pu + P * Pu * x)
    used = pad4(carry + temps) + 2 * pad4(staged)
    return 4 * G * (used + (32 // G - used) % 32)


def lanes_per_block(spec: GameSpec) -> int:
    """K2's lanes per block at this game's dims: the most of 8, 4, 2 and 1
    whose shared memory fits a block (`backward_smem_bytes`), or 0 where
    none does."""
    return next((G for G in (8, 4, 2, 1)
                 if backward_smem_bytes(spec, G) <= SMEM_LIMIT), 0)


def forward_smem_bytes(spec: GameSpec) -> int:
    """K3's dynamic shared memory per block, csrc/lq.cu's layout: a ring of
    `FWD_STAGES` knots of A, Bf and alpha for `FWD_G` lanes, and dx
    twice."""
    x, Pu = spec.xdim, spec.num_players * spec.umax
    return 4 * FWD_G * (FWD_STAGES * (x * x + x * Pu + Pu) + 2 * x)


def library(spec: GameSpec):
    """(source name, defines) of csrc/lq.cu for this game's dims."""
    x = spec.xdim
    fwd = forward_smem_bytes(spec)
    if fwd > SMEM_LIMIT or x * FWD_G > 1024:
        raise ValueError(f"K3 needs {x * FWD_G} threads and {fwd} B of "
                         f"shared memory per block at {FWD_G} lanes, above "
                         f"1024 or {SMEM_LIMIT} B")
    Pu = spec.num_players * spec.umax
    if Pu > 32 or x + 1 > 32:
        raise ValueError(f"K2's LU searches a pivot over a warp's threads, "
                         f"one per control row, and back-substitutes one "
                         f"thread per column of [P | alpha]: Pu = {Pu} and "
                         f"x + 1 = {x + 1}, where each must be at most 32")
    G = lanes_per_block(spec)
    if G == 0:
        raise ValueError(f"K2 needs {backward_smem_bytes(spec, 1)} B of "
                         f"shared memory per block at one lane, above the "
                         f"{SMEM_LIMIT} B a block may use")
    return "lq", {"LQ_X": spec.xdim, "LQ_P": spec.num_players,
                  "LQ_U": spec.umax, "LQ_G": G,
                  "LQ_SMEM": backward_smem_bytes(spec, G),
                  "LQ_FWD_G": FWD_G, "LQ_FWD_SMEM": fwd}


@functools.lru_cache(maxsize=None)
def load_kernels(spec: GameSpec) -> ctypes.CDLL:
    """Build (once per shape) and load csrc/lq.cu for this game's dims."""
    lib = build.load(*library(spec))
    lib.lq_backward.argtypes = [_P] * 8 + [_I] * 4 + [_P]
    lib.lq_backward.restype = _I
    lib.lq_forward.argtypes = [_P] * 5 + [_I] * 2 + [_P]
    lib.lq_forward.restype = _I
    return lib


def _op_shapes(spec: GameSpec, B: int) -> dict:
    N, P, x, u = spec.num_time_steps, spec.num_players, spec.xdim, spec.umax
    Pu = P * u
    return {"A": (N, x, x, B), "Bf": (N, x, Pu, B), "Qf": (N, P * x, x, B),
            "lf": (N, P * x, B), "Rf": (N, P * P * u, u, B),
            "rf": (N, P * P * u, B)}


def lq_backward_plain(spec: GameSpec, ops: dict, adaptive: bool = True):
    """Plain PyTorch K2, the kernel's operations on [.., B] slabs:
    returns (Ps [ns, Pu, x, B], alphas [ns, Pu, B])."""
    N, P, x, u = spec.num_time_steps, spec.num_players, spec.xdim, spec.umax
    Pu = P * u
    ns = N - 1
    A, Bf, Qf, lf, Rf, rf = (ops[k] for k in ("A", "Bf", "Qf", "lf", "Rf",
                                              "rf"))
    B = A.shape[-1]
    pid = torch.arange(Pu, device=A.device) // u
    pad = _pad_rows(spec)
    Z = Qf[N - 1].reshape(P, x, x, B)
    zeta = lf[N - 1].reshape(P, x, B)
    Ps = A.new_empty((ns, Pu, x, B))
    als = A.new_empty((ns, Pu, B))
    for s in range(ns - 1, -1, -1):
        As, Bs = A[s], Bf[s]                           # [x,x,B], [x,Pu,B]
        Rs = Rf[s].reshape(P, P, u, u, B)
        rs = rf[s].reshape(P, P, u, B)
        Zg, zg = Z[pid], zeta[pid]                     # [Pu,x,x,B], [Pu,x,B]

        BiZ = Bs[0][:, None, :] * Zg[:, 0]             # [Pu, x(y), B]
        for xx in range(1, x):
            BiZ = BiZ + Bs[xx][:, None, :] * Zg[:, xx]
        S = BiZ[:, 0, None, :] * Bs[0][None]           # [Pu, Pu, B]
        for y in range(1, x):
            S = S + BiZ[:, y, None, :] * Bs[y][None]
        Rown = torch.zeros_like(S)
        for i in range(P):
            Rown[i * u:(i + 1) * u, i * u:(i + 1) * u] = Rs[i, i]
        S = S + Rown
        for af in pad:
            eye_row = torch.zeros((Pu, 1), device=A.device)
            eye_row[af] = 1.0
            S[af] = S[af] + eye_row
        if adaptive:
            absS = torch.abs(S)
            colsum = absS[0]
            for r in range(1, Pu):
                colsum = colsum + absS[r]
            diag = torch.diagonal(S).T                 # [Pu, B]
            radius = colsum - torch.abs(diag)
            bump = torch.where(diag - radius < _MIN_GERSHGORIN_EVAL,
                               radius + _MIN_GERSHGORIN_EVAL, 0.0)
            S = S + torch.diag_embed(bump.T).permute(1, 2, 0)
        Yp = BiZ[:, 0, None, :] * As[0][None]          # [Pu, x, B]
        for y in range(1, x):
            Yp = Yp + BiZ[:, y, None, :] * As[y][None]
        Ya = Bs[0] * zg[:, 0]                          # [Pu, B]
        for xx in range(1, x):
            Ya = Ya + Bs[xx] * zg[:, xx]
        Ya = Ya + torch.stack([rs[i, i, a] for i in range(P)
                               for a in range(u)])
        rows = list(torch.cat([S, Yp, Ya[:, None]], dim=1))
        X = _lu_solve_rows(rows, Pu)
        Pm = torch.stack([X[af][:x] for af in range(Pu)])   # [Pu, x, B]
        alpha = torch.stack([X[af][x] for af in range(Pu)])  # [Pu, B]
        Ps[s] = Pm
        als[s] = alpha

        F = As
        for af in range(Pu):
            F = F - Bs[:, af][:, None, :] * Pm[af][None]
        beta = -(Bs[:, 0] * alpha[0])
        for af in range(1, Pu):
            beta = beta - Bs[:, af] * alpha[af]

        Z_new, zeta_new = [], []
        for i in range(P):
            Zi, zi = Z[i], zeta[i]
            Zb = Zi[:, 0] * beta[0]
            for y in range(1, x):
                Zb = Zb + Zi[:, y] * beta[y]
            w = zi + Zb
            Ftw = F[0] * w[0]
            for xx in range(1, x):
                Ftw = Ftw + F[xx] * w[xx]
            cross = torch.zeros_like(w)
            for j in range(P):
                for a in range(u):
                    Ra = Rs[i, j, a, 0] * alpha[j * u]
                    for v in range(1, u):
                        Ra = Ra + Rs[i, j, a, v] * alpha[j * u + v]
                    cross = cross + Pm[j * u + a] * (Ra - rs[i, j, a])
            zeta_new.append(Ftw + lf[s, i * x:(i + 1) * x] + cross)

            T = Zi[:, 0][:, None, :] * F[0][None]
            for y in range(1, x):
                T = T + Zi[:, y][:, None, :] * F[y][None]
            FtT = F[0][:, None, :] * T[0][None]
            for xx in range(1, x):
                FtT = FtT + F[xx][:, None, :] * T[xx][None]
            PRP = torch.zeros_like(FtT)
            for j in range(P):
                for a in range(u):
                    RP = Rs[i, j, a, 0] * Pm[j * u]
                    for v in range(1, u):
                        RP = RP + Rs[i, j, a, v] * Pm[j * u + v]
                    PRP = PRP + Pm[j * u + a][:, None, :] * RP[None]
            Z_new.append(FtT + Qf[s, i * x:(i + 1) * x] + PRP)
        Z = torch.stack(Z_new)
        zeta = torch.stack(zeta_new)
    return Ps, als


def _lu_solve_rows(rows, n):
    """Solve the n x n system in `rows` (n augmented [n + w, B] slabs) by LU
    with lane-wise partial pivoting; the pivot is the first row attaining
    the column max. Returns the n solution slabs [w, B]."""
    rows = list(rows)
    for k in range(n):
        absk = [torch.abs(rows[r][k]) for r in range(k, n)]
        m = absk[0]
        for a in absk[1:]:
            m = torch.maximum(m, a)
        taken = torch.zeros_like(m, dtype=torch.bool)
        sel = []
        for a in absk:
            hit = (a >= m) & ~taken
            sel.append(hit)
            taken = taken | hit
        pivotrow = rows[k]
        for off, s in enumerate(sel[1:], start=1):
            pivotrow = torch.where(s[None], rows[k + off], pivotrow)
        for off, s in enumerate(sel[1:], start=1):
            rows[k + off] = torch.where(s[None], rows[k], rows[k + off])
        rows[k] = pivotrow
        inv = 1.0 / pivotrow[k]
        for r in range(k + 1, n):
            f = rows[r][k] * inv
            rows[r] = rows[r] - f[None] * pivotrow
    X = [None] * n
    for k in reversed(range(n)):
        acc = rows[k][n:]
        for j in range(k + 1, n):
            acc = acc - rows[k][j][None] * X[j]
        X[k] = acc / rows[k][k][None]
    return X


def lq_forward_plain(spec: GameSpec, A, Bf, alphas, dx0):
    """Plain PyTorch K3: dxs [N, x, B] from A, Bf [N, ...], alphas
    [ns, Pu, B], dx0 [x, B]."""
    N, x = spec.num_time_steps, spec.xdim
    Pu = spec.num_players * spec.umax
    xs = dx0
    out = [xs]
    for k in range(N - 1):
        xn = A[k][:, 0] * xs[0]
        for y in range(1, x):
            xn = xn + A[k][:, y] * xs[y]
        for af in range(Pu):
            xn = xn - Bf[k][:, af] * alphas[k][af]
        xs = xn
        out.append(xs)
    return torch.stack(out)


def lq_backward(spec: GameSpec, ops: dict, adaptive: bool = True):
    """K2: (Ps [ns, Pu, x, B], alphas [ns, Pu, B]) from the batch-minor
    operand dict. CUDA tensors launch csrc/lq.cu; CPU tensors take
    `lq_backward_plain`."""
    B = ops["A"].shape[-1]
    shapes = _op_shapes(spec, B)
    dev = build.check_operands([(k, ops[k], shapes[k]) for k in shapes])
    if dev.type == "cpu":
        return lq_backward_plain(spec, ops, adaptive)
    N, P, x, u = spec.num_time_steps, spec.num_players, spec.xdim, spec.umax
    Pu = P * u
    lib = load_kernels(spec)
    Ps = torch.empty((N - 1, Pu, x, B), dtype=torch.float32, device=dev)
    al = torch.empty((N - 1, Pu, B), dtype=torch.float32, device=dev)
    pad_mask = sum(1 << af for af in _pad_rows(spec))
    args = [ops[k].data_ptr() for k in ("A", "Bf", "Qf", "lf", "Rf", "rf")]
    rc = lib.lq_backward(*args, Ps.data_ptr(), al.data_ptr(), N, B, pad_mask,
                         int(adaptive), build.stream(dev))
    build.check(rc, "lq_backward")
    lq_backward.launches += 1
    return Ps, al


lq_backward.launches = 0


def lq_forward(spec: GameSpec, A, Bf, alphas, dx0):
    """K3: dxs [N, x, B]. CUDA tensors launch csrc/lq.cu; CPU tensors take
    `lq_forward_plain`."""
    N, x = spec.num_time_steps, spec.xdim
    Pu = spec.num_players * spec.umax
    B = dx0.shape[-1]
    shapes = _op_shapes(spec, B)
    dev = build.check_operands([("A", A, shapes["A"]), ("Bf", Bf, shapes["Bf"]),
                                ("alphas", alphas, (N - 1, Pu, B)),
                                ("dx0", dx0, (x, B))])
    if dev.type == "cpu":
        return lq_forward_plain(spec, A, Bf, alphas, dx0)
    lib = load_kernels(spec)
    dxs = torch.empty((N, x, B), dtype=torch.float32, device=dev)
    rc = lib.lq_forward(A.data_ptr(), Bf.data_ptr(), alphas.data_ptr(),
                        dx0.data_ptr(), dxs.data_ptr(), N, B,
                        build.stream(dev))
    build.check(rc, "lq_forward")
    lq_forward.launches += 1
    return dxs


lq_forward.launches = 0


def solve_lq_feedback_bm(spec: GameSpec, ops: dict, dx0m: torch.Tensor,
                         adaptive_regularization: bool = True):
    """The kernel pair on the batch-minor operand dict and dx0m [x, B]:
    (Ps_r [ns, Pu, x, B], al_r [ns, Pu, B], dxs [N, x, B])."""
    Ps_r, al_r = lq_backward(spec, ops, adaptive_regularization)
    dxs = lq_forward(spec, ops["A"], ops["Bf"], al_r, dx0m)
    return Ps_r, al_r, dxs


def lq_operands(spec: GameSpec, lin: LinearDynamics, quad: QuadraticCosts,
                batch_block: int = 1) -> dict:
    """Batch-major stage containers -> the kernels' batch-minor operand
    dict, lanes padded to a multiple of `batch_block`."""
    N, P, x, u = spec.num_time_steps, spec.num_players, spec.xdim, spec.umax
    Bt = lin.A.shape[0]
    pad = lambda a: pad_batch(bm(a), batch_block).contiguous()
    return {
        "A": pad(lin.A),
        "Bf": pad(lin.Bs.permute(0, 1, 3, 2, 4).reshape(Bt, N, x, P * u)),
        "Qf": pad(quad.Q.reshape(Bt, N, P * x, x)),
        "lf": pad(quad.l.reshape(Bt, N, P * x)),
        "Rf": pad(quad.R.reshape(Bt, N, P * P * u, u)),
        "rf": pad(quad.r.reshape(Bt, N, P * P * u)),
    }


def solve_lq_feedback(spec: GameSpec, lin: LinearDynamics,
                      quad: QuadraticCosts, dx0: torch.Tensor,
                      adaptive_regularization: bool = True,
                      batch_block: int = 128) -> LQSolution:
    """Batched feedback-LQ solve on batch-major containers (lin.A
    [Bt, N, x, x], lin.Bs [Bt, N, P, x, u], quad batched, dx0 [Bt, x]);
    the counterpart of solve_lq_feedback_pallas. Lanes are padded to a
    multiple of `batch_block` as there."""
    N, P, x, u = spec.num_time_steps, spec.num_players, spec.xdim, spec.umax
    Bt = dx0.shape[0]
    Ps_r, al_r, dxs = solve_lq_feedback_bm(
        spec, lq_operands(spec, lin, quad, batch_block),
        pad_batch(bm(dx0), batch_block).contiguous(),
        adaptive_regularization)
    ns = N - 1
    Ps = mb(Ps_r, Bt).reshape(Bt, ns, P, u, x)
    alphas = mb(al_r, Bt).reshape(Bt, ns, P, u)
    return LQSolution(
        strategy=Strategy(
            Ps=torch.cat([Ps, Ps.new_zeros((Bt, 1, P, u, x))], dim=1),
            alphas=torch.cat([alphas, alphas.new_zeros((Bt, 1, P, u))],
                             dim=1)),
        delta_xs=mb(dxs, Bt))
