// Coupled feedback-Nash LQ game sweeps for Hopper (sm_90a): K2 and K3.
//
// K2 (lq_backward) replaces the Pallas kernel
// ilqgames_tpu/ops/pallas/lq.py:_backward_kernel. It runs the coupled
// Riccati recursion backward over the ns = N-1 knots of each lane: for
// every knot it forms B_i^T Z_i and the coupling matrix S (own R blocks,
// identity on padded controls, Gershgorin column regularization with
// minimum eigenvalue 1e-3), solves [P | alpha] by LU with partial
// pivoting (the pivot is the first row attaining the column max), and
// updates each player's value function Z_i, zeta_i.
//
// K3 (lq_forward) replaces ilqgames_tpu/ops/pallas/lq.py:_forward_kernel:
// dx_{k+1} = A_k dx_k - sum_af Bf[:, af] alpha_af, with the open-loop A of
// the reference's shipped forward pass (no -B P feedback term).
//
// Design. K2 runs one block of NT threads per lane. The block keeps the
// lane's value-function carry Z [P][X][X] and zeta [P][X], the knot's
// operands and every temporary in shared memory (about 11 KB). It walks
// the knots backward in phases separated by __syncthreads(). Each output
// element of a phase (an entry of B_i^T Z_i, of the augmented system, of
// F or of the new Z_i) is one thread's left fold, in the same order as
// the plain version. The LU pivot search runs on one thread, and the
// eliminations and the back-substitution are parallel over columns.
// Operands are batch-minor ([..., B]), as the JAX package lays them out:
// a block reads its lane's operands with stride B, and the blocks of
// neighbouring lanes share the sectors through L2. K3 runs one block per
// lane with one thread per state row, and keeps dx in shared memory.
//
// What bounds them on this card. Per knot, K2 reads about 1.2 K floats
// of operands per lane and does about 40 kFLOP. At B = 1024 there are
// 1024 blocks of NT threads, about 8 per SM. The time is the chain of
// about 26 barrier-separated phases per knot, and the card's FLOP/s and
// bandwidth are not the limit. An earlier version ran one thread per
// lane through spilled local memory. On an H100 (700 W power limit) it
// took 57-67 ms at B = 1024, N = 100 for any block size from 4 to 32
// threads. K3 does about 0.7 kFLOP per knot and lane; each knot is one
// 22-term fold per thread between two barriers, so it is bound by that
// chain over the horizon.
//
// Arithmetic follows the plain PyTorch versions (ops/cuda/lq.py)
// operation by operation: left folds over the contraction index,
// separate multiplies and adds (the library is built with --fmad=false)
// and IEEE division. So the kernels and the plain versions agree bit
// for bit.

#include <cuda_runtime.h>

#if !defined(LQ_X) || !defined(LQ_P) || !defined(LQ_U)
#error "build with -DLQ_X=<xdim> -DLQ_P=<players> -DLQ_U=<umax>"
#endif

namespace {

constexpr int X = LQ_X;
constexpr int P = LQ_P;
constexpr int U = LQ_U;
constexpr int PU = P * U;
constexpr int PX = P * X;
constexpr int W = PU + X + 1;  // augmented system width [S | Yp | Ya]
constexpr float MIN_GERSHGORIN_EVAL = 1e-3f;

// max that propagates NaN, as torch.maximum does.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

constexpr int NT = 128;         // threads of a K2 block
constexpr int PPU = P * P * U;  // rows of Rf and rf at one knot
static_assert((PU - 1) * W <= NT, "an elimination step needs a thread per entry");
static_assert(X + 1 <= NT, "back-substitution needs a thread per column");

__global__ void __launch_bounds__(NT) lq_backward_kernel(
    const float* __restrict__ A, const float* __restrict__ Bf,
    const float* __restrict__ Qf, const float* __restrict__ lf,
    const float* __restrict__ Rf, const float* __restrict__ rf,
    float* __restrict__ Ps, float* __restrict__ al, int N, int B,
    int pad_mask, int adaptive) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const long Bl = B;

  __shared__ float Z[P][X][X], zeta[P][X];          // value-function carry
  __shared__ float Am[X][X], Bm[X][PU], R[PPU][U], r[PPU];
  __shared__ float BiZ[PU][X], M[PU][W], Xs[PU][X + 1];
  __shared__ float F[X][X], beta[X], bump[PU];
  __shared__ float T[P][X][X], w[P][X], coef[P][PU];
  __shared__ int piv;

  // Terminal condition: the last knot's quadraticization.
  for (int e = tid; e < PX * X; e += NT)
    (&Z[0][0][0])[e] = Qf[((long)(N - 1) * PX * X + e) * Bl + b];
  for (int e = tid; e < PX; e += NT)
    (&zeta[0][0])[e] = lf[((long)(N - 1) * PX + e) * Bl + b];

  for (int s = N - 2; s >= 0; --s) {
    for (int e = tid; e < X * X; e += NT)
      (&Am[0][0])[e] = A[((long)s * X * X + e) * Bl + b];
    for (int e = tid; e < X * PU; e += NT)
      (&Bm[0][0])[e] = Bf[((long)s * X * PU + e) * Bl + b];
    for (int e = tid; e < PPU * U; e += NT)
      (&R[0][0])[e] = Rf[((long)s * PPU * U + e) * Bl + b];
    for (int e = tid; e < PPU; e += NT)
      r[e] = rf[((long)s * PPU + e) * Bl + b];
    __syncthreads();

    // B_i^T Z_i, rows over (player i, control a).
    for (int e = tid; e < PU * X; e += NT) {
      const int af = e / X, y = e % X, i = af / U;
      float acc = Bm[0][af] * Z[i][0][y];
      for (int xx = 1; xx < X; ++xx) acc = acc + Bm[xx][af] * Z[i][xx][y];
      BiZ[af][y] = acc;
    }
    __syncthreads();

    // The augmented system [S | B_i^T Z_i A | B_i^T zeta_i + r_ii]; S gets
    // the own R block and identity on padded controls.
    for (int e = tid; e < PU * W; e += NT) {
      const int af = e / W, c = e % W, i = af / U, a = af % U;
      float acc;
      if (c < PU) {
        acc = BiZ[af][0] * Bm[0][c];
        for (int y = 1; y < X; ++y) acc = acc + BiZ[af][y] * Bm[y][c];
        acc = acc + ((c / U) == i ? R[(i * P + i) * U + a][c % U] : 0.0f);
        if ((pad_mask >> af) & 1) acc = acc + (c == af ? 1.0f : 0.0f);
      } else if (c < PU + X) {
        const int z = c - PU;
        acc = BiZ[af][0] * Am[0][z];
        for (int y = 1; y < X; ++y) acc = acc + BiZ[af][y] * Am[y][z];
      } else {
        acc = Bm[0][af] * zeta[i][0];
        for (int xx = 1; xx < X; ++xx) acc = acc + Bm[xx][af] * zeta[i][xx];
        acc = acc + r[(i * P + i) * U + a];
      }
      M[af][c] = acc;
    }
    __syncthreads();

    // Gershgorin column regularization (adds 0 off the diagonal, as the
    // plain version's diag_embed does).
    if (adaptive) {
      if (tid < PU) {
        const int c = tid;
        float colsum = fabsf(M[0][c]);
        for (int rr = 1; rr < PU; ++rr) colsum = colsum + fabsf(M[rr][c]);
        const float d = M[c][c];
        const float radius = colsum - fabsf(d);
        bump[c] = (d - radius < MIN_GERSHGORIN_EVAL)
                      ? radius + MIN_GERSHGORIN_EVAL : 0.0f;
      }
      __syncthreads();
      if (tid < PU * PU) {
        const int rr = tid / PU, c = tid % PU;
        M[rr][c] = M[rr][c] + (c == rr ? bump[rr] : 0.0f);
      }
      __syncthreads();
    }

    // LU with partial pivoting on the augmented rows.
    for (int k = 0; k < PU; ++k) {
      if (tid == 0) {
        float m = fabsf(M[k][k]);
        for (int rr = k + 1; rr < PU; ++rr) m = nan_max(m, fabsf(M[rr][k]));
        int p = k;  // stays k when the column holds a NaN
        for (int rr = k; rr < PU; ++rr)
          if (fabsf(M[rr][k]) >= m) { p = rr; break; }
        piv = p;
      }
      __syncthreads();
      const int p = piv;
      if (p != k && tid < W) {
        const float tmp = M[k][tid];
        M[k][tid] = M[p][tid];
        M[p][tid] = tmp;
      }
      __syncthreads();
      const bool elim = tid < (PU - 1 - k) * W;
      const int rr = k + 1 + tid / W, c = tid % W;
      float f = 0.0f, pivot_c = 0.0f;
      if (elim) {
        f = M[rr][k] * (1.0f / M[k][k]);
        pivot_c = M[k][c];
      }
      __syncthreads();
      if (elim) M[rr][c] = M[rr][c] - f * pivot_c;
      __syncthreads();
    }

    // Back-substitution, one thread per right-hand side.
    if (tid <= X) {
      const int c = tid;
      for (int k = PU - 1; k >= 0; --k) {
        float acc = M[k][PU + c];
        for (int j = k + 1; j < PU; ++j) acc = acc - M[k][j] * Xs[j][c];
        Xs[k][c] = acc / M[k][k];
      }
    }
    __syncthreads();

    // Outputs; closed-loop transition F and drift beta.
    for (int e = tid; e < PU * (X + 1); e += NT) {
      const int af = e / (X + 1), z = e % (X + 1);
      if (z < X)
        Ps[(((long)s * PU + af) * X + z) * Bl + b] = Xs[af][z];
      else
        al[((long)s * PU + af) * Bl + b] = Xs[af][X];
    }
    for (int e = tid; e < X * X; e += NT) {
      const int rr = e / X, z = e % X;
      float f = Am[rr][z];
      for (int af = 0; af < PU; ++af) f = f - Bm[rr][af] * Xs[af][z];
      F[rr][z] = f;
    }
    if (tid < X) {
      float acc = -(Bm[tid][0] * Xs[0][X]);
      for (int af = 1; af < PU; ++af) acc = acc - Bm[tid][af] * Xs[af][X];
      beta[tid] = acc;
    }
    __syncthreads();

    // Value updates of all players; each reads only its own old Z_i.
    for (int e = tid; e < P * X * X; e += NT) {
      const int i = e / (X * X), rr = (e / X) % X, z = e % X;
      float acc = Z[i][rr][0] * F[0][z];
      for (int y = 1; y < X; ++y) acc = acc + Z[i][rr][y] * F[y][z];
      T[i][rr][z] = acc;
    }
    for (int e = tid; e < P * X; e += NT) {
      const int i = e / X, rr = e % X;
      float acc = Z[i][rr][0] * beta[0];
      for (int y = 1; y < X; ++y) acc = acc + Z[i][rr][y] * beta[y];
      w[i][rr] = zeta[i][rr] + acc;
    }
    for (int e = tid; e < P * PU; e += NT) {
      const int i = e / PU, ja = e % PU, j = ja / U;
      const float* Rrow = R[i * PU + ja];  // row (i, j, a) of R
      float Ra = Rrow[0] * Xs[j * U][X];
      for (int v = 1; v < U; ++v) Ra = Ra + Rrow[v] * Xs[j * U + v][X];
      coef[i][ja] = Ra - r[i * PU + ja];
    }
    __syncthreads();

    for (int e = tid; e < P * X; e += NT) {
      const int i = e / X, z = e % X;
      float acc = F[0][z] * w[i][0];
      for (int xx = 1; xx < X; ++xx) acc = acc + F[xx][z] * w[i][xx];
      const float zn = acc + lf[((long)s * PX + i * X + z) * Bl + b];
      float cross = 0.0f;
      for (int ja = 0; ja < PU; ++ja) cross = cross + Xs[ja][z] * coef[i][ja];
      zeta[i][z] = zn + cross;
    }
    for (int e = tid; e < P * X * X; e += NT) {
      const int i = e / (X * X), a = (e / X) % X, c = e % X;
      float acc = F[0][a] * T[i][0][c];
      for (int xx = 1; xx < X; ++xx) acc = acc + F[xx][a] * T[i][xx][c];
      float prp = 0.0f;
      for (int ja = 0; ja < PU; ++ja) {
        const int j = ja / U;
        const float* Rrow = R[i * PU + ja];
        float RP = Rrow[0] * Xs[j * U][c];
        for (int v = 1; v < U; ++v) RP = RP + Rrow[v] * Xs[j * U + v][c];
        prp = prp + Xs[ja][a] * RP;
      }
      Z[i][a][c] =
          acc + Qf[(((long)s * PX + i * X + a) * X + c) * Bl + b] + prp;
    }
    __syncthreads();
  }
}

constexpr int NT3 = 32;  // threads of a K3 block, one per state row
static_assert(X <= NT3, "K3 needs a thread per state row");

__global__ void __launch_bounds__(NT3) lq_forward_kernel(
    const float* __restrict__ A, const float* __restrict__ Bf,
    const float* __restrict__ al, const float* __restrict__ dx0,
    float* __restrict__ dxs, int N, int B) {
  const int b = blockIdx.x;
  const int row = threadIdx.x;
  const long Bl = B;
  __shared__ float xs[X];
  if (row < X) xs[row] = dx0[row * Bl + b];
  __syncthreads();
  for (int k = 0; k < N - 1; ++k) {
    float acc = 0.0f;
    if (row < X) {
      const float* Ak = A + ((long)k * X + row) * X * Bl + b;
      const float* Bk = Bf + ((long)k * X + row) * PU * Bl + b;
      const float* ak = al + (long)k * PU * Bl + b;
      dxs[((long)k * X + row) * Bl + b] = xs[row];
      acc = Ak[0] * xs[0];
      for (int y = 1; y < X; ++y) acc = acc + Ak[y * Bl] * xs[y];
      for (int af = 0; af < PU; ++af) acc = acc - Bk[af * Bl] * ak[af * Bl];
    }
    __syncthreads();
    if (row < X) xs[row] = acc;
    __syncthreads();
  }
  if (row < X) dxs[((long)(N - 1) * X + row) * Bl + b] = xs[row];
}

}  // namespace

extern "C" {

// Operands batch-minor over all N knots: A [N,X,X,B], Bf [N,X,PU,B],
// Qf [N,PX,X,B], lf [N,PX,B], Rf [N,P*P*U,U,B], rf [N,P*P*U,B]; knot N-1
// is the terminal condition. Outputs Ps [N-1,PU,X,B], al [N-1,PU,B]. Bit
// af of pad_mask marks a padded control row.
int lq_backward(const float* A, const float* Bf, const float* Qf,
                const float* lf, const float* Rf, const float* rf,
                float* Ps, float* al, int N, int B, int pad_mask,
                int adaptive, void* stream) {
  lq_backward_kernel<<<B, NT, 0, (cudaStream_t)stream>>>(
      A, Bf, Qf, lf, Rf, rf, Ps, al, N, B, pad_mask, adaptive);
  return (int)cudaGetLastError();
}

// A [N,X,X,B], Bf [N,X,PU,B], al [N-1,PU,B], dx0 [X,B] -> dxs [N,X,B].
int lq_forward(const float* A, const float* Bf, const float* al,
               const float* dx0, float* dxs, int N, int B, void* stream) {
  lq_forward_kernel<<<B, NT3, 0, (cudaStream_t)stream>>>(A, Bf, al, dx0, dxs,
                                                         N, B);
  return (int)cudaGetLastError();
}

}  // extern "C"
