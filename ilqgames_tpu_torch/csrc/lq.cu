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
// Design. K2 runs G = LQ_G lanes per block (8: eight floats of
// neighbouring lanes fill one 32-byte sector; fewer where the shared
// memory of eight does not fit a block, ops/cuda/lq.py:lanes_per_block: 4
// at the roundabout's x = 24, P = 4, whose reads of one element then fill
// half a sector) and one warp per lane. The
// whole block stages each knot's operands of its G lanes (A, Bf, Qf, lf,
// Rf, rf: 1,222 floats a lane) from device memory into shared memory,
// consecutive threads on consecutive lanes, so every read is coalesced and
// no device load is left inside a fold. The next knot's operands are
// copied by cp.async into a second buffer while a knot computes, so the
// staging hides behind the knot's work. The same pass writes the previous
// knot's outputs, coalesced the same way. Two block barriers per knot
// order the staging;
// every other phase is one warp's work on its own lane, separated by
// __syncwarp(). Each output element of a phase is one left fold in the
// plain version's order. The two largest phases, T_i = Z_i F and the value
// update, run in register tiles (a thread holds CW adjacent columns, four
// where x is a multiple of four and two where it is even, of MR rows of
// every player, read as one vector), so that a shared-memory load feeds
// several folds; the others give each thread whole entries. Where x does
// not fill a warp's tiles evenly (x = 2, 12), the threads past the tiles
// and the rows past x compute on row x - 1 and store nothing: no fold adds
// a padded term. The LU pivot search is
// a warp reduction (NaN-propagating max, then the first row attaining it
// by ballot). The eliminations touch only the columns right of the pivot:
// the entries left of it are never read again. The augmented system's
// W = PU + X + 1 columns may outnumber a warp's threads (33 at the
// roundabout): a row swap takes them in a strided loop, as the
// eliminations do. R_i P_j is formed once per knot (RP) and the value
// update folds from it. A lane takes 5,028 floats of dynamic shared memory
// at the flagship's dims with both operand buffers and its padding against
// bank conflicts (160,896 B a block at G = 8). Lanes past B compute on
// the last lane, meet every barrier and store nothing.
//
// K3 runs FG = LQ_FWD_G lanes per block (16) and one thread per (state
// row, lane), consecutive threads on consecutive lanes, so that every read
// of A, Bf and alpha and every write of dxs is coalesced over the lanes.
// Each knot's operands of the block's lanes (X X + X PU + PU floats a lane)
// are copied by 16-byte cp.async copies into a ring of three staged knots
// in dynamic shared memory (70,784 B a block): two knots are in flight
// while one folds. dx is a double-buffered [2][X][FG] shared array, and
// one block barrier per knot orders both. Lanes past B compute on the last
// lane, meet every barrier and store nothing.
//
// What bounds them on this card. K2 does 74,970 float32 operations per
// knot and lane (counted on the plain version) against 1,324 floats moved,
// so it is operation-bound; at B = 1024 it has 128 blocks, one per SM,
// eight warps each. Its time is each warp's instruction stream over the
// knot's phases (the folds, their shared-memory loads and index
// arithmetic) and the LU's dependent chain, with two warps per scheduler
// to hide latency. K3 does 2 (X + PU) operations per state row, knot and
// lane against X X + X PU + PU floats read: it is bound by the bytes it
// moves (153 MB at B = 1024, 94% of them A and Bf), which its ring keeps in
// flight behind each knot's chain of one 22-term fold and one barrier.
//
// Arithmetic follows the plain PyTorch versions (ops/cuda/lq.py)
// operation by operation: left folds over the contraction index,
// separate multiplies and adds (the library is built with --fmad=false)
// and IEEE division. So the kernels and the plain versions agree bit
// for bit.

#include <cuda_runtime.h>

#include "smem.cuh"

#if !defined(LQ_X) || !defined(LQ_P) || !defined(LQ_U)
#error "build with -DLQ_X=<xdim> -DLQ_P=<players> -DLQ_U=<umax>"
#endif
#if !defined(LQ_G) || !defined(LQ_SMEM) || !defined(LQ_FWD_G) || \
    !defined(LQ_FWD_SMEM)
#error "build through ops/cuda/lq.py:library, which sets the block layouts"
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

constexpr int G = LQ_G;         // lanes of a K2 block, one warp each
constexpr int NTB = 32 * G;     // threads of a K2 block
constexpr int PPU = P * P * U;  // rows of Rf and rf at one knot

// A lane's floats in shared memory. The arrays read as tile vectors (Z, T,
// F, RP, and Qf of the staged operands) start at multiples of four floats:
// the carry and the knot's temporaries first, then the staged operands,
// twice over: the knot's own and the next knot's, in flight. A lane's
// stride is 32 / G more than a multiple of 32 floats, so that the
// staging's stores (a warp's threads on G lanes of 32 / G elements side by
// side, lane g's banks 32 / G g further) fall in distinct banks.
constexpr int pad4(int n) { return (n + 3) / 4 * 4; }
constexpr int OFF_Z = 0;                        // Z [P][X][X]
constexpr int OFF_T = OFF_Z + PX * X;           // Z_i F [P][X][X]
constexpr int OFF_F = OFF_T + PX * X;           // F [X][X]
constexpr int OFF_RP = OFF_F + X * X;           // R_i P [P][PU][X]
constexpr int OFF_ZETA = OFF_RP + P * PU * X;   // zeta [P][X]
constexpr int OFF_BIZ = OFF_ZETA + PX;          // B_i^T Z_i [PU][X]
constexpr int OFF_M = OFF_BIZ + PU * X;         // [S | Yp | Ya] [PU][W]
constexpr int OFF_XS = OFF_M + PU * W;          // [P | alpha] [PU][X + 1]
constexpr int OFF_BETA = OFF_XS + PU * (X + 1); // beta [X]
constexpr int OFF_BUMP = OFF_BETA + X;          // bump [PU]
constexpr int OFF_W = OFF_BUMP + PU;            // w [P][X]
constexpr int OFF_COEF = OFF_W + PX;            // coef [P][PU]
constexpr int OFF_S = pad4(OFF_COEF + P * PU);  // the staged operands:
constexpr int S_Q = 0;                          //   Qf [PX][X]
constexpr int S_A = S_Q + PX * X;               //   A [X][X]
constexpr int S_B = S_A + X * X;                //   Bf [X][PU]
constexpr int S_L = S_B + X * PU;               //   lf [PX]
constexpr int S_R = S_L + PX;                   //   Rf [PPU][U]
constexpr int S_RV = S_R + PPU * U;             //   rf [PPU]
constexpr int STAGED = pad4(S_RV + PPU);
constexpr int LANE_USED = OFF_S + 2 * STAGED;
constexpr int LANE = LANE_USED + ((32 / G - LANE_USED) % 32 + 32) % 32;
constexpr int SMEM_BYTES = G * LANE * (int)sizeof(float);

// The value update's tiles: a thread holds CW adjacent columns of MR rows
// of every player, rows rg, rg + RG, ... of each. FULL: the tiles cover
// the warp's 32 threads and x's rows exactly (x = 16, 32), so no thread
// checks its rows.
constexpr int CW = X % 4 == 0 ? 4 : (X % 2 == 0 ? 2 : 1);  // tile columns
constexpr int CG = X / CW;                 // column groups
constexpr int RG = 32 / CG;                // row groups
constexpr int MR = (X + RG - 1) / RG;      // rows of one player per thread
constexpr bool FULL = CG * RG == 32 && X % RG == 0;
static_assert(CG <= 32, "K2's value-update tiles need x / CW <= 32");
// Players a thread's tiles take in one pass: all of them where their
// accumulators fit `budget` floats, else the fewest passes' worth that do.
// Every game before the roundabout takes its players in one pass (the
// overtaking's x = 18 fills both budgets); at the roundabout's x = 24,
// P = 4 (MR = 5 rows of 4 columns a player) all four players' tiles held
// ptxas at 255 registers with 32-96 B of spills, and of the splits tried
// on the card only T one player a pass with the value update two a pass
// built without a spill (250 registers).
constexpr int players_per_pass(int tile, int budget) {
  int passes = 1;
  while ((P + passes - 1) / passes * tile > budget && passes < P) ++passes;
  return (P + passes - 1) / passes;
}
constexpr int PT = players_per_pass(MR * CW, 36);      // T = Z F
constexpr int PZ = players_per_pass(2 * MR * CW, 96);  // the value update
static_assert(SMEM_BYTES == LQ_SMEM,
              "ops/cuda/lq.py:backward_smem_bytes disagrees with the layout");
static_assert(SMEM_BYTES <= MAX_SMEM, "a block may use 227 KB of shared memory");
static_assert(32 % G == 0, "a block's lanes divide a warp's banks");
static_assert(X + 1 <= 32 && PU <= 32,
              "a warp needs a thread per pivot row (the pivot's ballot) "
              "and per right-hand side (the back-substitution)");

// A tile row of CW floats, loaded and stored as one vector.
template <int W>
struct VecOf;
template <>
struct VecOf<4> { using T = float4; };
template <>
struct VecOf<2> { using T = float2; };
template <>
struct VecOf<1> { using T = float; };
using Vec = typename VecOf<CW>::T;

__device__ __forceinline__ Vec ldv(const float* p) {
  return *reinterpret_cast<const Vec*>(p);
}
__device__ __forceinline__ void stv(float* p, Vec v) {
  *reinterpret_cast<Vec*>(p) = v;
}
__device__ __forceinline__ float4 splat(float4, float s) {
  return make_float4(s, s, s, s);
}
__device__ __forceinline__ float2 splat(float2, float s) {
  return make_float2(s, s);
}
__device__ __forceinline__ float splat(float, float s) { return s; }
// Component d of a tile row.
__device__ __forceinline__ float comp(float4 v, int d) {
  return d == 0 ? v.x : d == 1 ? v.y : d == 2 ? v.z : v.w;
}
__device__ __forceinline__ float comp(float2 v, int d) {
  return d == 0 ? v.x : v.y;
}
__device__ __forceinline__ float comp(float v, int) { return v; }
// a + s * v, lane by lane, as separate multiplies and adds.
__device__ __forceinline__ float4 madd(float4 a, float s, float4 v) {
  return make_float4(a.x + s * v.x, a.y + s * v.y, a.z + s * v.z,
                     a.w + s * v.w);
}
__device__ __forceinline__ float2 madd(float2 a, float s, float2 v) {
  return make_float2(a.x + s * v.x, a.y + s * v.y);
}
__device__ __forceinline__ float madd(float a, float s, float v) {
  return a + s * v;
}
// (a + q) + p, lane by lane.
__device__ __forceinline__ float4 add2(float4 a, float4 q, float4 p) {
  return make_float4((a.x + q.x) + p.x, (a.y + q.y) + p.y, (a.z + q.z) + p.z,
                     (a.w + q.w) + p.w);
}
__device__ __forceinline__ float2 add2(float2 a, float2 q, float2 p) {
  return make_float2((a.x + q.x) + p.x, (a.y + q.y) + p.y);
}
__device__ __forceinline__ float add2(float a, float q, float p) {
  return (a + q) + p;
}

// Stage knot s's operands into buffer buf of every lane by cp.async, as
// one commit group.
__device__ __forceinline__ void stage_knot(
    float* sm, int buf, const float* __restrict__ A,
    const float* __restrict__ Bf, const float* __restrict__ Qf,
    const float* __restrict__ lf, const float* __restrict__ Rf,
    const float* __restrict__ rf, int s, int b0, int B, int tid) {
  const int o = OFF_S + buf * STAGED;
  const long sx = (long)s * X, spx = (long)s * PX, spp = (long)s * PPU;
  stage<true, G, LANE, PX * X>(sm, o + S_Q, Qf, spx * X, b0, B, tid);
  stage<true, G, LANE, X * X>(sm, o + S_A, A, sx * X, b0, B, tid);
  stage<true, G, LANE, X * PU>(sm, o + S_B, Bf, sx * PU, b0, B, tid);
  stage<true, G, LANE, PX>(sm, o + S_L, lf, spx, b0, B, tid);
  stage<true, G, LANE, PPU * U>(sm, o + S_R, Rf, spp * U, b0, B, tid);
  stage<true, G, LANE, PPU>(sm, o + S_RV, rf, spp, b0, B, tid);
  cp_async_commit();
}

// Write knot s's [P | alpha] of the block's lanes below B, coalesced.
__device__ __forceinline__ void store_knot(const float* sm,
                                           float* __restrict__ Ps,
                                           float* __restrict__ al, int s,
                                           int b0, int B, int tid) {
  const long Bl = B;
  for (int idx = tid; idx < PU * (X + 1) * G; idx += NTB) {
    const int e = idx / G, g = idx % G, b = b0 + g;
    if (b >= B) continue;
    const int af = e / (X + 1), z = e % (X + 1);
    const float v = sm[g * LANE + OFF_XS + e];
    if (z < X)
      Ps[(((long)s * PU + af) * X + z) * Bl + b] = v;
    else
      al[((long)s * PU + af) * Bl + b] = v;
  }
}

// At an odd x (one tile column a thread) ptxas held K2 to 128 registers and
// spilled (x = 15) unless told that one block per SM is enough; the even
// x's keep their build.
#if LQ_X % 2
#define K2_BOUNDS __launch_bounds__(NTB, 1)
#else
#define K2_BOUNDS __launch_bounds__(NTB)
#endif
__global__ void K2_BOUNDS lq_backward_kernel(
    const float* __restrict__ A, const float* __restrict__ Bf,
    const float* __restrict__ Qf, const float* __restrict__ lf,
    const float* __restrict__ Rf, const float* __restrict__ rf,
    float* __restrict__ Ps, float* __restrict__ al, int N, int B,
    int pad_mask, int adaptive) {
  extern __shared__ float sm[];
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * G;
  const int lt = tid % 32;
  float* L = sm + (tid / 32) * LANE;  // this warp's lane
  float* Z = L + OFF_Z;
  float* zeta = L + OFF_ZETA;
  float* BiZ = L + OFF_BIZ;
  float* M = L + OFF_M;
  float* Xs = L + OFF_XS;
  float* F = L + OFF_F;
  float* beta = L + OFF_BETA;
  float* bump = L + OFF_BUMP;
  float* T = L + OFF_T;
  float* w = L + OFF_W;
  float* coef = L + OFF_COEF;
  float* RP = L + OFF_RP;
  constexpr int XA = X + 1;  // row length of Xs
  const int c0 = CW * (lt % CG), rg = lt / CG;  // the thread's tile
  // Row m of the thread's tile, and whether it is one of x's rows that the
  // thread owns (the others compute on row x - 1 and store nothing).
  auto row = [&](int m) {
    if constexpr (FULL) return rg + RG * m;
    else return min(rg + RG * m, X - 1);
  };
  auto owns = [&](int m) {
    if constexpr (FULL) return true;
    else return rg < RG && rg + RG * m < X;
  };

  // Terminal condition: the last knot's quadraticization.
  stage<false, G, LANE, PX * X>(sm, OFF_Z, Qf, (long)(N - 1) * PX * X, b0,
                                B, tid);
  stage<false, G, LANE, PX>(sm, OFF_ZETA, lf, (long)(N - 1) * PX, b0, B,
                            tid);
  if (N >= 2)
    stage_knot(sm, 0, A, Bf, Qf, lf, Rf, rf, N - 2, b0, B, tid);

  for (int s = N - 2; s >= 0; --s) {
    const int cur = (N - 2 - s) & 1;
    __syncthreads();  // every warp is done with knot s + 1
    if (s < N - 2) store_knot(sm, Ps, al, s + 1, b0, B, tid);
    if (s > 0) {  // knot s - 1 into the buffer knot s + 1 left
      stage_knot(sm, cur ^ 1, A, Bf, Qf, lf, Rf, rf, s - 1, b0, B, tid);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* St = L + OFF_S + cur * STAGED;
    const float* Qs = St + S_Q;
    const float* Am = St + S_A;
    const float* Bm = St + S_B;
    const float* ls = St + S_L;
    const float* R = St + S_R;
    const float* r = St + S_RV;

    // B_i^T Z_i, rows over (player i, control a).
    for (int e = lt; e < PU * X; e += 32) {
      const int af = e / X, y = e % X;
      const float* Zi = Z + (af / U) * X * X;
      float acc = Bm[af] * Zi[y];
      for (int xx = 1; xx < X; ++xx)
        acc = acc + Bm[xx * PU + af] * Zi[xx * X + y];
      BiZ[e] = acc;
    }
    __syncwarp();

    // The augmented system [S | B_i^T Z_i A | B_i^T zeta_i + r_ii], one
    // loop per block of columns so that a warp's threads take one path; S
    // gets the own R block and identity on padded controls.
    for (int e = lt; e < PU * PU; e += 32) {
      const int af = e / PU, c = e % PU, i = af / U, a = af % U;
      const float* Bz = BiZ + af * X;
      float acc = Bz[0] * Bm[c];
      for (int y = 1; y < X; ++y) acc = acc + Bz[y] * Bm[y * PU + c];
      acc = acc + ((c / U) == i ? R[((i * P + i) * U + a) * U + c % U]
                                : 0.0f);
      if ((pad_mask >> af) & 1) acc = acc + (c == af ? 1.0f : 0.0f);
      M[af * W + c] = acc;
    }
    for (int e = lt; e < PU * X; e += 32) {
      const int af = e / X, z = e % X;
      const float* Bz = BiZ + af * X;
      float acc = Bz[0] * Am[z];
      for (int y = 1; y < X; ++y) acc = acc + Bz[y] * Am[y * X + z];
      M[af * W + PU + z] = acc;
    }
    if (lt < PU) {
      const int af = lt, i = af / U, a = af % U;
      float acc = Bm[af] * zeta[i * X];
      for (int xx = 1; xx < X; ++xx)
        acc = acc + Bm[xx * PU + af] * zeta[i * X + xx];
      M[af * W + PU + X] = acc + r[(i * P + i) * U + a];
    }
    __syncwarp();

    // Gershgorin column regularization (adds 0 off the diagonal, as the
    // plain version's diag_embed does).
    if (adaptive) {
      if (lt < PU) {
        const int c = lt;
        float colsum = fabsf(M[c]);
        for (int rr = 1; rr < PU; ++rr)
          colsum = colsum + fabsf(M[rr * W + c]);
        const float d = M[c * W + c];
        const float radius = colsum - fabsf(d);
        bump[c] = (d - radius < MIN_GERSHGORIN_EVAL)
                      ? radius + MIN_GERSHGORIN_EVAL : 0.0f;
      }
      __syncwarp();
      for (int e = lt; e < PU * PU; e += 32) {
        const int rr = e / PU, c = e % PU;
        M[rr * W + c] = M[rr * W + c] + (c == rr ? bump[rr] : 0.0f);
      }
      __syncwarp();
    }

    // LU with partial pivoting on the augmented rows. The pivot is the
    // first row attaining the NaN-propagating column max (row k on NaN).
#pragma unroll
    for (int k = 0; k < PU; ++k) {
      const bool mine = lt >= k && lt < PU;
      const float v = mine ? fabsf(M[lt * W + k]) : 0.0f;
      float m = v;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, o));
      const unsigned hit = __ballot_sync(0xffffffffu, mine && v >= m);
      const int p = hit ? __ffs(hit) - 1 : k;
      if (p != k) {
        for (int c = lt; c < W; c += 32) {
          const float tmp = M[k * W + c];
          M[k * W + c] = M[p * W + c];
          M[p * W + c] = tmp;
        }
      }
      __syncwarp();
      // Rows below k, columns right of k. This step writes nothing it
      // reads (row k and column k stay), and what it leaves in column k
      // below the pivot is never read again.
      const int nc = W - 1 - k;
      const float inv = 1.0f / M[k * W + k];
      for (int e = lt; e < (PU - 1 - k) * nc; e += 32) {
        const int rr = k + 1 + e / nc, c = k + 1 + e % nc;
        const float f = M[rr * W + k] * inv;
        M[rr * W + c] = M[rr * W + c] - f * M[k * W + c];
      }
      __syncwarp();
    }

    // Back-substitution, one thread per right-hand side.
    if (lt < XA) {
      const int c = lt;
      for (int k = PU - 1; k >= 0; --k) {
        float acc = M[k * W + PU + c];
        for (int j = k + 1; j < PU; ++j)
          acc = acc - M[k * W + j] * Xs[j * XA + c];
        Xs[k * XA + c] = acc / M[k * W + k];
      }
    }
    __syncwarp();

    // Closed-loop transition F and drift beta.
    for (int e = lt; e < X * X; e += 32) {
      const int rr = e / X, z = e % X;
      float f = Am[e];
      for (int af = 0; af < PU; ++af)
        f = f - Bm[rr * PU + af] * Xs[af * XA + z];
      F[e] = f;
    }
    if (lt < X) {
      float acc = -(Bm[lt * PU] * Xs[X]);
      for (int af = 1; af < PU; ++af)
        acc = acc - Bm[lt * PU + af] * Xs[af * XA + X];
      beta[lt] = acc;
    }
    __syncwarp();

    // What the value updates read: T_i = Z_i F, w_i = zeta_i + Z_i beta,
    // coef_i = R_i alpha - r_i, and R_i P once per (i, j, a) row.
    // T in tiles: per four knots of y, a float4 of each held row of Z and
    // of the four rows of F; each entry still folds y in order. The folds
    // start from -0, the identity of IEEE addition (-0 + p == p for every
    // p), so the first step equals the plain version's bare product.
#pragma unroll 1
    for (int i0 = 0; i0 < P; i0 += PT) {
      // Player i0 + ii of this pass (past P in a short last pass: none).
      auto live = [&](int ii) {
        if constexpr (P % PT == 0) return true;
        else return i0 + ii < P;
      };
      Vec acc[PT][MR];
#pragma unroll
      for (int ii = 0; ii < PT; ++ii)
#pragma unroll
        for (int m = 0; m < MR; ++m) acc[ii][m] = splat(Vec{}, -0.0f);
#pragma unroll 1
      for (int y0 = 0; y0 < X; y0 += CW) {
        Vec fy[CW];
#pragma unroll
        for (int d = 0; d < CW; ++d) fy[d] = ldv(F + (y0 + d) * X + c0);
#pragma unroll
        for (int ii = 0; ii < PT; ++ii) {
          if (!live(ii)) continue;
#pragma unroll
          for (int m = 0; m < MR; ++m) {
            const Vec z = ldv(Z + ((i0 + ii) * X + row(m)) * X + y0);
#pragma unroll
            for (int d = 0; d < CW; ++d)
              acc[ii][m] = madd(acc[ii][m], comp(z, d), fy[d]);
          }
        }
      }
#pragma unroll
      for (int ii = 0; ii < PT; ++ii)
#pragma unroll
        for (int m = 0; m < MR; ++m)
          if (live(ii) && owns(m))
            stv(T + ((i0 + ii) * X + row(m)) * X + c0, acc[ii][m]);
    }
    for (int e = lt; e < PX; e += 32) {
      const float* Zr = Z + e * X;
      float acc = Zr[0] * beta[0];
      for (int y = 1; y < X; ++y) acc = acc + Zr[y] * beta[y];
      w[e] = zeta[e] + acc;
    }
    for (int e = lt; e < P * PU; e += 32) {
      const int j = (e % PU) / U;
      const float* Rrow = R + e * U;  // row (i, j, a) of R
      float Ra = Rrow[0] * Xs[j * U * XA + X];
      for (int v = 1; v < U; ++v) Ra = Ra + Rrow[v] * Xs[(j * U + v) * XA + X];
      coef[e] = Ra - r[e];
    }
    for (int e = lt; e < P * PU * X; e += 32) {
      const int row = e / X, c = e % X;  // row (i, j, a) of R
      const int j = (row % PU) / U;
      const float* Rrow = R + row * U;
      float acc = Rrow[0] * Xs[j * U * XA + c];
      for (int v = 1; v < U; ++v) acc = acc + Rrow[v] * Xs[(j * U + v) * XA + c];
      RP[e] = acc;
    }
    __syncwarp();

    // Value updates of all players.
    for (int e = lt; e < PX; e += 32) {
      const int i = e / X, z = e % X;
      const float* wi = w + i * X;
      float acc = F[z] * wi[0];
      for (int xx = 1; xx < X; ++xx) acc = acc + F[xx * X + z] * wi[xx];
      const float zn = acc + ls[e];
      float cross = 0.0f;
      for (int ja = 0; ja < PU; ++ja)
        cross = cross + Xs[ja * XA + z] * coef[i * PU + ja];
      zeta[e] = zn + cross;
    }
    // Z in the same tiles: row (i, a) of F^T T_i + Q_i + P^T R_i P, the
    // F column entries and the P rows shared across players.
#pragma unroll 1
    for (int i0 = 0; i0 < P; i0 += PZ) {
      auto live = [&](int ii) {
        if constexpr (P % PZ == 0) return true;
        else return i0 + ii < P;
      };
      Vec acc[PZ][MR], prp[PZ][MR];
#pragma unroll
      for (int ii = 0; ii < PZ; ++ii)
#pragma unroll
        for (int m = 0; m < MR; ++m) {
          acc[ii][m] = splat(Vec{}, -0.0f);
          prp[ii][m] = splat(Vec{}, 0.0f);
        }
#pragma unroll 1
      for (int xx = 0; xx < X; ++xx) {
        float fa[MR];
#pragma unroll
        for (int m = 0; m < MR; ++m) fa[m] = F[xx * X + row(m)];
#pragma unroll
        for (int ii = 0; ii < PZ; ++ii) {
          if (!live(ii)) continue;
          const Vec t = ldv(T + ((i0 + ii) * X + xx) * X + c0);
#pragma unroll
          for (int m = 0; m < MR; ++m)
            acc[ii][m] = madd(acc[ii][m], fa[m], t);
        }
      }
#pragma unroll 1
      for (int ja = 0; ja < PU; ++ja) {
        float pa[MR];
#pragma unroll
        for (int m = 0; m < MR; ++m) pa[m] = Xs[ja * XA + row(m)];
#pragma unroll
        for (int ii = 0; ii < PZ; ++ii) {
          if (!live(ii)) continue;
          const Vec rp = ldv(RP + ((i0 + ii) * PU + ja) * X + c0);
#pragma unroll
          for (int m = 0; m < MR; ++m)
            prp[ii][m] = madd(prp[ii][m], pa[m], rp);
        }
      }
#pragma unroll
      for (int ii = 0; ii < PZ; ++ii) {
#pragma unroll
        for (int m = 0; m < MR; ++m) {
          const int e = ((i0 + ii) * X + row(m)) * X + c0;
          if (live(ii) && owns(m))
            stv(Z + e, add2(acc[ii][m], ldv(Qs + e), prp[ii][m]));
        }
      }
    }
  }
  if (N >= 2) {
    __syncthreads();
    store_knot(sm, Ps, al, 0, b0, B, tid);
  }
}

// K3's lanes per block and its ring of staged knots.
constexpr int FG = LQ_FWD_G;      // lanes of a K3 block
constexpr int NT3 = X * FG;       // threads: one per (state row, lane)
constexpr int FSTAGES = 3;        // knots staged: the one folded, two in flight
constexpr int FV = 4;             // lanes per 16-byte copy (when aligned)
// One staged knot, lane-minor: A transposed [X(y)][X(row)][FG], Bf
// transposed [PU][X(row)][FG], alpha [PU][FG]. A thread (row, g) reads
// A[row][y] at (y X + row) FG + g, so that a warp's 32 threads (two rows
// of sixteen lanes) read 32 consecutive floats.
constexpr int F_A = 0;
constexpr int F_B = F_A + X * X * FG;
constexpr int F_AL = F_B + PU * X * FG;
constexpr int FKNOT = F_AL + PU * FG;
constexpr int F_DX = FSTAGES * FKNOT;  // dx [2][X][FG] after the ring
constexpr int FWD_SMEM = (F_DX + 2 * X * FG) * (int)sizeof(float);
static_assert(NT3 <= 1024, "K3 needs a thread per (state row, lane)");
static_assert(FG % FV == 0, "a block's lanes are whole 16-byte copies");
static_assert(FWD_SMEM <= MAX_SMEM, "a block may use 227 KB of shared memory");
static_assert(FWD_SMEM == LQ_FWD_SMEM,
              "ops/cuda/lq.py:forward_smem_bytes disagrees with the layout");

// Copy knot k's A, Bf and alpha of lanes b0 .. b0 + FG - 1 into `buf` by
// cp.async, V lanes a copy. Consecutive threads take consecutive lanes, so
// that the FG lanes of one element are one 64-byte read; lanes past B read
// the last V lanes.
template <int V>
__device__ __forceinline__ void fwd_copy(float* buf,
                                         const float* __restrict__ A,
                                         const float* __restrict__ Bf,
                                         const float* __restrict__ al,
                                         int k, int b0, int B, int tid) {
  constexpr int GV = FG / V;
  const long Bl = B;
  auto cp = [&](float* d, const float* s) {
    if constexpr (V == 4) cp_async16(d, s); else cp_async4(d, s);
  };
  for (int idx = tid; idx < X * X * GV; idx += NT3) {
    const int g = V * (idx % GV), row = (idx / GV) % X, y = idx / (X * GV);
    const int b = min(b0 + g, B - V);
    cp(buf + F_A + (y * X + row) * FG + g,
       A + (((long)k * X + row) * X + y) * Bl + b);
  }
  for (int idx = tid; idx < PU * X * GV; idx += NT3) {
    const int g = V * (idx % GV), row = (idx / GV) % X, af = idx / (X * GV);
    const int b = min(b0 + g, B - V);
    cp(buf + F_B + (af * X + row) * FG + g,
       Bf + (((long)k * X + row) * PU + af) * Bl + b);
  }
  for (int idx = tid; idx < PU * GV; idx += NT3) {
    const int g = V * (idx % GV), af = idx / GV;
    const int b = min(b0 + g, B - V);
    cp(buf + F_AL + af * FG + g, al + ((long)k * PU + af) * Bl + b);
  }
}

// Stage knot k as one commit group: 16-byte copies when `vec` (every
// lane group of four is 16-byte aligned, see lq_forward), else 4-byte
// copies.
__device__ __forceinline__ void fwd_stage(float* buf,
                                          const float* __restrict__ A,
                                          const float* __restrict__ Bf,
                                          const float* __restrict__ al,
                                          int k, int b0, int B, int tid,
                                          bool vec) {
  if (vec)
    fwd_copy<FV>(buf, A, Bf, al, k, b0, B, tid);
  else
    fwd_copy<1>(buf, A, Bf, al, k, b0, B, tid);
  cp_async_commit();
}

// K3: FG lanes per block, thread (row, g) computes state row `row` of lane
// b0 + g. dx lives in a double-buffered [2][X][FG] shared array; each
// knot's operands arrive through a ring of FSTAGES staged knots, so that
// FSTAGES - 1 knots of copies are in flight while a knot folds. One block
// barrier per knot: it makes knot k's copies and dx_k visible, and frees
// the ring slot and the dx buffer that knot k - 1 read.
// At x = 24 (384 threads a block) ptxas held K3 to 80 registers and
// spilled unless told that one block per SM is enough (its shared memory,
// 152,064 B, allows no second); the smaller x's keep their build.
#if LQ_X >= 24
#define K3_BOUNDS __launch_bounds__(NT3, 1)
#else
#define K3_BOUNDS __launch_bounds__(NT3)
#endif
__global__ void K3_BOUNDS lq_forward_kernel(
    const float* __restrict__ A, const float* __restrict__ Bf,
    const float* __restrict__ al, const float* __restrict__ dx0,
    float* __restrict__ dxs, int N, int B, bool vec) {
  extern __shared__ __align__(16) float fsm[];
  const int tid = threadIdx.x;
  const int g = tid % FG, row = tid / FG;
  const int b0 = blockIdx.x * FG;
  const bool live = b0 + g < B;
  const int b = min(b0 + g, B - 1);
  const long Bl = B;
  const int ns = N - 1;
  float* dx = fsm + F_DX;
  float own = dx0[row * Bl + b];  // this thread's row of dx_k
  dx[row * FG + g] = own;
  for (int s = 0; s < FSTAGES - 1; ++s) {
    if (s < ns) fwd_stage(fsm + s * FKNOT, A, Bf, al, s, b0, B, tid, vec);
    else cp_async_commit();
  }
  for (int k = 0; k < ns; ++k) {
    // Groups committed: knots 0 .. k + FSTAGES - 2; knot k's is done when
    // at most FSTAGES - 2 are pending.
    cp_async_wait<FSTAGES - 2>();
    __syncthreads();
    const int kn = k + FSTAGES - 1;
    if (kn < ns)
      fwd_stage(fsm + (kn % FSTAGES) * FKNOT, A, Bf, al, kn, b0, B, tid,
                vec);
    else
      cp_async_commit();
    const float* op = fsm + (k % FSTAGES) * FKNOT;
    const float* xc = dx + (k & 1) * X * FG + g;
    float acc = op[F_A + row * FG + g] * xc[0];
#pragma unroll
    for (int y = 1; y < X; ++y)
      acc = acc + op[F_A + (y * X + row) * FG + g] * xc[y * FG];
#pragma unroll
    for (int af = 0; af < PU; ++af)
      acc = acc - op[F_B + (af * X + row) * FG + g] * op[F_AL + af * FG + g];
    if (live) dxs[((long)k * X + row) * Bl + b] = own;
    own = acc;
    dx[((k + 1) & 1) * X * FG + row * FG + g] = acc;
  }
  if (live) dxs[((long)ns * X + row) * Bl + b] = own;
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
  static unsigned opted = 0;
  if (int rc = opt_in_smem((const void*)lq_backward_kernel, SMEM_BYTES,
                           opted))
    return rc;
  lq_backward_kernel<<<(B + G - 1) / G, NTB, SMEM_BYTES,
                       (cudaStream_t)stream>>>(A, Bf, Qf, lf, Rf, rf, Ps, al,
                                               N, B, pad_mask, adaptive);
  return (int)cudaGetLastError();
}

// A [N,X,X,B], Bf [N,X,PU,B], al [N-1,PU,B], dx0 [X,B] -> dxs [N,X,B].
// The operands are staged by 16-byte copies when B % 4 == 0 and A, Bf and
// al start on 16-byte boundaries (every row then starts on one), else by
// 4-byte copies.
int lq_forward(const float* A, const float* Bf, const float* al,
               const float* dx0, float* dxs, int N, int B, void* stream) {
  static unsigned opted = 0;
  if (int rc = opt_in_smem((const void*)lq_forward_kernel, FWD_SMEM, opted))
    return rc;
  const bool vec = B % FV == 0 &&
                   (((size_t)A | (size_t)Bf | (size_t)al) & 15) == 0;
  lq_forward_kernel<<<(B + FG - 1) / FG, NT3, FWD_SMEM,
                      (cudaStream_t)stream>>>(A, Bf, al, dx0, dxs, N, B,
                                              vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
