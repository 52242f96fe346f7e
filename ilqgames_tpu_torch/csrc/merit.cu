// Merit consumer for Hopper (sm_90a): K6.
//
// Replaces the Pallas kernel
// ilqgames_tpu/ops/pallas/sweep.py:_make_merit_consumer_kernel (launched by
// _pallas_merits, merit_backend="pallas"). From the emitted candidate
// trajectories xs [N, X, C, B] (K4) and their controls us [N, PU, C, B]
// (rebuilt by ops/cuda/sweep.py:_us_from_xs) it folds, per candidate and
// lane, each knot's merit increment over the knots in ascending order:
//   merit = ctrl[0], then merit = merit + (ctrl[k] + state[k]) for k >= 1,
// where state[k] and ctrl[k] are the players' squared stage-gradient sums
// (costs.cuh: gradient_sq_into, player_cost.stage_gradient_sq_tuple) summed
// over players left to right. The result is the raw merit [C, B] (callers
// apply the 0.5). The fold is merit_plain's and K5's, operation by
// operation, built without FMA contraction. The atoms see each lane's
// absolute knot time t0[b] + k dt, as in the JAX package's merit consumer
// (ops/pallas/sweep.py:435).
//
// What bounds it on this card: the bytes are few (the trajectories once,
// (X + PU) floats per knot and chain: ~9 MB at C=1, B=2048, ~3 us at 3.35
// TB/s) and so are the operations (~670 per knot and chain). What is long
// is one knot's chain of dependent operations: three players' polyline
// queries and six proximity terms, each with a correctly rounded sqrt. One
// thread per chain looping over the knots would run N such chains in a row
// on C * B threads: 8 to 16 blocks of 128 on 132 SMs at the main path's
// shapes.
//
// Design: a knot's terms depend only on that knot's rows, so every
// (knot, chain) item is its own thread; only the fold over the knots is
// serial. A block takes LANES consecutive chains and all N knots: a warp's
// 32 threads are 32 / LANES knots of those chains, so each row of xs and
// us is read in LANES-float runs. A thread stages its knot's state in its
// own column of its warp's [X][32] shared array and accumulates the state
// gradient in another (costs::Column, ColumnGradAcc; built with CT_NORMS, a
// third column takes the dense atoms' gradient), its controls in
// registers read by selects (Selected, SelectGradAcc), so no register
// array is indexed at run time and nothing goes on the stack. It writes
// its knot's (state, ctrl) pair, summed over the players left to right, to
// the block's [N][2][LANES] shared array; after one barrier a thread per
// chain folds its N pairs in ascending k. The block's warps cover the
// items in as few passes of at most MAX_WARPS warps as they can: at N=100,
// one pass of 25 warps.
//
// Built with CT_REACH (the reachability games), K6 also reads the control
// constraints' multipliers lamC [N, nC, B] and, when the game has a MAX or
// MIN player, the extremal gate [N, P, B], which multiplies each player's squared state gradient before
// the players' sum (ops/cuda/sweep.py: merit_plain).
//
// LANES and MAX_WARPS were chosen on the card among blocks of 2, 4, 8, 16
// or 32 chains, of 8 to 32 warps at most, and with each player's terms in
// a thread of its own: eight chains in one pass of up to 32 warps was the
// fastest at C=8, B=128, the deep rounds' shape, and within 6% of the
// fastest at C=1, B=2048 (PERF.md, section 6).

#include <cuda_runtime.h>

#include "costs.cuh"
#include "smem.cuh"

#if !defined(MR_X) || !defined(MR_P) || !defined(MR_U)
#error "build with -DMR_X=<xdim> -DMR_P=<players> -DMR_U=<umax>"
#endif

namespace {

constexpr int X = MR_X;
constexpr int P = MR_P;
constexpr int U = MR_U;
constexpr int PU = P * U;
constexpr int WARP = 32;
constexpr int LANES = 8;       // chains per block
constexpr int MAX_WARPS = 32;  // warps per block at most
// [X][32] shared columns per warp: the state and the state gradient, and
// the dense atoms' gradient where the library has them.
constexpr int COLUMNS = CT_NORMS ? 3 : 2;
static_assert(WARP % LANES == 0, "a warp holds whole knots of the chains");

__global__ void __launch_bounds__(MAX_WARPS * WARP)
    merit_kernel(const float* __restrict__ xs, const float* __restrict__ us,
                 const float* __restrict__ t0,
                 const float* __restrict__ lamS, int nS,
                 const float* __restrict__ lamC, int nC,
                 const float* __restrict__ gate,
                 const float* __restrict__ mu, const float* __restrict__ segs,
                 float* __restrict__ merit_out, int N, int C, int B, float dt,
                 const __grid_constant__ CostTable cost) {
  extern __shared__ float smem[];
  const int nw = blockDim.x / WARP;
  const int w = threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  float* state = smem + w * X * WARP + lane;         // [nw][X][32]
  float* grad = smem + (nw + w) * X * WARP + lane;   // [nw][X][32]
#if CT_NORMS
  float* dgrad = smem + (2 * nw + w) * X * WARP + lane;  // [nw][X][32]
#endif
  float* terms = smem + COLUMNS * nw * X * WARP;     // [N][2][LANES]
  const long CB = (long)C * B;
  for (int it = threadIdx.x; it < LANES * N; it += blockDim.x) {
    const int j = it % LANES;
    const int k = it / LANES;
    const long idx = (long)blockIdx.x * LANES + j;
    if (idx >= CB) continue;
    const int b = (int)(idx % B);
    for (int r = 0; r < X; ++r)
      state[WARP * r] = xs[((long)k * X + r) * CB + idx];
    float u[PU];
#pragma unroll
    for (int a = 0; a < PU; ++a) u[a] = us[((long)k * PU + a) * CB + idx];
    auto lam = [&](int row) { return lamS[((long)k * nS + row) * B + b]; };
    auto lamc = [&](int row) { return lamC[((long)k * nC + row) * B + b]; };
    const float mu_b = mu[b];
    const float t = t0[b] + (float)k * dt;
    costs::ColumnGradAcc<X> gs{grad};
#if CT_NORMS
    costs::ColumnGradAcc<X> gd{dgrad};
#else
    costs::NoAcc gd;
#endif
    costs::SelectGradAcc<U> gu;
    float st = 0.0f, ct = 0.0f;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      float s_sq, r_sq;
      costs::gradient_sq_into<X, U>(cost, segs, i, costs::Column{state}, gs,
                                    gd, costs::Selected<U>{u + i * U}, gu,
                                    lam, lamc, mu_b, t, s_sq, r_sq);
#if CT_REACH
      if (gate != nullptr) s_sq = s_sq * gate[((long)k * P + i) * B + b];
#endif
      st = (i == 0) ? s_sq : st + s_sq;
      ct = (i == 0) ? r_sq : ct + r_sq;
    }
    terms[2 * k * LANES + j] = st;
    terms[(2 * k + 1) * LANES + j] = ct;
  }
  __syncthreads();
  if (threadIdx.x < LANES) {
    const int j = threadIdx.x;
    const long idx = (long)blockIdx.x * LANES + j;
    if (idx < CB) {
      float merit = terms[LANES + j];
      for (int k = 1; k < N; ++k)
        merit = merit + (terms[(2 * k + 1) * LANES + j] +
                         terms[2 * k * LANES + j]);
      merit_out[idx] = merit;
    }
  }
}

}  // namespace

extern "C" {

// xs [N,X,C,B], us [N,PU,C,B], t0 [B], lamS [N,nS,B] (null when nS = 0),
// lamC [N,nC,B] (null when nC = 0) and gate [N,P,B] (null: no MAX or MIN
// player; both read only with CT_REACH), mu [B], segs (cost_table.py) ->
// raw merits merit_out [C,B]. The block's shared memory grows with N (the opt-in is to the most a block may use);
// a launch that does not fit returns its error.
int merit_consumer(const float* xs, const float* us, const float* t0,
                   const float* lamS, int nS, const float* lamC, int nC,
                   const float* gate, const float* mu, const float* segs,
                   float* merit_out, int N, int C, int B, float dt,
                   CostTable cost, void* stream) {
  static unsigned opted = 0;
  const long total = (long)C * B;
  if (total == 0 || N == 0) return 0;
  if (int rc = opt_in_smem((const void*)merit_kernel, MAX_SMEM, opted))
    return rc;
  // The block's LANES * N items in the fewest passes of at most MAX_WARPS
  // warps, spread evenly over the passes.
  const int needed = (LANES * N + WARP - 1) / WARP;
  const int passes = (needed + MAX_WARPS - 1) / MAX_WARPS;
  const int nw = (needed + passes - 1) / passes;
  const size_t bytes =
      (COLUMNS * (size_t)nw * X * WARP + 2 * (size_t)N * LANES) *
      sizeof(float);
  merit_kernel<<<(int)((total + LANES - 1) / LANES), nw * WARP, bytes,
                 (cudaStream_t)stream>>>(xs, us, t0, lamS, nS, lamC, nC, gate,
                                         mu, segs, merit_out, N, C, B, dt,
                                         cost);
  return (int)cudaGetLastError();
}

}  // extern "C"
