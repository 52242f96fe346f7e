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
// (costs.cuh: gradient_sq, player_cost.stage_gradient_sq_tuple) summed over
// players left to right. The result is the raw merit [C, B] (callers apply
// the 0.5). The fold is merit_plain's and K5's, operation by operation,
// built without FMA contraction. The atoms ported are time-invariant, so
// the knot times are not formed.
//
// Design: one thread per (candidate, lane), a loop over the knots, the
// running merit in a register; neighbouring lanes read neighbouring
// addresses of every [.., C, B] row.
//
// What bounds it on this card: reading the trajectories, (X + PU) floats
// per knot per thread, 8.8 KB per (candidate, lane) at N=100: ~9 MB at
// C=1, B=1024 (~3 us at 3.35 TB/s). At these sizes there are only C*B
// threads (8 to 16 blocks of 128 on 132 SMs), so it is bound by
// one thread's chain over the knots (three polyline queries, six
// proximity terms, a correctly rounded sqrt per proximity term) rather
// than by bandwidth.

#include <cuda_runtime.h>

#include "costs.cuh"

#if !defined(MR_X) || !defined(MR_P) || !defined(MR_U)
#error "build with -DMR_X=<xdim> -DMR_P=<players> -DMR_U=<umax>"
#endif

namespace {

constexpr int X = MR_X;
constexpr int P = MR_P;
constexpr int U = MR_U;
constexpr int PU = P * U;

__global__ void merit_kernel(const float* __restrict__ xs,
                             const float* __restrict__ us,
                             const float* __restrict__ lamS, int nS,
                             const float* __restrict__ mu,
                             const float* __restrict__ segs,
                             float* __restrict__ merit_out, int N, int C,
                             int B, const __grid_constant__ CostTable cost) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)C * B) return;
  const int c = (int)(idx / B);
  const int b = (int)(idx % B);
  const long Bl = B, Cl = C;
  const float mu_b = mu[b];
  float x[X], u[PU];
  float merit = 0.0f;
  for (int k = 0; k < N; ++k) {
    for (int r = 0; r < X; ++r) x[r] = xs[(((long)k * X + r) * Cl + c) * Bl + b];
    for (int a = 0; a < PU; ++a)
      u[a] = us[(((long)k * PU + a) * Cl + c) * Bl + b];
    auto lam = [&](int row) { return lamS[((long)k * nS + row) * Bl + b]; };
    float ctrl_term, state_term;
    costs::merit_terms<X, P, U>(cost, segs, x, u, lam, mu_b, ctrl_term,
                                state_term);
    merit = (k == 0) ? ctrl_term : merit + (ctrl_term + state_term);
  }
  merit_out[idx] = merit;
}

constexpr int BLOCK = 128;

}  // namespace

extern "C" {

// xs [N,X,C,B], us [N,PU,C,B], lamS [N,nS,B] (null when nS = 0), mu [B],
// segs [*, 7] -> raw merits merit_out [C,B].
int merit_consumer(const float* xs, const float* us, const float* lamS,
                   int nS, const float* mu, const float* segs,
                   float* merit_out, int N, int C, int B, CostTable cost,
                   void* stream) {
  const long total = (long)C * B;
  const int grid = (int)((total + BLOCK - 1) / BLOCK);
  merit_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      xs, us, lamS, nS, mu, segs, merit_out, N, C, B, cost);
  return (int)cudaGetLastError();
}

}  // extern "C"
