// Candidate rollout for Hopper (sm_90a): K4, and the rollout with in-kernel
// merit: K5.
//
// K4 replaces the Pallas kernel ilqgames_tpu/ops/pallas/sweep.py:_make_kernel
// in its emitting modes (compute_merit=False, emit_traj="xs" or True),
// launched there through `_run`. For every candidate step size c and lane
// b it rolls the joint dynamics forward over the N knots under
//   u = (u_ref - P (x - x_ref) - scal[c, b] * alpha) * mask
// (left fold over the state index), one RK4 step with 2 substeps per knot,
// and emits the states [N, X, C, B] and, on request, the controls
// [N, PU, C, B]. The merit of each candidate is then computed from the
// emitted trajectories (ops/cuda/sweep.py: merit_plain, or K6 in merit.cu).
//
// K5 replaces the same Pallas kernel with compute_merit=True
// (merit_backend="kernel"): K4's rollout, with each knot's merit increment
// (the players' squared stage-gradient sums of costs.cuh, control terms
// always, state terms for k > 0) accumulated in registers in ascending k;
// it emits only the raw merits [C, B]. Its fold is K6's and merit_plain's.
//
// Dynamics: the device functions of rollout.cuh for car_6d and unicycle_4d
// (ilqgames_tpu/dynamics/models.py:80-175), chosen per subsystem by a small
// table (kind, state offset, control offset, inter-axle length) passed by
// value. Time is t = t0 + k*dt in float32 (unused by these two models).
// sin, cos and tan are the port's own float32 routines (fmath.cuh), which
// round exactly as ilqgames_tpu_torch/fmath.py does in PyTorch on the CPU
// and on the card: CUDA's sinf and the CPU's sin differ in the last bit,
// and along the diverged tail of a batch that difference grows until it
// flips linesearch decisions between the card and the CPU.
//
// Design: one thread per (candidate, lane), the state in registers or
// thread-local memory, so each candidate's arithmetic runs on one code
// path. The arithmetic follows the plain PyTorch versions
// (ops/cuda/sweep.py: rollout_plain, _us_from_xs, merit_plain) operation by
// operation, with FMA contraction off (--fmad=false).
//
// What bounds it on this card: per knot a thread reads ~130 floats of
// operands (x_ref, u_ref, P, alpha) shared by the C candidates of its lane
// and K4 writes X (+ PU) floats; the RK4 step is ~8 evaluations of the
// ODE's sin/cos/tan, and K5 adds the cost gradients (three polyline queries
// and six proximity terms per knot). At C=1, B=1024 that is 1024 threads
// (8 blocks of 128) on 132 SMs, so the card is mostly idle and the kernel
// is bound by one thread's dependent-latency chain over 100 knots; at
// C=8, B=128 likewise.

#include <cuda_runtime.h>

#include "rollout.cuh"

#if !defined(SW_X) || !defined(SW_PU) || !defined(SW_U)
#error "build with -DSW_X=<xdim> -DSW_PU=<players*umax> -DSW_U=<umax>"
#endif

namespace {

constexpr int X = SW_X;
constexpr int PU = SW_PU;
constexpr int U = SW_U;
constexpr int P = PU / U;

__global__ void rollout_kernel(
    const float* __restrict__ x0, const float* __restrict__ xs,
    const float* __restrict__ us, const float* __restrict__ Ps,
    const float* __restrict__ al, const float* __restrict__ t0,
    const float* __restrict__ scal, float* __restrict__ xs_out,
    float* __restrict__ us_out, int N, int C, int B, float dt, float h,
    int umask_bits, SubsysTable tab) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)C * B) return;
  const int c = (int)(idx / B);
  const int b = (int)(idx % B);
  const long Bl = B, Cl = C;
  const float sc = scal[idx];
  float x[X], u[PU];
  for (int r = 0; r < X; ++r) x[r] = x0[r * Bl + b];
  for (int k = 0; k < N; ++k) {
    for (int r = 0; r < X; ++r)
      xs_out[(((long)k * X + r) * Cl + c) * Bl + b] = x[r];
    rollout::control_law<X, PU>(xs, us, Ps, al, k, b, Bl, sc, umask_bits, x,
                                u);
    if (us_out)
      for (int af = 0; af < PU; ++af)
        us_out[(((long)k * PU + af) * Cl + c) * Bl + b] = u[af];
    const float t = t0[b] + (float)k * dt;
    rollout::integrate<X>(tab, t, h, x, u);
  }
}

__global__ void rollout_merit_kernel(
    const float* __restrict__ x0, const float* __restrict__ xs,
    const float* __restrict__ us, const float* __restrict__ Ps,
    const float* __restrict__ al, const float* __restrict__ t0,
    const float* __restrict__ scal, const float* __restrict__ lamS, int nS,
    const float* __restrict__ mu, const float* __restrict__ segs,
    float* __restrict__ merit_out, int N, int C, int B, float dt, float h,
    int umask_bits, const __grid_constant__ SubsysTable tab,
    const __grid_constant__ CostTable cost) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)C * B) return;
  const int b = (int)(idx % B);
  const long Bl = B;
  const float sc = scal[idx];
  const float mu_b = mu[b];
  float x[X], u[PU];
  for (int r = 0; r < X; ++r) x[r] = x0[r * Bl + b];
  float merit = 0.0f;
  for (int k = 0; k < N; ++k) {
    rollout::control_law<X, PU>(xs, us, Ps, al, k, b, Bl, sc, umask_bits, x,
                                u);
    auto lam = [&](int row) { return lamS[((long)k * nS + row) * Bl + b]; };
    float ctrl_term, state_term;
    costs::merit_terms<X, P, U>(cost, segs, x, u, lam, mu_b, ctrl_term,
                                state_term);
    merit = (k == 0) ? ctrl_term : merit + (ctrl_term + state_term);
    const float t = t0[b] + (float)k * dt;
    rollout::integrate<X>(tab, t, h, x, u);
  }
  merit_out[idx] = merit;
}

constexpr int BLOCK = 128;

}  // namespace

extern "C" {

// x0 [X,B], xs [N,X,B], us [N,PU,B], Ps [N,PU,X,B], al [N,PU,B], t0 [B],
// scal [C,B] -> xs_out [N,X,C,B] and, when us_out is not null,
// us_out [N,PU,C,B]. h = dt / 2. Bit af of umask_bits marks a real control.
int sweep_rollout(const float* x0, const float* xs, const float* us,
                  const float* Ps, const float* al, const float* t0,
                  const float* scal, float* xs_out, float* us_out, int N,
                  int C, int B, float dt, float h, int umask_bits,
                  SubsysTable tab, void* stream) {
  const long total = (long)C * B;
  const int grid = (int)((total + BLOCK - 1) / BLOCK);
  rollout_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      x0, xs, us, Ps, al, t0, scal, xs_out, us_out, N, C, B, dt, h,
      umask_bits, tab);
  return (int)cudaGetLastError();
}

// K5: as sweep_rollout, plus lamS [N,nS,B] (null when nS = 0), mu [B] and
// the cost table -> raw merits merit_out [C,B]; emits no trajectory.
int sweep_rollout_merit(const float* x0, const float* xs, const float* us,
                        const float* Ps, const float* al, const float* t0,
                        const float* scal, const float* lamS, int nS,
                        const float* mu, const float* segs, float* merit_out,
                        int N, int C, int B, float dt, float h, int umask_bits,
                        SubsysTable tab, CostTable cost, void* stream) {
  const long total = (long)C * B;
  const int grid = (int)((total + BLOCK - 1) / BLOCK);
  rollout_merit_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      x0, xs, us, Ps, al, t0, scal, lamS, nS, mu, segs, merit_out, N, C, B,
      dt, h, umask_bits, tab, cost);
  return (int)cudaGetLastError();
}

}  // extern "C"
