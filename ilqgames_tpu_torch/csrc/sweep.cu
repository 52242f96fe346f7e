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
// Dynamics: device functions for car_6d and unicycle_4d
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

#include "costs.cuh"

#if !defined(SW_X) || !defined(SW_PU) || !defined(SW_U)
#error "build with -DSW_X=<xdim> -DSW_PU=<players*umax> -DSW_U=<umax>"
#endif

namespace {

constexpr int X = SW_X;
constexpr int PU = SW_PU;
constexpr int U = SW_U;
constexpr int P = PU / U;
using costs::KIND_CAR_6D;
using costs::KIND_UNICYCLE_4D;

// The flagship's models are time-invariant: `t` is accepted for the
// interface and unused.
__device__ void ode(const SubsysTable& tab, float t, const float* x,
                    const float* u, float* dx) {
  for (int s = 0; s < tab.n; ++s) {
    const int o = tab.xoff[s];
    const int q = tab.uoff[s];
    if (tab.kind[s] == KIND_CAR_6D) {
      dx[o + 0] = x[o + 4] * fmath::cos(x[o + 2]);
      dx[o + 1] = x[o + 4] * fmath::sin(x[o + 2]);
      dx[o + 2] = (x[o + 4] / tab.length[s]) * fmath::tan(x[o + 3]);
      dx[o + 3] = u[q + 0];
      dx[o + 4] = x[o + 5];
      dx[o + 5] = u[q + 1];
    } else if (tab.kind[s] == KIND_UNICYCLE_4D) {
      dx[o + 0] = x[o + 3] * fmath::cos(x[o + 2]);
      dx[o + 1] = x[o + 3] * fmath::sin(x[o + 2]);
      dx[o + 2] = u[q + 0];
      dx[o + 3] = u[q + 1];
    }
  }
}

// One zero-order-hold step from time t: RK4 with 2 substeps of h = dt / 2.
__device__ void integrate(const SubsysTable& tab, float t, float h, float* x,
                          const float* u) {
  float k1[X], k2[X], k3[X], k4[X], tmp[X];
  for (int sub = 0; sub < 2; ++sub) {
    const float ts = t + (float)sub * h;
    ode(tab, ts, x, u, k1);
    for (int r = 0; r < X; ++r) { k1[r] = h * k1[r]; tmp[r] = x[r] + 0.5f * k1[r]; }
    ode(tab, ts + 0.5f * h, tmp, u, k2);
    for (int r = 0; r < X; ++r) { k2[r] = h * k2[r]; tmp[r] = x[r] + 0.5f * k2[r]; }
    ode(tab, ts + 0.5f * h, tmp, u, k3);
    for (int r = 0; r < X; ++r) { k3[r] = h * k3[r]; tmp[r] = x[r] + k3[r]; }
    ode(tab, ts + h, tmp, u, k4);
    for (int r = 0; r < X; ++r) {
      k4[r] = h * k4[r];
      x[r] = x[r] + (k1[r] + 2.0f * (k2[r] + k3[r]) + k4[r]) / 6.0f;
    }
  }
}

// The control law at knot k: u = ((u_ref - P delta) - sc * alpha) * mask,
// with P delta a left fold over the state index.
__device__ __forceinline__ void control_law(
    const float* __restrict__ xs, const float* __restrict__ us,
    const float* __restrict__ Ps, const float* __restrict__ al, int k, int b,
    long Bl, float sc, int umask_bits, const float* x, float* u) {
  float delta[X];
  for (int r = 0; r < X; ++r) delta[r] = x[r] - xs[((long)k * X + r) * Bl + b];
  for (int af = 0; af < PU; ++af) {
    const float* Pk = Ps + (((long)k * PU + af) * X) * Bl + b;
    float acc = Pk[0] * delta[0];
    for (int xx = 1; xx < X; ++xx) acc = acc + Pk[xx * Bl] * delta[xx];
    const long ka = ((long)k * PU + af) * Bl + b;
    const float row = (us[ka] - acc) - sc * al[ka];
    u[af] = row * (((umask_bits >> af) & 1) ? 1.0f : 0.0f);
  }
}

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
    control_law(xs, us, Ps, al, k, b, Bl, sc, umask_bits, x, u);
    if (us_out)
      for (int af = 0; af < PU; ++af)
        us_out[(((long)k * PU + af) * Cl + c) * Bl + b] = u[af];
    const float t = t0[b] + (float)k * dt;
    integrate(tab, t, h, x, u);
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
    control_law(xs, us, Ps, al, k, b, Bl, sc, umask_bits, x, u);
    auto lam = [&](int row) { return lamS[((long)k * nS + row) * Bl + b]; };
    float ctrl_term, state_term;
    costs::merit_terms<X, P, U>(cost, segs, x, u, lam, mu_b, ctrl_term,
                                state_term);
    merit = (k == 0) ? ctrl_term : merit + (ctrl_term + state_term);
    const float t = t0[b] + (float)k * dt;
    integrate(tab, t, h, x, u);
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
