// Probe kernels for Hopper (sm_90a): P1, P2 and P3, the H100 counterparts of
// the JAX package's TPU probes under tools/ (kernel_floor.py,
// sweep_floor5*.py, kernel_profile6i.py, profile_components.py). Those were
// written to find where a rollout kernel's time goes; here they measure the
// same ladder on the card, from the floor of one RK4 step up to the shipped
// rollout kernels K4 and K5 (sweep.cu).
//
// P1 fma_chain_kernel (tools/kernel_floor.py:63, case fma50): every element
//   of x [16, B] runs N steps of 50 dependent x = x * 1.000001f + 0.000001f.
//   Built with --fmad=false, each step is a separate multiply and add, so
//   it is a floor of dependent float32 latency, not of FMA issue.
// P2 probe_rollout_kernel<...> (the RK4 cases of kernel_floor.py and the
//   rungs of sweep_floor5*.py): one thread per (candidate, lane), like K4's
//   and K5's designs before one warp per subsystem, with the rollout of
//   rollout.cuh and compile-time switches that each add one feature of the
//   shipped kernels:
//     LAYOUT  the flagship's subsystem table as compile-time constants
//             (FlagshipTable: every state index can resolve) or passed at
//             run time, as K4 and K5 took it before (offsets index the
//             state at run time)
//     LAW     fixed u [PU, B]; the floor law u = -P delta - alpha; the
//             kernel_floor probe's u = P delta + alpha; the production law
//             of K4 and K5 (rollout.cuh control_law)
//     LANE_T  t = t0[b] + k dt per lane, or the probes' scalar t = 0.1
//     EMIT    none, xs [N, X, C, B], or xs and us [N, PU, C, B]
//     MERIT   none; the CostTable's squared stage gradients
//             (costs.cuh gradient_sq, K5's per-player content); or raw
//             terms with compile-time indices: the three nominal speeds
//             (100 (x[v] - v_nom))^2 or x[6]^2
//     GATE    multiply each player's state term by gate [N, P, B]
//     K0      how knot 0's state term is dropped: select (k > 0 ? s : 0),
//             hoist (knot 0 peeled out of the loop), multiply (s * (k > 0))
//     ACC     the merit in a register, or read and written in device memory
//             every knot (volatile, so each access stays)
//   Every rung writes the final state xf [X, C, B], so nothing is dead.
//   The fold is merit = merit + (ctrl + state') with state' per K0; hoist
//   starts from merit = ctrl at knot 0. The rungs instantiated are the
//   PROBE_RUNGS list below (ops/cuda/probes.py:RUNGS names them).
// P3 smoke_kernel (tools/profile_components.py:101): o = x * 2 + 1.
//
// Each kernel repeats its plain PyTorch version (ops/cuda/probes.py)
// operation by operation, with FMA contraction off.
//
// What bounds them on this card: P1 and P2 at the probes' shapes run
// 128-1024 threads (or 26 x 128) on 132 SMs, each a dependent chain over
// the knots; bytes are a few MB at most. They are bound by one thread's
// latency chain, which is what they measure. P3 moves 256 KB.

#include <cuda_runtime.h>

#include "rollout.cuh"

#if !defined(PB_X) || !defined(PB_PU) || !defined(PB_U)
#error "build with -DPB_X=<xdim> -DPB_PU=<players*umax> -DPB_U=<umax>"
#endif

extern "C" {

// The operands of one P2 launch, filled by ops/cuda/probes.py. Pointers a
// rung does not read may be null.
struct ProbeOperands {
  const float* x0;    // [X, C, B]
  const float* xs;    // [N, X, B] reference states
  const float* us;    // [N, PU, B] reference controls
  const float* Ps;    // [N, PU, X, B]
  const float* al;    // [N, PU, B]
  const float* ufix;  // [PU, B] (LAW fixed u)
  const float* t0;    // [B]
  const float* scal;  // [C, B]
  const float* gate;  // [N, P, B]
  const float* lamS;  // [N, nS, B], null when nS = 0
  const float* mu;    // [B]
  const float* segs;  // polyline segments of the CostTable
  float* xf_out;      // [X, C, B]
  float* xs_out;      // [N, X, C, B]
  float* us_out;      // [N, PU, C, B]
  float* merit_out;   // [C, B]
  int N, C, B, nS, umask_bits;
  float dt, h;
  SubsysTable tab;
  CostTable cost;
};

}  // extern "C"

namespace {

constexpr int X = PB_X;
constexpr int PU = PB_PU;
constexpr int U = PB_U;
constexpr int P = PU / U;
constexpr int BLOCK = 128;
constexpr int FMA_CHAIN = 50;

enum { LAYOUT_STATIC = 0, LAYOUT_TABLE = 1 };
enum { LAW_FIXED_U = 0, LAW_FLOOR = 1, LAW_PLUS = 2, LAW_PROD = 3 };
enum { EMIT_NONE = 0, EMIT_XS = 1, EMIT_XS_US = 2 };
enum { MERIT_NONE = 0, MERIT_TABLE = 1, MERIT_RAW_NOMV = 2, MERIT_RAW_X6 = 3 };
enum { K0_SELECT = 0, K0_HOIST = 1, K0_MULT = 2 };
enum { ACC_REG = 0, ACC_GLOBAL = 1 };

// The flagship's three subsystems (two car_6d with inter-axle length 4, one
// unicycle_4d), as ops/cuda/sweep.py:_device_table builds them, with every
// entry a compile-time constant (P2's static layout; the wrapper refuses it
// for any other game).
struct FlagshipTable {
  static constexpr int n = 3;
  struct Kind {
    __device__ int operator[](int s) const {
      return s < 2 ? costs::KIND_CAR_6D : costs::KIND_UNICYCLE_4D;
    }
  } kind;
  struct XOff {
    __device__ int operator[](int s) const { return 6 * s; }
  } xoff;
  struct UOff {
    __device__ int operator[](int s) const { return U * s; }
  } uoff;
  struct Length {
    __device__ float operator[](int s) const { return s < 2 ? 4.0f : 0.0f; }
  } length;
};

__global__ void fma_chain_kernel(const float* __restrict__ x,
                                 float* __restrict__ o, long n, int steps) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = x[i];
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int j = 0; j < FMA_CHAIN; ++j) v = v * 1.000001f + 0.000001f;
  }
  o[i] = v;
}

__global__ void smoke_kernel(const float* __restrict__ x,
                             float* __restrict__ o, long n) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = x[i] * 2.0f + 1.0f;
}

template <int LAYOUT, int LAW, bool LANE_T, int EMIT, int MERIT, bool GATE,
          int K0, int ACC>
__global__ void probe_rollout_kernel(
    const float* __restrict__ x0, const float* __restrict__ xs,
    const float* __restrict__ us, const float* __restrict__ Ps,
    const float* __restrict__ al, const float* __restrict__ ufix,
    const float* __restrict__ t0, const float* __restrict__ scal,
    const float* __restrict__ gate, const float* __restrict__ lamS,
    const float* __restrict__ mu, const float* __restrict__ segs,
    float* __restrict__ xf_out, float* __restrict__ xs_out,
    float* __restrict__ us_out, float* merit_out, int N, int C, int B,
    int nS, int umask_bits, float dt, float h, SubsysTable rt_tab,
    const __grid_constant__ CostTable cost) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)C * B) return;
  const int c = (int)(idx / B);
  const int b = (int)(idx % B);
  const long Bl = B, Cl = C;
  const float sc = scal[idx];
  float x[X], u[PU], uf[PU];
  for (int r = 0; r < X; ++r) x[r] = x0[((long)r * Cl + c) * Bl + b];
  if (LAW == LAW_FIXED_U)
    for (int af = 0; af < PU; ++af) uf[af] = ufix[af * Bl + b];
  const float mu_b = (MERIT == MERIT_TABLE) ? mu[b] : 0.0f;
  float merit = 0.0f;
  volatile float* macc =
      (MERIT != MERIT_NONE && ACC == ACC_GLOBAL) ? merit_out + idx : nullptr;
  if (MERIT != MERIT_NONE && ACC == ACC_GLOBAL) *macc = 0.0f;

  auto run = [&](const auto& tab) {
    auto knot = [&](int k) {
      if (EMIT != EMIT_NONE)
        for (int r = 0; r < X; ++r)
          xs_out[(((long)k * X + r) * Cl + c) * Bl + b] = x[r];
      if (LAW == LAW_PROD) {
        rollout::control_law<X, PU>(xs, us, Ps, al, k, b, Bl, sc, umask_bits,
                                    x, u);
      } else if (LAW == LAW_FIXED_U) {
        for (int af = 0; af < PU; ++af) u[af] = uf[af];
      } else {
        float delta[X];
        for (int r = 0; r < X; ++r)
          delta[r] = x[r] - xs[((long)k * X + r) * Bl + b];
        for (int af = 0; af < PU; ++af) {
          const float* Pk = Ps + (((long)k * PU + af) * X) * Bl + b;
          float acc = Pk[0] * delta[0];
          for (int xx = 1; xx < X; ++xx) acc = acc + Pk[xx * Bl] * delta[xx];
          const float a = al[((long)k * PU + af) * Bl + b];
          u[af] = (LAW == LAW_PLUS) ? acc + a : -acc - a;
        }
      }
      if (EMIT == EMIT_XS_US)
        for (int af = 0; af < PU; ++af)
          us_out[(((long)k * PU + af) * Cl + c) * Bl + b] = u[af];
      if (MERIT != MERIT_NONE) {
        float ctrl = 0.0f, state = 0.0f;
        if (MERIT == MERIT_TABLE) {
          auto lam = [&](int row) {
            return lamS[((long)k * nS + row) * Bl + b];
          };
          for (int i = 0; i < P; ++i) {
            float s, r;
            costs::gradient_sq<X, U>(cost, segs, i, x, u, lam, mu_b,
                                     t0[b] + (float)k * dt, s, r);
            if (GATE) s = s * gate[((long)k * P + i) * Bl + b];
            state = (i == 0) ? s : state + s;
            ctrl = (i == 0) ? r : ctrl + r;
          }
        } else if (MERIT == MERIT_RAW_NOMV) {
          // The flagship's nominal-speed gradients, players left to right.
          const float g0 = 100.0f * (x[4] - 8.0f);
          const float g1 = 100.0f * (x[10] - 5.0f);
          const float g2 = 100.0f * (x[15] - 1.5f);
          state = (g0 * g0 + g1 * g1) + g2 * g2;
        } else if (MERIT == MERIT_RAW_X6) {
          state = x[6] * x[6];
        }
        const float cur = (ACC == ACC_GLOBAL) ? *macc : merit;
        float next;
        if (K0 == K0_HOIST)
          next = (k == 0) ? ctrl : cur + (ctrl + state);
        else if (K0 == K0_MULT)
          next = cur + (ctrl + state * ((k > 0) ? 1.0f : 0.0f));
        else
          next = cur + (ctrl + ((k > 0) ? state : 0.0f));
        if (ACC == ACC_GLOBAL)
          *macc = next;
        else
          merit = next;
      }
      const float t = LANE_T ? t0[b] + (float)k * dt : 0.1f;
      rollout::integrate<X>(tab, t, h, x, u);
    };
    if (K0 == K0_HOIST && MERIT != MERIT_NONE) {
      knot(0);
      for (int k = 1; k < N; ++k) knot(k);
    } else {
      for (int k = 0; k < N; ++k) knot(k);
    }
  };
  if constexpr (LAYOUT == LAYOUT_STATIC)
    run(FlagshipTable{});
  else
    run(rt_tab);

  for (int r = 0; r < X; ++r) xf_out[((long)r * Cl + c) * Bl + b] = x[r];
  if (MERIT != MERIT_NONE && ACC == ACC_REG) merit_out[idx] = merit;
}

// The instantiated rungs: id, LAYOUT, LAW, LANE_T, EMIT, MERIT, GATE, K0,
// ACC. ops/cuda/probes.py:RUNGS holds the same list by name (a test checks
// that the two agree).
#define PROBE_RUNGS(R)                                                  \
  R(0, STATIC, FIXED_U, 0, NONE, NONE, 0, SELECT, REG)                  \
  R(1, STATIC, PLUS, 0, NONE, NONE, 0, SELECT, REG)                     \
  R(2, STATIC, FLOOR, 0, NONE, NONE, 0, SELECT, REG)                    \
  R(3, STATIC, PROD, 0, NONE, NONE, 0, SELECT, REG)                     \
  R(4, TABLE, PROD, 0, NONE, NONE, 0, SELECT, REG)                      \
  R(5, TABLE, PROD, 1, NONE, NONE, 0, SELECT, REG)                      \
  R(6, TABLE, PROD, 1, XS, NONE, 0, SELECT, REG)                        \
  R(7, TABLE, PROD, 1, XS_US, NONE, 0, SELECT, REG)                     \
  R(8, TABLE, PROD, 1, NONE, RAW_NOMV, 0, SELECT, GLOBAL)               \
  R(9, TABLE, PROD, 1, NONE, RAW_X6, 0, SELECT, GLOBAL)                 \
  R(10, TABLE, PROD, 1, NONE, TABLE, 1, SELECT, GLOBAL)                 \
  R(11, TABLE, PROD, 1, NONE, TABLE, 1, SELECT, REG)                    \
  R(12, TABLE, PROD, 1, NONE, TABLE, 0, SELECT, GLOBAL)                 \
  R(13, TABLE, PROD, 1, NONE, TABLE, 1, HOIST, GLOBAL)                  \
  R(14, TABLE, PROD, 1, NONE, TABLE, 0, HOIST, GLOBAL)                  \
  R(15, TABLE, PROD, 1, NONE, TABLE, 1, MULT, GLOBAL)

}  // namespace

extern "C" {

// P1: o[i] = x[i] after `steps` x 50 dependent multiply-adds, n elements.
int probe_fma_chain(const float* x, float* o, long n, int steps,
                    void* stream) {
  const int grid = (int)((n + BLOCK - 1) / BLOCK);
  fma_chain_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(x, o, n, steps);
  return (int)cudaGetLastError();
}

// P3: o = x * 2 + 1 over n elements.
int probe_smoke(const float* x, float* o, long n, void* stream) {
  const int grid = (int)((n + BLOCK - 1) / BLOCK);
  smoke_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(x, o, n);
  return (int)cudaGetLastError();
}

// P2: launch rung `rung` of PROBE_RUNGS on the operands `op`; returns
// cudaErrorInvalidValue for an unknown rung.
int probe_rollout(int rung, const ProbeOperands* op, void* stream) {
  const long total = (long)op->C * op->B;
  const int grid = (int)((total + BLOCK - 1) / BLOCK);
#define PROBE_LAUNCH(ID, LAY, LW, LT, EM, ME, GT, KZ, AC)                \
  case ID:                                                                 \
    probe_rollout_kernel<LAYOUT_##LAY, LAW_##LW, (LT) != 0, EMIT_##EM,     \
                         MERIT_##ME, (GT) != 0, K0_##KZ, ACC_##AC>         \
        <<<grid, BLOCK, 0, (cudaStream_t)stream>>>(                        \
            op->x0, op->xs, op->us, op->Ps, op->al, op->ufix, op->t0,      \
            op->scal, op->gate, op->lamS, op->mu, op->segs, op->xf_out,    \
            op->xs_out, op->us_out, op->merit_out, op->N, op->C, op->B,    \
            op->nS, op->umask_bits, op->dt, op->h, op->tab, op->cost);     \
    break;
  switch (rung) {
    PROBE_RUNGS(PROBE_LAUNCH)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PROBE_LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"
