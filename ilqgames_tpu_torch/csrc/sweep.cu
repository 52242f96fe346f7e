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
// (merit_backend="kernel"): the same rollout, with each knot's merit
// increment (the players' squared stage-gradient sums of costs.cuh, control
// terms always, state terms for k > 0) folded over the players left to
// right and then over the knots in ascending k; it emits only the raw
// merits [C, B]. Its fold is K6's and merit_plain's.
//
// Dynamics: car_6d, unicycle_4d, car_5d and dubins_car
// (ilqgames_tpu/dynamics/models.py:47-175), the coupled systems
// two_player_unicycle_4d and air_3d (:215-275; one subsystem that both
// players drive) and the constant-linear systems of the two-player point
// mass (ilqgames_tpu/examples/two_player_point_mass.py:31-35; one subsystem
// that both players drive) and of the flat systems
// (ilqgames_tpu/dynamics/flat.py:177-237; one subsystem per player) through
// the device functions of rollout.cuh, chosen per subsystem. The library is
// built for one game's layout of subsystems (kind, state offset, control
// offset, first and second parameter, rows and control rows each, and a
// linear system's terms), given as defines by
// ops/cuda/sweep.py:library: K4 and K5 read it as compile-time constants
// (Sub<S> and LinTerms below). The run-time SubsysTable they are handed is
// only checked against it.
// sin, cos and tan are the port's own float32 routines (fmath.cuh), which
// round exactly as ilqgames_tpu_torch/fmath.py does in PyTorch on the CPU
// and on the card: CUDA's sinf and the CPU's sin differ in the last bit,
// and along the diverged tail of a batch that difference grows until it
// flips linesearch decisions between the card and the CPU. The arithmetic
// follows the plain PyTorch versions (ops/cuda/sweep.py: rollout_plain,
// _us_from_xs, merit_plain) operation by operation, with FMA contraction
// off (--fmad=false).
//
// What bounds K4 on this card: one chain (candidate, lane) is 100 knots of
// an RK4 step, ~3,000 dependent-latency float32 operations each, and the
// main path launches 1,024-2,048 chains: throughput and bytes are far
// below the card's, the chain's latency is the bound. K4's design cuts the
// chain: one warp per subsystem (rollout_warp_kernel). A block holds 32
// chains, consecutive lanes b across a warp's threads, times S warps; warp
// s computes its player's control rows, stores its rows of xs and us
// (coalesced over b) and integrates its subsystem. The subsystems meet once
// per knot, in a double-buffered state [2][X][32] in shared memory and one
// barrier: each warp reads the whole state for the control law. The chain
// per knot is then the longest subsystem's RK4 (a car_6d: 3 of the 8 trig
// calls of each joint ODE evaluation) plus the barrier.
//
// K5 (rollout_merit_warp_kernel) is K4's design, with the merit split over
// the same warps. Player i's terms need the whole state x_k, player i's
// controls u_k and the knot's time t0[b] + k dt, and warp s computes the
// controls of the players whose rows its subsystem reads (one player for a
// model or a flat system's block, every player for a coupled system or a
// linear system in one subsystem; the library refuses a game
// where a player's rows are not within exactly one subsystem's). So within
// knot k each warp, after its control rows, computes its players'
// (state_sq, ctrl_sq) and writes them to a double-buffered [2][P][2][32]
// shared array; after the knot's barrier warp 0 folds the players' terms
// left to right and adds them to the merit it keeps in a register. x_k is read from the shared state, which knot k + 1
// overwrites, so each knot's terms are computed within it. The CostTable's
// indices are run-time values: the state is read from shared memory and
// the state gradient accumulated in a per-warp [X][32] shared array, so
// that no register array is indexed at run time (which would put it on the
// stack). The chain per knot is then the slowest warp's RK4 plus its own
// player's terms, where one thread per chain would run all three players'
// terms after the joint RK4. The CostTable is a kernel parameter: in
// constant or shared memory ptxas spilled K5. Built with CT_REACH (the
// reachability games), K5 also reads the control constraints'
// multipliers lamC [N, nC, B] and, when the game has a MAX or MIN player,
// the extremal gate [N, P, B], which multiplies each player's squared state
// gradient at each knot before the players' fold (ops/cuda/sweep.py:
// merit_plain); it computes a knot's terms after the knot's integration
// (from the knot's state, which the integration does not overwrite), so
// that the state rows are not live beside them.

#include <cuda_runtime.h>

#include "rollout.cuh"

#if !defined(SW_X) || !defined(SW_PU) || !defined(SW_U) || !defined(SW_NSUB)
#error "build with -DSW_X -DSW_PU -DSW_U and the layout defines of ops/cuda/sweep.py:library"
#endif

namespace {

constexpr int X = SW_X;
constexpr int PU = SW_PU;
constexpr int U = SW_U;
constexpr int P = PU / U;
constexpr int WARP = 32;

// The game's subsystems: each list define is SW_ITEM(v) per subsystem.
constexpr int NSUB = SW_NSUB;
#define SW_ITEM(v) v,
constexpr int SUB_KIND[] = {SW_SUB_KIND};
constexpr int SUB_XOFF[] = {SW_SUB_XOFF};
constexpr int SUB_UOFF[] = {SW_SUB_UOFF};
constexpr float SUB_LENGTH[] = {SW_SUB_LENGTH};
constexpr float SUB_PARAM2[] = {SW_SUB_PARAM2};
constexpr int SUB_DIM[] = {SW_SUB_DIM};
constexpr int SUB_UROWS[] = {SW_SUB_UROWS};
#undef SW_ITEM
static_assert(NSUB >= 1 && NSUB <= costs::MAX_SUBSYS &&
                  sizeof(SUB_KIND) == NSUB * sizeof(int) &&
                  sizeof(SUB_XOFF) == NSUB * sizeof(int) &&
                  sizeof(SUB_UOFF) == NSUB * sizeof(int) &&
                  sizeof(SUB_LENGTH) == NSUB * sizeof(float) &&
                  sizeof(SUB_PARAM2) == NSUB * sizeof(float) &&
                  sizeof(SUB_DIM) == NSUB * sizeof(int) &&
                  sizeof(SUB_UROWS) == NSUB * sizeof(int),
              "one SW_ITEM per subsystem in each layout define");

// A linear system's terms (SW_NLIN, SW_LIN_ROW, SW_LIN_SRC, SW_LIN_COEF:
// one SW_ITEM per term; SW_LIN_ZERO: its rows fold from x * 0), or none.
#ifdef SW_NLIN
#define SW_ITEM(v) v,
struct LinTerms {
  static constexpr int n = SW_NLIN;
  static constexpr int row[] = {SW_LIN_ROW};
  static constexpr int src[] = {SW_LIN_SRC};
  static constexpr float coef[] = {SW_LIN_COEF};
  static constexpr bool zero_start = SW_LIN_ZERO;
};
#undef SW_ITEM
static_assert(sizeof(LinTerms::row) == SW_NLIN * sizeof(int) &&
                  sizeof(LinTerms::src) == SW_NLIN * sizeof(int) &&
                  sizeof(LinTerms::coef) == SW_NLIN * sizeof(float),
              "one SW_ITEM per term in each linear define");
#else
using LinTerms = rollout::NoLin;
#endif

// Subsystem S's entries, as compile-time constants: its parameters, its
// state rows, and the control rows it computes and reads (its player's;
// every player's for a coupled system or a linear system in one
// subsystem).
template <int S>
struct Sub {
  static constexpr int kind = SUB_KIND[S];
  static constexpr int xoff = SUB_XOFF[S];
  static constexpr int uoff = SUB_UOFF[S];
  static constexpr float length = SUB_LENGTH[S];
  static constexpr float param2 = SUB_PARAM2[S];
  static constexpr int dim = SUB_DIM[S];
  static constexpr int urows = SUB_UROWS[S];
  static_assert(kind == costs::KIND_LINEAR || dim == rollout::kind_dim<kind>,
                "a model's rows are its kind's");
};

// K4's and K5's launch bounds: a block of one warp per subsystem; with
// SW_MIN_BLOCKS (ops/cuda/sweep.py:library, a layout with a car_5d or a
// dubins_car, of more than 16 states, or a library with CT_ZOO), also the
// least blocks per SM, which lifts ptxas's register target: without it
// ptxas held the reachability game's K4 to 56 registers and
// dubins_origin's K5 to 48, and both spilled.
#ifdef SW_MIN_BLOCKS
#define SW_BOUNDS __launch_bounds__(WARP * NSUB, SW_MIN_BLOCKS)
#else
#define SW_BOUNDS __launch_bounds__(WARP * NSUB)
#endif

// f(Sub<s>{}) for a subsystem index s known at run time: a chain of
// branches, uniform across a warp in K4 (s is the warp's index).
template <int S = 0, typename F>
__device__ __forceinline__ auto on_sub(int s, F f) {
  if constexpr (S + 1 < NSUB)
    return s == S ? f(Sub<S>{}) : on_sub<S + 1>(s, f);
  else
    return f(Sub<S>{});
}

// K4: warp s of a block integrates subsystem s of the block's 32 chains.
// Tail threads (chain index >= C * B) compute on the last chain and store
// nothing to device memory, so every thread reaches every barrier.
__global__ void SW_BOUNDS rollout_warp_kernel(
    const float* __restrict__ x0, const float* __restrict__ xs,
    const float* __restrict__ us, const float* __restrict__ Ps,
    const float* __restrict__ al, const float* __restrict__ scal,
    float* __restrict__ xs_out, float* __restrict__ us_out, int N, int C,
    int B, float h, int umask_bits) {
  __shared__ float state[2][X][WARP];
  const int lane = threadIdx.x % WARP;
  const int w = threadIdx.x / WARP;
  const long total = (long)C * B;
  const long idx_raw = (long)blockIdx.x * WARP + lane;
  const bool live = idx_raw < total;
  const long idx = live ? idx_raw : total - 1;
  const int c = (int)(idx / B);
  const int b = (int)(idx % B);
  const long Bl = B, Cl = C;
  const float sc = scal[idx];
  on_sub(w, [&](auto q) {
    using S = decltype(q);
    for (int j = 0; j < S::dim; ++j)
      state[0][S::xoff + j][lane] = x0[(S::xoff + j) * Bl + b];
  });
  __syncthreads();
  for (int k = 0; k < N; ++k) {
    const int cur = k & 1;
    float x[X];
    for (int r = 0; r < X; ++r) x[r] = state[cur][r][lane];
    on_sub(w, [&](auto q) {
      using S = decltype(q);
      constexpr int O = S::xoff, Q = S::uoff, D = S::dim, UR = S::urows;
      float u[UR];
      rollout::control_rows<X, PU, Q, UR>(xs, us, Ps, al, k, b, Bl, sc,
                                          umask_bits, x, u);
      if (live) {
        for (int j = 0; j < D; ++j)
          xs_out[(((long)k * X + O + j) * Cl + c) * Bl + b] = x[O + j];
        if (us_out)
          for (int a = 0; a < UR; ++a)
            us_out[(((long)k * PU + Q + a) * Cl + c) * Bl + b] = u[a];
      }
      float xo[D];
      for (int j = 0; j < D; ++j) xo[j] = x[O + j];
      rollout::sub_integrate<S::kind, D, X, LinTerms, O, Q>(
          S::length, S::param2, h, xo, u);
      for (int j = 0; j < D; ++j) state[cur ^ 1][O + j][lane] = xo[j];
    });
    __syncthreads();
  }
}

// K5: K4's warps, each also computing the merit terms of the players whose
// controls it computes, from the knot's state in shared memory, at the
// lane's time t0[b] + k dt. Warp 0 folds the players' terms of a knot
// after the knot's barrier.
__global__ void SW_BOUNDS rollout_merit_warp_kernel(
    const float* __restrict__ x0, const float* __restrict__ xs,
    const float* __restrict__ us, const float* __restrict__ Ps,
    const float* __restrict__ al, const float* __restrict__ t0,
    const float* __restrict__ scal, const float* __restrict__ lamS, int nS,
    const float* __restrict__ lamC, int nC, const float* __restrict__ gate,
    const float* __restrict__ mu, const float* __restrict__ segs,
    float* __restrict__ merit_out, int N, int C, int B, float dt, float h,
    int umask_bits, const __grid_constant__ CostTable cost) {
  __shared__ float state[2][X][WARP];
  __shared__ float grad[NSUB][X][WARP];    // each warp's state gradient
#if CT_NORMS
  __shared__ float dgrad[NSUB][X][WARP];   // and its dense atoms'
#endif
  __shared__ float terms[2][P][2][WARP];   // (state_sq, ctrl_sq) per player
  const int lane = threadIdx.x % WARP;
  const int w = threadIdx.x / WARP;
  const long total = (long)C * B;
  const long idx_raw = (long)blockIdx.x * WARP + lane;
  const bool live = idx_raw < total;
  const long idx = live ? idx_raw : total - 1;
  const int b = (int)(idx % B);
  const long Bl = B;
  const float sc = scal[idx];
  const float mu_b = mu[b];
  const float t0_b = t0[b];
  on_sub(w, [&](auto q) {
    using S = decltype(q);
    for (int j = 0; j < S::dim; ++j)
      state[0][S::xoff + j][lane] = x0[(S::xoff + j) * Bl + b];
  });
  __syncthreads();
  // Knot kt's merit increment, players folded left to right (warp 0).
  float merit = 0.0f;
  auto fold = [&](int kt) {
    const int t = kt & 1;
    float st = terms[t][0][0][lane], ct = terms[t][0][1][lane];
    for (int i = 1; i < P; ++i) {
      st = st + terms[t][i][0][lane];
      ct = ct + terms[t][i][1][lane];
    }
    merit = (kt == 0) ? ct : merit + (ct + st);
  };
  for (int k = 0; k < N; ++k) {
    const int cur = k & 1;
    if (w == 0 && k > 0) fold(k - 1);
    float x[X];
    for (int r = 0; r < X; ++r) x[r] = state[cur][r][lane];
    on_sub(w, [&](auto q) {
      using S = decltype(q);
      constexpr int O = S::xoff, Q = S::uoff, D = S::dim, UR = S::urows;
      float u[UR];
      rollout::control_rows<X, PU, Q, UR>(xs, us, Ps, al, k, b, Bl, sc,
                                          umask_bits, x, u);
      auto lam = [&](int row) { return lamS[((long)k * nS + row) * Bl + b]; };
      auto lamc = [&](int row) { return lamC[((long)k * nC + row) * Bl + b]; };
      const float t = t0_b + (float)k * dt;
      auto knot_terms = [&]() {
#pragma unroll
      for (int ii = 0; ii < UR / U; ++ii) {
        const int I = Q / U + ii;
        costs::ColumnGradAcc<X> gs{&grad[w][0][lane]};
#if CT_NORMS
        costs::ColumnGradAcc<X> gd{&dgrad[w][0][lane]};
#else
        costs::NoAcc gd;
#endif
        costs::SelectGradAcc<U> gu;
        float s_sq, r_sq;
        costs::gradient_sq_into<X, U>(
            cost, segs, I, costs::Column{&state[cur][0][lane]}, gs, gd,
            costs::Selected<U>{u + ii * U}, gu, lam, lamc, mu_b, t, s_sq,
            r_sq);
#if CT_REACH
        if (gate != nullptr) s_sq = s_sq * gate[((long)k * P + I) * Bl + b];
#endif
        terms[cur][I][0][lane] = s_sq;
        terms[cur][I][1][lane] = r_sq;
      }
      };
#if !CT_REACH
      knot_terms();
#endif
      float xo[D];
      for (int j = 0; j < D; ++j) xo[j] = x[O + j];
      rollout::sub_integrate<S::kind, D, X, LinTerms, O, Q>(
          S::length, S::param2, h, xo, u);
      for (int j = 0; j < D; ++j) state[cur ^ 1][O + j][lane] = xo[j];
#if CT_REACH
      knot_terms();
#endif
    });
    __syncthreads();
  }
  if (w == 0) {
    fold(N - 1);
    if (live) merit_out[idx] = merit;
  }
}

// Whether the run-time table describes the layout this library was built
// for.
bool matches_layout(const SubsysTable& tab) {
  if (tab.n != NSUB) return false;
  for (int s = 0; s < NSUB; ++s)
    if (tab.kind[s] != SUB_KIND[s] || tab.xoff[s] != SUB_XOFF[s] ||
        tab.uoff[s] != SUB_UOFF[s] || tab.length[s] != SUB_LENGTH[s] ||
        tab.param2[s] != SUB_PARAM2[s])
      return false;
  return true;
}

}  // namespace

extern "C" {

// x0 [X,B], xs [N,X,B], us [N,PU,B], Ps [N,PU,X,B], al [N,PU,B], t0 [B],
// scal [C,B] -> xs_out [N,X,C,B] and, when us_out is not null,
// us_out [N,PU,C,B]. h = dt / 2. Bit af of umask_bits marks a real control.
// Returns cudaErrorInvalidValue when `tab` is not the built layout. The
// models are time-invariant, so K4 reads no t0.
int sweep_rollout(const float* x0, const float* xs, const float* us,
                  const float* Ps, const float* al, const float* t0,
                  const float* scal, float* xs_out, float* us_out, int N,
                  int C, int B, float dt, float h, int umask_bits,
                  SubsysTable tab, void* stream) {
  if (!matches_layout(tab)) return (int)cudaErrorInvalidValue;
  const long total = (long)C * B;
  if (total == 0) return 0;
  const int grid = (int)((total + WARP - 1) / WARP);
  rollout_warp_kernel<<<grid, WARP * NSUB, 0, (cudaStream_t)stream>>>(
      x0, xs, us, Ps, al, scal, xs_out, us_out, N, C, B, h, umask_bits);
  return (int)cudaGetLastError();
}

// K5: as sweep_rollout, plus lamS [N,nS,B] (null when nS = 0), lamC
// [N,nC,B] (null when nC = 0) and gate [N,P,B] (null: no MAX or MIN player;
// both read only with CT_REACH), mu [B] and the cost table -> raw merits
// merit_out [C,B]; emits no trajectory. The atoms see each lane's time
// t0[b] + k dt (final_time reads it).
int sweep_rollout_merit(const float* x0, const float* xs, const float* us,
                        const float* Ps, const float* al, const float* t0,
                        const float* scal, const float* lamS, int nS,
                        const float* lamC, int nC, const float* gate,
                        const float* mu, const float* segs, float* merit_out,
                        int N, int C, int B, float dt, float h, int umask_bits,
                        SubsysTable tab, CostTable cost, void* stream) {
  if (!matches_layout(tab)) return (int)cudaErrorInvalidValue;
  const long total = (long)C * B;
  if (total == 0) return 0;
  const int grid = (int)((total + WARP - 1) / WARP);
  rollout_merit_warp_kernel<<<grid, WARP * NSUB, 0, (cudaStream_t)stream>>>(
      x0, xs, us, Ps, al, t0, scal, lamS, nS, lamC, nC, gate, mu, segs,
      merit_out, N, C, B, dt, h, umask_bits, cost);
  return (int)cudaGetLastError();
}

}  // extern "C"
