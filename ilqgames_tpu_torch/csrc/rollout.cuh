// The rollout's dynamics, shared by the candidate rollout K4 and the rollout
// with in-kernel merit K5 (sweep.cu) and by the probe rollout P2
// (probes.cu): the joint ODE of the flagship's models, one RK4 step with 2
// substeps, and the affine control law. K4 and K5 also run car_5d (the
// reachability game's model), dubins_car (dubins_origin's) and the coupled
// systems two_player_unicycle_4d and air_3d in `sub_ode`. Each repeats its plain PyTorch version operation by operation
// (built with FMA contraction off).
//
// P2's one thread per chain takes the models from a table of subsystems
// (kind, state offset, control offset, inter-axle length each): a
// SubsysTable passed at run time, whose offsets index the thread's state
// arrays at run time; or a type whose entries are compile-time constants
// (probes.cu FlagshipTable), so that every index resolves.
//
// K4's and K5's warp design (sweep.cu) integrates each subsystem in its own
// warp: `sub_ode`, `sub_integrate` and `control_rows` below are `ode`,
// `integrate` and `control_law` restricted to one subsystem's state rows
// and the control rows it reads (its player's, or every player's for a
// coupled system or a linear system in one subsystem). A coupled system
// is one subsystem over the whole state whose rows read several players'
// controls. The joint field is block-diagonal and
// every RK4 and control-row operation is elementwise or a per-row fold, so
// the restriction computes the same operations in the same order. A linear
// system's field (dynamics/base.py:linear) is its compile-time terms, a
// type Lin with static constexpr n, row[], src[] (a state index, or X plus
// a control row), coef[] and zero_start, folded per row in term order. It
// runs as one subsystem over the whole state that reads every control row,
// or (a flat system) as one subsystem per player over its own rows, reading
// its own states and controls: a subsystem at state offset O with D rows
// and control offset Q takes the terms of rows O .. O+D-1, with their state
// sources less O and control rows less Q.

#pragma once

#include "costs.cuh"

// Internal linkage, as when these lived in sweep.cu's anonymous namespace:
// each kernel library is one translation unit.
namespace {
namespace rollout {

using costs::KIND_CAR_5D;
using costs::KIND_CAR_6D;
using costs::KIND_LINEAR;
using costs::KIND_DUBINS;
using costs::KIND_UNICYCLE_4D;
using costs::KIND_TWO_UNICYCLE;
using costs::KIND_AIR_3D;

// The flagship's models are time-invariant: `t` is accepted for the
// interface and unused.
template <typename Tab>
__device__ void ode(const Tab& tab, float t, const float* x, const float* u,
                    float* dx) {
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
template <int X, typename Tab>
__device__ void integrate(const Tab& tab, float t, float h, float* x,
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
template <int X, int PU>
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

// State dimension of a model kind.
template <int KIND>
constexpr int kind_dim = KIND == KIND_CAR_6D   ? 6
                        : KIND == KIND_CAR_5D ? 5
                        : KIND == KIND_DUBINS ? 3
                        : KIND == KIND_AIR_3D ? 3
                                              : 4;

// The term list of a game with no linear system.
struct NoLin {
  static constexpr int n = 0;
  static constexpr int row[1] = {0};
  static constexpr int src[1] = {0};
  static constexpr float coef[1] = {0.0f};
  static constexpr bool zero_start = false;
};

// Whether term e of Lin is the first of its row.
template <typename Lin>
__host__ __device__ constexpr bool first_in_row(int e) {
  for (int j = 0; j < e; ++j)
    if (Lin::row[j] == Lin::row[e]) return false;
  return true;
}

// The rows O .. O+D-1 of a linear system, its terms unrolled at compile
// time (x: those rows' states, u: control rows Q on). Each row folds its
// terms left to right: the first setting it and a coefficient of 1 taking
// the value bare; or, with Lin::zero_start, from the row's x * 0 (set by
// the caller) with every coefficient multiplied.
template <int X, int O, int D, int Q, typename Lin, int E = 0>
__device__ __forceinline__ void linear_terms(const float* x, const float* u,
                                             float* dx) {
  if constexpr (E < Lin::n) {
    constexpr int row = Lin::row[E], q = Lin::src[E];
    if constexpr (row >= O && row < O + D) {
      constexpr int r = row - O;
      constexpr float c = Lin::coef[E];
      float v;
      if constexpr (q < X) v = x[q - O]; else v = u[q - X - Q];
      if constexpr (Lin::zero_start) {
        dx[r] = dx[r] + c * v;
      } else {
        float term;
        if constexpr (c == 1.0f) term = v; else term = c * v;
        if constexpr (first_in_row<Lin>(E)) dx[r] = term;
        else dx[r] = dx[r] + term;
      }
    }
    linear_terms<X, O, D, Q, Lin, E + 1>(x, u, dx);
  }
}

// `ode` for one subsystem of kind KIND with D states from state offset O,
// reading control rows from Q: x [D] its state, u the control rows it
// reads, `length` and `param2` the model's parameters. Time-invariant, so
// it takes no t.
template <int KIND, int D, int X, typename Lin, int O = 0, int Q = 0>
__device__ __forceinline__ void sub_ode(float length, float param2,
                                        const float* x, const float* u,
                                        float* dx) {
  static_assert(KIND == KIND_CAR_6D || KIND == KIND_UNICYCLE_4D ||
                    KIND == KIND_LINEAR || KIND == KIND_CAR_5D ||
                    KIND == KIND_DUBINS || KIND == KIND_TWO_UNICYCLE ||
                    KIND == KIND_AIR_3D,
                "no device ODE for this model kind");
  if constexpr (KIND == KIND_LINEAR) {
    // A row without terms is 0 (x * 0 with zero_start); the others fold
    // their terms.
#pragma unroll
    for (int r = 0; r < D; ++r)
      dx[r] = Lin::zero_start ? x[r] * 0.0f : 0.0f;
    linear_terms<X, O, D, Q, Lin>(x, u, dx);
  } else if constexpr (KIND == KIND_CAR_6D) {
    dx[0] = x[4] * fmath::cos(x[2]);
    dx[1] = x[4] * fmath::sin(x[2]);
    dx[2] = (x[4] / length) * fmath::tan(x[3]);
    dx[3] = u[0];
    dx[4] = x[5];
    dx[5] = u[1];
  } else if constexpr (KIND == KIND_CAR_5D) {
    dx[0] = x[4] * fmath::cos(x[2]);
    dx[1] = x[4] * fmath::sin(x[2]);
    dx[2] = (x[4] / length) * fmath::tan(x[3]);
    dx[3] = u[0];
    dx[4] = u[1];
  } else if constexpr (KIND == KIND_DUBINS) {
    // `length` is the car's speed.
    dx[0] = length * fmath::cos(x[2]);
    dx[1] = length * fmath::sin(x[2]);
    dx[2] = u[0];
  } else if constexpr (KIND == KIND_TWO_UNICYCLE) {
    // P1's [omega a] in u[0..1], P2's velocity disturbance in u[2..3].
    dx[0] = x[3] * fmath::cos(x[2]) + u[2];
    dx[1] = x[3] * fmath::sin(x[2]) + u[3];
    dx[2] = u[0];
    dx[3] = u[1];
  } else if constexpr (KIND == KIND_AIR_3D) {
    // `length` and `param2` are the evader's and the pursuer's speeds; u
    // the two turn rates.
    const float w1 = u[0];
    dx[0] = (-length + param2 * fmath::cos(x[2])) + w1 * x[1];
    dx[1] = param2 * fmath::sin(x[2]) - w1 * x[0];
    dx[2] = u[1] - w1;
  } else {
    dx[0] = x[3] * fmath::cos(x[2]);
    dx[1] = x[3] * fmath::sin(x[2]);
    dx[2] = u[0];
    dx[3] = u[1];
  }
}

// `integrate` for one subsystem: RK4 with 2 substeps of h on its D states.
template <int KIND, int D = kind_dim<KIND>, int X = 0, typename Lin = NoLin,
          int O = 0, int Q = 0>
__device__ __forceinline__ void sub_integrate(float length, float param2,
                                              float h, float* x,
                                              const float* u) {
  float k1[D], k2[D], k3[D], k4[D], tmp[D];
  for (int sub = 0; sub < 2; ++sub) {
    sub_ode<KIND, D, X, Lin, O, Q>(length, param2, x, u, k1);
    for (int r = 0; r < D; ++r) { k1[r] = h * k1[r]; tmp[r] = x[r] + 0.5f * k1[r]; }
    sub_ode<KIND, D, X, Lin, O, Q>(length, param2, tmp, u, k2);
    for (int r = 0; r < D; ++r) { k2[r] = h * k2[r]; tmp[r] = x[r] + 0.5f * k2[r]; }
    sub_ode<KIND, D, X, Lin, O, Q>(length, param2, tmp, u, k3);
    for (int r = 0; r < D; ++r) { k3[r] = h * k3[r]; tmp[r] = x[r] + k3[r]; }
    sub_ode<KIND, D, X, Lin, O, Q>(length, param2, tmp, u, k4);
    for (int r = 0; r < D; ++r) {
      k4[r] = h * k4[r];
      x[r] = x[r] + (k1[r] + 2.0f * (k2[r] + k3[r]) + k4[r]) / 6.0f;
    }
  }
}

// `control_law` for the U control rows Q .. Q+U-1 of PU (one player's, or
// all of them) at knot k, from the whole state x [X]: u [U].
template <int X, int PU, int Q, int U>
__device__ __forceinline__ void control_rows(
    const float* __restrict__ xs, const float* __restrict__ us,
    const float* __restrict__ Ps, const float* __restrict__ al, int k, int b,
    long Bl, float sc, int umask_bits, const float* x, float* u) {
  float delta[X];
  for (int r = 0; r < X; ++r) delta[r] = x[r] - xs[((long)k * X + r) * Bl + b];
  for (int a = 0; a < U; ++a) {
    const int af = Q + a;
    const float* Pk = Ps + (((long)k * PU + af) * X) * Bl + b;
    float acc = Pk[0] * delta[0];
    for (int xx = 1; xx < X; ++xx) acc = acc + Pk[xx * Bl] * delta[xx];
    const long ka = ((long)k * PU + af) * Bl + b;
    const float row = (us[ka] - acc) - sc * al[ka];
    u[a] = row * (((umask_bits >> af) & 1) ? 1.0f : 0.0f);
  }
}

}  // namespace rollout
}  // namespace
