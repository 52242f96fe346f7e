// Fused linearize + quadraticize for Hopper (sm_90a): K1.
//
// Replaces the Pallas kernel ilqgames_tpu/ops/pallas/stage.py:_make_kernel
// (launched by _lin_quad_parts through lin_quad_pallas). For every knot k
// and lane b it computes, from the operating point, the AL multipliers and
// mu, at the lane's time t = t0[b] + k * dt (ops/pallas/stage.py:141):
//   A = I + dt * Jx and Bf = dt * Ju from the models' analytic Jacobians
//   (dynamics/base.py:linearize), or a linear system's constant entries,
//   and
//   each player's Q, l, R and r from the sparse pairs of its atoms: state
//   costs, state constraints with their AL terms, the state
//   regularization diagonal; per control player, control costs and the
//   control regularization times the control mask
//   (costs/player_cost.py:quadraticize),
// and writes them straight into the LQ kernel's batch-minor operand dict:
// A [N,X,X,B], Bf [N,X,PU,B], Qf [N,P*X,X,B], lf [N,P*X,B],
// Rf [N,P*P*U,U,B], rf [N,P*P*U,B]. Built with CT_REACH (the reachability
// games, costs.cuh), it also takes the signed-distance atoms and their
// extremal groups, the control constraints' AL terms (R gets mu_eff at
// (dim, dim) and r the gradient, after the control costs, in the order of
// al_quad_pairs) with their multipliers lamC, and the extremal gate
// gate [N,P,B], which multiplies a MAX or MIN player's state terms before
// the regularization (player_cost.quadraticize). Built with CT_DIFF,
// CT_SEMI, CT_POLYSD, CT_ROUTE, CT_DUBINS, CT_CAR5D and CT_COUPLED
// (costs.cuh), it takes quadratic_difference, semiquadratic,
// polyline2_signed_distance and route_progress atoms and the Jacobians of dubins_car, car_5d and the coupled systems
// (two_player_unicycle_4d, air_3d: read at the knot's state and controls).
// Built with CT_ZOO, it takes the rest of the cost layer's sparse pieces:
// quadratic_norm, relative_distance, nominal_path_length, curvature,
// orientation, quadratic_difference at any count of differences, and a
// state constraint's single_dimension form and final-time gate.
//
// The game's SubsysTable and CostTable live in this library's constant
// memory (stage_set_tables), where every thread of a warp reads the same
// entry, as the parameter bank served them before.
//
// Design: one thread per (knot, lane), lanes fastest, so every load and
// store of the batch-minor layout is coalesced across a warp. A thread
// first writes every element of its outputs (zeros, and the identity of
// A), then accumulates the sparse pairs in place in its own output
// addresses, in pair order: the first pair of a key stores, later ones
// add, as the plain version's dict folds do (a dense per-thread
// accumulator does not fit: one player's Q alone is X*X = 256 floats).
// The arithmetic is the plain version's, operation by operation, built
// without FMA contraction.
//
// What bounds it on this card: stores. Per (knot, lane) it writes
// X*X + X*PU + P*X*X + P*X + P*P*U*U + P*P*U floats, 1,222 for the
// flagship, against ~60 floats read. At N=100, B=2048 that is ~1.0 GB,
// ~0.3 ms at 3.35 TB/s; the polyline queries and trig are small beside it.

#include <cuda_runtime.h>

#include "costs.cuh"

#if !defined(ST_X) || !defined(ST_P) || !defined(ST_U)
#error "build with -DST_X=<xdim> -DST_P=<players> -DST_U=<umax>"
#endif

namespace {

__constant__ SubsysTable c_dyn;
__constant__ CostTable c_tab;

constexpr int X = ST_X;
constexpr int P = ST_P;
constexpr int U = ST_U;
constexpr int PU = P * U;

// A state constraint's final-time gate: compiled in with CT_ZOO only, so
// that the other games' K1 is the same code.
#if CT_ZOO
#define ZGATE(v) gv(v)
#else
#define ZGATE(v) (v)
#endif

// One seen bit per entry of a thread's output block.
template <int E>
struct Seen {
  unsigned w[(E + 31) / 32];
  __device__ __forceinline__ void reset() {
    for (int i = 0; i < (E + 31) / 32; ++i) w[i] = 0u;
  }
  __device__ __forceinline__ bool test_set(int e) {
    const bool s = (w[e >> 5] >> (e & 31)) & 1u;
    w[e >> 5] |= 1u << (e & 31);
    return s;
  }
};

// out[e * B] = out[e * B] + v, or = v for the first pair of entry e.
template <int E>
__device__ __forceinline__ void put(float* out, long B, Seen<E>& seen, int e,
                                    float v) {
  float* p = out + e * B;
  *p = seen.test_set(e) ? *p + v : v;
}

// out[e * B] = v: an entry whose value is already final.
template <int E>
__device__ __forceinline__ void set(float* out, long B, Seen<E>& seen, int e,
                                    float v) {
  out[e * B] = v;
  seen.test_set(e);
}

__global__ void stage_kernel(const float* __restrict__ xs,
                             const float* __restrict__ us,
                             const float* __restrict__ t0,
                             const float* __restrict__ lamS, int nS,
                             const float* __restrict__ lamC, int nC,
                             const float* __restrict__ gate,
                             const float* __restrict__ mu,
                             const float* __restrict__ segs, float* A,
                             float* Bf, float* Qf, float* lf, float* Rf,
                             float* rf, int N, int B, float dt) {
  const SubsysTable& dyn = c_dyn;
  const CostTable& tab = c_tab;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)N * B) return;
  const long k = idx / B;
  const int b = (int)(idx % B);
  const long Bl = B;

  float x[X], u[PU];
  for (int r = 0; r < X; ++r) x[r] = xs[(k * X + r) * Bl + b];
  for (int a = 0; a < PU; ++a) u[a] = us[(k * PU + a) * Bl + b];
  const float mu_b = mu[b];
  const float t = t0[b] + (float)k * dt;
  auto lam = [&](int row) { return lamS[(k * nS + row) * Bl + b]; };
#if CT_REACH
  auto lamc = [&](int row) { return lamC[(k * nC + row) * Bl + b]; };
#endif

  float* Ak = A + k * X * X * Bl + b;
  float* Bk = Bf + k * X * PU * Bl + b;
  float* Qk = Qf + k * P * X * X * Bl + b;
  float* lk = lf + k * P * X * Bl + b;
  float* Rk = Rf + k * P * P * U * U * Bl + b;
  float* rk = rf + k * P * P * U * Bl + b;
  for (int e = 0; e < X * X; ++e) Ak[e * Bl] = (e % (X + 1) == 0) ? 1.0f : 0.0f;
  for (int e = 0; e < X * PU; ++e) Bk[e * Bl] = 0.0f;
  for (int e = 0; e < P * X * X; ++e) Qk[e * Bl] = 0.0f;
  for (int e = 0; e < P * X; ++e) lk[e * Bl] = 0.0f;
  for (int e = 0; e < P * P * U * U; ++e) Rk[e * Bl] = 0.0f;
  for (int e = 0; e < P * P * U; ++e) rk[e * Bl] = 0.0f;

  // ---- linearize: A = I + dt * Jx, Bf = dt * Ju ----
  {
    Seen<X * X> sa;
    Seen<X * PU> sb;
    sa.reset();
    sb.reset();
    for (int d = 0; d < X; ++d) sa.test_set(d * (X + 1));
    costs::jacobian(
        dyn, x, u,
        [&](bool is_u, int r, int c, float v) {
          if (is_u)
            put(Bk, Bl, sb, r * PU + c, dt * v);
          else
            put(Ak, Bl, sa, r * X + c, dt * v);
        },
        [&](bool is_u, int r, int c, float v) {
          if (is_u)
            set(Bk, Bl, sb, r * PU + c, v);
          else
            set(Ak, Bl, sa, r * X + c, v);
        });
  }

  // ---- quadraticize ----
  for (int i = 0; i < P; ++i) {
    float* Qi = Qk + i * X * X * Bl;
    float* li = lk + i * X * Bl;
    Seen<X * X> sq;
    Seen<X> sl;
    sq.reset();
    sl.reset();
    auto hq = [&](int r, int c, float v) { put(Qi, Bl, sq, r * X + c, v); };
    auto gq = [&](int r, float v) { put(li, Bl, sl, r, v); };
#if CT_REACH
    int active = 0, member = 0;  // as in costs::gradient_sq_into
#endif
    for (int n = 0; n < tab.n; ++n) {
      const CostAtom& a = tab.atom[n];
      if (a.player != i || a.on >= 0) continue;
#if CT_REACH
      if (a.kind == costs::KIND_EXTREME) {
        active = costs::extreme_active(tab, n, x);
        member = 0;
        continue;
      }
#endif
      const costs::Gate gv = costs::gate_of(a, t);
      if (a.kind == costs::KIND_QUADRATIC) {
        const int d = a.dim[0];
        hq(d, d, gv(a.w));
        gq(d, gv(a.w * (x[d] - a.aux)));
      } else if (a.kind == costs::KIND_POLYLINE ||
                 a.kind == costs::KIND_SEMI_POLYLINE) {
        float sc[5];
        if (a.kind == costs::KIND_POLYLINE)
          costs::polyline_scalars(a, segs, x, sc);
        else
          costs::semi_scalars(a, segs, x, sc);
        const int xi = a.dim[0], yi = a.dim[1];
        hq(xi, xi, gv(sc[2]));
        hq(yi, yi, gv(sc[3]));
        hq(xi, yi, gv(sc[4]));
        hq(yi, xi, gv(sc[4]));
        gq(xi, gv(sc[0]));
        gq(yi, gv(sc[1]));
      } else if (a.kind == costs::KIND_PROXIMITY_COST) {
        float gx, gy, h[2][2];
        costs::prox_cost_quad(a, x, gx, gy, h);
        // Rows and columns over (x1, y1, x2, y2): h on the blocks of one
        // point, -h across.
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float v = h[r % 2][c % 2];
            hq(a.dim[r], a.dim[c], gv((r < 2) == (c < 2) ? v : -v));
          }
        gq(a.dim[0], gv(gx));
        gq(a.dim[1], gv(gy));
        gq(a.dim[2], gv(-gx));
        gq(a.dim[3], gv(-gy));
      } else if (a.kind == costs::KIND_PROXIMITY) {
        float px, py, hxx, hyy, hxy;
        costs::prox_quad(a, x, lam(a.lam), mu_b, px, py, hxx, hyy, hxy);
        const int x1 = a.dim[0], y1 = a.dim[1], x2 = a.dim[2], y2 = a.dim[3];
        hq(x1, x1, ZGATE(hxx));
        hq(y1, y1, ZGATE(hyy));
        hq(x1, y1, ZGATE(hxy));
        hq(y1, x1, ZGATE(hxy));
        hq(x2, x2, ZGATE(hxx));
        hq(y2, y2, ZGATE(hyy));
        hq(x2, y2, ZGATE(hxy));
        hq(y2, x2, ZGATE(hxy));
        hq(x1, x2, ZGATE(-hxx));
        hq(x2, x1, ZGATE(-hxx));
        hq(y1, y2, ZGATE(-hyy));
        hq(y2, y1, ZGATE(-hyy));
        hq(x1, y2, ZGATE(-hxy));
        hq(y2, x1, ZGATE(-hxy));
        hq(y1, x2, ZGATE(-hxy));
        hq(x2, y1, ZGATE(-hxy));
        gq(x1, ZGATE(px));
        gq(y1, ZGATE(py));
        gq(x2, ZGATE(-px));
        gq(y2, ZGATE(-py));
      }
#if CT_REACH
      else if (a.kind == costs::KIND_SIGNED_DIST) {
        float gx, gy, h[2][2];
        costs::sd_quad(a, x, gx, gy, h);
        if (a.group < 0) {  // a member: times its one-hot gate
          const float g = (member++ == active) ? 1.0f : 0.0f;
          gx = gx * g;
          gy = gy * g;
          h[0][0] = h[0][0] * g;
          h[0][1] = h[0][1] * g;
          h[1][0] = h[1][0] * g;
          h[1][1] = h[1][1] * g;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float v = h[r % 2][c % 2];
            hq(a.dim[r], a.dim[c], gv((r < 2) == (c < 2) ? v : -v));
          }
        gq(a.dim[0], gv(gx));
        gq(a.dim[1], gv(gy));
        gq(a.dim[2], gv(-gx));
        gq(a.dim[3], gv(-gy));
      }
#endif
#if CT_SEMI
      else if (a.kind == costs::KIND_SEMIQUADRATIC) {
        const int d = a.dim[0];
        float diff;
        const bool on = costs::semi_active(a, x[d], diff);
        hq(d, d, gv(on ? a.w : 0.0f));
        gq(d, gv(on ? a.w * diff : 0.0f));
      }
#endif
#if CT_POLYSD
      else if (a.kind == costs::KIND_POLY_SD) {
        float sc[5];
        costs::polysd_scalars<true>(a, segs, x, sc);
        const int xi = a.dim[0], yi = a.dim[1];
        hq(xi, xi, gv(sc[2]));
        hq(yi, yi, gv(sc[3]));
        hq(xi, yi, gv(sc[4]));
        hq(yi, xi, gv(sc[4]));
        gq(xi, gv(sc[0]));
        gq(yi, gv(sc[1]));
      }
#endif
#if CT_ROUTE
      else if (a.kind == costs::KIND_ROUTE) {
        // The Hessian over the support (x, y): c + c on the diagonal, +0
        // across, in autodiff's pair order.
        float g[2];
        costs::route_grad(a, segs, x, t, g);
        const float h = 0.5f * a.w + 0.5f * a.w;
        const int xi = a.dim[0], yi = a.dim[1];
        hq(xi, xi, gv(h));
        hq(xi, yi, gv(0.0f));
        hq(yi, xi, gv(0.0f));
        hq(yi, yi, gv(h));
        gq(xi, gv(g[0]));
        gq(yi, gv(g[1]));
      }
#endif
#if CT_DIFF
      else if (a.kind == costs::KIND_QUAD_DIFF) {
        // The Hessian over the support (d1[0], d1[1], d2[0], d2[1]): w on
        // the diagonal, -w between d1[n] and d2[n], +0 elsewhere.
        float g[2];
        costs::qdiff_grad(a, x, g);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            hq(a.dim[r], a.dim[c],
               gv(r == c ? a.w : ((r % 2 == c % 2) ? -a.w : 0.0f)));
        gq(a.dim[0], gv(0.0f + g[0]));
        gq(a.dim[1], gv(0.0f + g[1]));
        gq(a.dim[2], gv(0.0f + -g[0]));
        gq(a.dim[3], gv(0.0f + -g[1]));
      }
#endif
#if CT_ZOO
      else if (a.kind == costs::KIND_QUADRATIC_NORM) {
        float g[2], h[3];
        costs::norm_quad(a, x, g, h);
        const int d1 = a.dim[0], d2 = a.dim[1];
        hq(d1, d1, gv(h[0]));
        hq(d1, d2, gv(h[2]));
        hq(d2, d1, gv(h[2]));
        hq(d2, d2, gv(h[1]));
        gq(d1, gv(g[0]));
        gq(d2, gv(g[1]));
      } else if (a.kind == costs::KIND_REL_DIST) {
        float gx, gy, h[2][2];
        costs::dist_quad(a, x, a.w, gx, gy, h);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float v = h[r % 2][c % 2];
            hq(a.dim[r], a.dim[c], gv((r < 2) == (c < 2) ? v : -v));
          }
        gq(a.dim[0], gv(gx));
        gq(a.dim[1], gv(gy));
        gq(a.dim[2], gv(-gx));
        gq(a.dim[3], gv(-gy));
      } else if (a.kind == costs::KIND_NOMINAL_PATH ||
                 a.kind == costs::KIND_ORIENTATION) {
        // Autodiff over the support (dim): p + p and c + c, c = 0.5 w.
        const int d = a.dim[0];
        const float c = 0.5f * a.w;
        const float p =
            c * (a.kind == costs::KIND_ORIENTATION
                     ? costs::orient_wrap(a, x[d])
                     : x[d] - t * a.aux);
        hq(d, d, gv(c + c));
        gq(d, gv(p + p));
      } else if (a.kind == costs::KIND_CURVATURE) {
        float g[2], h[4];
        costs::curv_terms<true>(a, x, g, h);
        const int o = a.dim[0], s = a.dim[1];
        hq(o, o, gv(h[0]));
        hq(o, s, gv(h[1]));
        hq(s, o, gv(h[2]));
        hq(s, s, gv(h[3]));
        gq(o, gv(g[0]));
        gq(s, gv(g[1]));
      } else if (a.kind == costs::KIND_QUAD_DIFF_N) {
        // The Hessian over the support (d1..., d2...): w on the diagonal,
        // -w between d1[m] and d2[m], +0 elsewhere; then the gradient.
        const int cnt = a.group, sup = 2 * a.group;
        for (int r = 0; r < sup; ++r)
          for (int c = 0; c < sup; ++c)
            hq(costs::qdiff_n_dim(tab, n, r), costs::qdiff_n_dim(tab, n, c),
               gv(r == c ? a.w : ((r % cnt == c % cnt) ? -a.w : 0.0f)));
        for (int m = 0; m < cnt; ++m)
          gq(tab.atom[n + 1 + m].dim[0],
             gv(0.0f + costs::qdiff_n_grad(tab, n, m, x)));
        for (int m = 0; m < cnt; ++m)
          gq(tab.atom[n + 1 + m].dim[1],
             gv(0.0f + -costs::qdiff_n_grad(tab, n, m, x)));
      } else if (a.kind == costs::KIND_SINGLE_DIM) {  // a state constraint
        const int d = a.dim[0];
        float mu_eff;
        const float g =
            costs::single_dim_ct(a, x[d], lam(a.lam), mu_b, mu_eff);
        hq(d, d, gv(mu_eff));
        gq(d, gv(g));
      }
#endif
    }
#if CT_REACH
    // A MAX or MIN player's state terms count at its extreme knot only:
    // each entry set so far times the gate, before the regularization.
    if (gate != nullptr && tab.extremal[i]) {
      const float g = gate[(k * P + i) * Bl + b];
      for (int e = 0; e < X * X; ++e)
        if ((sq.w[e >> 5] >> (e & 31)) & 1u) Qi[e * Bl] = Qi[e * Bl] * g;
      for (int e = 0; e < X; ++e)
        if ((sl.w[e >> 5] >> (e & 31)) & 1u) li[e * Bl] = li[e * Bl] * g;
    }
#endif
    if (tab.state_reg[i] != 0.0f)
      for (int d = 0; d < X; ++d) hq(d, d, tab.state_reg[i]);

    for (int j = 0; j < P; ++j) {
      if (!((tab.ctrl_players[i] >> j) & 1)) continue;
      float* Rij = Rk + (i * P + j) * U * U * Bl;
      float* rij = rk + (i * P + j) * U * Bl;
      Seen<U * U> sR;
      Seen<U> sr;
      sR.reset();
      sr.reset();
      for (int n = 0; n < tab.n; ++n) {
        const CostAtom& a = tab.atom[n];
#if CT_REACH
        if (a.player != i || a.on != j) continue;
        if (a.kind == costs::KIND_SINGLE_DIM) {
          const int d = a.dim[0];
          float mu_eff;
          const float g = costs::single_dim_ct(a, u[j * U + d], lamc(a.lam),
                                               mu_b, mu_eff);
          put(Rij, Bl, sR, d * U + d, mu_eff);
          put(rij, Bl, sr, d, g);
          continue;
        }
        if (a.kind != costs::KIND_QUADRATIC) continue;
#else
        if (a.player != i || a.on != j || a.kind != costs::KIND_QUADRATIC)
          continue;
#endif
        const costs::Gate gv = costs::gate_of(a, t);
        const int d = a.dim[0];
        put(Rij, Bl, sR, d * U + d, gv(a.w));
        put(rij, Bl, sr, d, gv(a.w * (u[j * U + d] - a.aux)));
      }
      if (tab.ctrl_reg[i] != 0.0f)
        for (int c = 0; c < U; ++c)
          put(Rij, Bl, sR, c * U + c,
              tab.ctrl_reg[i] * (c < tab.udims[j] ? 1.0f : 0.0f));
    }
  }
}

constexpr int BLOCK = 128;

}  // namespace

extern "C" {

// xs [N,X,B], us [N,PU,B], t0 [B], lamS [N,nS,B] (null when nS = 0),
// lamC [N,nC,B] (null when nC = 0), gate [N,P,B] (null: no MAX or MIN
// player; both read only with CT_REACH), mu [B], segs, and the device
// tables of stage_set_tables -> A, Bf, Qf, lf, Rf, rf (see the header).
int stage_lin_quad(const float* xs, const float* us, const float* t0,
                   const float* lamS, int nS, const float* lamC, int nC,
                   const float* gate, const float* mu, const float* segs,
                   float* A, float* Bf, float* Qf, float* lf, float* Rf,
                   float* rf, int N, int B, float dt, void* stream) {
  const long total = (long)N * B;
  if (total == 0) return 0;
  const int grid = (int)((total + BLOCK - 1) / BLOCK);
  stage_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      xs, us, t0, lamS, nS, lamC, nC, gate, mu, segs, A, Bf, Qf, lf, Rf, rf,
      N, B, dt);
  return (int)cudaGetLastError();
}

// Copy the game's tables into this library's constant memory, in stream
// order (kernels launched before still read the previous game's).
int stage_set_tables(const SubsysTable* dyn, const CostTable* tab,
                     void* stream) {
  cudaError_t err = cudaMemcpyToSymbolAsync(
      c_dyn, dyn, sizeof(SubsysTable), 0, cudaMemcpyHostToDevice,
      (cudaStream_t)stream);
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbolAsync(c_tab, tab, sizeof(CostTable), 0,
                                  cudaMemcpyHostToDevice,
                                  (cudaStream_t)stream);
  return (int)err;
}

}  // extern "C"
