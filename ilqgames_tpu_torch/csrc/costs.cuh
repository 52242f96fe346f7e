// Per-problem cost and dynamics math shared by the stage kernel K1
// (stage.cu), the in-kernel merit K5 (sweep.cu) and the merit consumer K6
// (merit.cu).
//
// Device forms of the atoms and models, each repeating its plain PyTorch
// version operation by operation (with FMA contraction off):
//   quadratic            costs/atoms.py:quadratic (over all dims: one atom
//                        per dim in the table, in dim order)
//   quadratic_polyline2  costs/atoms.py:quadratic_polyline2, with the query of
//                        geometry.py:polyline_closest_point_xy
//   semiquadratic_polyline2
//                        costs/atoms.py:semiquadratic_polyline2, with the
//                        signed query (need_sign=True)
//   proximity            costs/constraints.py:proximity, mu_eff_ineq of
//                        costs/base.py
//   proximity (cost)     costs/atoms.py:proximity
//   final_time           a gate on any of them: t >= tgate multiplies each
//                        pair's value by 1.0, else by 0.0
//   quadratic_norm       costs/atoms.py:quadratic_norm's gradient pairs
//   semiquadratic_norm   costs/atoms.py:semiquadratic_norm's dense gradient
//                        (autodiff's operations, gated on >= or <= of the
//                        norm), into a player's dense accumulator
//   signed_distance      costs/atoms.py:signed_distance
//   extreme_value        costs/atoms.py:extreme_value over signed-distance
//                        members: a header atom, then its members, each
//                        multiplied by its one-hot gate ((-p) * g is
//                        -(p * g): a pair's negation after the gate)
//   single_dimension     costs/constraints.py:single_dimension, a control
//                        constraint's AL terms
//   quadratic_difference costs/atoms.py:quadratic_difference (two
//                        differences: the pairs of the JAX package's
//                        autodiff over its support)
//   semiquadratic        costs/atoms.py:semiquadratic (strictly beyond its
//                        threshold on its side, else 0)
//   polyline2_signed_distance
//                        costs/atoms.py:polyline2_signed_distance's pairs,
//                        with the signed query (need_sign=True)
//   route_progress       costs/atoms.py:route_progress (the pairs of the
//                        JAX package's autodiff over its support), its
//                        desired point geometry.py:polyline_point_at at
//                        initial_route_pos + t * nominal_speed
//   car_6d, unicycle_4d, car_5d, dubins_car, the linear system
//                        the Jacobian entries of dynamics/models.py and the
//                        constant ones of dynamics/base.py:linear
// The two norm atoms are the merit's only (K5, K6): they are compiled in
// where the library is built with CT_NORMS=1 (ops/cuda/sweep.py), and K1
// has neither (its caller refuses them). The reachability games' atoms
// and control constraints are compiled in where the library is built with CT_REACH=1 (cost_table.has_reach), so that the
// other games' kernels are the same code; so are quadratic_difference
// (CT_DIFF=1, cost_table.has_diff), semiquadratic (CT_SEMI=1,
// cost_table.has_semi), polyline2_signed_distance (CT_POLYSD=1,
// cost_table.has_polysd), route_progress (CT_ROUTE=1,
// cost_table.has_route) and the Jacobians of dubins_car (CT_DUBINS=1),
// car_5d (CT_CAR5D=1) and the coupled systems two_player_unicycle_4d and
// air_3d (CT_COUPLED=1), K1's only (ops/cuda/stage.py). The CostTable holds
// CT_MAX_ATOMS atoms (32 unless the build says more: cost_table.capacity).
// The problem arrives as a CostTable (atom kinds, dims, weights, nominals,
// thresholds, signs, orientations, gate times, segment offsets, extremal
// groups, each player's structure; built by ops/cuda/cost_table.py), in the
// constant memory of K1's library (set by stage_set_tables before a launch
// of another problem) and by value as a kernel parameter of K5, K6 and the
// probe P2, and a small device array
// of polyline segments, 7 floats each: p1x p1y p2x p2y ux uy length,
// computed on the host in float32 as geometry._static_segments computes
// them, then the signed queries' shortcut segments, 8 floats each
// (geometry.shortcut_segments), then the route-progress atoms' segment
// start lengths, one float each. The time t an atom sees is its caller's:
// K1, K5 and K6 give each lane's t0 + k * dt.
//
// Pairs accumulate per key in pair order, the first pair of a key setting it
// and later ones adding to it, as the plain versions' dict folds do; callers
// keep a per-key "seen" bit for that. A player with a dense atom
// (semiquadratic_norm) accumulates the dense gradients apart, in atom
// order, and its merit term squares every entry of the pairs' sum plus the
// dense sum, folded left to right over all X dims
// (player_cost.stage_gradient_sq_tuple's dense branch).
//
// The atoms read the state through `v[d]` for any V that has it: a thread's
// own array (K1, the probes), or a Column of a [X][32] shared-memory array
// (K5, whose warps share a block's state, and K6), so that a run-time index
// d of the CostTable never indexes a register array (which puts the array
// on the stack).

#pragma once

#include "fmath.cuh"

#ifndef CT_NORMS
#define CT_NORMS 0
#endif
#ifndef CT_REACH
#define CT_REACH 0
#endif
#ifndef CT_DIFF
#define CT_DIFF 0
#endif
#ifndef CT_DUBINS
#define CT_DUBINS 0
#endif
#ifndef CT_SEMI
#define CT_SEMI 0
#endif
#ifndef CT_CAR5D
#define CT_CAR5D 0
#endif
#ifndef CT_POLYSD
#define CT_POLYSD 0
#endif
#ifndef CT_COUPLED
#define CT_COUPLED 0
#endif
#ifndef CT_ROUTE
#define CT_ROUTE 0
#endif
#ifndef CT_ZOO
#define CT_ZOO 0
#endif
#ifndef CT_MAX_ATOMS
#define CT_MAX_ATOMS 32
#endif

namespace costs {

constexpr int MAX_ATOMS = CT_MAX_ATOMS;
constexpr int MAX_PLAYERS = 8;
constexpr int MAX_SUBSYS = 8;
constexpr int KIND_QUADRATIC = 0;
constexpr int KIND_POLYLINE = 1;
constexpr int KIND_PROXIMITY = 2;
constexpr int KIND_SEMI_POLYLINE = 3;
constexpr int KIND_PROXIMITY_COST = 4;
constexpr int KIND_QUADRATIC_NORM = 5;
constexpr int KIND_SEMI_NORM = 6;
constexpr int KIND_SIGNED_DIST = 7;
constexpr int KIND_EXTREME = 8;
constexpr int KIND_SINGLE_DIM = 9;
constexpr int KIND_QUAD_DIFF = 10;
constexpr int KIND_SEMIQUADRATIC = 11;
constexpr int KIND_POLY_SD = 12;
constexpr int KIND_ROUTE = 13;
constexpr int KIND_REL_DIST = 14;
constexpr int KIND_NOMINAL_PATH = 15;
constexpr int KIND_CURVATURE = 16;
constexpr int KIND_ORIENTATION = 17;
constexpr int KIND_QUAD_DIFF_N = 18;
constexpr int KIND_QUAD_DIFF_MEMBER = 19;
constexpr int KIND_LOCAL_CONVEX = 20;
constexpr int KIND_WEIGHTED_CONVEX = 21;
// The constant Jacobian entries of a linear system: 48, those of four flat
// car_6d (6 diagonal, 4 off it and 2 in B each).
constexpr int MAX_LIN = 48;
constexpr int KIND_CAR_6D = 0;      // dynamics/models.py KIND_CAR_6D
constexpr int KIND_UNICYCLE_4D = 1;  // dynamics/models.py KIND_UNICYCLE_4D
constexpr int KIND_LINEAR = 2;       // dynamics/models.py KIND_LINEAR
constexpr int KIND_CAR_5D = 3;       // dynamics/models.py KIND_CAR_5D
constexpr int KIND_DUBINS = 4;       // dynamics/models.py KIND_DUBINS
constexpr int KIND_TWO_UNICYCLE = 5; // KIND_TWO_PLAYER_UNICYCLE_4D
constexpr int KIND_AIR_3D = 6;       // dynamics/models.py KIND_AIR_3D
constexpr float SMALL_NUMBER = 1e-4f;  // types.SMALL_NUMBER
constexpr float EPS = 1e-12f;          // constraints._EPS

}  // namespace costs

extern "C" {

// The concatenated models of the joint dynamics (ops/cuda/sweep.py
// _device_table): kind, state offset, control offset (flat, player-major)
// and first and second parameter (a car's inter-axle length, a Dubins
// car's speed; air_3d's evader and pursuer speeds) of each. A coupled
// system (two_player_unicycle_4d, air_3d) and a linear system are one
// subsystem over the whole state reading every control row; its nlin constant Jacobian entries (lin_u: of Bf, else of
// A; row, column, value) are the plain linearize's values.
struct SubsysTable {
  int n;
  int kind[costs::MAX_SUBSYS];
  int xoff[costs::MAX_SUBSYS];
  int uoff[costs::MAX_SUBSYS];
  float length[costs::MAX_SUBSYS];
  float param2[costs::MAX_SUBSYS];
  int nlin;
  int lin_u[costs::MAX_LIN];
  int lin_row[costs::MAX_LIN];
  int lin_col[costs::MAX_LIN];
  float lin_val[costs::MAX_LIN];
};

// One atom of one player's cost. on < 0: the state; on = j: player j's
// (padded) control. Quadratic: dim[0], w = weight, aux = nominal. Polyline: dim[0..1] = x, y index, w = weight, seg0/nseg its
// segments, ends = first and last point; the semiquadratic one also aux =
// threshold, aux2 = signed sq threshold, right = oriented right, fix0 = the
// float offset of its shortcut rows. Proximity constraint: dim[0..3] = x1,
// y1, x2, y2, w = threshold, aux = sign s (+1 keep within, -1 keep out),
// lam = its row of lamS. Proximity cost: dim[0..3], w = weight, aux =
// threshold, aux2 = threshold^2. Quadratic norm: dim[0..1], w = weight,
// aux = nominal. Semiquadratic norm: dim[0..1], w = weight, aux =
// threshold, right = oriented right. Signed distance: dim[0..3], w = sign
// s, aux = nominal. Extremal group header: group = its member count, right
// = 1 for the minimum; its members follow it, with group = -1. Single-
// dimension control constraint: on = j, dim[0], w = threshold, aux = +1
// (keep below) or -1 (keep above), lam = its row of lamC. Quadratic
// difference: dim[0..3] = its support d1[0], d1[1], d2[0], d2[1], w =
// weight. Semiquadratic: dim[0], w = weight, aux = threshold, right =
// oriented right. Polyline signed distance: dim[0..1] = x, y index,
// seg0/nseg its segments, fix0 the float offset of its shortcut rows, aux
// = the orientation flip (+1 or -1), aux2 = nominal. Route progress:
// dim[0..1] = x, y index, seg0/nseg its segments, fix0 the float offset of
// their start lengths, w = weight, aux = initial route position, aux2 =
// nominal speed. gated: a final-time gate at tgate.
struct CostAtom {
  int kind;
  int player;
  int on;
  int dim[4];
  int seg0;
  int nseg;
  int lam;
  float w;
  float aux;
  float ends[4];
  int fix0;
  int right;
  int gated;
  float tgate;
  float aux2;
  int group;
};

struct CostTable {
  int n;
  CostAtom atom[costs::MAX_ATOMS];
  float state_reg[costs::MAX_PLAYERS];
  float ctrl_reg[costs::MAX_PLAYERS];
  int ctrl_players[costs::MAX_PLAYERS];  // bit j: player i has terms in u_j
  int udims[costs::MAX_PLAYERS];
  int extremal[costs::MAX_PLAYERS];  // a MAX or MIN player: gated state
};

}  // extern "C"

namespace costs {

// torch.minimum: NaN if either is NaN.
__device__ __forceinline__ float nan_min(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return b < a ? b : a;
}

// torch.clamp_min(x, lo): NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return (x != x) ? x : (x < lo ? lo : x);
}

struct Closest {
  float cpx, cpy, p1x, p1y, ux, uy;
  bool vertex, endpoint;
};

__device__ __forceinline__ void segment(const float* s, float qx, float qy,
                                        float& cpx, float& cpy, float& ssd,
                                        bool& vertex) {
  const float rx = qx - s[0], ry = qy - s[1];
  const float dot = rx * s[4] + ry * s[5];
  const float cross = rx * s[5] - ry * s[4];
  const float sq_p1 = rx * rx + ry * ry;
  const float r2x = qx - s[2], r2y = qy - s[3];
  const float sq_p2 = r2x * r2x + r2y * r2y;
  const bool behind = dot < 0.0f;
  const bool ahead = dot > s[6];
  cpx = behind ? s[0] : (ahead ? s[2] : s[0] + dot * s[4]);
  cpy = behind ? s[1] : (ahead ? s[3] : s[1] + dot * s[5]);
  const float raw = behind ? sq_p1 : (ahead ? sq_p2 : cross * cross);
  ssd = (cross == 0.0f) ? 0.0f : raw;
  vertex = behind || ahead;
}

// geometry.polyline_closest_point_xy(need_sign=False): the winner is the
// first segment whose |sq distance| is <= the NaN-propagating minimum over
// all segments (segment 0 when that minimum is NaN).
__device__ __forceinline__ Closest closest(const CostAtom& a,
                                           const float* segs, float qx,
                                           float qy) {
  const float* s0 = segs + 7 * a.seg0;
  float cpx, cpy, ssd;
  bool vertex;
  float m = 0.0f;
  for (int s = 0; s < a.nseg; ++s) {
    segment(s0 + 7 * s, qx, qy, cpx, cpy, ssd, vertex);
    m = (s == 0) ? ssd : nan_min(m, ssd);
  }
  int win = 0;
  for (int s = 0; s < a.nseg; ++s) {
    segment(s0 + 7 * s, qx, qy, cpx, cpy, ssd, vertex);
    if (ssd <= m) { win = s; break; }
  }
  const float* w = s0 + 7 * win;
  Closest c;
  segment(w, qx, qy, c.cpx, c.cpy, ssd, c.vertex);
  c.p1x = w[0];
  c.p1y = w[1];
  c.ux = w[4];
  c.uy = w[5];
  const float fx = c.cpx - a.ends[0], fy = c.cpy - a.ends[1];
  const float lx = c.cpx - a.ends[2], ly = c.cpy - a.ends[3];
  c.endpoint = (fx * fx + fy * fy < SMALL_NUMBER) ||
               (lx * lx + ly * ly < SMALL_NUMBER);
  return c;
}

// atoms.quadratic_polyline2's _scalars: (dx, dy, ddx, ddy, dxdy).
template <typename V>
__device__ __forceinline__ void polyline_scalars(const CostAtom& a,
                                                 const float* segs,
                                                 const V& v, float out[5]) {
  const float qx = v[a.dim[0]], qy = v[a.dim[1]];
  const Closest c = closest(a, segs, qx, qy);
  const float w = a.w;
  const float dxv = w * (qx - c.cpx);
  const float dyv = w * (qy - c.cpy);
  const float w_cross = w * ((qx - c.p1x) * c.uy - (qy - c.p1y) * c.ux);
  const float dxi = w_cross * c.uy;
  const float dyi = -w_cross * c.ux;
  const float h0 = w * c.uy * c.uy, h1 = w * c.ux * c.ux;
  const float h2 = -w * c.ux * c.uy;
  const float gate = c.endpoint ? 0.0f : 1.0f;
  out[0] = (c.vertex ? dxv : dxi) * gate;
  out[1] = (c.vertex ? dyv : dyi) * gate;
  out[2] = (c.vertex ? w : h0) * gate;
  out[3] = (c.vertex ? w : h1) * gate;
  out[4] = (c.vertex ? 0.0f : h2) * gate;
}

// geometry.sign: -1, +1, or x itself at +-0 and NaN.
__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

// One candidate of the signed query: segment si of S (row s, shortcut row
// f), with the interior-vertex side fix.
__device__ __forceinline__ void segment_signed(const float* s, const float* f,
                                               int si, int S, float qx,
                                               float qy, float& cpx,
                                               float& cpy, float& ssd,
                                               bool& vertex) {
  const float rx = qx - s[0], ry = qy - s[1];
  const float dot = rx * s[4] + ry * s[5];
  const float cross = rx * s[5] - ry * s[4];
  const float sq_p1 = rx * rx + ry * ry;
  const float r2x = qx - s[2], r2y = qy - s[3];
  const float sq_p2 = r2x * r2x + r2y * r2y;
  const bool behind = dot < 0.0f;
  const bool ahead = dot > s[6];
  cpx = behind ? s[0] : (ahead ? s[2] : s[0] + dot * s[4]);
  cpy = behind ? s[1] : (ahead ? s[3] : s[1] + dot * s[5]);
  const float raw = behind ? sq_p1 : (ahead ? sq_p2 : cross * cross);
  float v = sign_of(cross) * ((cross == 0.0f) ? 0.0f : raw);
  const bool at_first = !ahead;
  const float* sc = at_first ? f : f + 4;
  const bool on_right = ((qx - sc[0]) * sc[3] - sc[2] * (qy - sc[1])) > 0.0f;
  bool fix = behind || ahead;
  if (si == 0) fix = fix && !at_first;
  if (si == S - 1) fix = fix && at_first;
  if (fix) v = on_right ? fabsf(v) : -fabsf(v);
  ssd = v;
  vertex = behind || ahead;
}

// geometry.polyline_closest_point_xy(need_sign=True): as `closest`, the
// winner by |signed sq distance|; returns the winner's signed sq distance.
__device__ __forceinline__ Closest closest_signed(const CostAtom& a,
                                                  const float* segs,
                                                  float qx, float qy,
                                                  float& ssd) {
  const float* s0 = segs + 7 * a.seg0;
  const float* f0 = segs + a.fix0;
  float cpx, cpy, v;
  bool vertex;
  float m = 0.0f;
  for (int s = 0; s < a.nseg; ++s) {
    segment_signed(s0 + 7 * s, f0 + 8 * s, s, a.nseg, qx, qy, cpx, cpy, v,
                   vertex);
    m = (s == 0) ? fabsf(v) : nan_min(m, fabsf(v));
  }
  int win = 0;
  for (int s = 0; s < a.nseg; ++s) {
    segment_signed(s0 + 7 * s, f0 + 8 * s, s, a.nseg, qx, qy, cpx, cpy, v,
                   vertex);
    if (fabsf(v) <= m) { win = s; break; }
  }
  const float* w = s0 + 7 * win;
  Closest c;
  segment_signed(w, f0 + 8 * win, win, a.nseg, qx, qy, c.cpx, c.cpy, ssd,
                 c.vertex);
  c.p1x = w[0];
  c.p1y = w[1];
  c.ux = w[4];
  c.uy = w[5];
  const float fx = c.cpx - a.ends[0], fy = c.cpy - a.ends[1];
  const float lx = c.cpx - a.ends[2], ly = c.cpy - a.ends[3];
  c.endpoint = (fx * fx + fy * fy < SMALL_NUMBER) ||
               (lx * lx + ly * ly < SMALL_NUMBER);
  return c;
}

// atoms.semiquadratic_polyline2's _scalars: (dx, dy, ddx, ddy, dxdy).
template <typename V>
__device__ __forceinline__ void semi_scalars(const CostAtom& a,
                                             const float* segs, const V& v,
                                             float out[5]) {
  const float qx = v[a.dim[0]], qy = v[a.dim[1]];
  float ssd;
  const Closest c = closest_signed(a, segs, qx, qy, ssd);
  const bool active = a.right ? ssd > a.aux2 : ssd < a.aux2;
  const float gate = (active && !c.endpoint) ? 1.0f : 0.0f;
  const float w = a.w, thr = a.aux;
  const float dist = fmath::sqrt(clamp_min(fabsf(ssd), EPS));
  const float scaling = (dist - fabsf(thr)) / dist;
  const float dxv = w * scaling * (qx - c.cpx);
  const float dyv = w * scaling * (qy - c.cpy);
  const float h0 = c.vertex ? w : w * c.uy * c.uy;
  const float h1 = c.vertex ? w : w * c.ux * c.ux;
  const float h2 = c.vertex ? 0.0f : -w * c.ux * c.uy;
  const float w_cross =
      w * ((qx - c.p1x) * c.uy - (qy - c.p1y) * c.ux - thr);
  const float dxi = w_cross * c.uy;
  const float dyi = -w_cross * c.ux;
  out[0] = (c.vertex ? dxv : dxi) * gate;
  out[1] = (c.vertex ? dyv : dyi) * gate;
  out[2] = h0 * gate;
  out[3] = h1 * gate;
  out[4] = h2 * gate;
}

#if CT_POLYSD
// atoms.polyline2_signed_distance's pairs: the gradient out[0..1] = (dx,
// dy) and, with HESS, the Hessian out[2..4] = (ddx, ddy, dxdy). At a
// vertex s * delta / dist and delta delta^T / denom, with s = sgn(ssd)
// (0 at 0), dist = sqrt(max(|ssd|, EPS)) and denom = ssd * dist, or EPS
// where |ssd * dist| < EPS; in a segment's interior (uy, -ux) and 0, the
// orientation flip not applied there (shipped).
template <bool HESS, typename V>
__device__ __forceinline__ void polysd_scalars(const CostAtom& a,
                                               const float* segs, const V& v,
                                               float out[5]) {
  const float qx = v[a.dim[0]], qy = v[a.dim[1]];
  float ssd;
  const Closest c = closest_signed(a, segs, qx, qy, ssd);
  ssd = ssd * a.aux;
  const float s = sign_of(ssd);
  const float dist = fmath::sqrt(clamp_min(fabsf(ssd), EPS));
  const float delta_x = qx - c.cpx, delta_y = qy - c.cpy;
  out[0] = c.vertex ? s * delta_x / dist : c.uy;
  out[1] = c.vertex ? s * delta_y / dist : -c.ux;
  if (HESS) {
    const float sd = ssd * dist;
    const float denom = (fabsf(sd) < EPS) ? EPS : sd;
    out[2] = c.vertex ? delta_y * delta_y / denom : 0.0f;
    out[3] = c.vertex ? delta_x * delta_x / denom : 0.0f;
    out[4] = c.vertex ? -delta_x * delta_y / denom : 0.0f;
  }
}
#endif  // CT_POLYSD

#if CT_ROUTE
// atoms.route_progress's gradient at time t: g[n] = 0 + (p + p) with p =
// (0.5 w) * (v[dim[n]] - desired[n]); the desired point is
// geometry.polyline_point_at's walk to s = aux + t * aux2: the last
// segment whose start length is <= s, segment 0 before the first, the
// last segment extrapolated past the end. Its Hessian is the caller's:
// (0.5 w) + (0.5 w) on the diagonal, +0 across.
template <typename V>
__device__ __forceinline__ void route_grad(const CostAtom& a,
                                           const float* segs, const V& v,
                                           float t, float g[2]) {
  const float s = a.aux + t * a.aux2;
  const float* row = segs + 7 * a.seg0;
  const float* start = segs + a.fix0;
  float px = 0.0f, py = 0.0f;
  for (int k = 0; k < a.nseg; ++k, row += 7) {
    const float rem = s - start[k];
    const float cx = row[0] + rem * row[4];
    const float cy = row[1] + rem * row[5];
    if (k == 0 || s >= start[k]) {
      px = cx;
      py = cy;
    }
  }
  const float c = 0.5f * a.w;
  const float p0 = c * (v[a.dim[0]] - px);
  const float p1 = c * (v[a.dim[1]] - py);
  g[0] = 0.0f + (p0 + p0);
  g[1] = 0.0f + (p1 + p1);
}
#endif  // CT_ROUTE

struct ProxCost {
  float dx, dy, dsq, dist, gap;
};

template <typename V>
__device__ __forceinline__ ProxCost prox_cost_geom(const CostAtom& a,
                                                   const V& v) {
  ProxCost p;
  p.dx = v[a.dim[0]] - v[a.dim[2]];
  p.dy = v[a.dim[1]] - v[a.dim[3]];
  p.dsq = p.dx * p.dx + p.dy * p.dy;
  p.dist = fmath::sqrt(clamp_min(p.dsq, EPS));
  p.gap = a.aux - p.dist;
  return p;
}

// atoms.proximity's grad_pairs: (px, py) of
// [(x1, px), (y1, py), (x2, -px), (y2, -py)].
template <typename V>
__device__ __forceinline__ void prox_cost_grad(const CostAtom& a, const V& v,
                                               float& px, float& py) {
  const ProxCost p = prox_cost_geom(a, v);
  const bool live = (p.dsq >= EPS) && (p.dsq < a.aux2);
  const float ct = live ? -a.w * p.gap / p.dist : 0.0f;
  px = ct * p.dx;
  py = ct * p.dy;
}

// atoms.proximity's quad_pairs: the gradient (gx, gy) of
// [(x1, gx), (y1, gy), (x2, -gx), (y2, -gy)] and h[2][2] of the 4 x 4
// Hessian over (x1, y1, x2, y2), h on the diagonal blocks, -h off them.
template <typename V>
__device__ __forceinline__ void prox_cost_quad(const CostAtom& a, const V& v,
                                               float& gx, float& gy,
                                               float h[2][2]) {
  const ProxCost p = prox_cost_geom(a, v);
  const float inside = (p.dsq < a.aux2) ? 1.0f : 0.0f;
  const float clamp = (p.dsq > EPS) ? 1.0f : ((p.dsq == EPS) ? 0.5f : 0.0f);
  const float cg = (0.5f * a.w) * p.gap;
  const float g = -(cg + cg) / (p.dist + p.dist) * clamp * inside;
  gx = g * p.dx + g * p.dx;
  gy = g * p.dy + g * p.dy;
  const float k = a.w * clamp * inside / p.dist;
  const float nx = p.dx / p.dist, ny = p.dy / p.dist;
  h[0][0] = k * (a.aux * nx * nx - p.gap);
  h[1][1] = k * (a.aux * ny * ny - p.gap);
  h[0][1] = k * (a.aux * nx * ny);
  h[1][0] = h[0][1];
}

// An atom's final-time gate at time t: 1.0 or 0.0; ungated atoms are not
// multiplied at all (gv).
struct Gate {
  bool on;
  float g;
  __device__ __forceinline__ float operator()(float v) const {
    return on ? v * g : v;
  }
};
__device__ __forceinline__ Gate gate_of(const CostAtom& a, float t) {
  return Gate{a.gated != 0, (t >= a.tgate) ? 1.0f : 0.0f};
}

// base.mu_eff_ineq.
__device__ __forceinline__ float mu_eff_ineq(float g, float lam, float mu) {
  const bool inactive = (g <= SMALL_NUMBER) && (fabsf(lam) <= SMALL_NUMBER);
  return inactive ? 0.0f : mu;
}

struct ProxGeom {
  float dx, dy, ssq, prox, g, live;
};

template <typename V>
__device__ __forceinline__ ProxGeom prox_geom(const CostAtom& a, const V& v) {
  ProxGeom p;
  p.dx = v[a.dim[0]] - v[a.dim[2]];
  p.dy = v[a.dim[1]] - v[a.dim[3]];
  p.ssq = p.dx * p.dx + p.dy * p.dy;
  p.prox = fmath::sqrt(clamp_min(p.ssq, EPS));
  p.g = a.aux * (p.prox - a.w);
  p.live = (p.ssq >= EPS) ? 1.0f : 0.0f;
  return p;
}

// constraints.proximity's al_grad_pairs: (px, py) of
// [(x1, px), (y1, py), (x2, -px), (y2, -py)].
template <typename V>
__device__ __forceinline__ void prox_grad(const CostAtom& a, const V& v,
                                          float lam, float mu, float& px,
                                          float& py) {
  const ProxGeom p = prox_geom(a, v);
  const float ct =
      (lam + mu_eff_ineq(p.g, lam, mu) * p.g) * a.aux * p.live / p.prox;
  px = ct * p.dx;
  py = ct * p.dy;
}

// constraints.proximity's al_quad_pairs: px, py as above and the Hessian
// entries hxx, hyy, hxy.
template <typename V>
__device__ __forceinline__ void prox_quad(const CostAtom& a, const V& v,
                                          float lam, float mu, float& px,
                                          float& py, float& hxx, float& hyy,
                                          float& hxy) {
  const ProxGeom p = prox_geom(a, v);
  const float s = a.aux;
  const float mu_eff = mu_eff_ineq(p.g, lam, mu);
  const float lam_t = lam + mu_eff * p.g;
  const float inv = 1.0f / p.prox;
  const float gx = s * p.dx * inv;
  const float gy = s * p.dy * inv;
  const float ct = lam_t * p.live;
  px = ct * gx;
  py = ct * gy;
  const float nx = p.dx * inv, ny = p.dy * inv;
  hxx = (mu_eff * gx * gx + lam_t * s * (ny * ny) * inv) * p.live;
  hyy = (mu_eff * gy * gy + lam_t * s * (nx * nx) * inv) * p.live;
  hxy = (mu_eff * gx * gy - lam_t * s * (nx * ny) * inv) * p.live;
}

// atoms.quadratic_norm's grad_pairs: (g1, g2) of [(d1, g1), (d2, g2)].
template <typename V>
__device__ __forceinline__ void norm_grad(const CostAtom& a, const V& v,
                                          float& g1, float& g2) {
  const float x = v[a.dim[0]], y = v[a.dim[1]];
  const float n = fmath::sqrt(clamp_min(x * x + y * y, EPS));
  const float ct = a.w * (n - a.aux) / n;
  g1 = ct * x;
  g2 = ct * y;
}

// atoms.semiquadratic_norm's dense gradient at (d1, d2): autodiff's
// operations (atoms._norm_quad), zero where the norm is not at or beyond
// the threshold on its side.
template <typename V>
__device__ __forceinline__ void semi_norm_grad(const CostAtom& a, const V& v,
                                               float& g1, float& g2) {
  const float x = v[a.dim[0]], y = v[a.dim[1]];
  const float s = x * x + y * y;
  const float n = fmath::sqrt(clamp_min(s, EPS));
  const float d = n - a.aux;
  const float clamp = (s > EPS) ? 1.0f : ((s == EPS) ? 0.5f : 0.0f);
  const float ct = (((0.5f * a.w) * (d + d)) * (0.5f / n)) * clamp;
  const bool on = a.right ? n >= a.aux : n <= a.aux;
  g1 = on ? ct * x + ct * x : 0.0f;
  g2 = on ? ct * y + ct * y : 0.0f;
}

#if CT_DIFF
// atoms.quadratic_difference's gradient: g[n] = p + p with p = (0.5 w) *
// (v[d1[n]] - v[d2[n]]); its pairs are (d1[n], 0 + g[n]) and
// (d2[n], 0 + -g[n]), the 0 the JAX package's scatter into zeros.
template <typename V>
__device__ __forceinline__ void qdiff_grad(const CostAtom& a, const V& v,
                                           float g[2]) {
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const float p = (0.5f * a.w) * (v[a.dim[n]] - v[a.dim[2 + n]]);
    g[n] = p + p;
  }
}
#endif  // CT_DIFF

#if CT_SEMI
// atoms.semiquadratic at the value x of its dim: its gradient w * diff
// and Hessian w where diff = x - threshold is strictly beyond it on its
// side (right: above), else 0.
__device__ __forceinline__ bool semi_active(const CostAtom& a, float x,
                                            float& diff) {
  diff = x - a.aux;
  return a.right ? diff > 0.0f : diff < 0.0f;
}
#endif  // CT_SEMI

#if CT_REACH
struct SignedDist {
  float dx, dy, ssq;
};

template <typename V>
__device__ __forceinline__ SignedDist sd_diff(const CostAtom& a, const V& v) {
  SignedDist p;
  p.dx = v[a.dim[0]] - v[a.dim[2]];
  p.dy = v[a.dim[1]] - v[a.dim[3]];
  p.ssq = p.dx * p.dx + p.dy * p.dy;
  return p;
}

// atoms.signed_distance's evaluate: s * (nominal - ||p1 - p2||).
template <typename V>
__device__ __forceinline__ float sd_value(const CostAtom& a, const V& v) {
  const SignedDist p = sd_diff(a, v);
  return a.w * (a.aux - fmath::sqrt(clamp_min(p.ssq, EPS)));
}

// atoms.signed_distance's grad_pairs: (gx, gy) of
// [(x1, gx), (y1, gy), (x2, -gx), (y2, -gy)].
template <typename V>
__device__ __forceinline__ void sd_grad(const CostAtom& a, const V& v,
                                        float& gx, float& gy) {
  const SignedDist p = sd_diff(a, v);
  const float d = fmath::sqrt(clamp_min(p.ssq, EPS));
  const float live = (p.ssq > EPS) ? 1.0f : 0.0f;
  const float ct = ((-a.w * 0.5f) / d) * live;
  const float px = ct * p.dx, py = ct * p.dy;
  gx = px + px;
  gy = py + py;
}

// atoms.signed_distance's quad_pairs: the gradient (gx, gy) as above and
// h[2][2] of the 4 x 4 Hessian over (x1, y1, x2, y2), h on the blocks of
// one point, -h across.
template <typename V>
__device__ __forceinline__ void sd_quad(const CostAtom& a, const V& v,
                                        float& gx, float& gy,
                                        float h[2][2]) {
  const SignedDist p = sd_diff(a, v);
  const float m = clamp_min(p.ssq, EPS);
  const float w = (p.ssq > EPS) ? 1.0f : ((p.ssq == EPS) ? 0.5f : 0.0f);
  const float q = 0.5f / fmath::sqrt(m);
  const float half_inv = 0.5f * (1.0f / m);
  const float ns = -a.w;
  const float c = (q * ns) * w;
  const float ws = w * ns;
  const float tx = (-(((p.dx + p.dx) * w) * q) * half_inv) * ws;
  const float ty = (-(((p.dy + p.dy) * w) * q) * half_inv) * ws;
  const float ha = c + p.dx * tx, hb = c + p.dy * ty;
  h[0][0] = ha + ha;
  h[1][1] = hb + hb;
  h[0][1] = p.dx * ty + p.dx * ty;
  h[1][0] = p.dy * tx + p.dy * tx;
  gx = p.dx * c + p.dx * c;
  gy = p.dy * c + p.dy * c;
}

// The active member of the extremal group whose header is atom `hdr`: the
// first largest (smallest, right = 1) member value, or the first NaN
// (base.extreme_index).
template <typename V>
__device__ __forceinline__ int extreme_active(const CostTable& tab, int hdr,
                                              const V& v) {
  const CostAtom& a = tab.atom[hdr];
  int best = 0;
  float bv = sd_value(tab.atom[hdr + 1], v);
  for (int c = 1; c < a.group; ++c) {
    const float x = sd_value(tab.atom[hdr + 1 + c], v);
    const bool take = (x != x) ? (bv == bv) : (a.right ? x < bv : x > bv);
    if (take) {
      best = c;
      bv = x;
    }
  }
  return best;
}

#endif  // CT_REACH

#if CT_REACH || CT_ZOO
// constraints.single_dimension's AL gradient at its dim for the value x
// there: lam + mu_eff * g, negated when keeping above; mu_eff its Hessian.
__device__ __forceinline__ float single_dim_ct(const CostAtom& a, float x,
                                               float lam, float mu,
                                               float& mu_eff) {
  const float g = (a.aux > 0.0f) ? x - a.w : a.w - x;
  mu_eff = mu_eff_ineq(g, lam, mu);
  const float ct = lam + mu_eff * g;
  return (a.aux > 0.0f) ? ct : -ct;
}
#endif  // CT_REACH || CT_ZOO

#if CT_ZOO
// atoms._distance_quad with coef c (relative_distance: c = w): the
// gradient (gx, gy) of [(x1, gx), (y1, gy), (x2, -gx), (y2, -gy)] and
// h[2][2] of the 4 x 4 Hessian over (x1, y1, x2, y2), h on the blocks of
// one point, -h across.
template <typename V>
__device__ __forceinline__ void dist_quad(const CostAtom& a, const V& v,
                                          float coef, float& gx, float& gy,
                                          float h[2][2]) {
  const float dx = v[a.dim[0]] - v[a.dim[2]];
  const float dy = v[a.dim[1]] - v[a.dim[3]];
  const float ssq = dx * dx + dy * dy;
  const float m = clamp_min(ssq, EPS);
  const float w = (ssq > EPS) ? 1.0f : ((ssq == EPS) ? 0.5f : 0.0f);
  const float q = 0.5f / fmath::sqrt(m);
  const float half_inv = 0.5f * (1.0f / m);
  const float c = (q * coef) * w;
  const float ws = w * coef;
  const float tx = (-(((dx + dx) * w) * q) * half_inv) * ws;
  const float ty = (-(((dy + dy) * w) * q) * half_inv) * ws;
  const float ha = c + dx * tx, hb = c + dy * ty;
  h[0][0] = ha + ha;
  h[1][1] = hb + hb;
  h[0][1] = dx * ty + dx * ty;
  h[1][0] = dy * tx + dy * tx;
  gx = dx * c + dx * c;
  gy = dy * c + dy * c;
}

// atoms._norm_quad (quadratic_norm's quad pairs, K1): the gradient
// g[0..1] at (d1, d2) and the Hessian h = (h11, h22, h12).
template <typename V>
__device__ __forceinline__ void norm_quad(const CostAtom& a, const V& v,
                                          float g[2], float h[3]) {
  const float x = v[a.dim[0]], y = v[a.dim[1]];
  const float s = x * x + y * y;
  const float n = fmath::sqrt(clamp_min(s, EPS));
  const float d = n - a.aux;
  const float clamp = (s > EPS) ? 1.0f : ((s == EPS) ? 0.5f : 0.0f);
  const float half = 0.5f * a.w;
  const float ct = ((half * (d + d)) * (0.5f / n)) * clamp;
  const float k1 = ((a.w * clamp) * d) / n;
  const float k2 = (((a.w * clamp) * clamp) * a.aux) / ((n * n) * n);
  g[0] = ct * x + ct * x;
  g[1] = ct * y + ct * y;
  h[0] = k1 + (k2 * x) * x;
  h[1] = k1 + (k2 * y) * y;
  h[2] = (k2 * x) * y;
}

// atoms.curvature's pairs over (omega, v): the gradient g[0..1] and, with
// HESS, h[0..3] = (h(o, o), h(o, v), h(v, o), h(v, v)): the forward pass
// of the gradient's operations along each support direction.
struct CurvTangent {
  float go, gv;
};
__device__ __forceinline__ CurvTangent curv_tangent(float o, float s,
                                                    float r, float r3,
                                                    float half, float gg,
                                                    float x, float d_o,
                                                    float d_v) {
  const float dq = d_o / s + ((-d_v) * o) * r;
  const float dg = half * dq + half * dq;
  const float dr = d_v * (-2.0f * r3);
  CurvTangent t;
  t.go = dg / s + ((-d_v) * gg) * r;
  t.gv = -((dg * r + gg * dr) * o + x * d_o);
  return t;
}

template <bool HESS, typename V>
__device__ __forceinline__ void curv_terms(const CostAtom& a, const V& v,
                                           float g[2], float h[4]) {
  const float o = v[a.dim[0]], s = v[a.dim[1]];
  const float half = 0.5f * a.w;
  const float q = o / s;
  const float r = 1.0f / (s * s);
  const float gg = half * q + half * q;
  g[0] = 0.0f + gg / s;
  g[1] = -((gg * r) * o) + 0.0f;
  if (HESS) {
    const float r3 = 1.0f / ((s * s) * s);
    const float x = gg * r;
    const CurvTangent to = curv_tangent(o, s, r, r3, half, gg, x, 1.0f, 0.0f);
    const CurvTangent tv = curv_tangent(o, s, r, r3, half, gg, x, 0.0f, 1.0f);
    h[0] = to.go;
    h[1] = tv.go;
    h[2] = to.gv;
    h[3] = tv.gv;
  }
}

// atoms.orientation's wrapped angle: fmod((x - nominal) + pi, 2 pi) - pi
// in float32.
__device__ __forceinline__ float orient_wrap(const CostAtom& a, float x) {
  const float pi = 3.14159265358979323846f;
  return fmodf((x - a.aux) + pi, 6.28318530717958647692f) - pi;
}

// atoms.quadratic_difference's difference n of the group headed by atom
// `hdr`: g = p + p with p = (0.5 w) * (v[d1[n]] - v[d2[n]]).
template <typename V>
__device__ __forceinline__ float qdiff_n_grad(const CostTable& tab, int hdr,
                                              int n, const V& v) {
  const CostAtom& m = tab.atom[hdr + 1 + n];
  const float p = (0.5f * tab.atom[hdr].w) * (v[m.dim[0]] - v[m.dim[1]]);
  return p + p;
}

// The support index r (0 .. 2 count - 1) of that group: d1[r], then
// d2[r - count].
__device__ __forceinline__ int qdiff_n_dim(const CostTable& tab, int hdr,
                                           int r) {
  const int cnt = tab.atom[hdr].group;
  return r < cnt ? tab.atom[hdr + 1 + r].dim[0]
                 : tab.atom[hdr + 1 + r - cnt].dim[1];
}

#if CT_NORMS
// The convex proximities' dense merit gradient (atoms.
// locally_convex_proximity, atoms.weighted_convex_proximity): the shipped
// gradient on the active axis (x where its penalty is strictly smaller),
// its pairs added in the JAX package's order; nothing where inactive.
template <typename V, typename DAcc, typename G>
__device__ __forceinline__ void convex_grad(const CostAtom& a, const V& v,
                                            DAcc& gd, const G& gv) {
  const float dx = v[a.dim[0]] - v[a.dim[2]];
  const float dy = v[a.dim[1]] - v[a.dim[3]];
  if (dx * dx >= a.aux2 || dy * dy >= a.aux2) return;
  const float delta_x = a.aux - fabsf(dx), delta_y = a.aux - fabsf(dy);
  const bool is_x = delta_x * delta_x < delta_y * delta_y;
  const int a1 = is_x ? a.dim[0] : a.dim[1];
  const int a2 = is_x ? a.dim[2] : a.dim[3];
  const float delta = is_x ? delta_x : delta_y;
  if (a.kind == KIND_LOCAL_CONVEX) {
    const float dval = -a.w * delta;
    gd.add(a1, gv(dval));
    gd.add(a2, gv(-dval));
    return;
  }
  const float s1 = v[a.seg0], s2 = v[a.nseg];
  const float vv = s1 * s1 + s2 * s2;
  const float da1 = ((-a.w) * delta) * vv;
  gd.add(a1, gv(da1));
  gd.add(a2, gv(-da1));
  gd.add(a.seg0, gv((((-a.w) * s1) * delta) * delta));
  gd.add(a.nseg, gv((((-a.w) * s2) * delta) * delta));
}
#endif  // CT_NORMS
#endif  // CT_ZOO

// The dense accumulator of a library built without the norm atoms, which
// never reads it.
struct NoAcc {};

// Sparse accumulation into a thread's own dense vector: the first pair of
// a key sets it, later ones add.
template <int D>
struct GradAcc {
  static_assert(D <= 32, "one seen bit per key in a 32-bit word");
  float g[D];
  unsigned seen;
  __device__ __forceinline__ void reset() { seen = 0u; }
  __device__ __forceinline__ void add(int d, float v) {
    g[d] = ((seen >> d) & 1u) ? g[d] + v : v;
    seen |= 1u << d;
  }
  // sum over the seen keys, ascending, of g^2, from 0.
  __device__ __forceinline__ float sq() const {
    float s = 0.0f;
    for (int d = 0; d < D; ++d)
      if ((seen >> d) & 1u) s = s + g[d] * g[d];
    return s;
  }
};

// GradAcc's accumulation in registers that a run-time key never indexes:
// each add compares the key with every d. For small D (a player's
// controls).
template <int D>
struct SelectGradAcc {
  static_assert(D <= 32, "one seen bit per key in a 32-bit word");
  float g[D];
  unsigned seen;
  __device__ __forceinline__ void reset() { seen = 0u; }
  __device__ __forceinline__ void add(int d, float v) {
#pragma unroll
    for (int j = 0; j < D; ++j)
      if (j == d) g[j] = ((seen >> j) & 1u) ? g[j] + v : v;
    seen |= 1u << d;
  }
  __device__ __forceinline__ float sq() const {
    float s = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d)
      if ((seen >> d) & 1u) s = s + g[d] * g[d];
    return s;
  }
};

// GradAcc's accumulation in one thread's column of a [D][32] shared array.
template <int D>
struct ColumnGradAcc {
  static_assert(D <= 32, "one seen bit per key in a 32-bit word");
  float* g;  // the thread's entry of row 0; row d is 32 floats further
  unsigned seen;
  __device__ __forceinline__ void reset() { seen = 0u; }
  __device__ __forceinline__ void add(int d, float v) {
    float& e = g[32 * d];
    e = ((seen >> d) & 1u) ? e + v : v;
    seen |= 1u << d;
  }
  __device__ __forceinline__ float sq() const {
    float s = 0.0f;
    for (int d = 0; d < D; ++d)
      if ((seen >> d) & 1u) s = s + g[32 * d] * g[32 * d];
    return s;
  }
  // key d's value, 0 where no pair set it.
  __device__ __forceinline__ float at(int d) const {
    return ((seen >> d) & 1u) ? g[32 * d] : 0.0f;
  }
};

// A thread's column of a [rows][32] shared array, read as v[d].
struct Column {
  const float* p;  // the thread's entry of row 0
  __device__ __forceinline__ float operator[](int d) const {
    return p[32 * d];
  }
};

// A thread's D values in registers, read as v[d] at a run-time d by
// selects.
template <int D>
struct Selected {
  const float* r;
  __device__ __forceinline__ float operator[](int d) const {
    float v = r[0];
#pragma unroll
    for (int j = 1; j < D; ++j) v = (d == j) ? r[j] : v;
    return v;
  }
};

// player_cost.stage_gradient_sq_tuple for one player i at one knot of time
// t: (state_sq, ctrl_sq) from the state v [X] and player i's controls ui
// [U], accumulated in gs (keys 0 .. X-1; the dense atoms' in gd) and gu
// (keys 0 .. U-1). lam(row) gives the multiplier of lamS row `row`, lamc(row)
// that of lamC row `row` (read only with CT_REACH). The extremal gate of the
// knot is the caller's.
template <int X, int U, typename V, typename SAcc, typename DAcc, typename C,
          typename CAcc, typename Lam, typename LamC>
__device__ __forceinline__ void gradient_sq_into(
    const CostTable& tab, const float* segs, int i, const V& v, SAcc& gs,
    DAcc& gd, const C& ui, CAcc& gu, Lam lam, LamC lamc, float mu, float t,
    float& state_sq, float& ctrl_sq) {
  gs.reset();
#if CT_NORMS
  gd.reset();
  bool dense = false;
#endif
#if CT_REACH
  // The current extremal group's active member, and the next member's
  // index: a header starts a group, its members follow it.
  int active = 0, member = 0;
#endif
  for (int n = 0; n < tab.n; ++n) {
    const CostAtom& a = tab.atom[n];
    if (a.player != i || a.on >= 0) continue;
#if CT_REACH
    if (a.kind == KIND_EXTREME) {
      active = extreme_active(tab, n, v);
      member = 0;
      continue;
    }
#endif
    const Gate gv = gate_of(a, t);
    if (a.kind == KIND_QUADRATIC) {
      gs.add(a.dim[0], gv(a.w * (v[a.dim[0]] - a.aux)));
    } else if (a.kind == KIND_POLYLINE || a.kind == KIND_SEMI_POLYLINE) {
      float sc[5];
      if (a.kind == KIND_POLYLINE)
        polyline_scalars(a, segs, v, sc);
      else
        semi_scalars(a, segs, v, sc);
      gs.add(a.dim[0], gv(sc[0]));
      gs.add(a.dim[1], gv(sc[1]));
    } else if (a.kind == KIND_PROXIMITY || a.kind == KIND_PROXIMITY_COST) {
      float px, py;
      if (a.kind == KIND_PROXIMITY)
        prox_grad(a, v, lam(a.lam), mu, px, py);
      else
        prox_cost_grad(a, v, px, py);
      gs.add(a.dim[0], gv(px));
      gs.add(a.dim[1], gv(py));
      gs.add(a.dim[2], gv(-px));
      gs.add(a.dim[3], gv(-py));
    }
#if CT_NORMS
    else if (a.kind == KIND_QUADRATIC_NORM) {
      float g1, g2;
      norm_grad(a, v, g1, g2);
      gs.add(a.dim[0], gv(g1));
      gs.add(a.dim[1], gv(g2));
    } else if (a.kind == KIND_SEMI_NORM) {
      float g1, g2;
      semi_norm_grad(a, v, g1, g2);
      gd.add(a.dim[0], gv(g1));
      gd.add(a.dim[1], gv(g2));
      dense = true;
    }
#endif
#if CT_REACH
    else if (a.kind == KIND_SIGNED_DIST) {
      float gx, gy;
      sd_grad(a, v, gx, gy);
      if (a.group < 0) {  // a member: times its one-hot gate
        const float g = (member++ == active) ? 1.0f : 0.0f;
        gx = gx * g;
        gy = gy * g;
      }
      gs.add(a.dim[0], gv(gx));
      gs.add(a.dim[1], gv(gy));
      gs.add(a.dim[2], gv(-gx));
      gs.add(a.dim[3], gv(-gy));
    }
#endif
#if CT_SEMI
    else if (a.kind == KIND_SEMIQUADRATIC) {
      float diff;
      const bool on = semi_active(a, v[a.dim[0]], diff);
      gs.add(a.dim[0], gv(on ? a.w * diff : 0.0f));
    }
#endif
#if CT_POLYSD
    else if (a.kind == KIND_POLY_SD) {
      float sc[5];
      polysd_scalars<false>(a, segs, v, sc);
      gs.add(a.dim[0], gv(sc[0]));
      gs.add(a.dim[1], gv(sc[1]));
    }
#endif
#if CT_ROUTE
    else if (a.kind == KIND_ROUTE) {
      float g[2];
      route_grad(a, segs, v, t, g);
      gs.add(a.dim[0], gv(g[0]));
      gs.add(a.dim[1], gv(g[1]));
    }
#endif
#if CT_DIFF
    else if (a.kind == KIND_QUAD_DIFF) {
      float g[2];
      qdiff_grad(a, v, g);
      gs.add(a.dim[0], gv(0.0f + g[0]));
      gs.add(a.dim[1], gv(0.0f + g[1]));
      gs.add(a.dim[2], gv(0.0f + -g[0]));
      gs.add(a.dim[3], gv(0.0f + -g[1]));
    }
#endif
#if CT_ZOO
    else if (a.kind == KIND_REL_DIST) {
      float gx, gy, h[2][2];
      dist_quad(a, v, a.w, gx, gy, h);
      gs.add(a.dim[0], gv(gx));
      gs.add(a.dim[1], gv(gy));
      gs.add(a.dim[2], gv(-gx));
      gs.add(a.dim[3], gv(-gy));
    } else if (a.kind == KIND_NOMINAL_PATH) {
      gs.add(a.dim[0], gv(a.w * (v[a.dim[0]] - t * a.aux)));
    } else if (a.kind == KIND_CURVATURE) {
      float g[2], h[4];
      curv_terms<false>(a, v, g, h);
      gs.add(a.dim[0], gv(g[0]));
      gs.add(a.dim[1], gv(g[1]));
    } else if (a.kind == KIND_ORIENTATION) {
      const float p = (0.5f * a.w) * orient_wrap(a, v[a.dim[0]]);
      gs.add(a.dim[0], gv(p + p));
    } else if (a.kind == KIND_QUAD_DIFF_N) {
      for (int m = 0; m < a.group; ++m)
        gs.add(tab.atom[n + 1 + m].dim[0],
               gv(0.0f + qdiff_n_grad(tab, n, m, v)));
      for (int m = 0; m < a.group; ++m)
        gs.add(tab.atom[n + 1 + m].dim[1],
               gv(0.0f + -qdiff_n_grad(tab, n, m, v)));
    } else if (a.kind == KIND_SINGLE_DIM) {  // a state constraint
      float mu_eff;
      gs.add(a.dim[0],
             gv(single_dim_ct(a, v[a.dim[0]], lam(a.lam), mu, mu_eff)));
    }
#if CT_NORMS
    else if (a.kind == KIND_LOCAL_CONVEX || a.kind == KIND_WEIGHTED_CONVEX) {
      convex_grad(a, v, gd, gv);
      dense = true;
    }
#endif
#endif
  }
#if CT_NORMS
  if (dense) {
    float s = 0.0f;
    for (int d = 0; d < X; ++d) {
      const float e = gs.at(d) + gd.at(d);
      s = s + e * e;
    }
    state_sq = s;
  } else {
    state_sq = gs.sq();
  }
#else
  state_sq = gs.sq();
#endif
  gu.reset();
  for (int n = 0; n < tab.n; ++n) {
    const CostAtom& a = tab.atom[n];
#if CT_REACH
    if (a.player != i || a.on != i) continue;
    if (a.kind == KIND_SINGLE_DIM) {
      float mu_eff;
      gu.add(a.dim[0], single_dim_ct(a, ui[a.dim[0]], lamc(a.lam), mu,
                                     mu_eff));
      continue;
    }
    if (a.kind != KIND_QUADRATIC) continue;
#else
    if (a.player != i || a.on != i || a.kind != KIND_QUADRATIC) continue;
#endif
    const Gate gv = gate_of(a, t);
    gu.add(a.dim[0], gv(a.w * (ui[a.dim[0]] - a.aux)));
  }
  ctrl_sq = gu.sq();
}

#if !CT_NORMS
// gradient_sq_into on a thread's own state v [X] and padded controls
// u [P * U], accumulated in its own arrays.
template <int X, int U, typename Lam>
__device__ void gradient_sq(const CostTable& tab, const float* segs, int i,
                            const float* v, const float* u, Lam lam, float mu,
                            float t, float& state_sq, float& ctrl_sq) {
  GradAcc<X> gs;
  NoAcc gd;
  GradAcc<U> gu;
  const float* ui = u + i * U;
  gradient_sq_into<X, U>(tab, segs, i, v, gs, gd, ui, gu, lam,
                         [](int) { return 0.0f; }, mu, t, state_sq, ctrl_sq);
}
#endif  // the register form has no dense accumulator: no norm atoms

// The models' analytic Jacobian entries at state x and the knot's flat
// controls u, in dynamics/models.py's order: add(false, row, col, v) for
// df/dx and add(true, row, flat control col, v) for df/du. A linear
// system's entries are already those of A and Bf: set(is_u, row, col, v)
// stores them, whether the system is one subsystem or one linear
// subsystem per player (a flat system). A coupled system's entries read u (air_3d's df/dx holds
// the evader's turn rate) and are compiled in with CT_COUPLED only.
template <typename Add, typename Set>
__device__ void jacobian(const SubsysTable& tab, const float* x,
                         const float* u, Add add, Set set) {
  if (tab.kind[0] == KIND_LINEAR) {
    for (int e = 0; e < tab.nlin; ++e)
      set(tab.lin_u[e] != 0, tab.lin_row[e], tab.lin_col[e], tab.lin_val[e]);
    return;
  }
#if CT_COUPLED
  // The whole state from offset 0; controls flat, player-major (U = 2
  // for the unicycle and its disturbance, U = 1 for air_3d).
  if (tab.n == 1 && tab.kind[0] == KIND_TWO_UNICYCLE) {
    const float sn = fmath::sin(x[2]), cs = fmath::cos(x[2]);
    add(false, 0, 2, -x[3] * sn);
    add(false, 0, 3, cs);
    add(false, 1, 2, x[3] * cs);
    add(false, 1, 3, sn);
    add(true, 2, 0, 1.0f);
    add(true, 3, 1, 1.0f);
    add(true, 0, 2, 1.0f);
    add(true, 1, 3, 1.0f);
    return;
  }
  if (tab.n == 1 && tab.kind[0] == KIND_AIR_3D) {
    const float vp = tab.param2[0];
    const float w1 = u[0];
    add(false, 0, 1, w1);
    add(false, 0, 2, (-vp) * fmath::sin(x[2]));
    add(false, 1, 0, -w1);
    add(false, 1, 2, vp * fmath::cos(x[2]));
    add(true, 0, 0, x[1]);
    add(true, 1, 0, -x[0]);
    add(true, 2, 0, -1.0f);
    add(true, 2, 1, 1.0f);
    return;
  }
#endif
  for (int s = 0; s < tab.n; ++s) {
    const int o = tab.xoff[s];
    const int q = tab.uoff[s];
    if (tab.kind[s] == KIND_CAR_6D) {
      const float L = tab.length[s];
      const float sn = fmath::sin(x[o + 2]), cs = fmath::cos(x[o + 2]);
      const float cos_phi = fmath::cos(x[o + 3]);
      const float sec2 = 1.0f / (cos_phi * cos_phi);
      add(false, o + 0, o + 2, -x[o + 4] * sn);
      add(false, o + 0, o + 4, cs);
      add(false, o + 1, o + 2, x[o + 4] * cs);
      add(false, o + 1, o + 4, sn);
      add(false, o + 2, o + 3, (x[o + 4] / L) * sec2);
      add(false, o + 2, o + 4, fmath::tan(x[o + 3]) / L);
      add(false, o + 4, o + 5, 1.0f);
      add(true, o + 3, q + 0, 1.0f);
      add(true, o + 5, q + 1, 1.0f);
    } else if (tab.kind[s] == KIND_UNICYCLE_4D) {
      const float sn = fmath::sin(x[o + 2]), cs = fmath::cos(x[o + 2]);
      add(false, o + 0, o + 2, -x[o + 3] * sn);
      add(false, o + 0, o + 3, cs);
      add(false, o + 1, o + 2, x[o + 3] * cs);
      add(false, o + 1, o + 3, sn);
      add(true, o + 2, q + 0, 1.0f);
      add(true, o + 3, q + 1, 1.0f);
    }
#if CT_CAR5D
    else if (tab.kind[s] == KIND_CAR_5D) {
      const float L = tab.length[s];
      const float sn = fmath::sin(x[o + 2]), cs = fmath::cos(x[o + 2]);
      const float cos_phi = fmath::cos(x[o + 3]);
      const float sec2 = 1.0f / (cos_phi * cos_phi);
      add(false, o + 0, o + 2, -x[o + 4] * sn);
      add(false, o + 0, o + 4, cs);
      add(false, o + 1, o + 2, x[o + 4] * cs);
      add(false, o + 1, o + 4, sn);
      add(false, o + 2, o + 3, (x[o + 4] / L) * sec2);
      add(false, o + 2, o + 4, fmath::tan(x[o + 3]) / L);
      add(true, o + 3, q + 0, 1.0f);
      add(true, o + 4, q + 1, 1.0f);
    }
#endif
#if CT_DUBINS
    else if (tab.kind[s] == KIND_DUBINS) {
      const float speed = tab.length[s];
      add(false, o + 0, o + 2, (-speed) * fmath::sin(x[o + 2]));
      add(false, o + 1, o + 2, speed * fmath::cos(x[o + 2]));
      add(true, o + 2, q + 0, 1.0f);
    }
#endif
  }
}

}  // namespace costs
