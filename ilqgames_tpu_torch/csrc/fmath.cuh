// float32 sin, cos and tan that round the same on every device: the CUDA
// twin of ilqgames_tpu_torch/fmath.py, operation for operation.
//
// Only IEEE-rounded float32 +, -, *, / and floor are used, in the same
// order as fmath.py, so with FMA contraction off (--fmad=false) the card
// gives the bits that PyTorch gives on the CPU and on the card for the same
// sequence. Constants are the float32 values that fmath.py's Python floats
// round to, written as hex literals.
//
// Method (Cephes sinf/cosf/tanf): reduce |x| by multiples of pi/4 with a
// three-part Cody-Waite constant, then minimax polynomials by octant.

#pragma once

namespace fmath {

constexpr float FOPI = 0x1.45f306p+0f;  // 4 / pi
constexpr float DP1 = 0x1.92p-1f;
constexpr float DP2 = 0x1.fb4p-13f;
constexpr float DP3 = 0x1.4442d2p-25f;

// |x| = r + (q + 8m) * pi/4 with q in {0, 2, 4, 6}.
__device__ __forceinline__ void reduce(float x, float& r, float& q) {
  const float ax = fabsf(x);
  float j = floorf(ax * FOPI);
  j = j + (j - 2.0f * floorf(j * 0.5f));  // round up to even
  r = ((ax - j * DP1) - j * DP2) - j * DP3;
  q = j - 8.0f * floorf(j * 0.125f);
}

__device__ __forceinline__ float sin_poly(float r, float z) {
  return ((-0x1.9943f2p-13f * z + 0x1.11073cp-7f) * z - 0x1.555546p-3f) * z *
             r + r;
}

__device__ __forceinline__ float cos_poly(float z) {
  return (((0x1.99eb9cp-16f * z - 0x1.6c0c34p-10f) * z + 0x1.55554ap-5f) * z *
              z - 0.5f * z) + 1.0f;
}

__device__ __forceinline__ float sin(float x) {
  float r, q;
  reduce(x, r, q);
  const float z = r * r;
  const float s = sin_poly(r, z), c = cos_poly(z);
  float y = (q == 2.0f || q == 6.0f) ? c : s;
  y = (q >= 4.0f) ? -y : y;
  return (x < 0.0f) ? -y : y;
}

__device__ __forceinline__ float cos(float x) {
  float r, q;
  reduce(x, r, q);
  const float z = r * r;
  const float s = sin_poly(r, z), c = cos_poly(z);
  const float y = (q == 2.0f || q == 6.0f) ? s : c;
  return (q == 2.0f || q == 4.0f) ? -y : y;
}

__device__ __forceinline__ float tan(float x) {
  float r, q;
  reduce(x, r, q);
  const float z = r * r;
  const float s = sin_poly(r, z), c = cos_poly(z);
  const float y = (q == 2.0f || q == 6.0f) ? -(c / s) : s / c;
  return (x < 0.0f) ? -y : y;
}

}  // namespace fmath
