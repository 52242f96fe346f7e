// float32 sin, cos and tan that round the same on every device: the CUDA
// twin of ilqgames_tpu_torch/fmath.py, operation for operation.
//
// Only IEEE-rounded float32 +, -, *, / and floor (and, for large
// arguments, an exact integer reduction) are used, in the same order as
// fmath.py, so with FMA contraction off (--fmad=false) the card
// gives the bits that PyTorch gives on the CPU and on the card for the same
// sequence. Constants are the float32 values that fmath.py's Python floats
// round to, written as hex literals.
//
// Method (Cephes sinf/cosf/tanf): reduce |x| by multiples of pi/4 with a
// three-part Cody-Waite constant, then minimax polynomials by octant.
// Arguments beyond +-8192 are first reduced modulo the float64 value of
// 2*pi exactly and rounded to float32, as fmath.py's _large.

#pragma once

namespace fmath {

constexpr float FOPI = 0x1.45f306p+0f;  // 4 / pi
constexpr float DP1 = 0x1.92p-1f;
constexpr float DP2 = 0x1.fb4p-13f;
constexpr float DP3 = 0x1.4442d2p-25f;

constexpr float LARGE = 8192.0f;
constexpr double TWO_PI = 6.283185307179586;

// Arguments beyond +-LARGE reduced modulo TWO_PI, sign kept: the float32
// rounding of the exact fmod((double)|x|, TWO_PI), as fmath.py computes it,
// by integer arithmetic with no call and no loop (a call of fmod in the
// rollout's hot loop made it 3.4x slower on an H100, even never taken;
// this form costs it 1.23x on bounded lanes).
// TWO_PI = C_M * 2^-47 exactly, and |x| = M * 2^(e - 150) with M < 2^24 and
// biased exponent e >= 140, so fmod(|x|, TWO_PI) = ((M * 2^K) mod C_M) *
// 2^-47 with K = e - 103 in [37, 151]; POW2_MOD_CM[K] = 2^K mod C_M.
constexpr unsigned long long C_M = 0x3243f6a8885a3ull;  // < 2^50
__constant__ unsigned long long POW2_MOD_CM[152] = {
    0x0000000000001ull, 0x0000000000002ull, 0x0000000000004ull,
    0x0000000000008ull, 0x0000000000010ull, 0x0000000000020ull,
    0x0000000000040ull, 0x0000000000080ull, 0x0000000000100ull,
    0x0000000000200ull, 0x0000000000400ull, 0x0000000000800ull,
    0x0000000001000ull, 0x0000000002000ull, 0x0000000004000ull,
    0x0000000008000ull, 0x0000000010000ull, 0x0000000020000ull,
    0x0000000040000ull, 0x0000000080000ull, 0x0000000100000ull,
    0x0000000200000ull, 0x0000000400000ull, 0x0000000800000ull,
    0x0000001000000ull, 0x0000002000000ull, 0x0000004000000ull,
    0x0000008000000ull, 0x0000010000000ull, 0x0000020000000ull,
    0x0000040000000ull, 0x0000080000000ull, 0x0000100000000ull,
    0x0000200000000ull, 0x0000400000000ull, 0x0000800000000ull,
    0x0001000000000ull, 0x0002000000000ull, 0x0004000000000ull,
    0x0008000000000ull, 0x0010000000000ull, 0x0020000000000ull,
    0x0040000000000ull, 0x0080000000000ull, 0x0100000000000ull,
    0x0200000000000ull, 0x0400000000000ull, 0x0800000000000ull,
    0x1000000000000ull, 0x2000000000000ull, 0x0dbc095777a5dull,
    0x1b7812aeef4baull, 0x04ac2eb5563d1ull, 0x09585d6aac7a2ull,
    0x12b0bad558f44ull, 0x256175aab1e88ull, 0x187ef4acdb76dull,
    0x30fde959b6edaull, 0x2fb7dc0ae5811ull, 0x2d2bc16d42a7full,
    0x28138c31fcf5bull, 0x1de321bb71913ull, 0x09824cce5ac83ull,
    0x1304999cb5906ull, 0x260933396b20cull, 0x19ce6fca4de75ull,
    0x0158e8ec13747ull, 0x02b1d1d826e8eull, 0x0563a3b04dd1cull,
    0x0ac747609ba38ull, 0x158e8ec137470ull, 0x2b1d1d826e8e0ull,
    0x23f6445c54c1dull, 0x15a8921021297ull, 0x2b5124204252eull,
    0x245e5197fc4b9ull, 0x1678ac87703cfull, 0x2cf1590ee079eull,
    0x279ebb7538999ull, 0x1cf98041e8d8full, 0x07af09db4957bull,
    0x0f5e13b692af6ull, 0x1ebc276d255ecull, 0x0b345831c2635ull,
    0x1668b06384c6aull, 0x2cd160c7098d4ull, 0x275ecae58ac05ull,
    0x1c799f228d267ull, 0x06af479c91f2bull, 0x0d5e8f3923e56ull,
    0x1abd1e7247cacull, 0x0336463c073b5ull, 0x066c8c780e76aull,
    0x0cd918f01ced4ull, 0x19b231e039da8ull, 0x01206d17eb5adull,
    0x0240da2fd6b5aull, 0x0481b45fad6b4ull, 0x090368bf5ad68ull,
    0x1206d17eb5ad0ull, 0x240da2fd6b5a0ull, 0x15d74f524e59dull,
    0x2bae9ea49cb3aull, 0x251946a0b10d1ull, 0x17ee9698d9bffull,
    0x2fdd2d31b37feull, 0x2d7663badea59ull, 0x28a8d0cd34f0full,
    0x1f0daaf1e187bull, 0x0bd75f3b3ab53ull, 0x17aebe76756a6ull,
    0x2f5d7cecead4cull, 0x2c7703314d4f5ull, 0x26aa0fba12447ull,
    0x1b1028cb9c2ebull, 0x03dc5aeeb0033ull, 0x07b8b5dd60066ull,
    0x0f716bbac00ccull, 0x1ee2d77580198ull, 0x0b81b84277d8dull,
    0x17037084efb1aull, 0x2e06e109df634ull, 0x29c9cb6b366c5ull,
    0x214fa02de47e7ull, 0x105b49b340a2bull, 0x20b6936681456ull,
    0x0f2930247a309ull, 0x1e526048f4612ull, 0x0a60c9e960681ull,
    0x14c193d2c0d02ull, 0x298327a581a04ull, 0x20c258a27ae65ull,
    0x0f40ba9c6d727ull, 0x1e817538dae4eull, 0x0abef3c92d6f9ull,
    0x157de7925adf2ull, 0x2afbcf24b5be4ull, 0x23b3a7a0e3225ull,
    0x152358993dea7ull, 0x2a46b1327bd4eull, 0x22496bbc6f4f9ull,
    0x124ee0d05644full, 0x249dc1a0ac89eull, 0x16f78c98d0b99ull,
    0x2def1931a1732ull, 0x299a3bbaba8c1ull, 0x20f080ccecbdfull,
    0x0f9d0af15121bull, 0x1f3a15e2a2436ull, 0x0c30351cbc2c9ull,
    0x18606a3978592ull, 0x30c0d472f0b24ull,
};

// x mod C_M for x < 2^62: the quotient estimated in float64 is off by at
// most one, and the remainder is corrected by one C_M either way.
__device__ __forceinline__ long long mod_cm(unsigned long long x) {
  const long long q = (long long)floor((double)x * (1.0 / (double)C_M));
  long long r = (long long)x - q * (long long)C_M;
  r = (r < 0) ? r + (long long)C_M : r;
  return (r >= (long long)C_M) ? r - (long long)C_M : r;
}

__device__ __forceinline__ float large(float x) {
  const float ax = fabsf(x);
  if (!(ax > LARGE)) return x;
  if (!isfinite(ax)) return x - x;  // NaN, as fmod(inf, TWO_PI)
  const unsigned bits = __float_as_uint(ax);
  const unsigned long long m = (bits & 0x7fffffu) | 0x800000u;
  const unsigned long long t = POW2_MOD_CM[(bits >> 23) - 103];
  const long long r1 = mod_cm((m >> 12) * t);
  long long r = mod_cm((unsigned long long)r1 << 12) + mod_cm((m & 0xfffu) * t);
  r = (r >= (long long)C_M) ? r - (long long)C_M : r;
  return copysignf((float)((double)r * 0x1p-47), x);
}

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
  x = large(x);
  float r, q;
  reduce(x, r, q);
  const float z = r * r;
  const float s = sin_poly(r, z), c = cos_poly(z);
  float y = (q == 2.0f || q == 6.0f) ? c : s;
  y = (q >= 4.0f) ? -y : y;
  return (x < 0.0f) ? -y : y;
}

__device__ __forceinline__ float cos(float x) {
  x = large(x);
  float r, q;
  reduce(x, r, q);
  const float z = r * r;
  const float s = sin_poly(r, z), c = cos_poly(z);
  const float y = (q == 2.0f || q == 6.0f) ? s : c;
  return (q == 2.0f || q == 4.0f) ? -y : y;
}

__device__ __forceinline__ float tan(float x) {
  x = large(x);
  float r, q;
  reduce(x, r, q);
  const float z = r * r;
  const float s = sin_poly(r, z), c = cos_poly(z);
  const float y = (q == 2.0f || q == 6.0f) ? -(c / s) : s / c;
  return (x < 0.0f) ? -y : y;
}

// Correctly rounded, as fmath.py's sqrt (a float64 root rounded to float32).
__device__ __forceinline__ float sqrt(float x) { return __fsqrt_rn(x); }

}  // namespace fmath
