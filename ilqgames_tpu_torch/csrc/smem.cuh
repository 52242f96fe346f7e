// Shared-memory helpers of the kernels that stage operands: the opt-in to
// dynamic shared memory above 48 KB (K2, K3, K6, K7), cp.async copies (K2,
// K3, K7) and the block-wide staging of batch-minor operands into lane
// regions (K2, K7).

#pragma once

#include <cuda_runtime.h>

// Internal linkage: each kernel library is one translation unit.
namespace {

// The most dynamic shared memory a block may use on sm_90 (227 KB).
constexpr int MAX_SMEM = 232448;

// Above 48 KB a block's dynamic shared memory needs the kernel's opt-in,
// once per device; `opted` keeps a bit per device done.
int opt_in_smem(const void* kernel, int bytes, unsigned& opted) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 32 && ((opted >> dev) & 1u)) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return (int)err;
  if (dev < 32) opted |= 1u << dev;
  return 0;
}

// cp.async from device to shared memory: 4 bytes (cached in L1) or 16
// bytes (L2 only; both addresses 16-byte aligned). A thread's copies are
// done, and visible to it, after cp_async_wait<n> leaves at most n of its
// committed groups pending.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

// Stage n floats per lane of the batch-minor array src (element e of lane
// b at src[(base + e) * B + b]) into the regions of a block's G lanes (lane
// g's at sm + g * LANE, from float off), with loads and stores or, ASYNC,
// with 4-byte cp.async copies. Thread tid of the block's 32 G takes lane
// tid % G and elements tid / G + 32 j, so that the G lanes of one element
// are one coalesced read; lanes past B read the last lane. Where a thread
// has at most UNROLL copies (n a compile-time count), they unroll, their
// addresses a stride apart (K7, whose staging is on its chain); else they
// go round a loop (K2: unrolled, its copies cost it registers, and at the
// collision's dims a spill).
template <bool ASYNC, int G, int LANE, int n, int UNROLL = 0>
__device__ __forceinline__ void stage(float* sm, int off,
                                      const float* __restrict__ src,
                                      long base, int b0, int B, int tid) {
  const long Bl = B;
  auto copy = [&](float* dst, const float* from) {
    if constexpr (ASYNC)
      cp_async4(dst, from);
    else
      *dst = *from;
  };
  if constexpr ((n + 31) / 32 <= UNROLL) {
    const int g = tid % G, e0 = tid / G;
    const float* from = src + (base + e0) * Bl + min(b0 + g, B - 1);
    float* dst = sm + g * LANE + off + e0;
#pragma unroll
    for (int j = 0; j < (n + 31) / 32; ++j)
      if (e0 + 32 * j < n) copy(dst + 32 * j, from + 32 * j * Bl);
  } else {
    for (int idx = tid; idx < n * G; idx += 32 * G) {
      const int e = idx / G, g = idx % G;
      copy(sm + g * LANE + off + e,
           src + (base + e) * Bl + min(b0 + g, B - 1));
    }
  }
}

}  // namespace
