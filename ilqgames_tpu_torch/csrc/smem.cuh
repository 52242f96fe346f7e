// Dynamic shared memory above 48 KB, for the kernels that use it: K2 and K3
// (lq.cu) and K6 (merit.cu).

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

}  // namespace
