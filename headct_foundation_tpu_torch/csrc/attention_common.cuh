// Pieces shared by the attention kernels (flash_fwd.cuh, flash_bwd.cuh and
// the sm_90a kernels over sm90_common.cuh): operand strides, the forward's
// arguments, the tags that tell the whole-sequence kernels (B1, B2), the
// blocked ones (B3, B4, B5) and the token-major ones (B7, B8) apart in a
// profile, vector loads of float32 and bfloat16 operands, and the dynamic
// shared-memory attribute set once per kernel.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <map>
#include <mutex>
#include <utility>

namespace {

// Which kernel an instantiation belongs to. The shared kernel templates take
// the tag as their first argument, so it shows in the kernel's name.
struct WholeSequence {};  // B1, B2
struct Blocked {};        // B3, B4, B5
struct TokenMajor {};     // B7, B8

// Strides of one [B, T, H, D] operand in elements; the head-dim stride is 1.
struct Strides {
  long long b, t, h;
};

// Arguments of one forward call (B1, B3, B7); pointers are device pointers.
struct FwdArgs {
  const void *q, *k, *v;
  void *o, *lse;
  long long B, tq, kv_len, n_heads, d;
  Strides qs, ks, vs;
  float scale;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  uint2 raw = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 a, b;
  memcpy(&a, &raw.x, sizeof(a));
  memcpy(&b, &raw.y, sizeof(b));
  const float2 fa = __bfloat1622float2(a);
  const float2 fb = __bfloat1622float2(b);
  return make_float4(fa.x, fa.y, fb.x, fb.y);
}

// Let `kernel` launch on the current device with `smem` bytes of dynamic
// shared memory. The attribute stays set, so cudaFuncSetAttribute runs once
// per kernel and device, and again only where a launch needs more than
// before (the float32 kernels' shared memory follows the head dim). Returns
// the call's error; a failed call is tried again at the next launch.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, size_t> granted;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  size_t& have = granted[{(const void*)kernel, dev}];
  if (smem <= have) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) have = smem;
  return err;
}

}  // namespace
