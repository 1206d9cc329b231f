// Pieces shared by the attention kernels (flash_fwd.cuh, flash_bwd.cuh):
// operand strides, the tags that tell the whole-sequence kernels (B1, B2)
// from the blocked ones (B3, B4, B5) in a profile, and vector loads of
// float32 and bfloat16 operands.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

namespace {

// Which kernel an instantiation belongs to. The shared kernel templates take
// the tag as their first argument, so it shows in the kernel's name.
struct WholeSequence {};
struct Blocked {};

// Strides of one [B, T, H, D] operand in elements; the head-dim stride is 1.
struct Strides {
  long long b, t, h;
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

}  // namespace
