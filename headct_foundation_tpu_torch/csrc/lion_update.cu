// Fused Lion update for NVIDIA Hopper (sm_90a): kernel B6.
//
// Replaces the TPU kernel headct_foundation_tpu/ops/lion_kernel.py:31
// `_lion_kernel` (launched by `pl.pallas_call` in `lion_update_leaf`, :89).
// Same function, per element, in float32:
//   u     = sign(b1 * m + (1 - b1) * g)     (sign(NaN) = NaN, as jnp.sign)
//   delta = -lr * wd * p - lr * u           (stored in p's dtype)
//   m_new = b2 * m + (1 - b2) * g           (float32)
// p and g float32 or bfloat16, m float32, any length n >= 1. m_new may be
// written over m: each thread reads its elements before it writes them.
//
// Design. An elementwise pass with nothing to keep on chip: a grid-stride
// loop in which each thread takes 4 elements at a time through vector loads
// and stores (16 bytes of float32, 8 of bfloat16) where all five pointers
// are aligned to them, then a scalar loop over the rest, so any length works.
// The TPU kernel pads every leaf to 512 x 128 blocks; that is TPU tiling and
// no spec. One launch per parameter tensor, as the TPU makes one
// `pallas_call` per leaf.
//
// Rounding. lr, wd, b1 and b2 arrive as float32, as the TPU kernel's SMEM
// scalars do, and -lr * wd, 1 - b1 and 1 - b2 are formed in float32 here.
// Every operation is an explicitly rounded intrinsic (__fmul_rn, __fadd_rn,
// __fsub_rn) in the plain version's order, so nvcc cannot contract a
// multiply and an add into an FMA, and the kernel rounds exactly as the
// plain version (separate float32 torch ops) does.
//
// Bound: 20 bytes per float32 element (p, g, m read; delta, m_new written)
// at 3.35 TB/s, about 8 operations per element: bound by bytes. For the
// 150.3 M trainable parameters of the 96^3 MAE, 3.0 GB or 0.90 ms per step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // 8 resident blocks of 256 on each of 132 SMs

struct Scalars {
  float lr, neg_lr_wd, b1, c1, b2, c2;  // c1 = 1 - b1, c2 = 1 - b2
};

__device__ __forceinline__ Scalars make_scalars(float lr, float wd, float b1, float b2) {
  return {lr, __fmul_rn(-lr, wd), b1, __fsub_rn(1.f, b1), b2, __fsub_rn(1.f, b2)};
}

__device__ __forceinline__ float sign_of(float x) {
  return isnan(x) ? x : (float)((x > 0.f) - (x < 0.f));
}

__device__ __forceinline__ void lion(float p, float g, float m, const Scalars& s, float& delta,
                                     float& m_new) {
  const float u = sign_of(__fadd_rn(__fmul_rn(m, s.b1), __fmul_rn(s.c1, g)));
  delta = __fsub_rn(__fmul_rn(s.neg_lr_wd, p), __fmul_rn(s.lr, u));
  m_new = __fadd_rn(__fmul_rn(m, s.b2), __fmul_rn(s.c2, g));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(bf16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ void load4(const float* p, float* x) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

__device__ __forceinline__ void load4(const bf16* p, float* x) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 a, b;
  memcpy(&a, &raw.x, sizeof(a));
  memcpy(&b, &raw.y, sizeof(b));
  const float2 fa = __bfloat1622float2(a);
  const float2 fb = __bfloat1622float2(b);
  x[0] = fa.x;
  x[1] = fa.y;
  x[2] = fb.x;
  x[3] = fb.y;
}

__device__ __forceinline__ void store4(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void store4(bf16* p, const float* x) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x[0], x[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(x[2], x[3]);
  uint2 raw;
  memcpy(&raw.x, &a, sizeof(a));
  memcpy(&raw.y, &b, sizeof(b));
  *reinterpret_cast<uint2*>(p) = raw;
}

// Groups [0, n_vec) of 4 elements through vector loads, then elements
// [4 n_vec, n) one by one. m and m_out may be the same array (no __restrict__).
template <typename P, typename G>
__global__ void __launch_bounds__(kThreads)
lion_kernel(const P* __restrict__ p, const G* __restrict__ g, const float* m,
            P* __restrict__ delta, float* m_out, long long n, long long n_vec, float lr,
            float wd, float b1, float b2) {
  const Scalars s = make_scalars(lr, wd, b1, b2);
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (long long i = first; i < n_vec; i += stride) {
    const long long e = 4 * i;
    float pv[4], gv[4], mv[4], dv[4], mn[4];
    load4(p + e, pv);
    load4(g + e, gv);
    load4(m + e, mv);
#pragma unroll
    for (int j = 0; j < 4; ++j) lion(pv[j], gv[j], mv[j], s, dv[j], mn[j]);
    store4(delta + e, dv);
    store4(m_out + e, mn);
  }
  for (long long e = 4 * n_vec + first; e < n; e += stride) {
    float d, mn;
    lion(to_float(p[e]), to_float(g[e]), m[e], s, d, mn);
    store1(delta + e, d);
    m_out[e] = mn;
  }
}

bool aligned(const void* x, size_t bytes) {
  return reinterpret_cast<uintptr_t>(x) % bytes == 0;
}

template <typename P, typename G>
cudaError_t launch(const void* p, const void* g, const void* m, void* delta, void* m_out,
                   long long n, float lr, float wd, float b1, float b2, cudaStream_t stream) {
  const bool vec = aligned(p, 4 * sizeof(P)) && aligned(delta, 4 * sizeof(P)) &&
                   aligned(g, 4 * sizeof(G)) && aligned(m, 16) && aligned(m_out, 16);
  const long long n_vec = vec ? n / 4 : 0;
  const long long work = n_vec > n - 4 * n_vec ? n_vec : n - 4 * n_vec;  // longer loop
  long long blocks = (work + kThreads - 1) / kThreads;
  blocks = blocks < 1 ? 1 : (blocks > kMaxBlocks ? kMaxBlocks : blocks);
  lion_kernel<P, G><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const P*>(p), static_cast<const G*>(g), static_cast<const float*>(m),
      static_cast<P*>(delta), static_cast<float*>(m_out), n, n_vec, lr, wd, b1, b2);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. p, g, m, delta and m_out hold n elements
// each, contiguous; m_out may equal m. p_dtype, g_dtype: 0 = float32,
// 1 = bfloat16 (delta takes p's). Returns the cudaError_t of the launch (0 on
// success).
extern "C" int headct_lion_update(const void* p, const void* g, const void* m, void* delta,
                                  void* m_out, long long n, float lr, float wd, float b1,
                                  float b2, int p_dtype, int g_dtype, void* stream) {
  if (n < 1 || p_dtype < 0 || p_dtype > 1 || g_dtype < 0 || g_dtype > 1) {
    return (int)cudaErrorInvalidValue;
  }
  using Launch = cudaError_t (*)(const void*, const void*, const void*, void*, void*, long long,
                                 float, float, float, float, cudaStream_t);
  const Launch by_dtype[2][2] = {{launch<float, float>, launch<float, bf16>},
                                 {launch<bf16, float>, launch<bf16, bf16>}};
  return (int)by_dtype[p_dtype][g_dtype](p, g, m, delta, m_out, n, lr, wd, b1, b2,
                                         static_cast<cudaStream_t>(stream));
}
