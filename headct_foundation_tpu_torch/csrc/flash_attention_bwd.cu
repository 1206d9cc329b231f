// Whole-sequence attention backward for NVIDIA Hopper (sm_90a): kernel B2.
//
// Replaces the TPU kernel headct_foundation_tpu/ops/flash_attention.py:86
// `_vmem_bwd_kernel` (launched by `pl.pallas_call` in `_fused_bwd`, :223).
// Same function: for every (batch, head), with square T <= 1024 and no mask,
//   P    = exp(scale * Q K^T - LSE)                  (float32)
//   dV   = P_op^T dO                                  (P_op: P rounded to the operand dtype)
//   dP   = dO V^T                                     (float32 accumulation)
//   d    = rowsum(dO * O)                             (O: the stored forward output)
//   dS   = P * (dP - d), rounded to the operand dtype
//   dQ   = scale * dS K,    dK = scale * dS^T Q
// dQ, dK, dV are stored [B, T, H, D] contiguous in the operand dtype; float32
// or bfloat16 operands, head size D a multiple of 4 up to 128.
//
// Design. The Pallas kernel holds the whole [T, T] slab of one (batch, head)
// in VMEM; a Hopper block has 227 KB of shared memory, so this follows the
// FlashAttention-2 backward split (Dao, arXiv 2307.08691), which needs no
// float atomics and so gives bit-identical gradients from run to run:
//   1. delta_kernel: d = rowsum(dO * O), one warp per query row, into a
//      float32 [B*H, T] scratch.
//   2. the dK/dV pass of flash_bwd.cuh: one block per (64-key tile,
//      batch*head), walking over all query tiles.
//   3. the dQ pass of flash_bwd.cuh: one block per (64-query tile,
//      batch*head), walking over all key tiles.
// Both passes are called with Tq = Tk = kv_len = T; bfloat16 operands
// (training) run on the tensor cores with mma.sync, float32 on the CUDA
// cores. The blocked backward B4/B5 (flash_attention_blocked_bwd.cu) is the
// same pair of passes without the square, T <= 1024 limits. wgmma, TMA and a
// fused dq/dk/dv write are later work.
//
// Bound at the MAE decoder shape [32, 513, 16, 48] bfloat16: the function's
// 5 products are 10*B*H*T^2*D = 6.47e10 operations, 0.065 ms at the bf16
// dense peak of 989 TFLOP/s; q, k, v, o, dO read once and dq, dk, dv written
// once plus LSE are 203 MB, 0.061 ms at 3.35 TB/s. So it is bound by
// operations, narrowly. mma.sync reaches only part of the dense peak, and the
// exp of every P element runs on the special-function units, so the kernel
// stays far from that bound.

#include "flash_bwd.cuh"

namespace {

// d[bh][t] = sum_c dO[b, t, h, c] * O[b, t, h, c] in float32; one warp per row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
             long long rows, int t_len, int n_heads, int d, Strides os, Strides gs) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (kThreads / 32) + warp;  // over B*H*T
  if (row >= rows) return;
  const int bh = (int)(row / t_len);
  const int t = (int)(row - (long long)bh * t_len);
  const int b = bh / n_heads;
  const int h = bh - b * n_heads;
  const T* orow = o + b * os.b + t * os.t + h * os.h;
  const T* grow = dout + b * gs.b + t * gs.t + h * gs.h;
  float s = 0.f;
  for (int c = lane * 4; c < d; c += 128) {
    const float4 x = load4(orow + c);
    const float4 y = load4(grow + c);
    s = fmaf(x.x, y.x, s);
    s = fmaf(x.y, y.y, s);
    s = fmaf(x.z, y.z, s);
    s = fmaf(x.w, y.w, s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

template <typename T>
cudaError_t launch(const BwdArgs& a, const void* o, const Strides& os, void* delta, int dtype,
                   cudaStream_t stream) {
  const long long rows = a.B * a.n_heads * a.tq;  // one warp per (b, h, t) row
  const unsigned delta_blocks = (unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32));
  delta_kernel<T><<<delta_blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(a.dout),
      static_cast<float*>(delta), rows, (int)a.tq, (int)a.n_heads,
      (int)a.d, os, a.gs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_dkv<WholeSequence>(a, dtype, stream);
  if (err != cudaSuccess) return err;
  return launch_dq<WholeSequence>(a, dtype, stream);
}

}  // namespace

// C entry point, bound with ctypes. Strides are in elements, in (batch,
// token, head) order; every head-dim stride must be 1. `delta` is a float32
// scratch of B*H*T elements that the caller allocates. dtype: 0 = float32,
// 1 = bfloat16. Returns the cudaError_t of the launches (0 on success).
extern "C" int headct_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* delta, void* dq, void* dk, void* dv,
    long long B, long long t_len, long long n_heads, long long d,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_st, long long o_sh,
    long long g_sb, long long g_st, long long g_sh,
    float scale, int dtype, void* stream) {
  if (d < 4 || d > 128 || d % 4 != 0 || t_len < 1 || t_len > 1024 || B < 1 || n_heads < 1 ||
      B * n_heads > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const BwdArgs a{q, k, v, dout, lse, delta, dq, dk, dv, B, t_len, t_len, t_len, n_heads, d,
                  {q_sb, q_st, q_sh}, {k_sb, k_st, k_sh}, {v_sb, v_st, v_sh},
                  {g_sb, g_st, g_sh}, scale};
  const Strides os{o_sb, o_st, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(a, o, os, delta, dtype, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(a, o, os, delta, dtype, s);
  return (int)cudaErrorInvalidValue;
}
