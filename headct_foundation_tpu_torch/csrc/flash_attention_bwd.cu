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
// What bounds it. At the MAE decoder shape [32, 513, 16, 48] bfloat16 the
// function's 5 products are 10*B*H*T^2*D = 6.47e10 operations, 0.065 ms at
// the bf16 dense peak of 989 TFLOP/s; q, k, v, o, dO read once and dq, dk, dv
// written once plus LSE are 203 MB, 0.061 ms at 3.35 TB/s: bound by
// operations, narrowly. The split below recomputes P and dS (7 products) and
// takes one exponential per P element in each pass, B*H*T^2 = 1.35e8, 0.032
// ms a pass at 16 per SM per clock. At T = 513 a block walks only 9 tiles of
// 64, the last holding one real row, so a block's set-up and epilogue weigh
// about 7 times more per walked tile than at the 192^3 decoder's T = 4097.
//
// Design. The Pallas kernel holds the whole [T, T] slab of one (batch, head)
// in VMEM; a Hopper block has 227 KB of shared memory, so this is the
// FlashAttention-2 split (Dao, arXiv 2307.08691), which needs no float
// atomics and so gives bit-identical gradients from run to run, in three
// launches (flash_bwd in flash_bwd.cuh):
//   1. delta_kernel: d = rowsum(dO * O), one warp per query row, into a
//      float32 [B*H, T] scratch.
//   2. the dK/dV pass: one block per (64-key tile, batch*head), walking the
//      query tiles.
//   3. the dQ pass: one block per (64-query tile, batch*head), walking the
//      key tiles.
// The passes are called with Tq = Tk = kv_len = T under the tag
// WholeSequence. bfloat16 operands (training) run the Hopper kernels that
// the blocked backward B4/B5 runs (flash_bwd_sm90.cuh dkv_wgmma_kernel,
// dq_wgmma_kernel): every product on wgmma, the walked tiles copied by two
// producer warps, one for each walked tensor, through a cp.async / mbarrier
// ring. float32 runs the CUDA-core passes of flash_bwd.cuh.

#include "flash_bwd.cuh"

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
  return (int)bwd::flash_bwd<WholeSequence>(a, o, {o_sb, o_st, o_sh}, delta, dtype,
                                             static_cast<cudaStream_t>(stream));
}
