// Whole-sequence forward attention for NVIDIA Hopper (sm_90a): kernel B1.
//
// Replaces the TPU kernel headct_foundation_tpu/ops/flash_attention.py:60
// `_vmem_fwd_kernel` (launched by `pl.pallas_call` in `_fused_fwd_impl`,
// :195). Same function: for every (batch, head) and query row t,
//   S = scale * q_t K^T            (float32 accumulation of operand-dtype products)
//   m = max S,  P = exp(S - m),  l = sum P
//   O_t = (P rounded to the operand dtype) V / max(l, 1e-30)   (stored in q's dtype)
//   LSE_t = m + log max(l, 1e-30)                               (float32, [B*H, 1, T])
// for square T <= 1024, no mask, float32 or bfloat16 operands, head size D a
// multiple of 4 up to 128.
//
// Design. The Pallas kernel holds the whole [T, T] float32 score slab in VMEM
// (1 MB at T = 513); a Hopper block has 227 KB of shared memory, so this kernel
// streams instead: the forward kernels of flash_fwd.cuh (64 query rows per
// block, 64-key tiles through shared memory, online softmax in registers;
// float32 on the CUDA cores, bfloat16 on the tensor cores with mma.sync),
// called with Tq = Tk = kv_len = T. The ragged tail is masked: 513 = 8 * 64 +
// 1, so the last key tile has one real column and the last query tile one real
// row. The blocked kernel B3 (flash_attention_blocked_fwd.cu) is the same code
// without the square, T <= 1024 limits.
//
// Bound at the serving shape [8, 513, 12, 64] float32: 4*B*H*T^2*D = 6.47e9
// operations, 0.097 ms at the H100 SXM's 67 TFLOP/s of float32 outside the
// tensor cores; q, k, v read once and o written once are 50.5 MB, 0.015 ms at
// 3.35 TB/s. So it is bound by operations. At the MAE decoder shape
// [32, 513, 16, 48] bfloat16: 2.59e10 operations, 0.026 ms at 989 TFLOP/s,
// against 102 MB, 0.030 ms: bound by bytes.

#include "flash_fwd.cuh"

// C entry point, bound with ctypes. Strides are in elements, in (batch, token,
// head) order; the head-dim stride must be 1. dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int headct_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    long long B, long long t_len, long long n_heads, long long d,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    float scale, int dtype, void* stream) {
  if (d < 4 || d > 128 || d % 4 != 0 || t_len < 1 || t_len > 1024 || B < 1 || n_heads < 1 ||
      B * n_heads > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const FwdArgs a{q, k, v, o, lse, B, t_len, t_len, n_heads, d,
                  {q_sb, q_st, q_sh}, {k_sb, k_st, k_sh}, {v_sb, v_st, v_sh}, scale};
  return (int)flash_fwd<WholeSequence>(a, dtype, static_cast<cudaStream_t>(stream));
}
