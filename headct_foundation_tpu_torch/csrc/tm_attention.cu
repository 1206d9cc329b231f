// Token-major attention for NVIDIA Hopper (sm_90a): kernels B7 and B8.
//
// Replaces the TPU kernels tools/experimental_tm_attention.py:55
// `_tm_fwd_kernel` (B7, launched by `pl.pallas_call` in `_tm_fwd_impl`, :150)
// and :80 `_tm_bwd_kernel` (B8, launched in `_tm_bwd`, :214). Same functions
// as B1 and B2, on operands in the model's token-major layout [B, T, H*D]
// (contiguous: strides T*H*D, H*D, D), with square T <= 1024:
//   B7: O = softmax(scale * Q K^T) V, P rounded to the operand dtype before
//       P.V, O stored [B, T, H*D] in q's dtype; LSE float32 [B, H, T].
//   B8: delta = rowsum(dO * O) from the stored O (as `_tm_bwd_kernel` does at
//       :115), then dV = P_op^T dO, dS = P (dO V^T - delta) rounded to the
//       operand dtype, dQ = scale dS K, dK = scale dS^T Q, each stored
//       [B, T, H*D] in q's dtype.
// float32 or bfloat16 operands, head size D a multiple of 4 up to 128.
//
// Design. On the TPU the token-major layout was its own kernel: one program
// per batch element looping over the heads of a VMEM-resident [T, H*D] slab,
// with a head-group split of the backward sized to VMEM and to 128-lane
// blocks (`_head_split`, :173-194). Both are TPU tuning and no spec here. The
// port's attention kernels already read q, k and v through their (batch,
// token, head) strides and write [B, T, H, D] contiguous, which is [B, T, H*D]
// contiguous, and their LSE [B*H, T] is [B, H, T]. So B7 is the forward of
// flash_fwd.cuh and B8 the delta pass and the FlashAttention-2 dK/dV and dQ
// passes of flash_bwd.cuh (no atomics, bit-identical reruns), called with the
// token-major strides and Tq = Tk = kv_len = T; the tag TokenMajor keeps
// their names in a profile apart from B1's and B2's. In bfloat16, B7 runs
// flash_fwd_sm90.cuh's wgmma kernel and B8 flash_bwd_sm90.cuh's wgmma passes,
// the kernels of B1 and B2, so B7 and B8 equal B1 and B2 bit for bit; float32
// runs both on the CUDA cores.
//
// Bounds are B1's and B2's: at the MAE decoder shape [32, 513, 16, 48]
// bfloat16, B7 moves 102 MB (0.030 ms at 3.35 TB/s) for 2.59e10 operations
// (0.026 ms at 989 TFLOP/s), bound by bytes, with its exponentials as long
// (0.032 ms, flash_attention_fwd.cu); B8's five products are 6.47e10
// operations (0.065 ms) against 203 MB (0.061 ms), bound by operations.

#include "flash_bwd.cuh"
#include "flash_fwd.cuh"

namespace {

bool bad_shape(long long B, long long t_len, long long n_heads, long long d) {
  return d < 4 || d > 128 || d % 4 != 0 || t_len < 1 || t_len > 1024 || B < 1 || n_heads < 1 ||
         B * n_heads > 65535;
}

// Strides (batch, token, head) of a contiguous [B, T, H*D] operand.
Strides token_major(long long t_len, long long n_heads, long long d) {
  return {t_len * n_heads * d, n_heads * d, d};
}

}  // namespace

// C entry points, bound with ctypes. Every operand is contiguous [B, T, H*D];
// lse is float32 [B, H, T]; `delta` is a float32 scratch of B*H*T elements
// that the caller allocates. dtype: 0 = float32, 1 = bfloat16. Each returns
// the cudaError_t of its launches (0 on success).

// B7: O and LSE.
extern "C" int headct_tm_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                       void* lse, long long B, long long t_len,
                                       long long n_heads, long long d, float scale, int dtype,
                                       void* stream) {
  if (bad_shape(B, t_len, n_heads, d)) return (int)cudaErrorInvalidValue;
  const Strides s = token_major(t_len, n_heads, d);
  const FwdArgs a{q, k, v, o, lse, B, t_len, t_len, n_heads, d, s, s, s, scale};
  return (int)fwd::flash_fwd<TokenMajor>(a, dtype, static_cast<cudaStream_t>(stream));
}

// B8: dQ, dK, dV, with delta computed inside.
extern "C" int headct_tm_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout, const void* lse,
                                       void* delta, void* dq, void* dk, void* dv, long long B,
                                       long long t_len, long long n_heads, long long d,
                                       float scale, int dtype, void* stream) {
  if (bad_shape(B, t_len, n_heads, d)) return (int)cudaErrorInvalidValue;
  const Strides s = token_major(t_len, n_heads, d);
  const BwdArgs a{q, k, v, dout, lse, delta, dq, dk, dv, B, t_len, t_len, t_len, n_heads,
                       d, s, s, s, s, scale};
  return (int)bwd::flash_bwd<TokenMajor>(a, o, s, delta, dtype,
                                         static_cast<cudaStream_t>(stream));
}
