// Blocked attention backward for NVIDIA Hopper (sm_90a): kernels B4 and B5.
//
// Replaces the TPU kernels headct_foundation_tpu/ops/flash_attention.py:292
// `_blocked_dkv_kernel` (B4, launched by `pl.pallas_call` in `_blocked_bwd`,
// :474) and :342 `_blocked_dq_kernel` (B5, :498). Same functions: for q
// [B, Tq, H, D] against k, v [B, Tk, H, D] with keys >= kv_len masked, from
// the forward's LSE and delta = rowsum(dO * O) (float32 [B*H, 1, Tq]; the
// caller computes delta, as `_blocked_bwd` does at :462),
//   B4: dK = scale * sum_q dS^T Q,  dV = sum_q P_op^T dO   (per key; 0 at keys >= kv_len)
//   B5: dQ = scale * sum_k dS K                            (per query)
// with P = exp(scale * Q K^T - LSE), P_op = P rounded to the operand dtype,
// dS = P * (dO V^T - delta) rounded to the operand dtype. dQ is stored
// [B, Tq, H, D], dK and dV [B, Tk, H, D], contiguous in the operand dtype.
//
// Design. The Pallas kernels run one program per (batch*head, 512-key block)
// holding the whole padded Q/dO slab in VMEM (B4), and per (batch*head, Q
// block) holding the whole K/V slab (B5). Here bfloat16 takes the Hopper
// kernels of flash_bwd_sm90.cuh: B4 one block per (64-key tile, batch*head)
// walking the query tiles, B5 one per (64-query tile, batch*head) walking the
// key tiles up to kv_len, every product on wgmma and the walked tiles staged
// by a producer warp through an mbarrier ring. float32 takes the CUDA-core
// passes of flash_bwd.cuh (dkv_kernel, dq_kernel), which keep full float32
// products as the TPU kernels do for float32 inputs. Neither uses atomics, so
// reruns are bit-identical. The TPU block sizes play no part. A key tile
// wholly at or past kv_len skips its walk and writes dK = dV = 0 (the outputs
// come from torch.empty); the JAX code zero-pads Q and relies on dO = 0,
// delta = 0 in the padded rows, while here query rows >= Tq get LSE = +inf,
// so P = dS = 0 there. All offsets are 64-bit.
//
// Bound at the decoder shape [2, 4097, 16, 48] bfloat16: B4's 4 products
// (S, dP, dV, dK) are 8*B*H*Tq*Tk*D = 2.06e11 operations, 0.209 ms at the dense
// bf16 peak of 989 TFLOP/s; B5's 3 (S, dP, dQ) 1.55e11, 0.156 ms. Their bytes
// (q, k, v, dO, LSE, delta read once, the gradients written once) are 76.6 MB
// and 64.0 MB, 0.023 and 0.019 ms at 3.35 TB/s: both are bound by
// operations. Each pass also takes one exponential per P element, 5.37e8,
// 0.128 ms on the special function units (flash_bwd_sm90.cuh).

#include "flash_bwd.cuh"
#include "flash_bwd_sm90.cuh"

namespace {

bool bad_shape(long long B, long long tq, long long tk, long long kv_len, long long n_heads,
               long long d) {
  return d < 4 || d > 128 || d % 4 != 0 || tq < 1 || tq > 2147483647LL - 64 || kv_len < 1 ||
         kv_len > tk || tk > 2147483647LL - 64 || B < 1 || n_heads < 1 || B * n_heads > 65535;
}

}  // namespace

// C entry points, bound with ctypes. Strides are in elements, in (batch,
// token, head) order; every head-dim stride must be 1. lse and delta are
// float32 [B*H, Tq]. dtype: 0 = float32, 1 = bfloat16. Each returns the
// cudaError_t of its launch (0 on success).

// B4: dK and dV.
extern "C" int headct_flash_attention_blocked_dkv(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dk, void* dv,
    long long B, long long tq, long long tk, long long kv_len, long long n_heads, long long d,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long g_sb, long long g_st, long long g_sh,
    float scale, int dtype, void* stream) {
  if (bad_shape(B, tq, tk, kv_len, n_heads, d)) return (int)cudaErrorInvalidValue;
  const bwd::BwdArgs a{q, k, v, dout, lse, delta, nullptr, dk, dv, B, tq, tk, kv_len, n_heads, d,
                       {q_sb, q_st, q_sh}, {k_sb, k_st, k_sh}, {v_sb, v_st, v_sh},
                       {g_sb, g_st, g_sh}, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return (int)bwd90::launch_dkv<Blocked>(a, s);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return (int)bwd::launch_dkv_kernel<float>(bwd::dkv_kernel<Blocked>, bwd::f32_bwd_smem(d, 6), a,
                                            s);
}

// B5: dQ.
extern "C" int headct_flash_attention_blocked_dq(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dq,
    long long B, long long tq, long long tk, long long kv_len, long long n_heads, long long d,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long g_sb, long long g_st, long long g_sh,
    float scale, int dtype, void* stream) {
  if (bad_shape(B, tq, tk, kv_len, n_heads, d)) return (int)cudaErrorInvalidValue;
  const bwd::BwdArgs a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, tq, tk, kv_len, n_heads,
                       d, {q_sb, q_st, q_sh}, {k_sb, k_st, k_sh}, {v_sb, v_st, v_sh},
                       {g_sb, g_st, g_sh}, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return (int)bwd90::launch_dq<Blocked>(a, s);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return (int)bwd::launch_dq_kernel<float>(bwd::dq_kernel<Blocked>, bwd::f32_bwd_smem(d, 5), a, s);
}

// Dynamic shared memory of one bfloat16 block of B4 (dkv != 0) or B5 at head
// dim d, in bytes (for reports).
extern "C" long long headct_flash_attention_blocked_bwd_smem(int dkv, long long d) {
  return (long long)bwd90::smem_bytes(dkv != 0, d);
}
