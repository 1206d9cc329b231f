// Blocked forward attention for NVIDIA Hopper (sm_90a): kernel B3.
//
// Replaces the TPU kernel headct_foundation_tpu/ops/flash_attention.py:256
// `_blocked_fwd_kernel` (launched by `pl.pallas_call` in `_blocked_fwd_impl`,
// :433). Same function: for q [B, Tq, H, D] against k, v [B, Tk, H, D], keys
// at positions >= kv_len (1 <= kv_len <= Tk) masked,
//   O = softmax(scale * Q K^T) V   over the keys < kv_len, P rounded to the
//       operand dtype before P.V   (O stored [B, Tq, H, D] in q's dtype)
//   LSE = row log-sum-exp          (float32, [B*H, 1, Tq])
// Any Tq and Tk (the 192^3 MAE runs Tq = Tk = 1025 in the encoder and 4097 in
// the decoder; the context-parallel path gives Tq != Tk), float32 or bfloat16
// operands, head size D a multiple of 4 up to 128.
//
// Design. The Pallas kernel walks 512-key blocks of a VMEM-resident K/V slab
// in one program per (batch*head, 256- or 512-query block), carrying (m, l,
// acc) through a fori_loop. A Hopper block has 227 KB of shared memory and
// blocks run in parallel, so this uses the forward kernels of flash_fwd.cuh.
// bfloat16 takes flash_fwd_sm90.cuh's wgmma kernel: one block per (128 query
// rows, batch*head) -- 1056 blocks at the decoder shape, 216 at the
// encoder's -- two consumer warpgroups sharing the 64-key K and V tiles that
// two producer warps stream through a cp.async/mbarrier ring. float32 takes
// flash_fwd_f32_sm90.cuh's kernel of the same shape, whose products run on
// the tensor cores as three TF32 products each (float32-accurate, as the
// TPU kernel keeps for float32 inputs). The TPU block sizes
// (`_blocked_block_sizes`, `BLOCK_Q`/`BLOCK_K`) are TPU tuning and play no
// part here. The key loop stops at the last tile holding a key < kv_len, so
// no tile is wholly masked and no work is spent past it; query rows >= Tq
// are not stored. All offsets are 64-bit. P is rounded to bf16 against the
// running max of the walk so far, where the TPU kernel rounds against that of
// each 512-key block, so bf16 outputs differ from it by about one bf16 step.
//
// Bound at the decoder shape [2, 4097, 16, 48] bfloat16: 4*B*H*Tq*Tk*D =
// 1.03e11 operations, 0.104 ms at the dense bf16 peak of 989 TFLOP/s, against
// q, k, v read and o, LSE written once, 50.9 MB, 0.015 ms at 3.35 TB/s: bound
// by operations (encoder [2, 1025, 12, 64]: 6.45e9, 0.0065 ms). Every P
// element takes an exponential on the special function units, B*H*Tq*Tk =
// 5.37e8 at 16 per SM per clock: 0.128 ms at 132 SMs and 1.98 GHz, above the
// operations bound (encoder: 0.006 ms). That floor, not the tensor cores,
// limits the kernel at D = 48.

#include "flash_fwd.cuh"

// C entry point, bound with ctypes. Strides are in elements, in (batch, token,
// head) order; the head-dim stride must be 1. dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int headct_flash_attention_blocked_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    long long B, long long tq, long long tk, long long kv_len, long long n_heads, long long d,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    float scale, int dtype, void* stream) {
  if (d < 4 || d > 128 || d % 4 != 0 || tq < 1 || tq > 2147483647LL - 64 || kv_len < 1 ||
      kv_len > tk || tk > 2147483647LL - 64 || B < 1 || n_heads < 1 || B * n_heads > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const FwdArgs a{q, k, v, o, lse, B, tq, kv_len, n_heads, d,
                       {q_sb, q_st, q_sh}, {k_sb, k_st, k_sh}, {v_sb, v_st, v_sh}, scale};
  return (int)fwd::flash_fwd<Blocked>(a, dtype, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of one bfloat16 block at head dim d, in bytes (for
// reports; B1 and B7 run the same kernel and take the same).
extern "C" long long headct_flash_attention_blocked_fwd_smem(long long d) {
  return (long long)fwd90::smem_bytes(d);
}

// The same for one float32 block (flash_fwd_f32_sm90.cuh).
extern "C" long long headct_flash_attention_blocked_fwd_f32_smem(long long d) {
  return (long long)fwd32::smem_bytes(d);
}
