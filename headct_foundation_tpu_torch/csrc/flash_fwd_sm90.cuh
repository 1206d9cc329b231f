// The attention forward for bfloat16 operands on Hopper (sm_90a):
// flash_fwd_wgmma_kernel, the bfloat16 route of B1 (flash_attention_fwd.cu),
// B3 (flash_attention_blocked_fwd.cu) and B7 (tm_attention.cu), all reached
// through fwd::flash_fwd<Tag> (flash_fwd.cuh).
//
// Replaces the TPU kernels headct_foundation_tpu/ops/flash_attention.py:60
// `_vmem_fwd_kernel` (B1, `pl.pallas_call` at :195) and :256
// `_blocked_fwd_kernel` (B3, :433). For q [B, Tq, H, D] against the first
// kv_len keys of k, v [B, Tk, H, D]:
//   S = scale * Q K^T (float32 accumulation), m = row max, P = exp(S - m), l = sum P
//   O = (P rounded to bf16) V / max(l, 1e-30)   (contiguous bf16 [B, Tq, H, D])
//   LSE = m + ln max(l, 1e-30)                   (float32 [B*H, 1, Tq], natural log)
// Keys >= kv_len carry no weight; query rows >= Tq are not stored. D is a
// multiple of 4 up to 128, zero-padded to DP = 16, 32, 48, 64 or 128; q, k, v
// are read through their (batch, token, head) strides.
//
// What bounds it. At the 192^3 decoder shape [2, 4097, 16, 48] the two
// products are 4*B*H*Tq*Tk*D = 1.03e11 operations, 0.104 ms at 989 TFLOP/s,
// and the bytes 0.015 ms at 3.35 TB/s. The exponentials weigh more: one per
// P element, B*H*Tq*Tk = 5.37e8, at 16 per SM per clock on the special
// function units (132 SMs at 1.98 GHz): 0.128 ms. At the 96^3 decoder shape
// [32, 513, 16, 48] the bytes (0.030 ms) and the exponentials (0.032 ms)
// bound it. Measured on an H100 (PERF.md; tools/ablate_attention_fwd.py
// takes one part of the work out at a time), the exponentials are not what
// holds this kernel back: the K/V copies and the softmax's other arithmetic
// weigh more. So the design keeps the instructions per copy and per score
// element few.
//
// Design (after FlashAttention-3, Shah et al. arXiv 2407.08608, without TMA):
// - A block owns kRows = 128 query rows of one (batch, head): two consumer
//   warpgroups of 64 rows, each with its Q tile fixed in shared memory, and
//   two producer warps, one copying K tiles and one V tiles of kKeys keys
//   through a ring of kStages buffers (cp.async, 16 or 8 bytes a copy, each
//   lane keeping one column chunk: `warp_load_tile`; the `full` / `empty`
//   mbarriers of sm90_common.cuh). The next tiles load while the consumers
//   compute, and both warpgroups share every tile. The walk stops at the last
//   tile holding a real key, so no walked tile is wholly masked and the
//   running max is finite after the first one.
// - S = Q K^T is `wgmma_ss<NT>` with Q and K both K-major as stored; O += P V
//   is `wgmma_rs<DP>` with P as register A straight from the S accumulator
//   (rounded to bf16, `to_a`) and V read MN-major through wgmma's transpose
//   bit. No transposed copy of V is built.
// - The online softmax runs in the log2 domain with c = |scale| log2(e): the
//   row max of S over the 4 lanes of a quad, P = ex2(S c - m) as one FFMA and
//   one MUFU.EX2 an element, alpha = ex2(m_old - m_new) where the max grew (0
//   on the first tile, where m_old = -inf) and O rescaled only in a warp
//   where some row's max grew. A negative scale negates Q once in shared
//   memory (exact in bf16). Each lane keeps its share of l and the quad sums
//   it once, at the end.
// - Each warpgroup runs S, the softmax and P V in turn; the other warpgroup
//   and the block beside it on the SM (two blocks an SM at DP <= 64) fill the
//   tensor cores and the special function units meanwhile. Issuing S_(i+1)
//   before tile i's softmax (FlashAttention-3's intra-warpgroup overlap), a
//   ping-pong of the two warpgroups, one producer warp for both tiles, one
//   warpgroup per block and 128-key tiles were each measured slower (PERF.md).
// - Ragged edges: rows past the tensor are zero-filled by the copies; keys
//   >= kv_len score -inf; a warpgroup whose rows all lie at or past Tq only
//   passes the ring's tiles on. Offsets are 64-bit. No atomics: reruns are
//   bit-identical.
// P is rounded to bf16 against the running max of the walk so far (the JAX
// B1 rounds against the whole row's max, B3 against each 512-key block's).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "sm90_common.cuh"

namespace {
namespace fwd90 {

using namespace sm90;

constexpr int kGroups = 2;                 // consumer warpgroups, 64 query rows each
constexpr int kRows = 64 * kGroups;        // query rows of a block
constexpr int kConsumers = 128 * kGroups;
constexpr int kThreads = kConsumers + 64;  // and two producer warps, one for K, one for V
constexpr int kStages = 4;
constexpr int kKeys = 64;                  // keys of a walked K/V tile
constexpr float kLn2 = 0.6931471805599453f;

// Shared memory of one block, in bytes from a 1024-byte aligned base:
// kGroups fixed [64][DP] Q tiles, kStages pairs of walked [NT][DP] K and V
// tiles, then the mbarriers (`full` completes on the producers' 64 lanes,
// `empty` on the consumers' 256 threads).
template <int DP, int NT>
struct Layout {
  static constexpr int kColBlocks = (DP + 63) / 64;  // 128-byte swizzle blocks of a row
  static constexpr int kQTile = 64 * 128 * kColBlocks;
  static constexpr int kWalkTile = NT * 128 * kColBlocks;
  static constexpr int kStage0 = kGroups * kQTile;
  static constexpr int kBars = kStage0 + kStages * 2 * kWalkTile;
  static constexpr size_t kSmem = kBars + 2 * kStages * 8 + 1024;  // + alignment slack
};

// Tile [key0, key0 + NT) of this thread's two rows (element 4j + e of s: row
// r0 + 8 (e / 2), key key0 + 8j + 2 (lane % 4) + e % 2), in the log2 domain
// with c = |scale| log2(e) > 0: keys >= kv_len to -inf, the running max m of
// S c over the quad (c times the max of S), P = 2^(S c - m) in place (one
// FFMA and one MUFU.EX2 an element), alpha = 2^(m_old - m) where the max grew
// (0 on the first tile, where m_old = -inf) and exactly 1 where it did not,
// and this lane's share of l rescaled and summed. Returns whether a row of
// this warp grew its max, that is whether O needs rescaling.
template <int NT>
__device__ __forceinline__ bool online_softmax(float (&s)[NT / 2], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], float c, int key0, int kv_len) {
  const int lane = threadIdx.x & 31;
  if (key0 + NT > kv_len) {
#pragma unroll
    for (int j = 0; j < NT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (key0 + 8 * j + 2 * (lane & 3) + (e & 1) >= kv_len) s[4 * j + e] = -INFINITY;
  }
  bool grew = false;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT / 8; ++j)
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * half], s[4 * j + 2 * half + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[half], mx * c);
    alpha[half] = m_new > m[half] ? ex2(m[half] - m_new) : 1.f;
    grew |= m_new > m[half];
    m[half] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      s[4 * j + 2 * half] = ex2(fmaf(s[4 * j + 2 * half], c, -m_new));
      s[4 * j + 2 * half + 1] = ex2(fmaf(s[4 * j + 2 * half + 1], c, -m_new));
      sum += s[4 * j + 2 * half] + s[4 * j + 2 * half + 1];
    }
    l[half] = l[half] * alpha[half] + sum;
  }
  return __any_sync(0xffffffffu, grew);
}

// Each of this thread's two rows of a 64 x DP accumulator times f[row].
template <int DP>
__device__ __forceinline__ void scale_rows(float (&o)[DP / 2], const float (&f)[2]) {
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[4 * j + e] *= f[e >> 1];
}

// One block per (kRows query rows, batch*head): O and LSE of those rows,
// walking the key tiles up to kv_len NT at a time.
template <typename Tag, int DP, int NT, int CH>
__global__ void __launch_bounds__(kThreads, DP > 64 ? 1 : 2)
flash_fwd_wgmma_kernel(const FwdArgs a) {
  using L = Layout<DP, NT>;
  const Smem sm = smem_base();
  const int tq = (int)a.tq, kv_len = (int)a.kv_len;
  const int n_heads = (int)a.n_heads, d = (int)a.d;
  const int bh = blockIdx.y;
  const int b = bh / n_heads;
  const int h = bh - b * n_heads;
  const int q0 = blockIdx.x * kRows;
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.qs.b + h * a.qs.h;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.ks.b + h * a.ks.h;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.vs.b + h * a.vs.h;
  const int n_tiles = (kv_len + NT - 1) / NT;  // the last one holds a real key
  const uint32_t full = sm.base + L::kBars, empty = full + 8 * kStages;
  auto stage = [&](int i) { return sm.base + L::kStage0 + (i % kStages) * 2 * L::kWalkTile; };

  // Set-up: the ring's barriers, and every warpgroup's Q tile (rows >= Tq
  // zero), loaded by all threads; for a negative scale Q is negated (exact
  // in bf16), so that the walk scales by c = |scale| log2(e) > 0.
  if (threadIdx.x == 0) ring_init(full, kStages, 64, kConsumers);
#pragma unroll
  for (int g = 0; g < kGroups; ++g)
    load_tile<DP, CH>(sm.base + g * L::kQTile, 64, q, a.qs.t, q0 + 64 * g, tq, d, threadIdx.x,
                      kThreads);
  cp_commit();
  cp_wait<0>();
  if (a.scale < 0.f) {
    __syncthreads();
    uint32_t* words = reinterpret_cast<uint32_t*>(sm.ptr);
    for (int w = threadIdx.x; w < kGroups * L::kQTile / 4; w += kThreads) words[w] ^= 0x80008000u;
  }
  proxy_fence();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= kConsumers / 32) {  // the producer warps: K, then V
    const bool is_v = warp > kConsumers / 32;
    const bf16* src = is_v ? v : k;
    const long long st = is_v ? a.vs.t : a.ks.t;
    for (int i = 0; i < n_tiles; ++i) {
      if (i >= kStages) bar_wait(empty + 8 * (i % kStages), ((i / kStages) - 1) & 1);
      warp_load_tile<DP, CH>(stage(i) + (is_v ? L::kWalkTile : 0), NT, src, st, i * NT, kv_len,
                             d, lane);
      cp_commit();
      if (i > 0) publish<1>(full + 8 * ((i - 1) % kStages));
    }
    publish<0>(full + 8 * ((n_tiles - 1) % kStages));
    return;
  }

  // A consumer warpgroup: 16 query rows a warp.
  const int g = warp >> 2;
  if (q0 + 64 * g >= tq) {  // no real row: pass the tiles on
    for (int i = 0; i < n_tiles; ++i) {
      bar_wait(full + 8 * (i % kStages), (i / kStages) & 1);
      bar_arrive(empty + 8 * (i % kStages));
    }
    return;
  }
  const uint32_t qt = sm.base + g * L::kQTile;
  const int row0 = q0 + 64 * g + 16 * (warp & 3);  // this warp's first row
  const float c = fmaxf(fabsf(a.scale) * kLog2e, 1e-30f);
  float o[DP / 2], s[NT / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
  uint32_t p[NT / 16][4];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) s[i] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    bar_wait(full + 8 * st, (i / kStages) & 1);
    const uint32_t kt = stage(i);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss<NT>(s, kmajor(qt, 64, kk), kmajor(kt, NT, kk), kk);
    wg_commit();
    wg_wait();
    pin(s);
    if (online_softmax<NT>(s, m, l, alpha, c, i * NT, kv_len)) scale_rows<DP>(o, alpha);
    to_a<NT>(p, s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < NT / 16; ++kk)
      wgmma_rs<DP>(o, p[kk], mnmajor<DP>(kt + L::kWalkTile, NT, kk), 1);
    wg_commit();
    wg_wait();
    pin(o);
    pin(p);
    bar_arrive(empty + 8 * st);
  }

  // Epilogue: l summed over the quad, O / l, LSE back to the natural log.
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
    l[half] = fmaxf(l[half], 1e-30f);
    alpha[half] = 1.f / l[half];
  }
  scale_rows<DP>(o, alpha);
  store_rows<DP>(static_cast<bf16*>(a.o), o, b, row0, h, tq, n_heads, d, 1.f);
  if ((lane & 3) == 0) {
    float* lse = static_cast<float*>(a.lse) + (long long)bh * tq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + (lane >> 2) + 8 * half;
      if (row < tq) lse[row] = (m[half] + log2f(l[half])) * kLn2;
    }
  }
}

// Launch at the padded head dim DP on `s`.
template <typename Tag, int DP>
cudaError_t launch(const FwdArgs& a, cudaStream_t s) {
  constexpr size_t smem = Layout<DP, kKeys>::kSmem;
  const auto kernel = wide_copies(a.d, {a.qs, a.ks, a.vs}, {a.q, a.k, a.v})
                          ? flash_fwd_wgmma_kernel<Tag, DP, kKeys, 8>
                          : flash_fwd_wgmma_kernel<Tag, DP, kKeys, 4>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((a.tq + kRows - 1) / kRows), (unsigned)(a.B * a.n_heads));
  kernel<<<grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

// Launch the bfloat16 forward on `s`; D <= 128 a multiple of 4.
template <typename Tag>
cudaError_t flash_fwd_bf16(const FwdArgs& a, cudaStream_t s) {
  return with_padded_d(a.d, [&](auto dp) { return launch<Tag, decltype(dp)::value>(a, s); });
}

// Dynamic shared memory of one block at head dim d.
inline size_t smem_bytes(long long d) {
  return with_padded_d(d, [](auto dp) { return Layout<decltype(dp)::value, kKeys>::kSmem; });
}

}  // namespace fwd90
}  // namespace
