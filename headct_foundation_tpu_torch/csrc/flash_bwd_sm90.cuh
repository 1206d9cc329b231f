// The attention backward for bfloat16 operands on Hopper (sm_90a): the dK/dV
// pass (dkv_wgmma_kernel) and the dQ pass (dq_wgmma_kernel) of the blocked
// backward B4/B5 (flash_attention_blocked_bwd.cu), the whole-sequence
// backward B2 (flash_attention_bwd.cu) and the token-major backward B8
// (tm_attention.cu), all reached through bwd::launch_dkv / launch_dq
// (flash_bwd.cuh); B2 and B8 call them with Tq = Tk = kv_len = T.
//
// Replaces the TPU kernels headct_foundation_tpu/ops/flash_attention.py:292
// `_blocked_dkv_kernel` (B4, `pl.pallas_call` at :474), :342
// `_blocked_dq_kernel` (B5, :498), :86 `_vmem_bwd_kernel` (B2, :223) and
// tools/experimental_tm_attention.py:80 `_tm_bwd_kernel` (B8, :214). For q
// [B, Tq, H, D] against the first kv_len keys of k, v [B, Tk, H, D], with the
// forward's LSE and delta = rowsum(dO * O), both float32 [B*H, Tq]:
//   P = exp(scale * Q K^T - LSE), P_op = P rounded to bf16 (0 at keys >= kv_len)
//   dS = P * (dO V^T - delta), rounded to bf16
//   dK/dV pass: dK = scale * sum_q dS^T Q,  dV = sum_q P_op^T dO   (0 at keys >= kv_len)
//   dQ pass:    dQ = scale * sum_k dS K
// dQ is stored [B, Tq, H, D], dK and dV [B, Tk, H, D], contiguous bf16.
//
// What bounds them. At the 192^3 decoder shape [2, 4097, 16, 48] the dK/dV
// pass's four products are 2.06e11 operations (0.209 ms at 989 TFLOP/s) and
// the dQ pass's three 1.55e11 (0.156 ms); their bytes take about 0.02 ms at
// 3.35 TB/s. At D = 48 the exponentials weigh nearly as much: each pass takes
// one per P element, B*H*Tq*Tk = 5.37e8, and the special function units give
// 16 per SM per clock (132 SMs at 1.98 GHz: 0.128 ms per pass). At the 96^3
// decoder shape [32, 513, 16, 48] (B2) the two passes' products are 9.06e10
// operations (0.092 ms) and their exponentials 0.032 ms a pass; a block
// there walks 9 tiles, the last with one real row. Measured on an H100
// (PERF.md; tools/ablate_attention_bwd.py takes one part of the work out at a
// time), the exponentials hold these kernels back least; the products and
// the copies that feed them weigh more.
//
// Design. The FlashAttention-2 split (Dao, arXiv 2307.08691): no float
// atomics, so two runs give bit-identical dQ, dK and dV. The one-pass
// backward with dQ summed by atomics (5 products instead of 7) would give
// that up and is not done. Each block is one warpgroup of 4 consumer warps
// that owns 64 rows (dK/dV: keys, dQ: queries) and two producer warps.
// - Every product is `wgmma.mma_async` m64nNk16 with float32 accumulators
//   (the wgmma, swizzle, cp.async and mbarrier pieces are in
//   sm90_common.cuh, shared with the forward). Tiles sit in shared memory as
//   rows of 64 bf16 (128 bytes) in the 128-byte swizzle, the head dim
//   zero-padded to DP. The dK/dV pass takes S^T = K Q^T and dP^T = V dO^T
//   with K, V as A and the Q, dO tiles as B, both K-major as stored; dV +=
//   P^T dO and dK += dS^T Q take P^T and dS^T as A straight from the
//   accumulators (rounded to bf16 in registers), and dO, Q as B through
//   wgmma's transpose bit (MN-major). The dQ pass takes S = Q K^T, dP = dO V^T
//   and dQ += dS K the same way. No transposed copy is built.
// - The walked tiles (dK/dV: Q with the LSE and delta rows, and dO; dQ: K and
//   V) stream through a ring of kStages buffers, one producer warp for each
//   walked tensor, as in the forward: each lane keeps one column chunk and
//   steps over the rows (`warp_load_tile`, a few instructions a copy; one
//   producer warp running `load_tile`, about 25, left the ring short of
//   tiles). A producer fills a buffer with cp.async while the consumers work
//   on the one before; each of its lanes waits for its own copies, fences
//   them to the tensor cores' (async) proxy and arrives on the buffer's
//   `full` mbarrier. The consumers wait on it and, once their products have
//   read the buffer, arrive on its `empty` mbarrier, which the producers
//   wait on before refilling it. The producers copy the block's two fixed
//   tiles first, onto a `fixed` mbarrier of their own that completes with the
//   ring's first fill, so that a block's set-up overlaps its first walked
//   tile (at T = 513 a block walks 9 tiles, so the set-up weighs more there).
// - The copies are 16 bytes where the head dim is a multiple of 8 and every
//   operand's strides and start allow it, else 8 bytes (D = 12, a view
//   whose start breaks 16-byte alignment): the route follows from shape and
//   alignment alone, and both fill the same layout and run the same code.
// - P = exp2(S * scale * log2(e) - LSE * log2(e)): one FFMA and one MUFU.EX2
//   per element.
// - Ragged edges: rows past the tensor are zero-filled by the copies (so a
//   key tile past kv_len has K = V = 0); query rows >= Tq get LSE = +inf and
//   delta = 0, so P = dS = 0; keys >= kv_len get P = 0; a key tile wholly
//   past kv_len skips its walk and writes dK = dV = 0. Offsets are 64-bit.
// The walked tile is 64 rows (32 in the dK/dV pass at D > 64, to keep its
// four accumulators in registers).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "sm90_common.cuh"

namespace {
namespace bwd90 {

using namespace sm90;

constexpr int kRows = 64;       // rows a block owns: one warpgroup's wgmma M
constexpr int kConsumers = 128;  // one warpgroup
constexpr int kProducers = 64;   // two producer warps, one for each walked tensor
constexpr int kThreads = kConsumers + kProducers;
constexpr int kStages = 3;

// Shared memory of one block, in bytes from a 1024-byte aligned base: two
// fixed [64][DP] tiles, kStages pairs of walked [NT][DP] tiles, kStages pairs
// of NT float row values (the dK/dV pass's LSE and delta), then the ring's
// mbarriers and the fixed tiles' one.
template <int DP, int NT>
struct Layout {
  static constexpr int kColBlocks = (DP + 63) / 64;  // 128-byte swizzle blocks of a row
  static constexpr int kFixedTile = kRows * 128 * kColBlocks;
  static constexpr int kWalkTile = NT * 128 * kColBlocks;
  static constexpr int kStage0 = 2 * kFixedTile;
  static constexpr int kRowVals = kStage0 + kStages * 2 * kWalkTile;
  static constexpr int kBars = kRowVals + kStages * 2 * NT * 4;
  static constexpr int kFixedBar = kBars + 2 * kStages * 8;
  static constexpr size_t kSmem = kFixedBar + 8 + 1024;  // + alignment slack
};

// Set up the block: the ring's barriers and the `fixed` barrier of the two
// fixed [64][DP] tiles, which completes on the producers' lanes.
template <int DP, int NT>
__device__ __forceinline__ void block_setup(const Smem& sm) {
  using L = Layout<DP, NT>;
  if (threadIdx.x == 0) {
    bar_init(sm.base + L::kFixedBar, kProducers);
    ring_init(sm.base + L::kBars, kStages, kProducers, kConsumers);
  }
  __syncthreads();
}

// The dK/dV pass: one block per (64-key tile, batch*head), dK and dV of
// those keys, walking the query tiles NT at a time.
template <typename Tag, int DP, int NT, int CH>
__global__ void __launch_bounds__(kThreads, DP > 64 ? 1 : 2)
dkv_wgmma_kernel(const BwdArgs a) {
  using L = Layout<DP, NT>;
  const Smem sm = smem_base();
  const int tq = (int)a.tq, tk = (int)a.tk, kv_len = (int)a.kv_len;
  const int n_heads = (int)a.n_heads, d = (int)a.d;
  const int bh = blockIdx.y;
  const int b = bh / n_heads;
  const int h = bh - b * n_heads;
  const int n0 = blockIdx.x * kRows;
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.qs.b + h * a.qs.h;
  const bf16* g = static_cast<const bf16*>(a.dout) + b * a.gs.b + h * a.gs.h;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.ks.b + h * a.ks.h;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.vs.b + h * a.vs.h;
  // a tile wholly at or past kv_len walks nothing and stores zeros
  const int n_tiles = n0 < kv_len ? (tq + NT - 1) / NT : 0;

  block_setup<DP, NT>(sm);
  const uint32_t full = sm.base + L::kBars, empty = full + 8 * kStages;
  const uint32_t fixed = sm.base + L::kFixedBar;  // K, V
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp >= kConsumers / 32) {  // the producer warps: Q with the LSE and delta rows, dO
    const bool is_g = warp > kConsumers / 32;
    const bf16* src = is_g ? g : q;
    const long long st = is_g ? a.gs.t : a.qs.t;
    const float* lse = static_cast<const float*>(a.lse) + (long long)bh * tq;
    const float* delta = static_cast<const float*>(a.delta) + (long long)bh * tq;
    // first the fixed tile (K or V), published as `fixed` with walked tile 0
    warp_load_tile<DP, CH>(sm.base + (is_g ? L::kFixedTile : 0), kRows, is_g ? v : k,
                           is_g ? a.vs.t : a.ks.t, n0, kv_len, d, lane);
    cp_commit();
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      if (i >= kStages) bar_wait(empty + 8 * s, ((i / kStages) - 1) & 1);
      const uint32_t tile = sm.base + L::kStage0 + s * 2 * L::kWalkTile;
      const int q0 = i * NT;
      warp_load_tile<DP, CH>(tile + (is_g ? L::kWalkTile : 0), NT, src, st, q0, tq, d, lane);
      if (!is_g) {
        const uint32_t rows = sm.base + L::kRowVals + s * 2 * NT * 4;
        float* rows_p = reinterpret_cast<float*>(sm.ptr + L::kRowVals + s * 2 * NT * 4);
        for (int r = lane; r < NT; r += 32) {
          if (q0 + r < tq) {
            cp_async<4>(rows + 4 * r, lse + q0 + r, true);
            cp_async<4>(rows + 4 * (NT + r), delta + q0 + r, true);
          } else {  // rows past Tq: P = dS = 0
            rows_p[r] = INFINITY;
            rows_p[NT + r] = 0.f;
          }
        }
      }
      cp_commit();
      publish<1>(i > 0 ? full + 8 * ((i - 1) % kStages) : fixed);
    }
    publish<0>(n_tiles > 0 ? full + 8 * ((n_tiles - 1) % kStages) : fixed);
  } else {  // the consumer warpgroup: 16 keys a warp
    const int r0 = 16 * warp + (lane >> 2);  // this thread's keys r0, r0 + 8 in the tile
    const bool key_ok[2] = {n0 + r0 < kv_len, n0 + r0 + 8 < kv_len};
    const float c = a.scale * kLog2e;
    float dk[DP / 2], dv[DP / 2], s[NT / 2], dp[NT / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) s[i] = dp[i] = 0.f;
    bar_wait(fixed, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kStages;
      bar_wait(full + 8 * st, (i / kStages) & 1);
      const uint32_t qt = sm.base + L::kStage0 + st * 2 * L::kWalkTile;
      const uint32_t gt = qt + L::kWalkTile;
      const float* lse_s = reinterpret_cast<const float*>(sm.ptr + L::kRowVals + st * 2 * NT * 4);
      const float* delta_s = lse_s + NT;

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x NT queries.
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss<NT>(s, kmajor(sm.base, kRows, kk), kmajor(qt, NT, kk), kk);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss<NT>(dp, kmajor(sm.base + L::kFixedTile, kRows, kk), kmajor(gt, NT, kk), kk);
      wg_commit();
      wg_wait();
      pin(s);
      pin(dp);

      // P^T (in s) and dS^T (in dp). Element 4j + e: key r0 + 8 (e / 2),
      // query 8j + 2 (lane % 4) + e % 2.
#pragma unroll
      for (int j = 0; j < NT / 8; ++j) {
        const int qc = 8 * j + 2 * (lane & 3);
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + qc);
        const float2 d2 = *reinterpret_cast<const float2*>(delta_s + qc);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lse_q = (e & 1) ? l2.y : l2.x;
          const float delta_q = (e & 1) ? d2.y : d2.x;
          const float p = key_ok[e >> 1] ? ex2(fmaf(s[4 * j + e], c, -lse_q * kLog2e)) : 0.f;
          dp[4 * j + e] = p * (dp[4 * j + e] - delta_q);
          s[4 * j + e] = p;
        }
      }
      uint32_t ap[NT / 16][4], ads[NT / 16][4];
      to_a<NT>(ap, s);
      to_a<NT>(ads, dp);

      // dV += P^T dO and dK += dS^T Q over the NT queries.
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < NT / 16; ++kk) {
        wgmma_rs<DP>(dv, ap[kk], mnmajor<DP>(gt, NT, kk), 1);
        wgmma_rs<DP>(dk, ads[kk], mnmajor<DP>(qt, NT, kk), 1);
      }
      wg_commit();
      wg_wait();
      pin(dv);
      pin(dk);
      pin(ap);
      pin(ads);
      bar_arrive(empty + 8 * st);
    }
    store_rows<DP>(static_cast<bf16*>(a.dk), dk, b, n0 + 16 * warp, h, tk, n_heads, d, a.scale);
    store_rows<DP>(static_cast<bf16*>(a.dv), dv, b, n0 + 16 * warp, h, tk, n_heads, d, 1.f);
  }
}

// The dQ pass: one block per (64-query tile, batch*head), dQ of those rows,
// walking the key tiles up to kv_len NT at a time.
template <typename Tag, int DP, int NT, int CH>
__global__ void __launch_bounds__(kThreads, DP > 64 ? 1 : 2)
dq_wgmma_kernel(const BwdArgs a) {
  using L = Layout<DP, NT>;
  const Smem sm = smem_base();
  const int tq = (int)a.tq, kv_len = (int)a.kv_len;
  const int n_heads = (int)a.n_heads, d = (int)a.d;
  const int bh = blockIdx.y;
  const int b = bh / n_heads;
  const int h = bh - b * n_heads;
  const int q0 = blockIdx.x * kRows;
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.qs.b + h * a.qs.h;
  const bf16* g = static_cast<const bf16*>(a.dout) + b * a.gs.b + h * a.gs.h;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.ks.b + h * a.ks.h;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.vs.b + h * a.vs.h;
  const int n_tiles = (kv_len + NT - 1) / NT;

  block_setup<DP, NT>(sm);
  const uint32_t full = sm.base + L::kBars, empty = full + 8 * kStages;
  const uint32_t fixed = sm.base + L::kFixedBar;  // Q, dO
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp >= kConsumers / 32) {  // the producer warps: K, then V
    const bool is_v = warp > kConsumers / 32;
    const bf16* src = is_v ? v : k;
    const long long st = is_v ? a.vs.t : a.ks.t;
    // first the fixed tile (Q or dO), published as `fixed` with walked tile 0
    warp_load_tile<DP, CH>(sm.base + (is_v ? L::kFixedTile : 0), kRows, is_v ? g : q,
                           is_v ? a.gs.t : a.qs.t, q0, tq, d, lane);
    cp_commit();
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      if (i >= kStages) bar_wait(empty + 8 * s, ((i / kStages) - 1) & 1);
      const uint32_t tile = sm.base + L::kStage0 + s * 2 * L::kWalkTile;
      warp_load_tile<DP, CH>(tile + (is_v ? L::kWalkTile : 0), NT, src, st, i * NT, kv_len, d,
                             lane);
      cp_commit();
      publish<1>(i > 0 ? full + 8 * ((i - 1) % kStages) : fixed);
    }
    publish<0>(full + 8 * ((n_tiles - 1) % kStages));
  } else {  // the consumer warpgroup: 16 queries a warp
    const int r0 = 16 * warp + (lane >> 2);  // this thread's queries r0, r0 + 8 in the tile
    float neg_lse2[2], row_delta[2];         // -LSE log2(e): rows past Tq give P = 0
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = q0 + r0 + 8 * half;
      const long long at = (long long)bh * tq + row;
      neg_lse2[half] = row < tq ? -static_cast<const float*>(a.lse)[at] * kLog2e : -INFINITY;
      row_delta[half] = row < tq ? static_cast<const float*>(a.delta)[at] : 0.f;
    }
    const float c = a.scale * kLog2e;
    float dq[DP / 2], s[NT / 2], dp[NT / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) s[i] = dp[i] = 0.f;
    bar_wait(fixed, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kStages;
      bar_wait(full + 8 * st, (i / kStages) & 1);
      const uint32_t kt = sm.base + L::kStage0 + st * 2 * L::kWalkTile;
      const uint32_t vt = kt + L::kWalkTile;

      // S = Q K^T and dP = dO V^T: 64 queries x NT keys.
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss<NT>(s, kmajor(sm.base, kRows, kk), kmajor(kt, NT, kk), kk);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss<NT>(dp, kmajor(sm.base + L::kFixedTile, kRows, kk), kmajor(vt, NT, kk), kk);
      wg_commit();
      wg_wait();
      pin(s);
      pin(dp);

      // dS (in dp). Element 4j + e: query r0 + 8 (e / 2), key
      // i NT + 8j + 2 (lane % 4) + e % 2; keys >= kv_len get P = 0.
#pragma unroll
      for (int j = 0; j < NT / 8; ++j) {
        const int key = i * NT + 8 * j + 2 * (lane & 3);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p =
              key + (e & 1) < kv_len ? ex2(fmaf(s[4 * j + e], c, neg_lse2[e >> 1])) : 0.f;
          dp[4 * j + e] = p * (dp[4 * j + e] - row_delta[e >> 1]);
        }
      }
      uint32_t ads[NT / 16][4];
      to_a<NT>(ads, dp);

      // dQ += dS K over the NT keys.
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < NT / 16; ++kk) wgmma_rs<DP>(dq, ads[kk], mnmajor<DP>(kt, NT, kk), 1);
      wg_commit();
      wg_wait();
      pin(dq);
      pin(ads);
      bar_arrive(empty + 8 * st);
    }
    store_rows<DP>(static_cast<bf16*>(a.dq), dq, b, q0 + 16 * warp, h, tq, n_heads, d, a.scale);
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, long long rows, const BwdArgs& a,
                   cudaStream_t s) {
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((rows + kRows - 1) / kRows), (unsigned)(a.B * a.n_heads));
  kernel<<<grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

// Rows of the walked tile: 64, or 32 in the dK/dV pass above D = 64, where
// its four accumulators would not fit the registers.
template <bool Dkv, int DP>
constexpr int walk_rows() { return Dkv && DP > 64 ? 32 : 64; }

template <bool Dkv, int DP>
constexpr size_t smem_of() { return Layout<DP, walk_rows<Dkv, DP>()>::kSmem; }

// Launch the dK/dV pass (Dkv) or the dQ pass at the padded head dim DP on
// `s`.
template <typename Tag, bool Dkv, int DP>
cudaError_t launch_pass(const BwdArgs& a, cudaStream_t s) {
  constexpr int NT = walk_rows<Dkv, DP>();
  const bool wide = wide_copies(a.d, {a.qs, a.ks, a.vs, a.gs}, {a.q, a.k, a.v, a.dout});
  if constexpr (Dkv)
    return wide ? launch(dkv_wgmma_kernel<Tag, DP, NT, 8>, smem_of<Dkv, DP>(), a.tk, a, s)
                : launch(dkv_wgmma_kernel<Tag, DP, NT, 4>, smem_of<Dkv, DP>(), a.tk, a, s);
  else
    return wide ? launch(dq_wgmma_kernel<Tag, DP, NT, 8>, smem_of<Dkv, DP>(), a.tq, a, s)
                : launch(dq_wgmma_kernel<Tag, DP, NT, 4>, smem_of<Dkv, DP>(), a.tq, a, s);
}

// Launch the dK/dV pass on `s`; bfloat16 operands, D <= 128 a multiple of 4.
template <typename Tag>
cudaError_t launch_dkv(const BwdArgs& a, cudaStream_t s) {
  return with_padded_d(a.d,
                       [&](auto dp) { return launch_pass<Tag, true, decltype(dp)::value>(a, s); });
}

// Launch the dQ pass on `s`; as launch_dkv.
template <typename Tag>
cudaError_t launch_dq(const BwdArgs& a, cudaStream_t s) {
  return with_padded_d(a.d,
                       [&](auto dp) { return launch_pass<Tag, false, decltype(dp)::value>(a, s); });
}

// Dynamic shared memory of one block of the dK/dV (dkv) or dQ pass at head
// dim d.
inline size_t smem_bytes(bool dkv, long long d) {
  return with_padded_d(d, [&](auto dp) {
    return dkv ? smem_of<true, decltype(dp)::value>() : smem_of<false, decltype(dp)::value>();
  });
}

}  // namespace bwd90
}  // namespace
