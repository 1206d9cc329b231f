// Backward attention kernels shared by the whole-sequence backward B2
// (flash_attention_bwd.cu) and the blocked backward B4/B5
// (flash_attention_blocked_bwd.cu). For q [B, Tq, H, D] against the first
// kv_len keys of k, v [B, Tk, H, D], with the forward's LSE and
// delta = rowsum(dO * O), both float32 [B*H, Tq]:
//   P    = exp(scale * Q K^T - LSE)                  (float32; 0 at keys >= kv_len)
//   dV   = P_op^T dO                                  (P_op: P rounded to the operand dtype)
//   dP   = dO V^T                                     (float32 accumulation)
//   dS   = P * (dP - delta), rounded to the operand dtype
//   dQ   = scale * dS K,    dK = scale * dS^T Q
// dQ is stored [B, Tq, H, D], dK and dV [B, Tk, H, D], contiguous in the
// operand dtype; keys at or past kv_len get dK = dV = 0 written.
//
// The FlashAttention-2 split (Dao, arXiv 2307.08691), which needs no float
// atomics and so gives bit-identical gradients from run to run:
//   dkv kernel: one block per (64-key tile, batch*head). K and V stay in the
//      block; it walks over all query tiles, recomputes P and dS for the tile
//      pair and accumulates dK and dV. A tile wholly at or past kv_len skips
//      the walk and writes zeros.
//   dq kernel: one block per (64-query tile, batch*head). Q and dO stay in the
//      block; it walks over the key tiles up to kv_len and accumulates dQ.
// P and dS are recomputed in both (7 tile products where a kernel with atomics
// would do 5) and never touch device memory. Ragged tails: key columns >=
// kv_len get P = 0, so they add nothing to dQ; query rows >= Tq get LSE = +inf
// and so P = 0 and dS = 0, so they add nothing to dK or dV. Inputs are read
// through their (batch, token, head) strides with a unit head-dim stride;
// every offset into them is 64-bit.
//
// bfloat16 operands run every tile product on the tensor cores with mma.sync
// (dkv_tc_kernel, dq_tc_kernel; see the note above them). float32 operands run
// them on the float32 CUDA cores through one shared-memory tile-product helper
// (4x4 register micro-tiles; dkv_kernel, dq_kernel), which keeps full float32
// products, as the TPU kernels do for float32 inputs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "bf16_mma.cuh"

namespace {

using namespace headct_mma;

constexpr int kTile = 64;      // query rows or keys per tile
constexpr int kThreads = 128;
constexpr int kLdp = kTile + 1;  // row stride of the [64, 64] P and dS tiles
static_assert(kTile == kMmaRows && kThreads == kMmaThreads, "tiles shared with bf16_mma.cuh");

// Arguments of one backward call; pointers are device pointers, lse and delta
// float32 [B*H, Tq].
struct BwdArgs {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  long long B, tq, tk, kv_len, n_heads, d;
  Strides qs, ks, vs, gs;
  float scale;
};

// Rows [row0, row0 + 64) of a float32 [T, D] slab with row stride `st`
// (elements) into shared memory with leading dimension `ld`; rows >= n_rows
// are 0.
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src, long long st,
                                          int row0, int n_rows, int d) {
  const int quads = d >> 2;
  for (int idx = threadIdx.x; idx < kTile * quads; idx += kThreads) {
    const int r = idx / quads;
    const int c = (idx - r * quads) << 2;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows) x = load4(src + (long long)(row0 + r) * st + c);
    float* out = dst + r * ld + c;
    out[0] = x.x;
    out[1] = x.y;
    out[2] = x.z;
    out[3] = x.w;
  }
}

// C[m][n] (+)= sum_k A(m, k) B(k, n) over shared-memory operands, with
// A(m, k) = A[m * a_rs + k * a_cs] and B(k, n) = B[k * b_rs + n * b_cs];
// M = 64, N a multiple of 4. Each thread owns whole 4x4 micro-tiles of C,
// the same ones for every call with the same N, so accumulating calls need
// no synchronisation among themselves.
__device__ __forceinline__ void tile_mm(float* C, int ldc, const float* A, int a_rs, int a_cs,
                                        const float* B, int b_rs, int b_cs, int n, int k_len,
                                        bool accumulate) {
  const int n_groups = n >> 2;
  for (int t = threadIdx.x; t < (kTile / 4) * n_groups; t += kThreads) {
    const int m0 = (t % (kTile / 4)) * 4;
    const int n0 = (t / (kTile / 4)) * 4;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    const float* a = A + m0 * a_rs;
    const float* b = B + n0 * b_cs;
    for (int kk = 0; kk < k_len; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a[i * a_rs + kk * a_cs];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = b[kk * b_rs + j * b_cs];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* c = C + (m0 + i) * ldc + n0 + j;
        *c = accumulate ? *c + acc[i][j] : acc[i][j];
      }
  }
}

// P = exp(scale * S - lse) for the [64 query, 64 key] tile held in ps (S on
// entry), masked to 0 outside the n_valid real keys; then, with dP in dss on
// entry, dss = P * (dP - delta) and, when store_p, ps = P. (float32 operands:
// rounding to the operand dtype is the identity.)
__device__ __forceinline__ void softmax_grad_tile(float* ps, float* dss, const float* lse_s,
                                                  const float* delta_s, int n_valid, float scale,
                                                  bool store_p) {
  for (int idx = threadIdx.x; idx < kTile * kTile; idx += kThreads) {
    const int i = idx / kTile;  // query row in the tile
    const int j = idx - i * kTile;
    const float p = j < n_valid ? expf(scale * ps[i * kLdp + j] - lse_s[i]) : 0.f;
    dss[i * kLdp + j] = p * (dss[i * kLdp + j] - delta_s[i]);
    if (store_p) ps[i * kLdp + j] = p;
  }
}

// LSE and delta of the query rows [m0, m0 + 64) into shared memory; rows >= Tq
// get LSE = +inf (P = 0) and delta = 0.
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s, const float* lse,
                                          const float* delta, int bh, int m0, int tq) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const bool real = m0 + i < tq;
    lse_s[i] = real ? lse[(long long)bh * tq + m0 + i] : INFINITY;
    delta_s[i] = real ? delta[(long long)bh * tq + m0 + i] : 0.f;
  }
}

// float32 operands: one block per (64-key tile, batch*head), dK and dV of
// those keys.
template <typename Tag>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           const float* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int tq,
           int tk, int kv_len, int n_heads, int d, Strides qs, Strides ks, Strides vs, Strides gs,
           float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = d + 1;
  float* k_s = smem;                  // [64][ld]
  float* v_s = k_s + kTile * ld;      // [64][ld]
  float* q_s = v_s + kTile * ld;      // [64][ld]
  float* g_s = q_s + kTile * ld;      // [64][ld] dO
  float* dk_s = g_s + kTile * ld;     // [64][ld] accumulator
  float* dv_s = dk_s + kTile * ld;    // [64][ld] accumulator
  float* p_s = dv_s + kTile * ld;     // [64][kLdp]
  float* ds_s = p_s + kTile * kLdp;   // [64][kLdp]
  float* lse_s = ds_s + kTile * kLdp; // [64]
  float* delta_s = lse_s + kTile;     // [64]

  const int bh = blockIdx.y;
  const int b = bh / n_heads;
  const int h = bh - b * n_heads;
  const int n0 = blockIdx.x * kTile;
  const int n_valid = min(kTile, kv_len - n0);  // real keys in the tile; <= 0 past kv_len
  const float* qb = q + b * qs.b + h * qs.h;
  const float* gb = dout + b * gs.b + h * gs.h;

  for (int idx = threadIdx.x; idx < kTile * ld; idx += kThreads) dk_s[idx] = dv_s[idx] = 0.f;
  if (n_valid > 0) {  // the same for the whole block
    load_tile(k_s, ld, k + b * ks.b + h * ks.h, ks.t, n0, kv_len, d);
    load_tile(v_s, ld, v + b * vs.b + h * vs.h, vs.t, n0, kv_len, d);
    for (int m0 = 0; m0 < tq; m0 += kTile) {
      __syncthreads();  // the previous query tile is consumed
      load_tile(q_s, ld, qb, qs.t, m0, tq, d);
      load_tile(g_s, ld, gb, gs.t, m0, tq, d);
      load_rows(lse_s, delta_s, lse, delta, bh, m0, tq);
      __syncthreads();
      tile_mm(p_s, kLdp, q_s, ld, 1, k_s, 1, ld, kTile, d, false);   // S = Q K^T
      tile_mm(ds_s, kLdp, g_s, ld, 1, v_s, 1, ld, kTile, d, false);  // dP = dO V^T
      __syncthreads();
      softmax_grad_tile(p_s, ds_s, lse_s, delta_s, n_valid, scale, true);
      __syncthreads();
      // dV += P_op^T dO and dK += dS^T Q: rows are keys j, the sum runs over queries i.
      tile_mm(dv_s, ld, p_s, 1, kLdp, g_s, ld, 1, d, kTile, true);
      tile_mm(dk_s, ld, ds_s, 1, kLdp, q_s, ld, 1, d, kTile, true);
    }
  }
  __syncthreads();
  const int n_store = min(kTile, tk - n0);
  for (int idx = threadIdx.x; idx < n_store * d; idx += kThreads) {
    const int j = idx / d;
    const int c = idx - j * d;
    const long long out = (((long long)b * tk + n0 + j) * n_heads + h) * d + c;
    dk[out] = scale * dk_s[j * ld + c];
    dv[out] = dv_s[j * ld + c];
  }
}

// float32 operands: one block per (64-query tile, batch*head), dQ of those rows.
template <typename Tag>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          const float* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, float* __restrict__ dq, int tq, int kv_len, int n_heads,
          int d, Strides qs, Strides ks, Strides vs, Strides gs, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = d + 1;
  float* q_s = smem;                  // [64][ld]
  float* g_s = q_s + kTile * ld;      // [64][ld] dO
  float* k_s = g_s + kTile * ld;      // [64][ld]
  float* v_s = k_s + kTile * ld;      // [64][ld]
  float* dq_s = v_s + kTile * ld;     // [64][ld] accumulator
  float* p_s = dq_s + kTile * ld;     // [64][kLdp]
  float* ds_s = p_s + kTile * kLdp;   // [64][kLdp]
  float* lse_s = ds_s + kTile * kLdp; // [64]
  float* delta_s = lse_s + kTile;     // [64]

  const int bh = blockIdx.y;
  const int b = bh / n_heads;
  const int h = bh - b * n_heads;
  const int m0 = blockIdx.x * kTile;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;

  load_tile(q_s, ld, q + b * qs.b + h * qs.h, qs.t, m0, tq, d);
  load_tile(g_s, ld, dout + b * gs.b + h * gs.h, gs.t, m0, tq, d);
  load_rows(lse_s, delta_s, lse, delta, bh, m0, tq);
  for (int idx = threadIdx.x; idx < kTile * ld; idx += kThreads) dq_s[idx] = 0.f;

  for (int n0 = 0; n0 < kv_len; n0 += kTile) {
    __syncthreads();  // the previous key tile is consumed (and Q, dO are loaded)
    load_tile(k_s, ld, kb, ks.t, n0, kv_len, d);
    load_tile(v_s, ld, vb, vs.t, n0, kv_len, d);
    __syncthreads();
    tile_mm(p_s, kLdp, q_s, ld, 1, k_s, 1, ld, kTile, d, false);   // S = Q K^T
    tile_mm(ds_s, kLdp, g_s, ld, 1, v_s, 1, ld, kTile, d, false);  // dP = dO V^T
    __syncthreads();
    softmax_grad_tile(p_s, ds_s, lse_s, delta_s, min(kTile, kv_len - n0), scale, false);
    __syncthreads();
    tile_mm(dq_s, ld, ds_s, kLdp, 1, k_s, ld, 1, d, kTile, true);  // dQ += dS K
  }
  __syncthreads();
  const int m_valid = min(kTile, tq - m0);
  for (int idx = threadIdx.x; idx < m_valid * d; idx += kThreads) {
    const int i = idx / d;
    const int c = idx - i * d;
    dq[(((long long)b * tq + m0 + i) * n_heads + h) * d + c] = scale * dq_s[i * ld + c];
  }
}

// ---------------------------------------------------------------------------
// bfloat16 operands: the tile products on the tensor cores (bf16_mma.cuh;
// the same products as the float32-core path above, summed in another
// order). Each warp owns 16 rows of the block's 64: in the dK/dV pass 16
// keys, for which it computes S^T = K Q^T and dP^T = V dO^T, then P^T and
// dS^T in registers, which feed dV += P^T dO and dK += dS^T Q straight from
// the accumulator fragments; in the dQ pass 16 queries, with S = Q K^T,
// dP = dO V^T and dQ += dS K. The B operands of the second products (Q^T,
// dO^T, K^T) are stored transposed.
// ---------------------------------------------------------------------------

// Store a 16 x DP accumulator block (rows row0 + lane/4 and + 8 of n_rows) as
// bf16 rows of a contiguous [B, n_rows, H, D] output, times `mul`.
template <int DP>
__device__ __forceinline__ void store_rows(bf16* out, const float (*acc)[4], int b, int row0,
                                           int h, int n_rows, int n_heads, int d, float mul) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + (lane >> 2) + 8 * half;
    if (row >= n_rows) continue;
    bf16* o = out + (((long long)b * n_rows + row) * n_heads + h) * d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = j * 8 + 2 * (lane & 3);
      if (c < d)
        *reinterpret_cast<__nv_bfloat162*>(o + c) =
            __floats2bfloat162_rn(mul * acc[j][2 * half], mul * acc[j][2 * half + 1]);
    }
  }
}

// One block per (64-key tile, batch*head): dK and dV of those keys.
template <typename Tag, int DP>
__global__ void __launch_bounds__(kThreads)
dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dk, bf16* __restrict__ dv, int tq, int tk, int kv_len,
              int n_heads, int d, Strides qs, Strides ks, Strides vs, Strides gs, float scale) {
  constexpr int LD = DP + 8;
  extern __shared__ float4 smem4[];
  bf16* k_s = reinterpret_cast<bf16*>(smem4);  // [64][LD]
  bf16* v_s = k_s + kTile * LD;                 // [64][LD]
  bf16* q_s = v_s + kTile * LD;                 // [64][LD]
  bf16* g_s = q_s + kTile * LD;                 // [64][LD] dO
  bf16* qt_s = g_s + kTile * LD;                // [DP][kLdt] Q^T
  bf16* gt_s = qt_s + DP * kLdt;                // [DP][kLdt] dO^T
  float* lse_s = reinterpret_cast<float*>(gt_s + DP * kLdt);  // [64]
  float* delta_s = lse_s + kTile;                               // [64]

  const int bh = blockIdx.y;
  const int b = bh / n_heads;
  const int h = bh - b * n_heads;
  const int n0 = blockIdx.x * kTile;
  const int lane = threadIdx.x & 31;
  const int m0 = (threadIdx.x >> 5) * 16;  // this warp's 16 keys in the tile
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* gb = dout + b * gs.b + h * gs.h;
  const bool key_real[2] = {n0 + m0 + (lane >> 2) < kv_len, n0 + m0 + (lane >> 2) + 8 < kv_len};

  float acc_dk[DP / 8][4], acc_dv[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[j][e] = acc_dv[j][e] = 0.f;

  if (n0 < kv_len) {  // the same for the whole block; a tile past kv_len stores zeros
    load_tile_bf16<DP>(k_s, nullptr, k + b * ks.b + h * ks.h, ks.t, n0, kv_len, d);
    load_tile_bf16<DP>(v_s, nullptr, v + b * vs.b + h * vs.h, vs.t, n0, kv_len, d);
    for (int q0 = 0; q0 < tq; q0 += kTile) {
      __syncthreads();  // the previous query tile is consumed
      load_tile_bf16<DP>(q_s, qt_s, qb, qs.t, q0, tq, d);
      load_tile_bf16<DP>(g_s, gt_s, gb, gs.t, q0, tq, d);
      load_rows(lse_s, delta_s, lse, delta, bh, q0, tq);
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: 16 keys x 64 queries, 8 tiles of 8 queries.
      float s[8][4], dp[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP; kk += 16) {
        uint32_t ak[4], av[4];
        load_a(ak, k_s, LD, m0, kk);
        load_a(av, v_s, LD, m0, kk);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          uint32_t b0, b1;
          load_b(b0, b1, q_s, LD, j * 8, kk);
          mma_bf16(s[j], ak, b0, b1);
          load_b(b0, b1, g_s, LD, j * 8, kk);
          mma_bf16(dp[j], av, b0, b1);
        }
      }
      // P^T (in s) and dS^T (in dp); element e of tile j is key row + 8 (e / 2),
      // query column j * 8 + 2 (lane % 4) + e % 2.
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = j * 8 + 2 * (lane & 3) + (e & 1);
          const float p = key_real[e >> 1] ? expf(scale * s[j][e] - lse_s[qi]) : 0.f;
          dp[j][e] = p * (dp[j][e] - delta_s[qi]);
          s[j][e] = p;
        }
      // dV += P^T dO and dK += dS^T Q over the 64 queries, 4 steps of 16.
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {
        uint32_t ap[4], ads[4];
        acc_to_a(ap, s, kq);
        acc_to_a(ads, dp, kq);
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          uint32_t b0, b1;
          load_b(b0, b1, gt_s, kLdt, j * 8, kq * 16);
          mma_bf16(acc_dv[j], ap, b0, b1);
          load_b(b0, b1, qt_s, kLdt, j * 8, kq * 16);
          mma_bf16(acc_dk[j], ads, b0, b1);
        }
      }
    }
  }
  store_rows<DP>(dk, acc_dk, b, n0 + m0, h, tk, n_heads, d, scale);
  store_rows<DP>(dv, acc_dv, b, n0 + m0, h, tk, n_heads, d, 1.f);
}

// One block per (64-query tile, batch*head): dQ of those rows.
template <typename Tag, int DP>
__global__ void __launch_bounds__(kThreads)
dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
             const bf16* __restrict__ dout, const float* __restrict__ lse,
             const float* __restrict__ delta, bf16* __restrict__ dq, int tq, int kv_len,
             int n_heads, int d, Strides qs, Strides ks, Strides vs, Strides gs, float scale) {
  constexpr int LD = DP + 8;
  extern __shared__ float4 smem4[];
  bf16* q_s = reinterpret_cast<bf16*>(smem4);  // [64][LD]
  bf16* g_s = q_s + kTile * LD;                 // [64][LD] dO
  bf16* k_s = g_s + kTile * LD;                 // [64][LD]
  bf16* v_s = k_s + kTile * LD;                 // [64][LD]
  bf16* kt_s = v_s + kTile * LD;                // [DP][kLdt] K^T

  const int bh = blockIdx.y;
  const int b = bh / n_heads;
  const int h = bh - b * n_heads;
  const int q0 = blockIdx.x * kTile;
  const int lane = threadIdx.x & 31;
  const int m0 = (threadIdx.x >> 5) * 16;  // this warp's 16 queries in the tile
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;

  load_tile_bf16<DP>(q_s, nullptr, q + b * qs.b + h * qs.h, qs.t, q0, tq, d);
  load_tile_bf16<DP>(g_s, nullptr, dout + b * gs.b + h * gs.h, gs.t, q0, tq, d);
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + m0 + (lane >> 2) + 8 * half;
    row_lse[half] = row < tq ? lse[(long long)bh * tq + row] : INFINITY;
    row_delta[half] = row < tq ? delta[(long long)bh * tq + row] : 0.f;
  }
  float acc_dq[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dq[j][e] = 0.f;

  for (int n0 = 0; n0 < kv_len; n0 += kTile) {
    __syncthreads();  // the previous key tile is consumed (and Q, dO are loaded)
    load_tile_bf16<DP>(k_s, kt_s, kb, ks.t, n0, kv_len, d);
    load_tile_bf16<DP>(v_s, nullptr, vb, vs.t, n0, kv_len, d);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: 16 queries x 64 keys, 8 tiles of 8 keys.
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      uint32_t aq[4], ag[4];
      load_a(aq, q_s, LD, m0, kk);
      load_a(ag, g_s, LD, m0, kk);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t b0, b1;
        load_b(b0, b1, k_s, LD, j * 8, kk);
        mma_bf16(s[j], aq, b0, b1);
        load_b(b0, b1, v_s, LD, j * 8, kk);
        mma_bf16(dp[j], ag, b0, b1);
      }
    }
    // dS (in dp); element e of tile j is query row + 8 (e / 2), key column
    // n0 + j * 8 + 2 (lane % 4) + e % 2. Keys >= kv_len get P = 0.
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n0 + j * 8 + 2 * (lane & 3) + (e & 1);
        const float p = key < kv_len ? expf(scale * s[j][e] - row_lse[e >> 1]) : 0.f;
        dp[j][e] = p * (dp[j][e] - row_delta[e >> 1]);
      }
    // dQ += dS K over the 64 keys, 4 steps of 16.
#pragma unroll
    for (int kq = 0; kq < 4; ++kq) {
      uint32_t ads[4];
      acc_to_a(ads, dp, kq);
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        uint32_t b0, b1;
        load_b(b0, b1, kt_s, kLdt, j * 8, kq * 16);
        mma_bf16(acc_dq[j], ads, b0, b1);
      }
    }
  }
  store_rows<DP>(dq, acc_dq, b, q0 + m0, h, tq, n_heads, d, scale);
}

template <typename T, typename Kernel>
cudaError_t launch_dkv_kernel(Kernel kernel, size_t smem, const BwdArgs& a, cudaStream_t s) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((a.tk + kTile - 1) / kTile), (unsigned)(a.B * a.n_heads));
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      (int)a.tq, (int)a.tk, (int)a.kv_len, (int)a.n_heads, (int)a.d, a.qs, a.ks, a.vs, a.gs,
      a.scale);
  return cudaGetLastError();
}

template <typename T, typename Kernel>
cudaError_t launch_dq_kernel(Kernel kernel, size_t smem, const BwdArgs& a, cudaStream_t s) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((a.tq + kTile - 1) / kTile), (unsigned)(a.B * a.n_heads));
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.dq), (int)a.tq, (int)a.kv_len,
      (int)a.n_heads, (int)a.d, a.qs, a.ks, a.vs, a.gs, a.scale);
  return cudaGetLastError();
}

// Shared memory of the float32 kernels: 6 (dK/dV) or 5 (dQ) [64][D + 1]
// tiles, the P and dS tiles and 64 LSE and delta values.
inline size_t f32_bwd_smem(long long d, int tiles) {
  return ((size_t)tiles * kTile * (d + 1) + (size_t)2 * kTile * kLdp + 2 * kTile) * sizeof(float);
}

// Shared memory of the tensor-core kernels: 4 [64][DP + 8] bf16 tiles and
// 2 (dK/dV, with 64 LSE and delta values) or 1 (dQ) transposed [DP][kLdt].
template <int DP>
constexpr size_t tc_bwd_smem(bool dkv) {
  return 4 * (size_t)kTile * (DP + 8) * sizeof(bf16) +
         (dkv ? 2 : 1) * (size_t)DP * kLdt * sizeof(bf16) + (dkv ? 2 * kTile * sizeof(float) : 0);
}

// Launch the dK/dV pass on `s`. dtype: 0 = float32 (CUDA cores), 1 = bfloat16
// (tensor cores, head dim padded to the next of 16, 32, 48, 64, 128).
template <typename Tag>
cudaError_t launch_dkv(const BwdArgs& a, int dtype, cudaStream_t s) {
  if (dtype == 0) return launch_dkv_kernel<float>(dkv_kernel<Tag>, f32_bwd_smem(a.d, 6), a, s);
  if (dtype != 1) return cudaErrorInvalidValue;
#define HEADCT_DKV(DP) \
  return launch_dkv_kernel<bf16>(dkv_tc_kernel<Tag, DP>, tc_bwd_smem<DP>(true), a, s)
  if (a.d <= 16) HEADCT_DKV(16);
  if (a.d <= 32) HEADCT_DKV(32);
  if (a.d <= 48) HEADCT_DKV(48);
  if (a.d <= 64) HEADCT_DKV(64);
  HEADCT_DKV(128);
#undef HEADCT_DKV
}

// Launch the dQ pass on `s`; dtype as for launch_dkv.
template <typename Tag>
cudaError_t launch_dq(const BwdArgs& a, int dtype, cudaStream_t s) {
  if (dtype == 0) return launch_dq_kernel<float>(dq_kernel<Tag>, f32_bwd_smem(a.d, 5), a, s);
  if (dtype != 1) return cudaErrorInvalidValue;
#define HEADCT_DQ(DP) \
  return launch_dq_kernel<bf16>(dq_tc_kernel<Tag, DP>, tc_bwd_smem<DP>(false), a, s)
  if (a.d <= 16) HEADCT_DQ(16);
  if (a.d <= 32) HEADCT_DQ(32);
  if (a.d <= 48) HEADCT_DQ(48);
  if (a.d <= 64) HEADCT_DQ(64);
  HEADCT_DQ(128);
#undef HEADCT_DQ
}

}  // namespace
