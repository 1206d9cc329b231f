// Whole-sequence attention backward for NVIDIA Hopper (sm_90a).
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
//   2. dkv_kernel: one block per (64-key tile, batch*head). K and V stay in
//      shared memory; the block walks over all query tiles, recomputes P and
//      dS for the tile pair and accumulates dK and dV in shared memory.
//   3. dq_kernel: one block per (64-query tile, batch*head). Q and dO stay in
//      shared memory; the block walks over all key tiles and accumulates dQ.
// P and dS are recomputed in both passes (7 tile products where a kernel
// with atomics would do 5), and never touch device memory. The ragged tail
// (513 = 8 * 64 + 1) is masked: key columns >= T get P = 0, so they add
// nothing to dQ; query rows >= T get LSE = +inf and so P = 0 and dS = 0, so
// they add nothing to dK or dV. Inputs are read through their (batch, token,
// head) strides with a unit head-dim stride, as in the forward kernel.
//
// Two paths share that structure. bfloat16 operands (training) run every
// tile product on the tensor cores with mma.sync (dkv_tc_kernel,
// dq_tc_kernel; see the note above them). float32 operands run them on the
// float32 CUDA cores through one shared-memory tile-product helper (4x4
// register micro-tiles; dkv_kernel, dq_kernel), which keeps full float32
// products, as the TPU kernel does for float32 inputs. wgmma, TMA and a fused
// dq/dk/dv write are later work.
//
// Bound at the MAE decoder shape [32, 513, 16, 48] bfloat16: the function's
// 5 products are 10*B*H*T^2*D = 6.47e10 operations, 0.065 ms at the bf16
// dense peak of 989 TFLOP/s; q, k, v, o, dO read once and dq, dk, dv written
// once plus LSE are 203 MB, 0.061 ms at 3.35 TB/s. So it is bound by
// operations, narrowly. mma.sync reaches only part of the dense peak, and the
// exp of every P element runs on the special-function units, so the kernel
// stays far from that bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "bf16_mma.cuh"

namespace {

using namespace headct_mma;

constexpr int kTile = 64;      // query rows or keys per tile
constexpr int kThreads = 128;
constexpr int kLdp = kTile + 1;  // row stride of the [64, 64] P and dS tiles
static_assert(kTile == kMmaRows && kThreads == kMmaThreads, "tiles shared with bf16_mma.cuh");

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  uint2 raw = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 a, b;
  memcpy(&a, &raw.x, sizeof(a));
  memcpy(&b, &raw.y, sizeof(b));
  const float2 fa = __bfloat1622float2(a);
  const float2 fb = __bfloat1622float2(b);
  return make_float4(fa.x, fa.y, fb.x, fb.y);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Rounding to the operand dtype before a product, as the TPU kernel casts p
// and ds to q.dtype (flash_attention.py:105, :115).
template <typename T> __device__ __forceinline__ float to_operand(float x);
template <> __device__ __forceinline__ float to_operand<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_operand<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Rows [row0, row0 + 64) of a [T, D] slab with row stride `st` (elements)
// into shared memory as float with leading dimension `ld`; rows >= T are 0.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src, long long st,
                                          int row0, int t_len, int d) {
  const int quads = d >> 2;
  for (int idx = threadIdx.x; idx < kTile * quads; idx += kThreads) {
    const int r = idx / quads;
    const int c = (idx - r * quads) << 2;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < t_len) x = load4(src + (long long)(row0 + r) * st + c);
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

// d[bh][t] = sum_c dO[b, t, h, c] * O[b, t, h, c] in float32; one warp per row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
             long long rows, int t_len, int n_heads, int d, long long o_sb, long long o_st,
             long long o_sh, long long g_sb, long long g_st, long long g_sh) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (kThreads / 32) + warp;  // over B*H*T
  if (row >= rows) return;
  const int bh = (int)(row / t_len);
  const int t = (int)(row - (long long)bh * t_len);
  const int b = bh / n_heads;
  const int h = bh - b * n_heads;
  const T* orow = o + b * o_sb + t * o_st + h * o_sh;
  const T* grow = dout + b * g_sb + t * g_st + h * g_sh;
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

// Strides of one [B, T, H, D] operand, in elements.
struct Strides {
  long long b, t, h;
};

// P = exp(scale * S - lse) for the [64 query, 64 key] tile held in ps (S on
// entry), masked to 0 outside the real keys; then, with dP in dss on entry,
// dss = round(P * (dP - delta)) and, when round_p, ps = round(P).
template <typename T>
__device__ __forceinline__ void softmax_grad_tile(float* ps, float* dss, const float* lse_s,
                                                  const float* delta_s, int n_valid, float scale,
                                                  bool round_p) {
  for (int idx = threadIdx.x; idx < kTile * kTile; idx += kThreads) {
    const int i = idx / kTile;  // query row in the tile
    const int j = idx - i * kTile;
    const float p = j < n_valid ? expf(scale * ps[i * kLdp + j] - lse_s[i]) : 0.f;
    dss[i * kLdp + j] = to_operand<T>(p * (dss[i * kLdp + j] - delta_s[i]));
    if (round_p) ps[i * kLdp + j] = to_operand<T>(p);
  }
}

// One block per (64-key tile, batch*head): dK and dV of those keys.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int t_len,
           int n_heads, int d, Strides qs, Strides ks, Strides vs, Strides gs, float scale) {
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
  const int n_valid = min(kTile, t_len - n0);
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const T* gb = dout + b * gs.b + h * gs.h;

  load_tile(k_s, ld, kb, ks.t, n0, t_len, d);
  load_tile(v_s, ld, vb, vs.t, n0, t_len, d);
  for (int idx = threadIdx.x; idx < kTile * ld; idx += kThreads) dk_s[idx] = dv_s[idx] = 0.f;

  for (int m0 = 0; m0 < t_len; m0 += kTile) {
    __syncthreads();  // the previous query tile is consumed
    load_tile(q_s, ld, qb, qs.t, m0, t_len, d);
    load_tile(g_s, ld, gb, gs.t, m0, t_len, d);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const bool real = m0 + i < t_len;
      lse_s[i] = real ? lse[(long long)bh * t_len + m0 + i] : INFINITY;  // P = 0 on padding
      delta_s[i] = real ? delta[(long long)bh * t_len + m0 + i] : 0.f;
    }
    __syncthreads();
    tile_mm(p_s, kLdp, q_s, ld, 1, k_s, 1, ld, kTile, d, false);   // S = Q K^T
    tile_mm(ds_s, kLdp, g_s, ld, 1, v_s, 1, ld, kTile, d, false);  // dP = dO V^T
    __syncthreads();
    softmax_grad_tile<T>(p_s, ds_s, lse_s, delta_s, n_valid, scale, true);
    __syncthreads();
    // dV += P_op^T dO and dK += dS^T Q: rows are keys j, the sum runs over queries i.
    tile_mm(dv_s, ld, p_s, 1, kLdp, g_s, ld, 1, d, kTile, true);
    tile_mm(dk_s, ld, ds_s, 1, kLdp, q_s, ld, 1, d, kTile, true);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < n_valid * d; idx += kThreads) {
    const int j = idx / d;
    const int c = idx - j * d;
    const long long out = (((long long)b * t_len + n0 + j) * n_heads + h) * d + c;
    store(dk + out, scale * dk_s[j * ld + c]);
    store(dv + out, dv_s[j * ld + c]);
  }
}

// One block per (64-query tile, batch*head): dQ of those rows.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, int t_len, int n_heads, int d,
          Strides qs, Strides ks, Strides vs, Strides gs, float scale) {
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
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const T* gb = dout + b * gs.b + h * gs.h;

  load_tile(q_s, ld, qb, qs.t, m0, t_len, d);
  load_tile(g_s, ld, gb, gs.t, m0, t_len, d);
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const bool real = m0 + i < t_len;
    lse_s[i] = real ? lse[(long long)bh * t_len + m0 + i] : INFINITY;
    delta_s[i] = real ? delta[(long long)bh * t_len + m0 + i] : 0.f;
  }
  for (int idx = threadIdx.x; idx < kTile * ld; idx += kThreads) dq_s[idx] = 0.f;

  for (int n0 = 0; n0 < t_len; n0 += kTile) {
    __syncthreads();  // the previous key tile is consumed (and Q, dO are loaded)
    load_tile(k_s, ld, kb, ks.t, n0, t_len, d);
    load_tile(v_s, ld, vb, vs.t, n0, t_len, d);
    __syncthreads();
    tile_mm(p_s, kLdp, q_s, ld, 1, k_s, 1, ld, kTile, d, false);   // S = Q K^T
    tile_mm(ds_s, kLdp, g_s, ld, 1, v_s, 1, ld, kTile, d, false);  // dP = dO V^T
    __syncthreads();
    softmax_grad_tile<T>(p_s, ds_s, lse_s, delta_s, min(kTile, t_len - n0), scale, false);
    __syncthreads();
    tile_mm(dq_s, ld, ds_s, kLdp, 1, k_s, ld, 1, d, kTile, true);  // dQ += dS K
  }
  __syncthreads();
  const int m_valid = min(kTile, t_len - m0);
  for (int idx = threadIdx.x; idx < m_valid * d; idx += kThreads) {
    const int i = idx / d;
    const int c = idx - i * d;
    store(dq + (((long long)b * t_len + m0 + i) * n_heads + h) * d + c, scale * dq_s[i * ld + c]);
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

// Store a 16 x DP accumulator block (rows row0 + lane/4 and + 8) as bf16 rows
// of a contiguous [B, T, H, D] output, times `mul`.
template <int DP>
__device__ __forceinline__ void store_rows(bf16* out, const float (*acc)[4], int b, int row0,
                                           int h, int t_len, int n_heads, int d, float mul) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + (lane >> 2) + 8 * half;
    if (row >= t_len) continue;
    bf16* o = out + (((long long)b * t_len + row) * n_heads + h) * d;
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
template <int DP>
__global__ void __launch_bounds__(kThreads)
dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dk, bf16* __restrict__ dv, int t_len, int n_heads, int d,
              Strides qs, Strides ks, Strides vs, Strides gs, float scale) {
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

  load_tile_bf16<DP>(k_s, nullptr, k + b * ks.b + h * ks.h, ks.t, n0, t_len, d);
  load_tile_bf16<DP>(v_s, nullptr, v + b * vs.b + h * vs.h, vs.t, n0, t_len, d);
  const bool key_real[2] = {n0 + m0 + (lane >> 2) < t_len, n0 + m0 + (lane >> 2) + 8 < t_len};

  float acc_dk[DP / 8][4], acc_dv[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[j][e] = acc_dv[j][e] = 0.f;

  for (int q0 = 0; q0 < t_len; q0 += kTile) {
    __syncthreads();  // the previous query tile is consumed
    load_tile_bf16<DP>(q_s, qt_s, qb, qs.t, q0, t_len, d);
    load_tile_bf16<DP>(g_s, gt_s, gb, gs.t, q0, t_len, d);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const bool real = q0 + i < t_len;
      lse_s[i] = real ? lse[(long long)bh * t_len + q0 + i] : INFINITY;  // P = 0 on padding
      delta_s[i] = real ? delta[(long long)bh * t_len + q0 + i] : 0.f;
    }
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
  store_rows<DP>(dk, acc_dk, b, n0 + m0, h, t_len, n_heads, d, scale);
  store_rows<DP>(dv, acc_dv, b, n0 + m0, h, t_len, n_heads, d, 1.f);
}

// One block per (64-query tile, batch*head): dQ of those rows.
template <int DP>
__global__ void __launch_bounds__(kThreads)
dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
             const bf16* __restrict__ dout, const float* __restrict__ lse,
             const float* __restrict__ delta, bf16* __restrict__ dq, int t_len, int n_heads,
             int d, Strides qs, Strides ks, Strides vs, Strides gs, float scale) {
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

  load_tile_bf16<DP>(q_s, nullptr, q + b * qs.b + h * qs.h, qs.t, q0, t_len, d);
  load_tile_bf16<DP>(g_s, nullptr, dout + b * gs.b + h * gs.h, gs.t, q0, t_len, d);
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + m0 + (lane >> 2) + 8 * half;
    row_lse[half] = row < t_len ? lse[(long long)bh * t_len + row] : INFINITY;
    row_delta[half] = row < t_len ? delta[(long long)bh * t_len + row] : 0.f;
  }
  float acc_dq[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dq[j][e] = 0.f;

  for (int n0 = 0; n0 < t_len; n0 += kTile) {
    __syncthreads();  // the previous key tile is consumed (and Q, dO are loaded)
    load_tile_bf16<DP>(k_s, kt_s, kb, ks.t, n0, t_len, d);
    load_tile_bf16<DP>(v_s, nullptr, vb, vs.t, n0, t_len, d);
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
    // n0 + j * 8 + 2 (lane % 4) + e % 2. Keys >= T get P = 0.
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n0 + j * 8 + 2 * (lane & 3) + (e & 1);
        const float p = key < t_len ? expf(scale * s[j][e] - row_lse[e >> 1]) : 0.f;
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
  store_rows<DP>(dq, acc_dq, b, q0 + m0, h, t_len, n_heads, d, scale);
}

template <int DP>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, void* dk, void* dv,
                      long long B, long long t_len, long long n_heads, long long d,
                      const Strides& qs, const Strides& ks, const Strides& vs,
                      const Strides& gs, float scale, cudaStream_t stream) {
  constexpr size_t tile = (size_t)kTile * (DP + 8) * sizeof(bf16);
  constexpr size_t tile_t = (size_t)DP * kLdt * sizeof(bf16);
  constexpr size_t smem_dkv = 4 * tile + 2 * tile_t + 2 * kTile * sizeof(float);
  constexpr size_t smem_dq = 4 * tile + tile_t;
  const dim3 grid((unsigned)((t_len + kTile - 1) / kTile), (unsigned)(B * n_heads));
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* gp = static_cast<const bf16*>(dout);
  const float* lp = static_cast<const float*>(lse);
  const float* dp = static_cast<const float*>(delta);

  cudaError_t err = cudaFuncSetAttribute(
      dkv_tc_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkv);
  if (err != cudaSuccess) return err;
  dkv_tc_kernel<DP><<<grid, kThreads, smem_dkv, stream>>>(
      qp, kp, vp, gp, lp, dp, static_cast<bf16*>(dk), static_cast<bf16*>(dv), (int)t_len,
      (int)n_heads, (int)d, qs, ks, vs, gs, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_tc_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dq);
  if (err != cudaSuccess) return err;
  dq_tc_kernel<DP><<<grid, kThreads, smem_dq, stream>>>(
      qp, kp, vp, gp, lp, dp, static_cast<bf16*>(dq), (int)t_len, (int)n_heads, (int)d, qs, ks,
      vs, gs, scale);
  return cudaGetLastError();
}

// The head dim padded to the next of 16, 32, 48, 64, 128.
cudaError_t dispatch_tc(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dq, void* dk, void* dv,
                        long long B, long long t_len, long long n_heads, long long d,
                        const Strides& qs, const Strides& ks, const Strides& vs,
                        const Strides& gs, float scale, cudaStream_t s) {
#define HEADCT_TC(DP) \
  return launch_tc<DP>(q, k, v, dout, lse, delta, dq, dk, dv, B, t_len, n_heads, d, qs, ks, vs, \
                       gs, scale, s)
  if (d <= 16) HEADCT_TC(16);
  if (d <= 32) HEADCT_TC(32);
  if (d <= 48) HEADCT_TC(48);
  if (d <= 64) HEADCT_TC(64);
  HEADCT_TC(128);
#undef HEADCT_TC
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const void* lse, void* delta, void* dq, void* dk, void* dv, long long B,
                   long long t_len, long long n_heads, long long d, const Strides& qs,
                   const Strides& ks, const Strides& vs, const Strides& os, const Strides& gs,
                   float scale, cudaStream_t stream) {
  const long long rows = B * n_heads * t_len;  // one warp per (b, h, t) row
  const unsigned delta_blocks = (unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32));
  delta_kernel<T><<<delta_blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), static_cast<float*>(delta), rows,
      (int)t_len, (int)n_heads, (int)d, os.b, os.t, os.h, gs.b, gs.t, gs.h);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (std::is_same<T, bf16>::value)
    return dispatch_tc(q, k, v, dout, lse, delta, dq, dk, dv, B, t_len, n_heads, d, qs, ks, vs,
                       gs, scale, stream);

  const int ld = (int)d + 1;
  const size_t tiles = (size_t)kTile * ld * sizeof(float);
  const size_t pds = (size_t)2 * kTile * kLdp * sizeof(float) + 2 * kTile * sizeof(float);
  const size_t smem_dkv = 6 * tiles + pds;
  const size_t smem_dq = 5 * tiles + pds;
  const dim3 grid((unsigned)((t_len + kTile - 1) / kTile), (unsigned)(B * n_heads));

  err = cudaFuncSetAttribute(dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dkv);
  if (err != cudaSuccess) return err;
  dkv_kernel<T><<<grid, kThreads, smem_dkv, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), (int)t_len,
      (int)n_heads, (int)d, qs, ks, vs, gs, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dq);
  if (err != cudaSuccess) return err;
  dq_kernel<T><<<grid, kThreads, smem_dq, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), (int)t_len, (int)n_heads, (int)d,
      qs, ks, vs, gs, scale);
  return cudaGetLastError();
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
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh}, vs{v_sb, v_st, v_sh};
  const Strides os{o_sb, o_st, o_sh}, gs{g_sb, g_st, g_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, t_len, n_heads, d, qs,
                              ks, vs, os, gs, scale, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, t_len,
                                      n_heads, d, qs, ks, vs, os, gs, scale, s);
  return (int)cudaErrorInvalidValue;
}
