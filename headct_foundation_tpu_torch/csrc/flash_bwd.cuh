// The attention backward's dispatch and its float32 passes, shared by the
// whole-sequence backward B2 (flash_attention_bwd.cu), the token-major
// backward B8 (tm_attention.cu) and the blocked backward B4/B5
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
// Both dtypes take the FlashAttention-2 split (Dao, arXiv 2307.08691), which
// needs no float atomics and so gives bit-identical gradients from run to
// run: a dK/dV pass with one block per (64-key tile, batch*head), K and V
// fixed in the block, walking the query tiles; and a dQ pass with one block
// per (64-query tile, batch*head), Q and dO fixed, walking the key tiles up
// to kv_len. P and dS are recomputed in both (7 tile products where a
// kernel with atomics would do 5) and never touch device memory.
// - bfloat16 operands (every training path) take the Hopper kernels of
//   flash_bwd_sm90.cuh (bwd90::dkv_wgmma_kernel, dq_wgmma_kernel): wgmma
//   products, walked tiles staged by producer warps through a cp.async /
//   mbarrier ring. launch_dkv and launch_dq below send them there.
// - float32 operands run the same passes here on the float32 CUDA cores
//   through one shared-memory tile-product helper (4x4 register
//   micro-tiles; dkv_kernel, dq_kernel), which keeps full float32 products,
//   as the TPU kernels do for float32 inputs. Ragged tails: key columns >=
//   kv_len get P = 0; query rows >= Tq get LSE = +inf and so P = dS = 0.
//   Inputs are read through their (batch, token, head) strides with a unit
//   head-dim stride; every offset into them is 64-bit.
//
// B2 and B8 take delta from the stored O themselves: flash_bwd runs
// delta_kernel, then the two passes. B4/B5 get delta from the caller.
// Everything here lives in namespace `bwd`, so that one source can include
// this header and flash_fwd.cuh together (tm_attention.cu does).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "flash_bwd_sm90.cuh"

namespace {
namespace bwd {

constexpr int kTile = 64;      // query rows or keys per tile
constexpr int kThreads = 128;
constexpr int kLdp = kTile + 1;  // row stride of the [64, 64] P and dS tiles

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

template <typename T, typename Kernel>
cudaError_t launch_dkv_kernel(Kernel kernel, size_t smem, const BwdArgs& a, cudaStream_t s) {
  const cudaError_t err = allow_smem(kernel, smem);
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
  const cudaError_t err = allow_smem(kernel, smem);
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

// Launch the dK/dV pass on `s`. dtype: 0 = float32 (CUDA cores), 1 =
// bfloat16 (bwd90::dkv_wgmma_kernel).
template <typename Tag>
cudaError_t launch_dkv(const BwdArgs& a, int dtype, cudaStream_t s) {
  if (dtype == 0) return launch_dkv_kernel<float>(dkv_kernel<Tag>, f32_bwd_smem(a.d, 6), a, s);
  if (dtype == 1) return bwd90::launch_dkv<Tag>(a, s);
  return cudaErrorInvalidValue;
}

// Launch the dQ pass on `s`; dtype as for launch_dkv (bfloat16:
// bwd90::dq_wgmma_kernel).
template <typename Tag>
cudaError_t launch_dq(const BwdArgs& a, int dtype, cudaStream_t s) {
  if (dtype == 0) return launch_dq_kernel<float>(dq_kernel<Tag>, f32_bwd_smem(a.d, 5), a, s);
  if (dtype == 1) return bwd90::launch_dq<Tag>(a, s);
  return cudaErrorInvalidValue;
}

// delta[bh][t] = sum_c dO[b, t, h, c] * O[b, t, h, c] in float32; one warp per row.
template <typename Tag, typename T>
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

// The whole backward on `stream` (B2, B8): delta = rowsum(dO * O) of the
// stored O (strides `os`) into the caller's float32 [B*H, Tq] scratch
// `delta` (also a.delta), then the dK/dV and dQ passes; dtype as for
// launch_dkv. Square: a.tq = a.tk = a.kv_len.
template <typename Tag>
cudaError_t flash_bwd(const BwdArgs& a, const void* o, const Strides& os, void* delta, int dtype,
                      cudaStream_t stream) {
  const long long rows = a.B * a.n_heads * a.tq;  // one warp per (b, h, t) row
  const unsigned blocks = (unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32));
  if (dtype == 0) {
    delta_kernel<Tag, float><<<blocks, kThreads, 0, stream>>>(
        static_cast<const float*>(o), static_cast<const float*>(a.dout),
        static_cast<float*>(delta), rows, (int)a.tq, (int)a.n_heads, (int)a.d, os, a.gs);
  } else if (dtype == 1) {
    delta_kernel<Tag, __nv_bfloat16><<<blocks, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(o),
        static_cast<const __nv_bfloat16*>(a.dout),
        static_cast<float*>(delta), rows, (int)a.tq, (int)a.n_heads, (int)a.d, os, a.gs);
  } else {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_dkv<Tag>(a, dtype, stream);
  if (err != cudaSuccess) return err;
  return launch_dq<Tag>(a, dtype, stream);
}

}  // namespace bwd
}  // namespace
