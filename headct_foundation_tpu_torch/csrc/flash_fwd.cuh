// Forward attention shared by the whole-sequence kernel B1
// (flash_attention_fwd.cu), the blocked kernel B3
// (flash_attention_blocked_fwd.cu) and the token-major kernel B7
// (tm_attention.cu). For every (batch, head) and query row t
// of q [B, Tq, H, D], against the first kv_len keys of k, v [B, Tk, H, D]:
//   S = scale * q_t K^T            (float32 accumulation of operand-dtype products)
//   P = exp(S - m) with m the running row max, l = sum P
//   O_t = (P rounded to the operand dtype) V / max(l, 1e-30)   (stored in q's dtype)
//   LSE_t = m + log max(l, 1e-30)                               (float32, [B*H, 1, Tq])
// Keys at positions >= kv_len carry no weight. B1 calls it with
// Tq = Tk = kv_len = T.
//
// `flash_fwd` routes bfloat16 operands to the Hopper kernel of
// flash_fwd_sm90.cuh (wgmma, producer warps feeding a cp.async/mbarrier
// ring) and float32 operands to flash_fwd_kernel
// here, which runs every product on the float32 CUDA cores, as the TPU
// kernels keep full float32 products for float32 inputs.
//
// flash_fwd_kernel: one block of 128 threads per (64 query rows,
// batch*head). The query tile stays in shared memory; key/value tiles of 64
// rows are staged through shared memory one after another up to kv_len, and
// each warp keeps, for its 16 query rows, a running max m, sum l and float32
// accumulator (online softmax, Dao et al. arXiv 2205.14135). The loop ends at
// the last tile holding a real key, so no tile is wholly masked and the
// running max is finite after the first one (no -inf - -inf). Scores never
// touch device memory. Ragged tails are masked: key columns >= kv_len score
// -inf, query rows >= Tq are computed on zeros and not stored. Inputs are
// read through their (batch, token, head) strides with a unit head-dim
// stride; every offset into them is 64-bit.
// Everything here lives in namespace `fwd`, so that one source can include
// this header and flash_bwd.cuh together (tm_attention.cu does).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "flash_fwd_sm90.cuh"

namespace {
namespace fwd {

constexpr int kBlockM = 64;                    // query rows per block
constexpr int kBlockN = 64;                    // keys per staged tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBlockM / kWarps;  // 16
constexpr int kLdp = kBlockN + 4;              // row stride of the P tile
static_assert(kBlockM == kBlockN, "load_tile_f32 stages kBlockN rows for Q as well");

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Rows [row0, row0 + 64) of a float32 [T, D] slab with row stride `st`
// (elements) into shared memory with leading dimension `ld`; rows >= n_rows
// are zeros.
__device__ __forceinline__ void load_tile_f32(float* dst, int ld, const float* src, long long st,
                                              int row0, int n_rows, int d) {
  const int quads = d >> 2;
  for (int idx = threadIdx.x; idx < kBlockN * quads; idx += kThreads) {
    const int r = idx / quads;
    const int c = (idx - r * quads) << 2;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows) x = load4(src + (long long)(row0 + r) * st + c);
    *reinterpret_cast<float4*>(dst + r * ld + c) = x;
  }
}

// float32 on the CUDA cores. NC = head-dim columns per lane in the P.V
// product (D <= 32 * NC).
template <typename Tag, int NC>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                 int tq, int kv_len, int n_heads, int d, Strides qs, Strides ks, Strides vs,
                 float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldk = d + 4;  // conflict-free float4 reads of K rows by 8 lanes
  float* q_s = smem;                   // [kBlockM][ldk]
  float* k_s = q_s + kBlockM * ldk;    // [kBlockN][ldk]
  float* v_s = k_s + kBlockN * ldk;    // [kBlockN][d]
  float* p_s = v_s + kBlockN * d;      // [kBlockM][kLdp]

  const int bh = blockIdx.y;
  const int b = bh / n_heads;
  const int h = bh - b * n_heads;
  const int m0 = blockIdx.x * kBlockM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = warp * kRowsPerWarp;

  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;

  load_tile_f32(q_s, ldk, q + b * qs.b + h * qs.h, qs.t, m0, tq, d);

  float m_run[kRowsPerWarp], l_run[kRowsPerWarp], acc[kRowsPerWarp][NC];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  for (int n0 = 0; n0 < kv_len; n0 += kBlockN) {
    __syncthreads();  // the previous K/V/P tiles are consumed (and Q is loaded)
    load_tile_f32(k_s, ldk, kb, ks.t, n0, kv_len, d);
    load_tile_f32(v_s, d, vb, vs.t, n0, kv_len, d);
    __syncthreads();
    const int n_valid = min(kBlockN, kv_len - n0);

    // S for this warp's 16 rows; lane owns key columns lane and lane + 32.
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r][0] = s[r][1] = 0.f;
    for (int c = 0; c < d; c += 4) {
      const float4 k0 = *reinterpret_cast<const float4*>(k_s + lane * ldk + c);
      const float4 k1 = *reinterpret_cast<const float4*>(k_s + (lane + 32) * ldk + c);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(q_s + (r0 + r) * ldk + c);
        s[r][0] = fmaf(qv.x, k0.x, s[r][0]);
        s[r][0] = fmaf(qv.y, k0.y, s[r][0]);
        s[r][0] = fmaf(qv.z, k0.z, s[r][0]);
        s[r][0] = fmaf(qv.w, k0.w, s[r][0]);
        s[r][1] = fmaf(qv.x, k1.x, s[r][1]);
        s[r][1] = fmaf(qv.y, k1.y, s[r][1]);
        s[r][1] = fmaf(qv.z, k1.z, s[r][1]);
        s[r][1] = fmaf(qv.w, k1.w, s[r][1]);
      }
    }

    // Online softmax: rescale the running state to the new row max.
    const bool valid0 = lane < n_valid;
    const bool valid1 = lane + 32 < n_valid;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float s0 = valid0 ? s[r][0] * scale : -INFINITY;
      const float s1 = valid1 ? s[r][1] * scale : -INFINITY;
      const float m_new = fmaxf(m_run[r], warp_max(fmaxf(s0, s1)));
      const float alpha = expf(m_run[r] - m_new);  // 0 on the first tile
      const float p0 = expf(s0 - m_new);
      const float p1 = expf(s1 - m_new);
      l_run[r] = l_run[r] * alpha + warp_sum(p0 + p1);
      m_run[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
      p_s[(r0 + r) * kLdp + lane] = p0;
      p_s[(r0 + r) * kLdp + lane + 32] = p1;
    }
    __syncwarp();

    // acc += P V over the real keys of the tile; lane owns head-dim columns
    // lane + 32 * c.
    const int n_pv = (n_valid + 3) & ~3;
    for (int j = 0; j < n_pv; j += 4) {
      float vv[4][NC];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int col = c * 32 + lane;
          vv[jj][c] = col < d ? v_s[(j + jj) * d + col] : 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 p = *reinterpret_cast<const float4*>(p_s + (r0 + r) * kLdp + j);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          acc[r][c] = fmaf(p.x, vv[0][c], acc[r][c]);
          acc[r][c] = fmaf(p.y, vv[1][c], acc[r][c]);
          acc[r][c] = fmaf(p.z, vv[2][c], acc[r][c]);
          acc[r][c] = fmaf(p.w, vv[3][c], acc[r][c]);
        }
      }
    }
  }

  // O is written contiguous [B, Tq, H, D]; LSE as [B*H, 1, Tq].
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int t = m0 + r0 + r;
    if (t < tq) {
      const float l_safe = fmaxf(l_run[r], 1e-30f);
      float* orow = o + (((long long)b * tq + t) * n_heads + h) * d;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = c * 32 + lane;
        if (col < d) orow[col] = acc[r][c] / l_safe;
      }
      if (lane == 0) lse[(long long)bh * tq + t] = m_run[r] + logf(l_safe);
    }
  }
}

template <typename Kernel>
cudaError_t launch_fwd(Kernel kernel, size_t smem, const FwdArgs& a, cudaStream_t stream) {
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((a.tq + kBlockM - 1) / kBlockM), (unsigned)(a.B * a.n_heads));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), static_cast<float*>(a.lse),
      (int)a.tq, (int)a.kv_len, (int)a.n_heads, (int)a.d, a.qs, a.ks, a.vs, a.scale);
  return cudaGetLastError();
}

// Launch the forward on `stream`. dtype: 0 = float32 (CUDA cores), 1 =
// bfloat16 (flash_fwd_sm90.cuh, head dim padded to the next of 16, 32, 48,
// 64, 128).
template <typename Tag>
cudaError_t flash_fwd(const FwdArgs& a, int dtype, cudaStream_t s) {
  if (dtype == 1) return fwd90::flash_fwd_bf16<Tag>(a, s);
  if (dtype != 0) return cudaErrorInvalidValue;
  const size_t smem = ((size_t)(kBlockM + kBlockN) * (a.d + 4) + (size_t)kBlockN * a.d +
                       (size_t)kBlockM * kLdp) * sizeof(float);
  if (a.d <= 32) return launch_fwd(flash_fwd_kernel<Tag, 1>, smem, a, s);
  if (a.d <= 64) return launch_fwd(flash_fwd_kernel<Tag, 2>, smem, a, s);
  return launch_fwd(flash_fwd_kernel<Tag, 4>, smem, a, s);
}

}  // namespace fwd
}  // namespace
