// Forward attention kernels shared by the whole-sequence kernel B1
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
// Design: one block of 128 threads per (64 query rows, batch*head). The query
// tile stays in shared memory (float32 operands) or in registers (bfloat16);
// key/value tiles of 64 rows are staged through shared memory one after
// another up to kv_len, and each warp keeps, for its 16 query rows, a running
// max m, sum l and float32 accumulator (online softmax, Dao et al. arXiv
// 2205.14135). The loop ends at the last tile holding a real key, so no tile
// is wholly masked and the running max is finite after the first one (no
// -inf - -inf). Scores never touch device memory. Ragged tails are masked:
// key columns >= kv_len score -inf, query rows >= Tq are computed on zeros and
// not stored. Inputs are read through their (batch, token, head) strides with
// a unit head-dim stride; every offset into them is 64-bit.
// float32 operands run every product on the float32 CUDA cores
// (flash_fwd_kernel); bfloat16 operands run them on the tensor cores with
// mma.sync (flash_fwd_tc_kernel, bf16_mma.cuh), P (rounded to bf16) feeding
// the P.V product straight from the S accumulator fragments. No wgmma, no TMA.
// Everything here lives in namespace `fwd`, so that one source can include
// this header and flash_bwd.cuh together (tm_attention.cu does).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "bf16_mma.cuh"

namespace {
namespace fwd {

constexpr int kBlockM = 64;                    // query rows per block
constexpr int kBlockN = 64;                    // keys per staged tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBlockM / kWarps;  // 16
constexpr int kLdp = kBlockN + 4;              // row stride of the P tile
static_assert(kBlockM == kBlockN, "load_tile stages kBlockN rows for Q as well");
static_assert(kBlockM == headct_mma::kMmaRows && kThreads == headct_mma::kMmaThreads,
              "tiles shared with bf16_mma.cuh");

// Arguments of one forward call; pointers are device pointers.
struct FwdArgs {
  const void *q, *k, *v;
  void *o, *lse;
  long long B, tq, kv_len, n_heads, d;
  Strides qs, ks, vs;
  float scale;
};

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

// bfloat16 on the tensor cores: one block per (64 query rows, batch*head),
// each warp 16 rows; K tiles row-major and V tiles transposed in shared
// memory as the two B operands.
template <typename Tag, int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                    float* __restrict__ lse, int tq, int kv_len, int n_heads, int d, Strides qs,
                    Strides ks, Strides vs, float scale) {
  using namespace headct_mma;
  constexpr int LD = DP + 8;
  extern __shared__ float4 smem4[];
  bf16* q_s = reinterpret_cast<bf16*>(smem4);  // [64][LD]
  bf16* k_s = q_s + kBlockM * LD;               // [64][LD]
  bf16* vt_s = k_s + kBlockN * LD;              // [DP][kLdt] V^T

  const int bh = blockIdx.y;
  const int b = bh / n_heads;
  const int h = bh - b * n_heads;
  const int q0 = blockIdx.x * kBlockM;
  const int lane = threadIdx.x & 31;
  const int m0 = (threadIdx.x >> 5) * 16;  // this warp's 16 query rows
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;

  load_tile_bf16<DP>(q_s, nullptr, q + b * qs.b + h * qs.h, qs.t, q0, tq, d);
  __syncthreads();
  uint32_t qf[DP / 16][4];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) load_a(qf[kk], q_s, LD, m0, kk * 16);

  // rows lane / 4 and lane / 4 + 8 of the warp's 16
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int n0 = 0; n0 < kv_len; n0 += kBlockN) {
    __syncthreads();  // the previous K/V tiles are consumed
    load_tile_bf16<DP>(k_s, nullptr, kb, ks.t, n0, kv_len, d);
    load_tile_bf16<DP>(nullptr, vt_s, vb, vs.t, n0, kv_len, d);
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys; element e of tile j is row + 8 (e / 2),
    // key n0 + j * 8 + 2 (lane % 4) + e % 2.
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t b0, b1;
        load_b(b0, b1, k_s, LD, j * 8, kk * 16);
        mma_bf16(s[j], qf[kk], b0, b1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n0 + j * 8 + 2 * (lane & 3) + (e & 1);
        s[j][e] = key < kv_len ? s[j][e] * scale : -INFINITY;
      }
    }

    // Online softmax; the 4 lanes of a quad share a row.
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * half], s[j][2 * half + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[half], mx);
      const float alpha = expf(m_run[half] - m_new);  // 0 on the first tile
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][2 * half] = expf(s[j][2 * half] - m_new);
        s[j][2 * half + 1] = expf(s[j][2 * half + 1] - m_new);
        sum += s[j][2 * half] + s[j][2 * half + 1];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run[half] = l_run[half] * alpha + sum;
      m_run[half] = m_new;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        acc[j][2 * half] *= alpha;
        acc[j][2 * half + 1] *= alpha;
      }
    }

    // acc += P V, P rounded to bf16.
#pragma unroll
    for (int kq = 0; kq < 4; ++kq) {
      uint32_t ap[4];
      acc_to_a(ap, s, kq);
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        uint32_t b0, b1;
        load_b(b0, b1, vt_s, kLdt, j * 8, kq * 16);
        mma_bf16(acc[j], ap, b0, b1);
      }
    }
  }

  // O is written contiguous [B, Tq, H, D]; LSE as [B*H, 1, Tq].
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = q0 + m0 + (lane >> 2) + 8 * half;
    if (t >= tq) continue;
    const float l_safe = fmaxf(l_run[half], 1e-30f);
    bf16* orow = o + (((long long)b * tq + t) * n_heads + h) * d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = j * 8 + 2 * (lane & 3);
      if (c < d)
        *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(
            acc[j][2 * half] / l_safe, acc[j][2 * half + 1] / l_safe);
    }
    if ((lane & 3) == 0) lse[(long long)bh * tq + t] = m_run[half] + logf(l_safe);
  }
}

template <typename T, typename Kernel>
cudaError_t launch_fwd(Kernel kernel, size_t smem, const FwdArgs& a, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((a.tq + kBlockM - 1) / kBlockM), (unsigned)(a.B * a.n_heads));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.o), static_cast<float*>(a.lse), (int)a.tq, (int)a.kv_len,
      (int)a.n_heads, (int)a.d, a.qs, a.ks, a.vs, a.scale);
  return cudaGetLastError();
}

template <int DP>
constexpr size_t tc_fwd_smem() {
  return (size_t)(kBlockM + kBlockN) * (DP + 8) * sizeof(__nv_bfloat16) +
         (size_t)DP * headct_mma::kLdt * sizeof(__nv_bfloat16);
}

// Launch the forward on `stream`. dtype: 0 = float32 (CUDA cores), 1 =
// bfloat16 (tensor cores, head dim padded to the next of 16, 32, 48, 64, 128).
template <typename Tag>
cudaError_t flash_fwd(const FwdArgs& a, int dtype, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  if (dtype == 0) {
    const size_t smem = ((size_t)(kBlockM + kBlockN) * (a.d + 4) + (size_t)kBlockN * a.d +
                         (size_t)kBlockM * kLdp) * sizeof(float);
    if (a.d <= 32) return launch_fwd<float>(flash_fwd_kernel<Tag, 1>, smem, a, s);
    if (a.d <= 64) return launch_fwd<float>(flash_fwd_kernel<Tag, 2>, smem, a, s);
    return launch_fwd<float>(flash_fwd_kernel<Tag, 4>, smem, a, s);
  }
  if (dtype == 1) {
    if (a.d <= 16) return launch_fwd<bf16>(flash_fwd_tc_kernel<Tag, 16>, tc_fwd_smem<16>(), a, s);
    if (a.d <= 32) return launch_fwd<bf16>(flash_fwd_tc_kernel<Tag, 32>, tc_fwd_smem<32>(), a, s);
    if (a.d <= 48) return launch_fwd<bf16>(flash_fwd_tc_kernel<Tag, 48>, tc_fwd_smem<48>(), a, s);
    if (a.d <= 64) return launch_fwd<bf16>(flash_fwd_tc_kernel<Tag, 64>, tc_fwd_smem<64>(), a, s);
    return launch_fwd<bf16>(flash_fwd_tc_kernel<Tag, 128>, tc_fwd_smem<128>(), a, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace fwd
}  // namespace
