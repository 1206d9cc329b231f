// Whole-sequence forward attention for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel headct_foundation_tpu/ops/flash_attention.py:60
// `_vmem_fwd_kernel` (launched by `pl.pallas_call` in `_fused_fwd_impl`,
// :195). Same function: for every (batch, head) and query row t,
//   S = scale * q_t K^T            (float32 accumulation of operand-dtype products)
//   m = max S,  P = exp(S - m),  l = sum P
//   O_t = (P rounded to the operand dtype) V / max(l, 1e-30)   (stored in q's dtype)
//   LSE_t = m + log max(l, 1e-30)                               (float32, [B*H, 1, T])
// for square T <= 1024, no mask, float32 or bfloat16 operands, head size D a
// multiple of 4 up to 128.
//
// Design. The Pallas kernel holds the whole [T, T] float32 score slab in VMEM
// (1 MB at T = 513); a Hopper block has 227 KB of shared memory, so this kernel
// streams instead: one block of 128 threads per (64 query rows, batch*head);
// the query tile stays in shared memory, key/value tiles of 64 rows are staged
// through shared memory one after another, and each warp keeps, for its 16
// query rows, a running max m, sum l and float32 accumulator in registers
// (online softmax, Dao et al. arXiv 2205.14135). Scores and probabilities never
// touch device memory. The ragged tail is masked: 513 = 8 * 64 + 1, so the last
// key tile has one real column (score -inf elsewhere) and the last query tile
// one real row (the others are computed on zeros and not stored). Inputs are
// read through their (batch, token, head) strides with a unit head-dim stride,
// so the q/k/v views sliced from the fused qkv projection need no copy.
// float32 operands run every product on the float32 CUDA cores; bfloat16
// operands (MAE training) run them on the tensor cores with mma.sync
// (flash_fwd_tc_kernel, bf16_mma.cuh): each warp keeps its 16 query rows' Q
// fragments, running max and sum and output accumulator in registers, and P
// (rounded to bf16) feeds the P.V product straight from the S accumulator
// fragments. No wgmma, no TMA yet.
//
// Bound at the serving shape [8, 513, 12, 64] float32: 4*B*H*T^2*D = 6.47e9
// operations, 0.097 ms at the H100 SXM's 67 TFLOP/s of float32 outside the
// tensor cores; q, k, v read once and o written once are 50.5 MB, 0.015 ms at
// 3.35 TB/s. So it is bound by operations. At the MAE decoder shape
// [32, 513, 16, 48] bfloat16: 2.59e10 operations, 0.026 ms at 989 TFLOP/s,
// against 102 MB, 0.030 ms: bound by bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "bf16_mma.cuh"

namespace {

constexpr int kBlockM = 64;                    // query rows per block
constexpr int kBlockN = 64;                    // keys per staged tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBlockM / kWarps;  // 16
constexpr int kLdp = kBlockN + 4;              // row stride of the P tile
static_assert(kBlockM == kBlockN, "load_tile stages kBlockN rows for Q as well");
static_assert(kBlockM == headct_mma::kMmaRows && kThreads == headct_mma::kMmaThreads,
              "tiles shared with bf16_mma.cuh");

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// P rounded to the operand dtype before the P.V product, as the TPU kernel
// casts p to v.dtype (flash_attention.py:78-81); the bfloat16 rounding is in
// flash_fwd_tc_kernel.
template <typename T> __device__ __forceinline__ float to_operand(float x);
template <> __device__ __forceinline__ float to_operand<float>(float x) { return x; }

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

// Rows [row0, row0 + 64) of a [T, D] slab with row stride `st` (elements) into
// shared memory as float with leading dimension `ld`; rows >= T are zeros.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src, long long st,
                                          int row0, int t_len, int d) {
  const int quads = d >> 2;
  for (int idx = threadIdx.x; idx < kBlockN * quads; idx += kThreads) {
    const int r = idx / quads;
    const int c = (idx - r * quads) << 2;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < t_len) x = load4(src + (long long)(row0 + r) * st + c);
    *reinterpret_cast<float4*>(dst + r * ld + c) = x;
  }
}

// NC = head-dim columns per lane in the P.V product (D <= 32 * NC).
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int t_len, int n_heads, int d,
                 long long q_sb, long long q_st, long long q_sh,
                 long long k_sb, long long k_st, long long k_sh,
                 long long v_sb, long long v_st, long long v_sh, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldk = d + 4;  // conflict-free float4 reads of K rows by 8 lanes
  float* qs = smem;                    // [kBlockM][ldk]
  float* ks = qs + kBlockM * ldk;      // [kBlockN][ldk]
  float* vs = ks + kBlockN * ldk;      // [kBlockN][d]
  float* ps = vs + kBlockN * d;        // [kBlockM][kLdp]

  const int bh = blockIdx.y;
  const int b = bh / n_heads;
  const int h = bh - b * n_heads;
  const int m0 = blockIdx.x * kBlockM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = warp * kRowsPerWarp;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;

  load_tile(qs, ldk, qb, q_st, m0, t_len, d);

  float m_run[kRowsPerWarp], l_run[kRowsPerWarp], acc[kRowsPerWarp][NC];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  for (int n0 = 0; n0 < t_len; n0 += kBlockN) {
    __syncthreads();  // the previous K/V/P tiles are consumed (and Q is loaded)
    load_tile(ks, ldk, kb, k_st, n0, t_len, d);
    load_tile(vs, d, vb, v_st, n0, t_len, d);
    __syncthreads();
    const int n_valid = min(kBlockN, t_len - n0);

    // S for this warp's 16 rows; lane owns key columns lane and lane + 32.
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r][0] = s[r][1] = 0.f;
    for (int c = 0; c < d; c += 4) {
      const float4 k0 = *reinterpret_cast<const float4*>(ks + lane * ldk + c);
      const float4 k1 = *reinterpret_cast<const float4*>(ks + (lane + 32) * ldk + c);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + (r0 + r) * ldk + c);
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
      ps[(r0 + r) * kLdp + lane] = to_operand<T>(p0);
      ps[(r0 + r) * kLdp + lane + 32] = to_operand<T>(p1);
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
          vv[jj][c] = col < d ? vs[(j + jj) * d + col] : 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 p = *reinterpret_cast<const float4*>(ps + (r0 + r) * kLdp + j);
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

  // O is written contiguous [B, T, H, D]; LSE as [B*H, 1, T].
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int t = m0 + r0 + r;
    if (t < t_len) {
      const float l_safe = fmaxf(l_run[r], 1e-30f);
      T* orow = o + (((long long)b * t_len + t) * n_heads + h) * d;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = c * 32 + lane;
        if (col < d) store(orow + col, acc[r][c] / l_safe);
      }
      if (lane == 0) lse[(long long)bh * t_len + t] = m_run[r] + logf(l_safe);
    }
  }
}

template <typename T, int NC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse,
                   long long B, long long t_len, long long n_heads, long long d,
                   const long long* qs, const long long* ks, const long long* vs,
                   float scale, cudaStream_t stream) {
  const size_t smem =
      ((size_t)(kBlockM + kBlockN) * (d + 4) + (size_t)kBlockN * d + (size_t)kBlockM * kLdp) *
      sizeof(float);
  auto kernel = flash_fwd_kernel<T, NC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((t_len + kBlockM - 1) / kBlockM), (unsigned)(B * n_heads));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), (int)t_len, (int)n_heads, (int)d,
      qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, void* lse,
                       long long B, long long t_len, long long n_heads, long long d,
                       const long long* qs, const long long* ks, const long long* vs,
                       float scale, cudaStream_t stream) {
  if (d <= 32) return launch<T, 1>(q, k, v, o, lse, B, t_len, n_heads, d, qs, ks, vs, scale, stream);
  if (d <= 64) return launch<T, 2>(q, k, v, o, lse, B, t_len, n_heads, d, qs, ks, vs, scale, stream);
  return launch<T, 4>(q, k, v, o, lse, B, t_len, n_heads, d, qs, ks, vs, scale, stream);
}

// bfloat16 on the tensor cores: one block per (64 query rows, batch*head),
// each warp 16 rows; K tiles row-major and V tiles transposed in shared
// memory as the two B operands.
template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                    float* __restrict__ lse, int t_len, int n_heads, int d,
                    long long q_sb, long long q_st, long long q_sh,
                    long long k_sb, long long k_st, long long k_sh,
                    long long v_sb, long long v_st, long long v_sh, float scale) {
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
  const bf16* kb = k + b * k_sb + h * k_sh;
  const bf16* vb = v + b * v_sb + h * v_sh;

  load_tile_bf16<DP>(q_s, nullptr, q + b * q_sb + h * q_sh, q_st, q0, t_len, d);
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

  for (int n0 = 0; n0 < t_len; n0 += kBlockN) {
    __syncthreads();  // the previous K/V tiles are consumed
    load_tile_bf16<DP>(k_s, nullptr, kb, k_st, n0, t_len, d);
    load_tile_bf16<DP>(nullptr, vt_s, vb, v_st, n0, t_len, d);
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
        s[j][e] = key < t_len ? s[j][e] * scale : -INFINITY;
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

    // acc += P V, P rounded to bf16 (flash_attention.py:78-81).
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

  // O is written contiguous [B, T, H, D]; LSE as [B*H, 1, T].
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = q0 + m0 + (lane >> 2) + 8 * half;
    if (t >= t_len) continue;
    const float l_safe = fmaxf(l_run[half], 1e-30f);
    bf16* orow = o + (((long long)b * t_len + t) * n_heads + h) * d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = j * 8 + 2 * (lane & 3);
      if (c < d)
        *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(
            acc[j][2 * half] / l_safe, acc[j][2 * half + 1] / l_safe);
    }
    if ((lane & 3) == 0) lse[(long long)bh * t_len + t] = m_run[half] + logf(l_safe);
  }
}

template <int DP>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, void* lse,
                      long long B, long long t_len, long long n_heads, long long d,
                      const long long* qs, const long long* ks, const long long* vs,
                      float scale, cudaStream_t stream) {
  constexpr size_t smem = (size_t)(kBlockM + kBlockN) * (DP + 8) * sizeof(__nv_bfloat16) +
                          (size_t)DP * headct_mma::kLdt * sizeof(__nv_bfloat16);
  auto kernel = flash_fwd_tc_kernel<DP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((t_len + kBlockM - 1) / kBlockM), (unsigned)(B * n_heads));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), (int)t_len, (int)n_heads, (int)d, qs[0], qs[1], qs[2], ks[0],
      ks[1], ks[2], vs[0], vs[1], vs[2], scale);
  return cudaGetLastError();
}

// The head dim padded to the next of 16, 32, 48, 64, 128.
cudaError_t dispatch_tc(const void* q, const void* k, const void* v, void* o, void* lse,
                        long long B, long long t_len, long long n_heads, long long d,
                        const long long* qs, const long long* ks, const long long* vs,
                        float scale, cudaStream_t s) {
  if (d <= 16) return launch_tc<16>(q, k, v, o, lse, B, t_len, n_heads, d, qs, ks, vs, scale, s);
  if (d <= 32) return launch_tc<32>(q, k, v, o, lse, B, t_len, n_heads, d, qs, ks, vs, scale, s);
  if (d <= 48) return launch_tc<48>(q, k, v, o, lse, B, t_len, n_heads, d, qs, ks, vs, scale, s);
  if (d <= 64) return launch_tc<64>(q, k, v, o, lse, B, t_len, n_heads, d, qs, ks, vs, scale, s);
  return launch_tc<128>(q, k, v, o, lse, B, t_len, n_heads, d, qs, ks, vs, scale, s);
}

}  // namespace

// C entry point, bound with ctypes. Strides are in elements, in (batch, token,
// head) order; the head-dim stride must be 1. dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int headct_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    long long B, long long t_len, long long n_heads, long long d,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    float scale, int dtype, void* stream) {
  if (d < 4 || d > 128 || d % 4 != 0 || t_len < 1 || t_len > 1024 || B < 1 || n_heads < 1 ||
      B * n_heads > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const long long qs[3] = {q_sb, q_st, q_sh};
  const long long ks[3] = {k_sb, k_st, k_sh};
  const long long vs[3] = {v_sb, v_st, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<float>(q, k, v, o, lse, B, t_len, n_heads, d, qs, ks, vs, scale, s);
  if (dtype == 1) return (int)dispatch_tc(q, k, v, o, lse, B, t_len, n_heads, d, qs, ks, vs, scale, s);
  return (int)cudaErrorInvalidValue;
}
