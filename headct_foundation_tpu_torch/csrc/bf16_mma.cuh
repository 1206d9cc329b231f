// bfloat16 tensor-core building blocks of the whole-sequence backward
// (flash_bwd.cuh: B2, B8; pack_bf16 also serves sm90_common.cuh):
// mma.sync.m16n8k16 with
// bf16 operands and float32 accumulation, its fragment loads from padded
// shared-memory tiles, and the conversion of an accumulator block into an
// A operand (the m16n8 accumulator layout is the m16n8k16 A-operand layout,
// so P or dS computed in registers feed the next product directly, as in
// FlashAttention-2, Dao arXiv 2307.08691).
//
// Layout: a tile of 64 rows sits in shared memory as bf16 [64][DP + 8], the
// head dim padded with zeros to DP (a multiple of 16) and each row by 8
// elements more, which makes every fragment load conflict-free; B operands
// that run along the 64 rows are stored transposed, [DP][kLdt].

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

namespace headct_mma {

using bf16 = __nv_bfloat16;
constexpr int kMmaRows = 64;       // rows of a tile (query rows or keys)
constexpr int kMmaThreads = 128;   // 4 warps, 16 rows each
constexpr int kLdt = kMmaRows + 8;  // row stride of a transposed [DP][64] tile

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two floats rounded to bf16 and packed, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t r;
  memcpy(&r, &v, sizeof(r));
  return r;
}

// c[0..3] += A (16x16, 4 registers) * B (16x8, 2 registers).
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of rows [m0, m0 + 16), columns [k0, k0 + 16) of a row-major tile.
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* x, int ld, int m0, int k0) {
  const int lane = threadIdx.x & 31;
  const bf16* p = x + (m0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  a[0] = ld_pair(p);
  a[1] = ld_pair(p + 8 * ld);
  a[2] = ld_pair(p + 8);
  a[3] = ld_pair(p + 8 * ld + 8);
}

// B fragment (k in [k0, k0 + 16), n in [n0, n0 + 8)) of a tile stored [n][k].
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1, const bf16* y, int ld, int n0,
                                       int k0) {
  const int lane = threadIdx.x & 31;
  const bf16* p = y + (n0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  b0 = ld_pair(p);
  b1 = ld_pair(p + 8);
}

// Rows [row0, row0 + 64) of a bf16 [T, D] slab into dst [64][DP + 8] (head
// dim padded with zeros to DP, rows >= T zero), if dst is given, and into its
// transpose dst_t [DP][kLdt], if dst_t is given.
template <int DP>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, bf16* dst_t, const bf16* src,
                                               long long st, int row0, int t_len, int d) {
  constexpr int quads = DP / 4;
  for (int idx = threadIdx.x; idx < kMmaRows * quads; idx += kMmaThreads) {
    const int r = idx / quads;
    const int c = (idx - r * quads) * 4;
    uint2 raw = make_uint2(0u, 0u);
    if (row0 + r < t_len && c < d)
      raw = *reinterpret_cast<const uint2*>(src + (long long)(row0 + r) * st + c);
    if (dst != nullptr) *reinterpret_cast<uint2*>(dst + r * (DP + 8) + c) = raw;
    if (dst_t != nullptr) {
      bf16 e[4];
      memcpy(e, &raw, sizeof(e));
#pragma unroll
      for (int i = 0; i < 4; ++i) dst_t[(c + i) * kLdt + r] = e[i];
    }
  }
}

// A fragments of a 16x64 block of P or dS held as 8 accumulator tiles, for
// k-step kq (columns [16 kq, 16 kq + 16)), rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float (*x)[4], int kq) {
  a[0] = pack_bf16(x[2 * kq][0], x[2 * kq][1]);
  a[1] = pack_bf16(x[2 * kq][2], x[2 * kq][3]);
  a[2] = pack_bf16(x[2 * kq + 1][0], x[2 * kq + 1][1]);
  a[3] = pack_bf16(x[2 * kq + 1][2], x[2 * kq + 1][3]);
}

}  // namespace headct_mma
