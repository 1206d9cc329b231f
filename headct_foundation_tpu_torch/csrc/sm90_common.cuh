// Hopper (sm_90a) pieces shared by the bfloat16 wgmma attention kernels: the
// forward (flash_fwd_sm90.cuh: B1, B3, B7) and the blocked backward
// (flash_bwd_sm90.cuh: B4, B5).
//
// - Tiles sit in shared memory as rows of 64 bf16 (128 bytes) in the 128-byte
//   swizzle, the head dim zero-padded to DP; a row of DP = 128 spans two
//   64-column blocks, `rows * 128` bytes apart (`swz`). `kmajor` and
//   `mnmajor` are wgmma's shared-memory descriptors of such a tile read with
//   the head dim as the product's sum (K-major) or as its N (MN-major, through
//   the transpose bit: no transposed copy is built).
// - `wgmma_ss` / `wgmma_rs`: `wgmma.mma_async` m64nNk16 with float32
//   accumulators, A from shared memory or from registers (`to_a` rounds an
//   accumulator to the register A operand of the next product).
// - The ring: producer warps fill a buffer with cp.async (`load_tile`, or
//   `warp_load_tile` with fewer instructions a copy; 16 or 8 bytes a copy),
//   each lane waits for its own copies, fences them to the async proxy and
//   arrives on the buffer's `full` mbarrier (`publish`); consumers wait on it
//   and arrive on its `empty` mbarrier when done.
// Everything here lives in namespace `sm90`.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "attention_common.cuh"
#include "bf16_mma.cuh"

namespace {
namespace sm90 {

using headct_mma::bf16;
using headct_mma::pack_bf16;

constexpr float kLog2e = 1.4426950408889634f;

// Byte address of element (r, c) of a [rows][DP] tile at `tile` in the
// 128-byte swizzle: 16-byte chunk c / 8 of row r sits at chunk (c / 8) ^ (r % 8).
__device__ __forceinline__ uint32_t swz(uint32_t tile, int rows, int r, int c) {
  return tile + (c >> 6) * rows * 128 + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) + (c & 7) * 2;
}

// wgmma shared-memory descriptor of the 128-byte swizzle.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// Operand of k-step kk (16 columns) of a [rows][DP] tile read K-major (the
// head dim is the product's sum): 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int rows, int kk) {
  return make_desc(tile + (kk >> 2) * rows * 128 + (kk & 3) * 32, 16, 1024);
}

// B operand of k-step kk (16 rows) of a [rows][DP] tile read MN-major (the
// rows are the product's sum, the head dim its N): 8-row groups 1024 bytes
// apart, 64-column blocks rows * 128 bytes apart.
template <int DP>
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int rows, int kk) {
  return make_desc(tile + kk * 2048, DP > 64 ? rows * 128 : 1024, 1024);
}

template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int acc);
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b, int acc);

// D (+)= A B, A and B from shared memory, both K-major; acc = 0 overwrites D.
template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// D (+)= A B, A from registers (4 bf16 pairs a thread), B from shared memory
// MN-major (transpose bit set).
template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t b,
                                             int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                             int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}


template <>
__device__ __forceinline__ void wgmma_rs<48>(float (&d)[24], const uint32_t (&a)[4], uint64_t b,
                                             int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                             int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}


template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                             int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Tie registers to this point of the program: the compiler may not move
// their reads and writes across it (wgmma works on them asynchronously).
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// Initialise a ring's barriers at `bars`: `stages` `full` ones that complete
// after `fills` arrivals (producer lanes), then `stages` `empty` ones after
// `drains` arrivals (consumer threads or warps).
__device__ __forceinline__ void ring_init(uint32_t bars, int stages, int fills, int drains) {
  for (int s = 0; s < stages; ++s) {
    bar_init(bars + 8 * s, fills);
    bar_init(bars + 8 * (stages + s), drains);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Copy `bytes` (16, 8 or 4) from global to shared memory asynchronously; an
// invalid copy writes zeros and reads nothing.
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src),
                 "n"(BYTES), "r"(n)
                 : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Make this thread's completed copies visible to wgmma (the async proxy).
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [row0, row0 + rows) of a bf16 [T, D] slab (row stride st) into the
// swizzled [rows][DP] tile, CH elements a copy, by threads tid, tid + n, ...;
// rows >= t_len and columns >= d are zero.
template <int DP, int CH>
__device__ __forceinline__ void load_tile(uint32_t tile, int rows, const bf16* src, long long st,
                                          int row0, int t_len, int d, int tid, int n) {
  constexpr int per_row = DP / CH;
  for (int idx = tid; idx < rows * per_row; idx += n) {
    const int r = idx / per_row;
    const int c = (idx - r * per_row) * CH;
    const bool valid = row0 + r < t_len && c < d;
    cp_async<CH * 2>(swz(tile, rows, r, c), valid ? src + (long long)(row0 + r) * st + c : src,
                     valid);
  }
}

// The same tile as load_tile, copied by one warp: each lane keeps one
// column chunk and steps over the rows, 32 / (DP / CH) rows a step, so a
// copy costs a few instructions (lanes past the last whole row idle).
template <int DP, int CH>
__device__ __forceinline__ void warp_load_tile(uint32_t tile, int rows, const bf16* src,
                                               long long st, int row0, int t_len, int d,
                                               int lane) {
  constexpr int per_row = DP / CH;
  constexpr int step = 32 / per_row;
  if (lane >= step * per_row) return;
  const int c = (lane % per_row) * CH;
  const uint32_t col = tile + (c >> 6) * rows * 128 + (c & 7) * 2;
  const int chunk = (c >> 3) & 7;
  int r = lane / per_row;
  const bf16* p = src + (long long)(row0 + r) * st + c;
  for (; r < rows; r += step, p += step * st) {
    const bool valid = row0 + r < t_len && c < d;
    cp_async<CH * 2>(col + r * 128 + ((chunk ^ (r & 7)) << 4), valid ? p : src, valid);
  }
}

// Producer lane: wait for this lane's copies of a walked tile (all but the
// newest `Pending` groups), fence them to the async proxy and arrive on the
// buffer's `full` barrier, which completes when all 32 lanes have.
template <int Pending>
__device__ __forceinline__ void publish(uint32_t full_bar) {
  cp_wait<Pending>();
  proxy_fence();
  bar_arrive(full_bar);
}

// The block's shared memory: `base` its 1024-aligned shared address, `ptr`
// the same as a generic pointer.
struct Smem {
  uint32_t base;
  unsigned char* ptr;
};
__device__ __forceinline__ Smem smem_base() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  return {base, smem_raw + (base - raw)};
}

// Round a 64 x NT accumulator (P^T, dS^T, dS or P) to bf16 A operands, one
// per k-step of 16 columns: the accumulator layout of columns [16 kk, 16 kk +
// 16) is the A-operand layout of that k-step (FlashAttention-3's register A).
template <int NT>
__device__ __forceinline__ void to_a(uint32_t (&a)[NT / 16][4], const float (&x)[NT / 2]) {
#pragma unroll
  for (int kk = 0; kk < NT / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

// Store a 64 x DP accumulator (this thread's rows row0 + lane/4 (+ 8) of a
// warp's 16) as bf16 rows of a contiguous [B, n_rows, H, D] output, times mul.
template <int DP>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[DP / 2], int b, int row0,
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
            __floats2bfloat162_rn(mul * acc[4 * j + 2 * half], mul * acc[4 * j + 2 * half + 1]);
    }
  }
}

// 16-byte copies need a head dim that is a multiple of 8 and 16-byte aligned
// rows in every copied operand; otherwise the kernels copy 8 bytes at a time.
inline bool wide_copies(long long d, std::initializer_list<Strides> strides,
                        std::initializer_list<const void*> ptrs) {
  if (d % 8 != 0) return false;
  for (const Strides& s : strides)
    if (s.b % 8 != 0 || s.t % 8 != 0 || s.h % 8 != 0) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

// f(std::integral_constant<int, DP>) with d padded to the next of 16, 32,
// 48, 64, 128.
template <typename F>
auto with_padded_d(long long d, F f) {
  if (d <= 16) return f(std::integral_constant<int, 16>());
  if (d <= 32) return f(std::integral_constant<int, 32>());
  if (d <= 48) return f(std::integral_constant<int, 48>());
  if (d <= 64) return f(std::integral_constant<int, 64>());
  return f(std::integral_constant<int, 128>());
}

}  // namespace sm90
}  // namespace
