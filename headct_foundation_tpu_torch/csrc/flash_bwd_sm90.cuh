// The blocked attention backward for bfloat16 operands on Hopper (sm_90a):
// kernels B4 (dkv_wgmma_kernel) and B5 (dq_wgmma_kernel), launched by
// flash_attention_blocked_bwd.cu.
//
// Replaces the TPU kernels headct_foundation_tpu/ops/flash_attention.py:292
// `_blocked_dkv_kernel` (B4, `pl.pallas_call` at :474) and :342
// `_blocked_dq_kernel` (B5, :498). For q [B, Tq, H, D] against the first
// kv_len keys of k, v [B, Tk, H, D], with the forward's LSE and delta =
// rowsum(dO * O), both float32 [B*H, Tq]:
//   P = exp(scale * Q K^T - LSE), P_op = P rounded to bf16 (0 at keys >= kv_len)
//   dS = P * (dO V^T - delta), rounded to bf16
//   B4: dK = scale * sum_q dS^T Q,  dV = sum_q P_op^T dO   (dK = dV = 0 at keys >= kv_len)
//   B5: dQ = scale * sum_k dS K
// dQ is stored [B, Tq, H, D], dK and dV [B, Tk, H, D], contiguous bf16.
//
// What bounds them. At the decoder shape [2, 4097, 16, 48] B4's four products
// are 2.06e11 operations (0.209 ms at 989 TFLOP/s) and B5's three 1.55e11
// (0.156 ms); their bytes take about 0.02 ms at 3.35 TB/s. At D = 48 the
// exponentials weigh nearly as much: each pass takes one per P element,
// B*H*Tq*Tk = 5.37e8, and the special function units give 16 per SM per
// clock (132 SMs at 1.98 GHz: 0.128 ms per pass).
//
// Design. The FlashAttention-2 split (Dao, arXiv 2307.08691): no float
// atomics, so two runs give bit-identical dQ, dK and dV. The one-pass
// backward with dQ summed by atomics (5 products instead of 7) would give
// that up and is not done. Each block is one warpgroup of 4 consumer warps
// that owns 64 rows (B4: keys, B5: queries) and one producer warp.
// - Every product is `wgmma.mma_async` m64nNk16 with float32 accumulators.
//   Tiles sit in shared memory as rows of 64 bf16 (128 bytes) in the 128-byte
//   swizzle, the head dim zero-padded to DP. B4 takes S^T = K Q^T and
//   dP^T = V dO^T with K, V as A and the Q, dO tiles as B, both K-major as
//   stored; dV += P^T dO and dK += dS^T Q take P^T and dS^T as A straight
//   from the accumulators (rounded to bf16 in registers), and dO, Q as B
//   through wgmma's transpose bit (MN-major). B5 takes S = Q K^T, dP = dO V^T
//   and dQ += dS K the same way. No transposed copy is built.
// - The walked tiles (B4: Q, dO, LSE, delta; B5: K, V) stream through a
//   ring of kStages buffers. The producer warp fills a buffer with cp.async
//   while the consumers work on the one before; each of its lanes waits for
//   its own copies, fences them to the tensor cores' (async) proxy and
//   arrives on the buffer's `full` mbarrier. The consumers wait on it and,
//   once their products have read the buffer, arrive on its `empty`
//   mbarrier, which the producer waits on before refilling it.
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
// The walked tile is 64 rows (32 in B4 at D > 64, to keep its four
// accumulators in registers).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_common.cuh"
#include "bf16_mma.cuh"
#include "flash_bwd.cuh"

namespace {
namespace bwd90 {

using headct_mma::bf16;
using headct_mma::pack_bf16;

constexpr int kRows = 64;       // rows a block owns: one warpgroup's wgmma M
constexpr int kConsumers = 128;  // one warpgroup
constexpr int kThreads = kConsumers + 32;  // and a producer warp
constexpr int kStages = 3;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of one block, in bytes from a 1024-byte aligned base: two
// fixed [64][DP] tiles, kStages pairs of walked [NT][DP] tiles, kStages pairs
// of NT float row values (B4's LSE and delta), then the mbarriers.
template <int DP, int NT>
struct Layout {
  static constexpr int kColBlocks = (DP + 63) / 64;  // 128-byte swizzle blocks of a row
  static constexpr int kFixedTile = kRows * 128 * kColBlocks;
  static constexpr int kWalkTile = NT * 128 * kColBlocks;
  static constexpr int kStage0 = 2 * kFixedTile;
  static constexpr int kRowVals = kStage0 + kStages * 2 * kWalkTile;
  static constexpr int kBars = kRowVals + kStages * 2 * NT * 4;
  static constexpr size_t kSmem = kBars + 2 * kStages * 8 + 1024;  // + alignment slack
};

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

// Set up the block: barriers, and the two fixed [64][DP] tiles (rows
// [row0, row0 + 64) of x0 and x1, rows >= t_len zero), loaded by all threads.
template <int DP, int NT, int CH>
__device__ __forceinline__ void block_setup(const Smem& sm, const bf16* x0, long long st0,
                                            const bf16* x1, long long st1, int row0, int t_len,
                                            int d) {
  using L = Layout<DP, NT>;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(sm.base + L::kBars + 8 * s, 32);                       // full
      bar_init(sm.base + L::kBars + 8 * (kStages + s), kConsumers);   // empty
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  load_tile<DP, CH>(sm.base, kRows, x0, st0, row0, t_len, d, threadIdx.x, kThreads);
  load_tile<DP, CH>(sm.base + L::kFixedTile, kRows, x1, st1, row0, t_len, d, threadIdx.x,
                    kThreads);
  cp_commit();
  cp_wait<0>();
  proxy_fence();
  __syncthreads();
}

// Round a 64 x NT accumulator (P^T, dS^T, or dS) to bf16 A operands, one per
// k-step of 16 columns: the accumulator layout of columns [16 kk, 16 kk + 16)
// is the A-operand layout of that k-step (FlashAttention-3's register A).
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

// B4: one block per (64-key tile, batch*head), dK and dV of those keys,
// walking the query tiles NT at a time.
template <typename Tag, int DP, int NT, int CH>
__global__ void __launch_bounds__(kThreads, DP > 64 ? 1 : 2)
dkv_wgmma_kernel(const bwd::BwdArgs a) {
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

  block_setup<DP, NT, CH>(sm, k, a.ks.t, v, a.vs.t, n0, kv_len, d);  // K, V
  const uint32_t full = sm.base + L::kBars, empty = full + 8 * kStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp == kConsumers / 32) {  // the producer warp: Q, dO, LSE, delta
    const float* lse = static_cast<const float*>(a.lse) + (long long)bh * tq;
    const float* delta = static_cast<const float*>(a.delta) + (long long)bh * tq;
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      if (i >= kStages) bar_wait(empty + 8 * s, ((i / kStages) - 1) & 1);
      const uint32_t tile = sm.base + L::kStage0 + s * 2 * L::kWalkTile;
      const int q0 = i * NT;
      load_tile<DP, CH>(tile, NT, q, a.qs.t, q0, tq, d, lane, 32);
      load_tile<DP, CH>(tile + L::kWalkTile, NT, g, a.gs.t, q0, tq, d, lane, 32);
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
      cp_commit();
      if (i > 0) publish<1>(full + 8 * ((i - 1) % kStages));
    }
    if (n_tiles > 0) publish<0>(full + 8 * ((n_tiles - 1) % kStages));
  } else {  // the consumer warpgroup: 16 keys a warp
    const int r0 = 16 * warp + (lane >> 2);  // this thread's keys r0, r0 + 8 in the tile
    const bool key_ok[2] = {n0 + r0 < kv_len, n0 + r0 + 8 < kv_len};
    const float c = a.scale * kLog2e;
    float dk[DP / 2], dv[DP / 2], s[NT / 2], dp[NT / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) s[i] = dp[i] = 0.f;
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

// B5: one block per (64-query tile, batch*head), dQ of those rows, walking
// the key tiles up to kv_len NT at a time.
template <typename Tag, int DP, int NT, int CH>
__global__ void __launch_bounds__(kThreads, DP > 64 ? 1 : 2)
dq_wgmma_kernel(const bwd::BwdArgs a) {
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

  block_setup<DP, NT, CH>(sm, q, a.qs.t, g, a.gs.t, q0, tq, d);  // Q, dO
  const uint32_t full = sm.base + L::kBars, empty = full + 8 * kStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp == kConsumers / 32) {  // the producer warp: K, V
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      if (i >= kStages) bar_wait(empty + 8 * s, ((i / kStages) - 1) & 1);
      const uint32_t tile = sm.base + L::kStage0 + s * 2 * L::kWalkTile;
      load_tile<DP, CH>(tile, NT, k, a.ks.t, i * NT, kv_len, d, lane, 32);
      load_tile<DP, CH>(tile + L::kWalkTile, NT, v, a.vs.t, i * NT, kv_len, d, lane, 32);
      cp_commit();
      if (i > 0) publish<1>(full + 8 * ((i - 1) % kStages));
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

// 16-byte copies need a head dim that is a multiple of 8 and 16-byte aligned
// rows in every operand; otherwise the kernels copy 8 bytes at a time.
inline bool wide_copies(const bwd::BwdArgs& a) {
  auto rows16 = [](const Strides& s) { return s.b % 8 == 0 && s.t % 8 == 0 && s.h % 8 == 0; };
  auto at16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  return a.d % 8 == 0 && rows16(a.qs) && rows16(a.ks) && rows16(a.vs) && rows16(a.gs) &&
         at16(a.q) && at16(a.k) && at16(a.v) && at16(a.dout);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, long long rows, const bwd::BwdArgs& a,
                   cudaStream_t s) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((rows + kRows - 1) / kRows), (unsigned)(a.B * a.n_heads));
  kernel<<<grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

// Rows of the walked tile: 64, or 32 in B4 above D = 64, where its four
// accumulators would not fit the registers.
template <bool Dkv, int DP>
constexpr int walk_rows() { return Dkv && DP > 64 ? 32 : 64; }

template <bool Dkv, int DP>
constexpr size_t smem_of() { return Layout<DP, walk_rows<Dkv, DP>()>::kSmem; }

// Launch B4 (Dkv) or B5 at the padded head dim DP on `s`.
template <typename Tag, bool Dkv, int DP>
cudaError_t launch_pass(const bwd::BwdArgs& a, cudaStream_t s) {
  constexpr int NT = walk_rows<Dkv, DP>();
  const bool wide = wide_copies(a);
  if constexpr (Dkv)
    return wide ? launch(dkv_wgmma_kernel<Tag, DP, NT, 8>, smem_of<Dkv, DP>(), a.tk, a, s)
                : launch(dkv_wgmma_kernel<Tag, DP, NT, 4>, smem_of<Dkv, DP>(), a.tk, a, s);
  else
    return wide ? launch(dq_wgmma_kernel<Tag, DP, NT, 8>, smem_of<Dkv, DP>(), a.tq, a, s)
                : launch(dq_wgmma_kernel<Tag, DP, NT, 4>, smem_of<Dkv, DP>(), a.tq, a, s);
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

// Launch B4 (dK, dV) on `s`; bfloat16 operands, D <= 128 a multiple of 4.
template <typename Tag>
cudaError_t launch_dkv(const bwd::BwdArgs& a, cudaStream_t s) {
  return with_padded_d(a.d,
                       [&](auto dp) { return launch_pass<Tag, true, decltype(dp)::value>(a, s); });
}

// Launch B5 (dQ) on `s`; as launch_dkv.
template <typename Tag>
cudaError_t launch_dq(const bwd::BwdArgs& a, cudaStream_t s) {
  return with_padded_d(a.d,
                       [&](auto dp) { return launch_pass<Tag, false, decltype(dp)::value>(a, s); });
}

// Dynamic shared memory of one block of B4 (dkv) or B5 at head dim d.
inline size_t smem_bytes(bool dkv, long long d) {
  return with_padded_d(d, [&](auto dp) {
    return dkv ? smem_of<true, decltype(dp)::value>() : smem_of<false, decltype(dp)::value>();
  });
}

}  // namespace bwd90
}  // namespace
