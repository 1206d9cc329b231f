// The attention forward for float32 operands on Hopper (sm_90a):
// flash_fwd_tf32_kernel, the float32 route of B1 (flash_attention_fwd.cu),
// B3 (flash_attention_blocked_fwd.cu) and B7 (tm_attention.cu), all reached
// through fwd::flash_fwd<Tag> (flash_fwd.cuh).
//
// Replaces, for float32 inputs, the TPU kernels
// headct_foundation_tpu/ops/flash_attention.py:60 `_vmem_fwd_kernel` (B1,
// `pl.pallas_call` at :195) and :256 `_blocked_fwd_kernel` (B3, :433), whose
// float32 dots are multi-pass products on the TPU's matrix unit. For q
// [B, Tq, H, D] against the first kv_len keys of k, v [B, Tk, H, D]:
//   S = scale * Q K^T (float32-accurate), m = row max, P = exp(S - m), l = sum P
//   O = P V / max(l, 1e-30)              (contiguous float32 [B, Tq, H, D])
//   LSE = m + ln max(l, 1e-30)           (float32 [B*H, 1, Tq], natural log)
// Keys >= kv_len carry no weight; query rows >= Tq are not stored. D is a
// multiple of 4 up to 128, zero-padded to DP = 16, 32, 48, 64 or 128; q, k, v
// are read through their (batch, token, head) strides, which must be
// multiples of 4 elements from a 16-byte aligned start.
//
// What bounds it. At the serving shape [8, 513, 12, 64] the two products are
// 4*B*H*T^2*D = 6.47e9 operations: 0.097 ms on the float32 CUDA cores at 67
// TFLOP/s. On the tensor cores float32 accuracy takes three TF32 products
// for each (below), 1.94e10 operations, 0.039 ms at 495 TFLOP/s TF32; the
// bytes take 0.015 ms at 3.35 TB/s and the exponentials (B*H*T^2 = 2.53e7 at
// 16 per SM per clock) 0.006 ms. So the route is held to 0.039 ms, by
// operations.
//
// Design: 3xTF32 (the split of CUTLASS's OpMultiplyAddFastF32, which
// PyTorch's memory-efficient attention runs for float32 on the same card,
// with Ampere's mma.sync). Each operand x is split into hi = rna_tf32(x) and
// lo = x - hi (exact; the tensor cores read its TF32 part); a product is
// a_lo b_hi + a_hi b_lo + a_hi b_hi in a float32 accumulator, in that order,
// the small terms first (a_lo b_lo, below 2^-21 of the product, is
// dropped). The rest follows flash_fwd_sm90.cuh:
// - A block owns kRows = 128 query rows of one (batch, head) (64 at DP =
//   128): two consumer warpgroups of 64 rows, each with its Q tile split
//   once into a hi and a lo tile in shared memory, and one producer
//   warpgroup that streams K and V tiles of NT keys through a ring of two
//   stages (cp.async, 16 bytes a copy; the `full` / `empty` mbarriers of
//   sm90_common.cuh). The producers split each K tile in place into hi and
//   a lo tile, and each V tile into a transposed hi and lo (V^T, below), and
//   publish it at once; only then do they wait for a stage to refill. Each
//   lane reads back only its own copies, so no barrier is needed.
// - S = Q K^T is three `wgmma` m64nNTk8 tf32 chains, Q and K both K-major as
//   stored, in the 128-byte swizzle: a tf32 k-step is 8 elements, 32 bytes,
//   the bf16 k-step's bytes, so sm90_common.cuh's descriptors serve
//   unchanged.
// - O += P V is three `wgmma` m64nDPk8 tf32 chains with P from registers,
//   straight from the S accumulator. tf32 wgmma reads shared memory K-major
//   only (the transpose bit exists for 16-bit types alone), so V's producers
//   write V^T [DP][NT]. The accumulator holds keys 2t and 2t + 1 of each
//   8-key step where the A fragment wants keys t and t + 4; the sum does not
//   care which key is called which, so V^T's columns are put in that order.
//   P V on mma.sync over V as it lies (three stages fit) measured 12% slower
//   (PERF.md).
// - The online softmax is the bfloat16 kernel's (`fwd90::online_softmax`):
//   log2 domain, one FFMA and one MUFU.EX2 an element, O rescaled only in a
//   warp where some row's max grew. A negative scale negates Q in the split
//   (exact), so the walk scales by c = |scale| log2(e) > 0.
// - Shared memory: the split Q tiles (64 KB) and two stages of K hi, K lo,
//   V as copied, V^T hi and V^T lo, 225 KB at DP = 64 (32-key tiles at DP =
//   128). One block an SM.
// - Ragged edges: rows past the tensor are zero-filled by the copies; keys
//   >= kv_len score -inf; a warpgroup whose rows all lie at or past Tq only
//   passes the ring's tiles on. Offsets are 64-bit. No atomics and a fixed
//   order of the three products: reruns are bit-identical.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "flash_fwd_sm90.cuh"
#include "sm90_common.cuh"

namespace {
namespace fwd32 {

using namespace sm90;

// Keys of a walked tile, stages of the ring and consumer warpgroups (64 query
// rows each) at padded head dim DP, beside one producer warpgroup. Twelve
// warps leave a thread 168 registers (three warps on each of the SM's four
// schedulers); at DP = 128 one consumer warpgroup (eight warps, 255
// registers) keeps O's 64 accumulators out of local memory.
template <int DP>
struct Tiles {
  static constexpr int kKeys = DP > 64 ? 32 : 64;
  static constexpr int kStages = 2;
  static constexpr int kGroups = DP > 64 ? 1 : 2;
  static constexpr int kRows = 64 * kGroups;
  static constexpr int kConsumers = 128 * kGroups;
  static constexpr int kThreads = kConsumers + 128;
};

// Shared memory of one block, in bytes from a 1024-byte aligned base: the
// kGroups Q hi tiles, then their lo tiles ([64][DP] each, 128-byte swizzle,
// a row of 32 floats a 128-byte block), then per stage a K hi, a K lo and a
// V tile as copied ([NT][DP]) and a V^T hi and lo tile ([DP][NT]), then the
// mbarriers (`full` completes on the producers' 128 lanes, `empty` on the
// consumers' kConsumers threads).
template <int DP>
struct Layout {
  static constexpr int NT = Tiles<DP>::kKeys, kStages = Tiles<DP>::kStages;
  static constexpr int kGroups = Tiles<DP>::kGroups;
  static constexpr int kColBlocks = (DP + 31) / 32;
  static constexpr int kQTile = 64 * 128 * kColBlocks;
  static constexpr int kKTile = NT * 128 * kColBlocks;
  static constexpr int kVtTile = DP * 128 * (NT / 32);
  static constexpr int kQLo = kGroups * kQTile;
  static constexpr int kK0 = 2 * kGroups * kQTile;
  static constexpr int kStage = 3 * kKTile + 2 * kVtTile;
  static constexpr int kBars = kK0 + kStages * kStage;
  static constexpr size_t kSmem = kBars + 2 * kStages * 8 + 1024;  // + alignment slack
};

// Byte address of float (r, c) of a [rows][DP] tile at `tile` in the
// 128-byte swizzle, for c a multiple of 4: 16-byte chunk (c % 32) / 4 of row
// r of column block c / 32 sits at chunk ((c % 32) / 4) ^ (r % 8).
__device__ __forceinline__ uint32_t swz4(uint32_t tile, int rows, int r, int c) {
  return tile + (c >> 5) * rows * 128 + r * 128 + ((((c >> 2) & 7) ^ (r & 7)) << 4);
}

// x rounded to TF32, to nearest with ties away from zero: cvt.rna.tf32.f32's
// rounding in two integer instructions (ptxas emits cvt.rna.tf32.f32 as a
// compare and a select around the same two; the split runs on every operand
// element, and cvt.rna.tf32.f32 measured 4% slower on the H100). Infinities
// stay what they are. A NaN with mantissa bits 12 to 22 all set (the
// card's canonical 0x7FFFFFFF) carries into the sign bit and gives hi = -0;
// its lo = x - hi is then the NaN, which still reaches the products.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo exactly, hi a TF32 value and lo = x - hi, of which the
// tensor cores read the TF32 part (its 13 low mantissa bits are dropped:
// below 2^-21 |x|). Rounding lo as well measured 2% slower.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// The float4 at shared address `at` split in place into hi, its lo at
// `at + lo_off`; times `sign` (+1 or -1, exact) first.
__device__ __forceinline__ void split_chunk(const Smem& sm, uint32_t at, uint32_t lo_off,
                                            float sign) {
  float4* p = reinterpret_cast<float4*>(sm.ptr + (at - sm.base));
  const float4 x = *p;
  uint4 hi, lo;
  split(sign * x.x, hi.x, lo.x);
  split(sign * x.y, hi.y, lo.y);
  split(sign * x.z, hi.z, lo.z);
  split(sign * x.w, hi.w, lo.w);
  *reinterpret_cast<uint4*>(p) = hi;
  *reinterpret_cast<uint4*>(sm.ptr + (at + lo_off - sm.base)) = lo;
}

// D (+)= A B, tf32 A and B from shared memory, both K-major; acc = 0
// overwrites D.
template <int N>
__device__ void wgmma_tf32(float (&d)[N / 2], uint64_t a, uint64_t b, int acc);

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// D (+)= A B, tf32 A from registers (this thread's rows g, g + 8 of its
// warp's 16, columns t, t + 4: g = lane / 4, t = lane % 4), B from shared
// memory K-major.
template <int N>
__device__ void wgmma_rs_tf32(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b, int acc);

template <>
__device__ __forceinline__ void wgmma_rs_tf32<16>(float (&d)[8], const uint32_t (&a)[4],
                                                 uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs_tf32<32>(float (&d)[16], const uint32_t (&a)[4],
                                                 uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs_tf32<48>(float (&d)[24], const uint32_t (&a)[4],
                                                 uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs_tf32<64>(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs_tf32<128>(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// One block per (kRows query rows, batch*head): O and LSE of those rows,
// walking the key tiles up to kv_len NT at a time.
template <typename Tag, int DP, int NT>
__global__ void __launch_bounds__(Tiles<DP>::kThreads, 1)
flash_fwd_tf32_kernel(const FwdArgs a) {
  using L = Layout<DP>;
  using Tl = Tiles<DP>;
  constexpr int kStages = L::kStages, kRows = Tl::kRows, kConsumers = Tl::kConsumers;
  constexpr int kPerRow = DP / 4;  // 16-byte chunks of a row
  const Smem sm = smem_base();
  const int tq = (int)a.tq, kv_len = (int)a.kv_len;
  const int n_heads = (int)a.n_heads, d = (int)a.d;
  const int bh = blockIdx.y;
  const int b = bh / n_heads;
  const int h = bh - b * n_heads;
  const int q0 = blockIdx.x * kRows;
  const float* q = static_cast<const float*>(a.q) + b * a.qs.b + h * a.qs.h;
  const float* k = static_cast<const float*>(a.k) + b * a.ks.b + h * a.ks.h;
  const float* v = static_cast<const float*>(a.v) + b * a.vs.b + h * a.vs.h;
  const int n_tiles = (kv_len + NT - 1) / NT;  // the last one holds a real key
  const uint32_t full = sm.base + L::kBars, empty = full + 8 * kStages;
  auto k_tile = [&](int i) { return sm.base + L::kK0 + (i % kStages) * L::kStage; };
  auto v_copy = [&](int i) { return k_tile(i) + 2 * L::kKTile; };
  auto vt_tile = [&](int i) { return k_tile(i) + 3 * L::kKTile; };

  // Set-up: the ring's barriers, and every warpgroup's Q tile (rows >= Tq
  // zero), copied by all threads; each thread then splits its own copies
  // into hi and lo, negated for a negative scale.
  if (threadIdx.x == 0) ring_init(full, kStages, 128, kConsumers);
  for (int idx = threadIdx.x; idx < kRows * kPerRow; idx += Tl::kThreads) {
    const int r = idx / kPerRow, c = (idx - r * kPerRow) * 4;
    const bool valid = q0 + r < tq && c < d;
    cp_async<16>(swz4(sm.base + (r >> 6) * L::kQTile, 64, r & 63, c),
                 valid ? q + (long long)(q0 + r) * a.qs.t + c : q, valid);
  }
  cp_commit();
  cp_wait<0>();
  const float sign = a.scale < 0.f ? -1.f : 1.f;
  for (int idx = threadIdx.x; idx < kRows * kPerRow; idx += Tl::kThreads) {
    const int r = idx / kPerRow, c = (idx - r * kPerRow) * 4;
    split_chunk(sm, swz4(sm.base + (r >> 6) * L::kQTile, 64, r & 63, c), L::kQLo, sign);
  }
  proxy_fence();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= kConsumers / 32) {
    // The producer warpgroup shares every tile. For K each of its 128 lanes
    // keeps one column chunk and steps over the rows, kStep rows a step
    // (lanes past the last whole row idle, at DP = 48), and splits its own
    // copies in place into hi and a lo tile. For V lane pl copies chunks
    // [vc0, vc0 + kVc) of key row vj = pl % NT and writes them split and
    // transposed into V^T hi and lo, key vj at column `pos` of its 8-key
    // step (2t + e -> t + 4e, the P fragment's order): the 32 lanes of a
    // warp hold 32 keys, so each transposed store hits 32 banks. A tile is
    // published as soon as it is prepared; the copy of tile j - 1 + kStages,
    // which waits for the consumers to release tile j - 1, comes after.
    constexpr int kStep = 128 / kPerRow, kSteps = (NT + kStep - 1) / kStep;
    const int pl = threadIdx.x - kConsumers;
    const int c = (pl % kPerRow) * 4, r0 = pl < kStep * kPerRow ? pl / kPerRow : NT;
    constexpr int kVc = DP / (128 / NT);
    const int vj = pl % NT, vc0 = (pl / NT) * kVc;
    const int pos = (vj & ~7) | ((vj & 7) >> 1) | ((vj & 1) << 2);
    auto copy = [&](int i) {
#pragma unroll 4
      for (int n = 0; n < kSteps; ++n) {
        const int r = r0 + n * kStep, row = i * NT + r;
        const bool valid = row < kv_len && c < d;
        if (r < NT) {
          cp_async<16>(swz4(k_tile(i), NT, r, c), valid ? k + (long long)row * a.ks.t + c : k,
                       valid);
        }
      }
      const int row = i * NT + vj;
#pragma unroll
      for (int cc = vc0; cc < vc0 + kVc; cc += 4) {
        const bool valid = row < kv_len && cc < d;
        cp_async<16>(swz4(v_copy(i), NT, vj, cc), valid ? v + (long long)row * a.vs.t + cc : v,
                     valid);
      }
    };
    auto transpose_v = [&](int j) {
      const uint32_t col = vt_tile(j) + (pos >> 5) * DP * 128 + (pos & 3) * 4 - sm.base;
      const int chunk = (pos >> 2) & 7;
#pragma unroll
      for (int cc = vc0; cc < vc0 + kVc; cc += 4) {
        const float4 x =
            *reinterpret_cast<const float4*>(sm.ptr + (swz4(v_copy(j), NT, vj, cc) - sm.base));
        const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          uint32_t hi, lo;
          split(xs[e], hi, lo);
          const uint32_t at = col + (cc + e) * 128 + ((chunk ^ ((cc + e) & 7)) << 4);
          *reinterpret_cast<uint32_t*>(sm.ptr + at) = hi;
          *reinterpret_cast<uint32_t*>(sm.ptr + at + L::kVtTile) = lo;
        }
      }
    };
    // Commit group j holds tile j's copies (empty where no tile is left to
    // copy): the prologue commits groups 0 .. kStages - 1, step j >= 1 group
    // j - 1 + kStages, so at step j the kStages - 2 newest groups may still
    // be in flight.
    for (int i = 0; i < kStages; ++i) {
      if (i < n_tiles) copy(i);
      cp_commit();
    }
    for (int j = 0; j < n_tiles; ++j) {
      cp_wait<kStages - 2>();
#pragma unroll 4
      for (int n = 0; n < kSteps; ++n)
        if (r0 + n * kStep < NT)
          split_chunk(sm, swz4(k_tile(j), NT, r0 + n * kStep, c), L::kKTile, 1.f);
      transpose_v(j);
      proxy_fence();
      bar_arrive(full + 8 * (j % kStages));
      if (j > 0) {
        const int i = j - 1 + kStages;
        if (i < n_tiles) {
          bar_wait(empty + 8 * (i % kStages), ((i / kStages) - 1) & 1);
          copy(i);
        }
        cp_commit();
      }
    }
    return;
  }

  // A consumer warpgroup: 16 query rows a warp.
  const int g = warp >> 2;
  if (q0 + 64 * g >= tq) {  // no real row: pass the tiles on
    for (int i = 0; i < n_tiles; ++i) {
      bar_wait(full + 8 * (i % kStages), (i / kStages) & 1);
      bar_arrive(empty + 8 * (i % kStages));
    }
    return;
  }
  const uint32_t q_hi = sm.base + g * L::kQTile, q_lo = q_hi + L::kQLo;
  const int row0 = q0 + 64 * g + 16 * (warp & 3);  // this warp's first row
  const float c = fmaxf(fabsf(a.scale) * kLog2e, 1e-30f);
  float o[DP / 2], s[NT / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
  uint32_t p_hi[NT / 8][4], p_lo[NT / 8][4];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) s[i] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    bar_wait(full + 8 * st, (i / kStages) & 1);
    const uint32_t k_hi = k_tile(i), k_lo = k_hi + L::kKTile;
    const uint32_t vt_hi = vt_tile(i), vt_lo = vt_hi + L::kVtTile;
    // S = Q_lo K_hi + Q_hi K_lo + Q_hi K_hi, the small terms first.
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk)
      wgmma_tf32<NT>(s, kmajor(q_lo, 64, kk), kmajor(k_hi, NT, kk), kk);
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk)
      wgmma_tf32<NT>(s, kmajor(q_hi, 64, kk), kmajor(k_lo, NT, kk), 1);
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk)
      wgmma_tf32<NT>(s, kmajor(q_hi, 64, kk), kmajor(k_hi, NT, kk), 1);
    wg_commit();
    wg_wait();
    pin(s);
    if (fwd90::online_softmax<NT>(s, m, l, alpha, c, i * NT, kv_len))
      fwd90::scale_rows<DP>(o, alpha);
    // O += P_lo V_hi + P_hi V_lo + P_hi V_hi: P as the A operand, position t
    // of an 8-key step holding key 2t and t + 4 key 2t + 1, as V^T's columns.
#pragma unroll
    for (int kk = 0; kk < NT / 8; ++kk) {
      split(s[4 * kk], p_hi[kk][0], p_lo[kk][0]);
      split(s[4 * kk + 2], p_hi[kk][1], p_lo[kk][1]);
      split(s[4 * kk + 1], p_hi[kk][2], p_lo[kk][2]);
      split(s[4 * kk + 3], p_hi[kk][3], p_lo[kk][3]);
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < NT / 8; ++kk)
      wgmma_rs_tf32<DP>(o, p_lo[kk], kmajor(vt_hi, DP, kk), 1);
#pragma unroll
    for (int kk = 0; kk < NT / 8; ++kk)
      wgmma_rs_tf32<DP>(o, p_hi[kk], kmajor(vt_lo, DP, kk), 1);
#pragma unroll
    for (int kk = 0; kk < NT / 8; ++kk)
      wgmma_rs_tf32<DP>(o, p_hi[kk], kmajor(vt_hi, DP, kk), 1);
    wg_commit();
    wg_wait();
    pin(o);
    pin(p_hi);
    pin(p_lo);
    bar_arrive(empty + 8 * st);
  }

  // Epilogue: l summed over the quad, O / l, LSE back to the natural log.
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
    l[half] = fmaxf(l[half], 1e-30f);
    alpha[half] = 1.f / l[half];
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + (lane >> 2) + 8 * half;
    if (row >= tq) continue;
    float* out = static_cast<float*>(a.o) + (((long long)b * tq + row) * n_heads + h) * d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = j * 8 + 2 * (lane & 3);
      if (col < d)
        *reinterpret_cast<float2*>(out + col) =
            make_float2(alpha[half] * o[4 * j + 2 * half], alpha[half] * o[4 * j + 2 * half + 1]);
    }
    if ((lane & 3) == 0)
      static_cast<float*>(a.lse)[(long long)bh * tq + row] =
          (m[half] + log2f(l[half])) * fwd90::kLn2;
  }
}

// Launch at the padded head dim DP on `s`.
template <typename Tag, int DP>
cudaError_t launch(const FwdArgs& a, cudaStream_t s) {
  constexpr size_t smem = Layout<DP>::kSmem;
  const auto kernel = flash_fwd_tf32_kernel<Tag, DP, Tiles<DP>::kKeys>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  constexpr int kRows = Tiles<DP>::kRows;
  const dim3 grid((unsigned)((a.tq + kRows - 1) / kRows), (unsigned)(a.B * a.n_heads));
  kernel<<<grid, Tiles<DP>::kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

// Launch the float32 forward on `s`; D <= 128 a multiple of 4, every
// operand's strides multiples of 4 from a 16-byte aligned start (16-byte
// copies only).
template <typename Tag>
cudaError_t flash_fwd_f32(const FwdArgs& a, cudaStream_t s) {
  if (a.d % 4 != 0) return cudaErrorInvalidValue;
  for (const Strides& st : {a.qs, a.ks, a.vs})
    if (st.b % 4 != 0 || st.t % 4 != 0 || st.h % 4 != 0) return cudaErrorInvalidValue;
  for (const void* p : {a.q, a.k, a.v})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return cudaErrorInvalidValue;
  return with_padded_d(a.d, [&](auto dp) { return launch<Tag, decltype(dp)::value>(a, s); });
}

// Dynamic shared memory of one block at head dim d.
inline size_t smem_bytes(long long d) {
  return with_padded_d(d, [](auto dp) { return Layout<decltype(dp)::value>::kSmem; });
}

}  // namespace fwd32
}  // namespace
