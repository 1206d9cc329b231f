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
// `flash_fwd` routes bfloat16 operands to the wgmma kernel of
// flash_fwd_sm90.cuh and float32 operands to the 3xTF32 tensor-core kernel
// of flash_fwd_f32_sm90.cuh, whose products keep float32 accuracy, as the
// TPU kernels keep for float32 inputs. Both walk 128 query rows a block
// against key tiles that producer warps stream through a cp.async/mbarrier
// ring, with an online softmax (Dao et al. arXiv 2205.14135) in registers.
// Everything here lives in namespace `fwd`, so that one source can include
// this header and flash_bwd.cuh together (tm_attention.cu does).

#pragma once

#include <cuda_runtime.h>

#include "attention_common.cuh"
#include "flash_fwd_f32_sm90.cuh"
#include "flash_fwd_sm90.cuh"

namespace {
namespace fwd {

// Launch the forward on `stream`. dtype: 0 = float32 (flash_fwd_f32_sm90.cuh),
// 1 = bfloat16 (flash_fwd_sm90.cuh); the head dim is padded to the next of
// 16, 32, 48, 64, 128.
template <typename Tag>
cudaError_t flash_fwd(const FwdArgs& a, int dtype, cudaStream_t s) {
  if (dtype == 1) return fwd90::flash_fwd_bf16<Tag>(a, s);
  if (dtype == 0) return fwd32::flash_fwd_f32<Tag>(a, s);
  return cudaErrorInvalidValue;
}

}  // namespace fwd
}  // namespace
