"""Whole-sequence forward attention: the CUDA kernel and its plain version.

``fused_attention`` is the port of the JAX package's ``fused_attention``
forward (``ops/flash_attention.py:153``, kernel ``_vmem_fwd_kernel`` at
``:60``): on a CUDA tensor it launches ``csrc/flash_attention_fwd.cu`` or
raises; on a CPU tensor it runs ``fused_attention_reference``, the plain
PyTorch version of the same function. Both return ``(o, lse)``: o [B, T, H, D]
in q's dtype and the float32 log-sum-exp in the JAX layout [B*H, 1, T], the
residual the backward kernel will need.

No autograd yet: serving needs no gradient.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from headct_foundation_tpu_torch.ops import _build

# Sequences up to this length take the whole-sequence kernel (the JAX
# package's VMEM_PATH_MAX_T); longer ones need the blocked kernel.
VMEM_PATH_MAX_T = 1024

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_C_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 13
           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _c_entry():
    """The kernel's C entry point, built and loaded at first use."""
    fn = _build.load("flash_attention_fwd").headct_flash_attention_fwd
    fn.argtypes = _C_ARGS
    fn.restype = ctypes.c_int
    return fn


def _scale(d: int, scale: Optional[float]) -> float:
    return float(d) ** -0.5 if scale is None else float(scale)


def fused_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: scores in float32 from operand-dtype inputs,
    P rounded to the operand dtype before P.V, the TPU kernel's guards."""
    B, T, H, D = q.shape
    s = _scale(D, scale)
    qh, kh, vh = (x.permute(0, 2, 1, 3).float() for x in (q, k, v))  # [B, H, T, D]
    scores = torch.matmul(qh, kh.transpose(-1, -2)) * s
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p.to(v.dtype).float(), vh) / l
    lse = (m + torch.log(l)).reshape(B * H, 1, T)
    return o.permute(0, 2, 1, 3).to(q.dtype), lse


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, {k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"fused_attention takes float32 or bfloat16 q/k/v, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"fused_attention takes equal [B, T, H, D] shapes, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, T, H, D = q.shape
    if not (1 <= T <= VMEM_PATH_MAX_T) or D % 4 or not (4 <= D <= 128) or B * H > 65535:
        raise ValueError(f"fused_attention kernel takes T <= {VMEM_PATH_MAX_T}, D a multiple "
                         f"of 4 up to 128 and B*H <= 65535; got {tuple(q.shape)}")
    per_vector = 16 if q.dtype == torch.float32 else 8  # bytes of one 4-element load
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1 or any(st % 4 for st in x.stride()[:3]) \
                or x.data_ptr() % per_vector:
            raise ValueError(
                f"fused_attention kernel needs {name} with a unit head-dim stride, "
                f"(batch, token, head) strides that are multiples of 4 and a "
                f"{per_vector}-byte aligned start; got strides {x.stride()}")


def fused_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention over [B, T, H, D] (square, T <= 1024) -> (o, lse [B*H, 1, T]).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    on the current stream or raises."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return fused_attention_reference(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention runs on cuda or cpu, not {q.device}")
    fn = _c_entry()
    B, T, H, D = q.shape
    o = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, 1, T), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            B, T, H, D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            _scale(D, scale), _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd kernel launch failed: cudaError {rc} "
                           f"at shape {tuple(q.shape)} {q.dtype}")
    fused_attention.launches += 1
    return o, lse


# Launches of the CUDA kernel in this process (the plain version is not counted).
fused_attention.launches = 0
