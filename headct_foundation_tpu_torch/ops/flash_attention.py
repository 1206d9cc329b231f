"""Whole-sequence attention, forward and backward: CUDA kernels and their
plain versions.

* ``fused_attention`` ports the JAX package's forward
  (``ops/flash_attention.py:177 _fused_fwd_impl``, kernel ``_vmem_fwd_kernel``
  at ``:60``): on a CUDA tensor it launches ``csrc/flash_attention_fwd.cu`` or
  raises; on a CPU tensor it runs ``fused_attention_reference``. Both return
  ``(o, lse)``: o [B, T, H, D] in q's dtype and the float32 log-sum-exp in
  the JAX layout [B*H, 1, T].
* ``fused_attention_bwd`` ports the backward (``:215 _fused_bwd``, kernel
  ``_vmem_bwd_kernel`` at ``:86``): ``csrc/flash_attention_bwd.cu`` on a CUDA
  tensor, ``fused_attention_bwd_reference`` on a CPU tensor.
* ``FusedAttention`` wires the two as a ``torch.autograd.Function`` that
  keeps exactly the JAX custom VJP's residuals (q, k, v, o, lse). On the CPU
  its backward is the plain backward, so the CPU tests exercise the kernel's
  contract rather than autograd through matmuls.

Each wrapper counts its CUDA launches in ``<wrapper>.launches``; the plain
versions are not counted.
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
# (pointer arguments, stride/shape arguments) of each kernel's C entry
_C_ARITY = {"flash_attention_fwd": (5, 13), "flash_attention_bwd": (10, 19)}


@functools.lru_cache(maxsize=None)
def _c_entry(name: str):
    """A kernel's C entry point, built and loaded at first use."""
    fn = getattr(_build.load(name), f"headct_{name}")
    n_ptr, n_int = _C_ARITY[name]
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_longlong] * n_int
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
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


def fused_attention_bwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernel, at its rounding points:
    P = exp(scale QK^T - LSE) in float32, rounded to the operand dtype for
    dV = P^T dO only; delta = rowsum(dO * O) from the stored O;
    dS = P (dO V^T - delta) rounded to the operand dtype before both of its
    products; dQ = scale dS K, dK = scale dS^T Q. Returns (dq, dk, dv)
    [B, T, H, D] in q's dtype."""
    B, T, H, D = q.shape
    s = _scale(D, scale)
    qh, kh, vh, oh, gh = (x.permute(0, 2, 1, 3).float() for x in (q, k, v, o, do))
    p = torch.exp(s * torch.matmul(qh, kh.transpose(-1, -2)) - lse.reshape(B, H, T, 1))
    dv = torch.matmul(p.to(q.dtype).float().transpose(-1, -2), gh)
    dp = torch.matmul(gh, vh.transpose(-1, -2))
    delta = (gh * oh).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta)).to(q.dtype).float()
    dq = s * torch.matmul(ds, kh)
    dk = s * torch.matmul(ds.transpose(-1, -2), qh)
    return tuple(x.permute(0, 2, 1, 3).to(q.dtype) for x in (dq, dk, dv))


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
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not _kernel_layout(x):
            raise ValueError(
                f"fused_attention kernel needs {name} with a unit head-dim stride, "
                f"(batch, token, head) strides that are multiples of 4 and a "
                f"{4 * x.element_size()}-byte aligned start; got strides {x.stride()}")


def _kernel_layout(x: torch.Tensor) -> bool:
    """True where the kernels can read x through its strides: a unit
    head-dim stride, other strides multiples of 4 and a start aligned to
    one 4-element vector load."""
    return (x.stride(3) == 1 and not any(st % 4 for st in x.stride()[:3])
            and x.data_ptr() % (4 * x.element_size()) == 0)


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
    fn = _c_entry("flash_attention_fwd")
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


def fused_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) [B, T, H, D] of ``fused_attention``'s o from
    q, k, v, the stored o and lse [B*H, 1, T], and the incoming do.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    on the current stream or raises. q, k, v and o are read through their
    strides; a do that the kernel cannot read so (autograd may hand over any
    layout) is copied contiguous first."""
    _check(q, k, v)
    B, T, H, D = q.shape
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError(f"fused_attention_bwd needs o and do like q {tuple(q.shape)} "
                         f"{q.dtype}; got {tuple(o.shape)} {o.dtype}, "
                         f"{tuple(do.shape)} {do.dtype}")
    if lse.shape != (B * H, 1, T) or lse.dtype != torch.float32:
        raise ValueError(f"fused_attention_bwd needs float32 lse [{B * H}, 1, {T}], got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if q.device.type == "cpu":
        return fused_attention_bwd_reference(q, k, v, o, do, lse, scale)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention_bwd runs on cuda or cpu, not {q.device}")
    if not _kernel_layout(o):
        raise ValueError(f"fused_attention_bwd kernel cannot read o with strides {o.stride()}")
    if not _kernel_layout(do):
        do = do.contiguous()
    lse = lse.contiguous()
    fn = _c_entry("flash_attention_bwd")
    dq, dk, dv = (torch.empty((B, T, H, D), dtype=q.dtype, device=q.device) for _ in range(3))
    delta = torch.empty((B * H, T), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, T, H, D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], *do.stride()[:3], _scale(D, scale), _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: cudaError {rc} "
                           f"at shape {tuple(q.shape)} {q.dtype}")
    fused_attention_bwd.launches += 1
    return dq, dk, dv


# Launches of the CUDA kernel in this process (the plain version is not counted).
fused_attention_bwd.launches = 0


class FusedAttention(torch.autograd.Function):
    """Differentiable whole-sequence attention: ``fused_attention`` forward,
    ``fused_attention_bwd`` backward (the kernels on CUDA tensors, their
    plain versions on CPU tensors). ``apply(q, k, v, scale)`` returns
    (o, lse); lse is not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, scale=None):
        o, lse = fused_attention(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = fused_attention_bwd(q, k, v, o, do, lse, ctx.scale)
        return dq, dk, dv, None
