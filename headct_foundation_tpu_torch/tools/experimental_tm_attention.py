"""Token-major whole-sequence attention: the CUDA kernels B7, B8 and their
plain versions.

Port of the JAX repository's ``tools/experimental_tm_attention.py``, an A/B
experiment off every training path: the same function as
``ops.flash_attention.FusedAttention`` (square T <= 1024, [B, T, H, D] in and
out), computed on the operands in the model's token-major layout
[B, T, H*D] (the reshape of a contiguous [B, T, H, D] tensor is free), with
the log-sum-exp as float32 [B, H, T]:

* ``tm_attention_fwd`` ports ``_tm_fwd_impl`` (kernel ``_tm_fwd_kernel`` at
  ``:55``, ``pallas_call`` at ``:150``): ``csrc/tm_attention.cu``'s forward
  entry on a CUDA tensor, ``tm_attention_fwd_reference`` on a CPU tensor.
* ``tm_attention_bwd`` ports ``_tm_bwd`` (kernel ``_tm_bwd_kernel`` at
  ``:80``, ``pallas_call`` at ``:214``), which computes delta = rowsum(dO * O)
  itself: the backward entry of ``csrc/tm_attention.cu`` on a CUDA tensor,
  ``tm_attention_bwd_reference`` on a CPU tensor.
* ``FusedAttentionTM`` wires them as a ``torch.autograd.Function`` with the
  JAX custom VJP's residuals (q, k, v, o, lse); ``fused_attention_tm``
  returns its o.

The JAX backward's head-group split (``_head_split``: a VMEM budget and
128-lane blocks) is TPU tuning and no spec here. The kernels take contiguous
operands and raise on others; each wrapper counts its CUDA launches in
``<wrapper>.launches``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from headct_foundation_tpu_torch.ops.flash_attention import (
    _check,
    _launch,
    _on,
    _scale,
    fused_attention_bwd_reference,
    fused_attention_reference,
)


def _check_tm(name: str, *xs: torch.Tensor) -> None:
    """Raise on what the token-major kernels do not take: besides the
    whole-sequence checks, every operand contiguous."""
    _check(*xs[:3], name)
    for x in xs:
        if x.shape != xs[0].shape or x.dtype != xs[0].dtype:
            raise ValueError(f"{name} needs operands like q {tuple(xs[0].shape)} {xs[0].dtype}; "
                             f"got {tuple(x.shape)} {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} takes contiguous [B, T, H, D] operands (the [B, T, H*D] "
                             f"layout); got strides {x.stride()}")


def _check_lse(name: str, q: torch.Tensor, lse: torch.Tensor) -> None:
    B, T, H, _ = q.shape
    if lse.shape != (B, H, T) or lse.dtype != torch.float32:
        raise ValueError(f"{name} needs float32 lse [{B}, {H}, {T}], got "
                         f"{tuple(lse.shape)} {lse.dtype}")


def tm_attention_fwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of B7: ``fused_attention_reference`` (the same
    rounding points as ``_tm_fwd_kernel``), o contiguous, lse as [B, H, T]."""
    B, T, H, _ = q.shape
    o, lse = fused_attention_reference(q, k, v, scale)
    return o.contiguous(), lse.reshape(B, H, T)


def tm_attention_bwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of B8: ``fused_attention_bwd_reference`` (delta
    from the stored o, as ``_tm_bwd_kernel`` takes it) on lse [B, H, T]."""
    B, T, H, _ = q.shape
    return fused_attention_bwd_reference(q, k, v, o, do, lse.reshape(B * H, 1, T), scale)


def tm_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention over contiguous [B, T, H, D] (square, T <= 1024) -> (o
    [B, T, H, D], lse float32 [B, H, T]).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    on the current stream or raises."""
    _check_tm("tm_attention_fwd", q, k, v)
    if not _on(q, "tm_attention_fwd"):
        return tm_attention_fwd_reference(q, k, v, scale)
    B, T, H, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    _launch("tm_attention_fwd", q, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, T, H, D, _scale(D, scale))
    tm_attention_fwd.launches += 1
    return o, lse


# Launches of the CUDA kernel in this process (the plain version is not counted).
tm_attention_fwd.launches = 0


def tm_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) [B, T, H, D] of ``tm_attention_fwd``'s o from
    q, k, v, the stored o and lse [B, H, T], and the incoming do, all
    contiguous.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    on the current stream or raises."""
    _check_tm("tm_attention_bwd", q, k, v, o, do)
    _check_lse("tm_attention_bwd", q, lse)
    if not _on(q, "tm_attention_bwd"):
        return tm_attention_bwd_reference(q, k, v, o, do, lse, scale)
    B, T, H, D = q.shape
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    _launch("tm_attention_bwd", q, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, T, H, D, _scale(D, scale))
    tm_attention_bwd.launches += 1
    return dq, dk, dv


# Launches of the CUDA kernel in this process (the plain version is not counted).
tm_attention_bwd.launches = 0


class FusedAttentionTM(torch.autograd.Function):
    """Differentiable token-major attention: ``tm_attention_fwd`` forward,
    ``tm_attention_bwd`` backward (the kernels on CUDA tensors, their plain
    versions on CPU tensors), keeping the JAX custom VJP's residuals
    (q, k, v, o, lse). ``apply(q, k, v, scale)`` returns (o, lse); lse is not
    differentiable. An incoming gradient that is not contiguous is copied."""

    @staticmethod
    def forward(ctx, q, k, v, scale=None):
        o, lse = tm_attention_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = tm_attention_bwd(q, k, v, o, do.contiguous(), lse, ctx.scale)
        return dq, dk, dv, None


def fused_attention_tm(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> torch.Tensor:
    """Differentiable token-major attention over contiguous [B, T, H, D]
    (the JAX tool's ``fused_attention_tm``) -> o [B, T, H, D]."""
    return FusedAttentionTM.apply(q, k, v, scale)[0]
