"""Attention dispatch: the hand-written kernels or the plain version.

Port of the JAX package's ``ops/attention.py:120-137, 189-216`` on one
device. Under the kernel backend, a sequence with ``Tq >= pallas_min_t()``
goes to ``ops.flash_attention.flash_attention``, which picks the kernels:
``FusedAttention`` (whole-sequence) when the sequence is square with
``T <= VMEM_PATH_MAX_T`` (read at call time), ``BlockedFusedAttention``
otherwise, for longer sequences (the 192^3 MAE's 1025 and 4097 tokens) and
rectangular ones. Both run their CUDA kernels on a CUDA tensor and their
plain versions on a CPU tensor. Shorter sequences take the plain PyTorch
attention, where the JAX package takes XLA's ``jax.nn.dot_product_attention``.

The sharded and context-parallel branches of the JAX module (``:139-186``)
are not ported yet.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from headct_foundation_tpu_torch.ops import flash_attention as _fa
from headct_foundation_tpu_torch.ops.flash_attention import fused_attention_reference

# "kernel" | "plain" | None (auto: the kernel on CUDA tensors, plain on CPU).
_BACKEND: Optional[str] = None
_PALLAS_MIN_T: Optional[int] = None


def set_attention_backend(name: Optional[str]) -> Optional[str]:
    """Set the backend ("kernel" | "plain" | None = auto). Returns the
    previous raw value, so a caller can restore it exactly."""
    global _BACKEND
    if name not in ("kernel", "plain", None):
        raise ValueError(f"unknown attention backend {name!r}")
    prev = _BACKEND
    _BACKEND = name
    return prev


def get_attention_backend(device: torch.device) -> str:
    if _BACKEND is None:
        return "kernel" if device.type == "cuda" else "plain"
    return _BACKEND


def set_pallas_min_t(n: Optional[int]) -> Optional[int]:
    """Set the kernel/plain crossover sequence length (None = env/default).
    Returns the previous raw value."""
    global _PALLAS_MIN_T
    prev = _PALLAS_MIN_T
    _PALLAS_MIN_T = None if n is None else int(n)
    return prev


def pallas_min_t() -> int:
    """Shortest sequence that takes the kernel; HEADCT_PALLAS_MIN_T is read
    at call time. The default 192 is the JAX package's, not tuned for the GPU."""
    if _PALLAS_MIN_T is not None:
        return _PALLAS_MIN_T
    return int(os.environ.get("HEADCT_PALLAS_MIN_T", "192"))


def dot_product_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: Optional[float] = None
) -> torch.Tensor:
    """Multi-head attention over [B, T, H, D] tensors -> [B, Tq, H, D] in q.dtype.
    Differentiable on every branch: the kernel branches through their own
    backward, the plain branch through autograd."""
    if get_attention_backend(q.device) == "kernel" and q.shape[1] >= pallas_min_t():
        return _fa.flash_attention(q, k, v, scale=scale)
    return fused_attention_reference(q, k, v, scale)[0]
