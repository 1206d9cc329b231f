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
float64 q, k and v (the downstream main's float64 reference mode) take the
plain attention at every length: no kernel takes float64, and each kernel
entry raises on it.

The sharded branches (JAX ``:139-186``), on the port's mesh
(``parallel/mesh.py``):

* ``tensor``: q, k and v arrive with this rank's H / t heads (the
  column-parallel qkv of ``models/attention.py``) and take the same
  dispatch; heads are independent, so nothing else changes.
* ``seq``: inside a trunk whose T tokens are split over the ranks
  (``mesh.token_shard``), q, k and v are this rank's ceil(T / s) tokens,
  the last rank's tail padding. K and V are all-gathered over ``seq``
  (``parallel/comm.py gather_tokens``, whose backward sums the ranks' dK
  and dV partials and keeps this rank's), and ``attend_shard`` runs the Q
  shard against them with ``kv_len`` = T, so the padded keys carry no
  weight; the padded query rows are dropped at the trunk's end and carry
  no gradient. As in JAX (``:207``), the kernel-or-plain choice is taken on
  the global T: a Q shard shorter than ``pallas_min_t()`` still takes the
  blocked kernel when T does not (the 96^3 encoder's 129 tokens on two or
  four ranks), and a trunk shorter than it takes the plain attention over
  the gathered keys.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from headct_foundation_tpu_torch.ops import flash_attention as _fa
from headct_foundation_tpu_torch.ops.flash_attention import fused_attention_reference
from headct_foundation_tpu_torch.parallel import comm, mesh

# "kernel" | "plain" | None (auto: the kernel on CUDA tensors, plain on CPU).
_BACKEND: Optional[str] = None
_PALLAS_MIN_T: Optional[int] = None
# Shortest sequence that takes the kernel by default, here and in the config's
# PARALLEL.PALLAS_MIN_T: the least T of tools/sweep_attention.py's grid (65,
# 129, 192, 257, 513) from which the kernels beat the plain attention forward
# and backward on an H100 (bfloat16, batch 32 and 64). The JAX package's 192
# is its TPU crossover.
DEFAULT_PALLAS_MIN_T = 65


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
    at call time, else ``DEFAULT_PALLAS_MIN_T``."""
    if _PALLAS_MIN_T is not None:
        return _PALLAS_MIN_T
    return int(os.environ.get("HEADCT_PALLAS_MIN_T", DEFAULT_PALLAS_MIN_T))


def _takes_kernel(q: torch.Tensor, t: int) -> bool:
    """The kernel for ``q`` at (global) query count ``t``: the kernel backend,
    at least ``pallas_min_t()`` queries, and not float64."""
    return (get_attention_backend(q.device) == "kernel" and t >= pallas_min_t()
            and q.dtype != torch.float64)


def dot_product_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: Optional[float] = None
) -> torch.Tensor:
    """Multi-head attention over [B, T, H, D] tensors -> [B, Tq, H, D] in q.dtype.
    Differentiable on every branch: the kernel branches through their own
    backward, the plain branch through autograd."""
    t = mesh.current_tokens()
    if t is not None and mesh.current().group("seq") is not None:
        group = mesh.current().group("seq")
        return attend_shard(q, comm.gather_tokens(k, group), comm.gather_tokens(v, group), t,
                            scale=scale)
    if _takes_kernel(q, q.shape[1]):
        return _fa.flash_attention(q, k, v, scale=scale)
    return fused_attention_reference(q, k, v, scale)[0]


def attend_shard(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len: int, *,
                 tq: Optional[int] = None, scale: Optional[float] = None) -> torch.Tensor:
    """One ``seq`` rank's attention: its Q shard [B, Tl, H, D] against the
    gathered (padded) K, V [B, s Tl, H, D], of which the first ``kv_len``
    are real. The kernel or the plain version is chosen on the global
    query count ``tq`` (default ``kv_len``): ``BlockedFusedAttention`` with
    ``kv_len``, else the plain attention over the real keys."""
    tq = kv_len if tq is None else tq
    if _takes_kernel(q, tq):
        return _fa.BlockedFusedAttention.apply(q, k, v, scale, kv_len)[0]
    return fused_attention_reference(q, k[:, :kv_len], v[:, :kv_len], scale)[0]
