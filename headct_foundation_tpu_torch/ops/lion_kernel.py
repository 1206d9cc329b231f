"""Fused Lion update: the CUDA kernel B6 and its plain version.

Port of the JAX package's ``ops/lion_kernel.py``: ``lion_update_leaf`` (``:45``,
kernel ``_lion_kernel`` at ``:31``), with its contract, per element in
float32::

    delta = -lr * wd * p - lr * sign(b1 * m + (1 - b1) * g)
    m_new = b2 * m + (1 - b2) * g

delta in p's dtype, m_new in float32; p and g float32 or bfloat16, m float32.
On a CUDA tensor ``lion_update_leaf`` launches ``csrc/lion_update.cu`` or
raises; on a CPU tensor it runs ``lion_update_leaf_reference``, which takes
the same float32 operations in the same order, with lr, wd, b1 and b2 as
float32 0-d tensors and 1 - b1, 1 - b2 formed in float32, as the TPU kernel's
SMEM scalars are. sign keeps a NaN (``jnp.sign`` does; ``torch.sign`` gives 0).
The wrapper counts its CUDA launches in ``lion_update_leaf.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from headct_foundation_tpu_torch.ops import _build
from headct_foundation_tpu_torch.ops.flash_attention import _on

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def sign_keep_nan(x: torch.Tensor) -> torch.Tensor:
    """sign(x) with sign(NaN) = NaN, as ``jnp.sign`` and the kernel give it."""
    return torch.where(torch.isnan(x), x, torch.sign(x))


@functools.lru_cache(maxsize=None)
def _c_entry():
    """The kernel's C entry point, its library built and loaded at first use."""
    fn = _build.load("lion_update").headct_lion_update
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_float] * 4
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def lion_update_leaf_reference(
    p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, lr: float, wd: float, b1: float,
    b2: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: one float32 op at a time, in the
    TPU kernel's order. Returns (delta in p's dtype, m_new float32)."""
    lr, wd, b1, b2, one = (torch.tensor(float(x), dtype=torch.float32, device=p.device)
                           for x in (lr, wd, b1, b2, 1.0))
    p32, g32 = p.float(), g.float()
    update = sign_keep_nan(m * b1 + (one - b1) * g32)
    delta = -lr * wd * p32 - lr * update
    m_new = m * b2 + (one - b2) * g32
    return delta.to(p.dtype), m_new


def _check(p, g, m, m_out) -> None:
    """Raise on what the kernel does not take."""
    tensors = {"p": p, "g": g, "m": m, **({} if m_out is None else {"m_out": m_out})}
    if len({x.device for x in tensors.values()}) != 1:
        raise ValueError(f"lion_update_leaf: tensors on different devices "
                         f"{ {n: str(x.device) for n, x in tensors.items()} }")
    if p.dtype not in _DTYPES or g.dtype not in _DTYPES or any(
            x.dtype != torch.float32 for n, x in tensors.items() if n.startswith("m")):
        raise TypeError(f"lion_update_leaf takes float32 or bfloat16 p and g and float32 m; "
                        f"got {[str(x.dtype) for x in tensors.values()]}")
    if any(x.shape != p.shape for x in tensors.values()) or p.numel() < 1:
        raise ValueError(f"lion_update_leaf takes equal, non-empty shapes; got "
                         f"{[tuple(x.shape) for x in tensors.values()]}")
    if not all(x.is_contiguous() for x in tensors.values()):
        raise ValueError("lion_update_leaf takes contiguous tensors")


def lion_update_leaf(
    p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, lr: float, wd: float, b1: float,
    b2: float, *, m_out: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused Lion update of one parameter tensor -> (delta in p's dtype,
    m_new float32). ``m_out`` (which may be ``m`` itself) receives m_new in
    place; otherwise m_new is a new tensor.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    on the current stream or raises."""
    _check(p, g, m, m_out)
    if not _on(p, "lion_update_leaf"):
        delta, m_new = lion_update_leaf_reference(p, g, m, lr, wd, b1, b2)
        return delta, m_new if m_out is None else m_out.copy_(m_new)
    delta = torch.empty_like(p)
    m_new = torch.empty_like(m) if m_out is None else m_out
    rc = _c_entry()(p.data_ptr(), g.data_ptr(), m.data_ptr(), delta.data_ptr(), m_new.data_ptr(),
                    p.numel(), float(lr), float(wd), float(b1), float(b2), _DTYPES[p.dtype],
                    _DTYPES[g.dtype], torch.cuda.current_stream(p.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lion_update kernel launch failed: cudaError {rc} at "
                           f"{tuple(p.shape)} {p.dtype}")
    lion_update_leaf.launches += 1
    return delta, m_new


# Launches of the CUDA kernel in this process (the plain version is not counted).
lion_update_leaf.launches = 0
