"""Device-side MAE augmentation.

Port of the JAX package's ``data/augment.py:45-62, 246-257`` (reference:
src/data/transforms.py:181-255, ``mae3d_transforms``): per sample, a flip
along each spatial axis with p = 0.1, then an additive intensity shift
drawn from U(-0.1, 0.1) applied with p = 0.5 and added in the batch's dtype.
``reshape=True``, the training setting, skips the Gaussian smoothing; the
smoothing (``reshape=False``) is not ported yet and raises.

The random decisions are drawn apart from their application
(``draw_mae_augment`` / ``apply_mae_augment``), so a test can hand the
port the decisions that ``jax.random`` drew for the JAX package.
Volumes are [B, C, H, W, D].
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

FLIP_PROB = 0.1
SHIFT_OFFSET = 0.1
SHIFT_PROB = 0.5

Decisions = Dict[str, torch.Tensor]


def draw_mae_augment(batch: int, generator: Optional[torch.Generator],
                     device: torch.device) -> Decisions:
    """The per-sample decisions of one ``mae_augment`` call:
    ``flip`` bool [3, B] (spatial axes 1, 2, 3), ``shift`` float32 [B] and
    ``shift_on`` bool [B]."""
    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=device)

    return {
        "flip": uniform(3, batch) < FLIP_PROB,
        "shift": (uniform(batch) * 2.0 - 1.0) * SHIFT_OFFSET,
        "shift_on": uniform(batch) < SHIFT_PROB,
    }


def rand_flip(x: torch.Tensor, do: torch.Tensor, axis: int) -> torch.Tensor:
    """Flip the samples where ``do`` [B] is set along spatial ``axis``
    (1-indexed after the channel axis)."""
    view = (-1,) + (1,) * (x.dim() - 1)
    return torch.where(do.reshape(view), torch.flip(x, dims=(axis + 1,)), x)


def rand_shift_intensity(x: torch.Tensor, shift: torch.Tensor,
                         do: torch.Tensor) -> torch.Tensor:
    """x + shift [B] (cast to x's dtype) where ``do`` [B] is set."""
    view = (-1,) + (1,) * (x.dim() - 1)
    return torch.where(do.reshape(view), x + shift.to(x.dtype).reshape(view), x)


def apply_mae_augment(x: torch.Tensor, decisions: Decisions) -> torch.Tensor:
    for axis in range(3):
        x = rand_flip(x, decisions["flip"][axis].to(x.device), axis + 1)
    return rand_shift_intensity(x, decisions["shift"].to(x.device),
                                decisions["shift_on"].to(x.device))


def mae_augment(x: torch.Tensor, generator: Optional[torch.Generator] = None,
                reshape: bool = True) -> torch.Tensor:
    """Train-time MAE augmentation with decisions drawn from ``generator``."""
    if not reshape:
        raise NotImplementedError(
            "mae_augment(reshape=False) adds a random Gaussian smoothing that is not "
            "ported yet (JAX data/augment.py:88 rand_gaussian_smooth)")
    return apply_mae_augment(x, draw_mae_augment(x.shape[0], generator, x.device))
