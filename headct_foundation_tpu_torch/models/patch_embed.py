"""3D patch embedding as patchify + one matmul.

The reference embeds patches with a Conv3d whose kernel equals its stride
(reference: src/utils/patch_embedding.py:102-105). That convolution is
exactly a block reshape followed by one [B*L, patch_dim] x [patch_dim, C]
matmul, which is how the JAX package computes it; the port does the same.
The matmul route also keeps the float32 forward out of cuDNN, whose
convolutions run in TF32 by default.

Parameters stay float32; ``dtype`` is the compute dtype that patches,
weight, bias and position embedding are cast to, as flax's ``dtype`` /
``param_dtype`` (JAX ``models/patch_embed.py:120-135``).

An input whose spatial size is not ``img_size`` takes the position
embedding interpolated to its own patch grid, which may be non-cubic
(``interpolate_pos_embed(pe, 0, new_grid=spatial // patch)``, JAX
``:119-137``; reference: src/utils/patch_embedding.py:135-146). A size that
the patch does not divide raises.

Dropout (JAX ``:115,137``) follows the position embedding in ``train()``
mode at a rate above 0, its mask drawn from the ``generator`` handed to
``forward``.

The weight is stored in the reference's Conv3d layout,
``patch_embeddings.weight`` [O, C, ph, pw, pd], so reference and exported
checkpoints load by name, and is folded to [(ph pw pd C), O] at use.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from headct_foundation_tpu_torch.models.layers import dropout
from headct_foundation_tpu_torch.models.pos_embed import (
    build_sincos_position_embedding,
    interpolate_pos_embed,
)


def patchify3d(x: torch.Tensor, patch_size: Sequence[int]) -> torch.Tensor:
    """[B, C, H, W, D] -> [B, gh*gw*gd, ph*pw*pd*C] in reference order."""
    B, C, H, W, D = x.shape
    ph, pw, pd = patch_size
    gh, gw, gd = H // ph, W // pw, D // pd
    x = x.reshape(B, C, gh, ph, gw, pw, gd, pd)
    # (B, gh, gw, gd, ph, pw, pd, C) — the reference's permute(0,2,4,6,3,5,7,1)
    x = x.permute(0, 2, 4, 6, 3, 5, 7, 1)
    return x.reshape(B, gh * gw * gd, ph * pw * pd * C)


def unpatchify3d(x: torch.Tensor, patch_size: Sequence[int],
                 out_shape: Sequence[int]) -> torch.Tensor:
    """[B, L, ph*pw*pd*C] -> [B, C, H, W, D], ``patchify3d``'s inverse
    (reference: mae.py:172-192; JAX ``models/patch_embed.py:43-53``)."""
    B = x.shape[0]
    C, H, W, D = out_shape
    ph, pw, pd = patch_size
    gh, gw, gd = H // ph, W // pw, D // pd
    x = x.reshape(B, gh, gw, gd, ph, pw, pd, C)
    x = x.permute(0, 7, 1, 4, 2, 5, 3, 6)
    return x.reshape(B, C, gh * ph, gw * pw, gd * pd)


class _ConvParams(nn.Module):
    """Holds a Conv3d's ``weight`` [O, C, ph, pw, pd] and ``bias`` [O] under
    the reference's names; never run as a convolution."""

    def __init__(self, in_channels: int, out_channels: int, patch_size: Tuple[int, int, int]):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_channels, in_channels, *patch_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))


class PatchEmbeddingBlock(nn.Module):
    """Patch embedding + position embedding for 3D volumes."""

    def __init__(
        self,
        img_size: Tuple[int, int, int],
        patch_size: Tuple[int, int, int],
        in_channels: int,
        hidden_size: int,
        pos_embed: str = "learnable",
        dropout_rate: float = 0.0,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        self.dropout_sites = (":0", ":1")  # set by label_dropout_sites
        for m, p in zip(img_size, patch_size):
            if m < p:
                raise ValueError("patch_size should be smaller than img_size")
            if m % p != 0:
                raise ValueError("img_size must be divisible by patch_size")
        self.img_size = tuple(img_size)
        self.patch_size = tuple(patch_size)
        self.grid_size = tuple(m // p for m, p in zip(img_size, patch_size))
        n_patches = int(np.prod(self.grid_size))
        self.patch_embeddings = _ConvParams(in_channels, hidden_size, self.patch_size)
        if pos_embed == "none":
            self.position_embeddings = None
        elif pos_embed == "learnable":
            self.position_embeddings = nn.Parameter(torch.zeros(1, n_patches, hidden_size))
        elif pos_embed == "sincos":
            # A frozen parameter, as in the reference, so checkpoints carry it.
            init = build_sincos_position_embedding(self.grid_size, hidden_size, 3)
            self.position_embeddings = nn.Parameter(
                torch.from_numpy(init), requires_grad=False
            )
        else:
            raise ValueError(f"pos_embed type {pos_embed} not supported")

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """[B, C, H, W, D] -> [B, L, hidden]."""
        spatial = tuple(x.shape[2:])
        if any(s % p for s, p in zip(spatial, self.patch_size)):
            raise ValueError(f"input spatial size {spatial} is not divisible by the patch size "
                             f"{self.patch_size}")
        dt = self.dtype
        w = self.patch_embeddings.weight
        kernel = w.permute(2, 3, 4, 1, 0).reshape(-1, w.shape[0]).to(dt)
        tokens = patchify3d(x, self.patch_size).to(dt) @ kernel
        tokens = tokens + self.patch_embeddings.bias.to(dt)
        if self.position_embeddings is not None:
            pe = self.position_embeddings
            if spatial != self.img_size:  # the input's own grid, which may be non-cubic
                pe = interpolate_pos_embed(
                    pe, 0, new_grid=tuple(s // p for s, p in zip(spatial, self.patch_size)))
            tokens = tokens + pe.to(dt)
        return dropout(tokens, self.dropout_rate if self.training else 0.0, generator,
                       site=self.dropout_sites[0])
