"""3D sin-cos positional embeddings.

Mirrors the JAX package's ``models/pos_embed.py`` (reference:
src/utils/pos_embed.py:10-85), including its axis quirk for 3D grids where
the first meshgrid axis ranges over ``w`` and the second over ``h``, and the
channel order [sin(w), cos(w), sin(h), cos(h), sin(d), cos(d)]. Computed in
float64 numpy, then cast to float32.

Resolution interpolation (``interpolate_pos_embed``) is not ported yet: the
serving path always feeds ``img_size`` volumes, and the patch embedding
raises on any other spatial size.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np


def _to_tuple(x: Union[int, Sequence[int]], n: int) -> Tuple[int, ...]:
    if isinstance(x, (int, np.integer)):
        return (int(x),) * n
    t = tuple(int(v) for v in x)
    if len(t) != n:
        raise ValueError(f"expected {n} dims, got {t}")
    return t


def build_sincos_position_embedding(
    grid_size: Union[int, Sequence[int]],
    embed_dim: int,
    spatial_dims: int = 3,
    temperature: float = 10000.0,
) -> np.ndarray:
    """Fixed sin-cos position embedding of shape [1, prod(grid), embed_dim]."""
    if spatial_dims == 2:
        h, w = _to_tuple(grid_size, 2)
        if embed_dim % 4:
            raise ValueError("embed_dim must be divisible by 4 for 2D sincos")
        pos_dim = embed_dim // 4
        omega = 1.0 / (temperature ** (np.arange(pos_dim, dtype=np.float64) / pos_dim))
        gh, gw = np.meshgrid(np.arange(h, dtype=np.float64),
                             np.arange(w, dtype=np.float64), indexing="ij")
        out_h = np.einsum("m,d->md", gh.flatten(), omega)
        out_w = np.einsum("m,d->md", gw.flatten(), omega)
        emb = np.concatenate(
            [np.sin(out_h), np.cos(out_h), np.sin(out_w), np.cos(out_w)], axis=1
        )
    elif spatial_dims == 3:
        h, w, d = _to_tuple(grid_size, 3)
        if embed_dim % 6:
            raise ValueError("embed_dim must be divisible by 6 for 3D sincos")
        pos_dim = embed_dim // 6
        omega = 1.0 / (temperature ** (np.arange(pos_dim, dtype=np.float64) / pos_dim))
        # Reference quirk: the first meshgrid axis ranges over `w`, the second
        # over `h` (reference: src/utils/pos_embed.py:54-56).
        gh, gw, gd = np.meshgrid(
            np.arange(w, dtype=np.float64),
            np.arange(h, dtype=np.float64),
            np.arange(d, dtype=np.float64),
            indexing="ij",
        )
        out_h = np.einsum("m,d->md", gh.flatten(), omega)
        out_w = np.einsum("m,d->md", gw.flatten(), omega)
        out_d = np.einsum("m,d->md", gd.flatten(), omega)
        emb = np.concatenate(
            [
                np.sin(out_w), np.cos(out_w),
                np.sin(out_h), np.cos(out_h),
                np.sin(out_d), np.cos(out_d),
            ],
            axis=1,
        )
    else:
        raise NotImplementedError(f"spatial_dims={spatial_dims} not implemented")
    return emb[None].astype(np.float32)
