"""3D sin-cos positional embeddings.

Mirrors the JAX package's ``models/pos_embed.py`` (reference:
src/utils/pos_embed.py:10-85), including its axis quirk for 3D grids where
the first meshgrid axis ranges over ``w`` and the second over ``h``, and the
channel order [sin(w), cos(w), sin(h), cos(h), sin(d), cos(d)]. Computed in
float64 numpy, then cast to float32.

``interpolate_pos_embed`` (JAX ``models/pos_embed.py:91-144``) resizes the
patch tokens of a position embedding to another grid, at checkpoint load
(``utils/torch_interop.py merge_params``) and in the forward of an input of
another size (``models/patch_embed.py``). It reproduces
``jax.image.resize(method="linear")``, antialiasing included: per axis a
weight matrix as ``jax.image.scale_and_translate`` builds it (a triangle
kernel at half-pixel centres, widened by 1 / scale when the axis shrinks,
each output's weights normalised to sum to 1), applied as three small
products. ``torch.nn.functional.interpolate(mode="trilinear")`` has no
antialias in 3-D and matches JAX only when every axis grows.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch


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


def nth_root(n: int, k: int) -> int:
    """Greatest integer x with x**k <= n (reference: src/utils/pos_embed.py:87-95)."""
    x = int(n ** (1.0 / k))
    while (x + 1) ** k <= n:
        x += 1
    while x**k > n:
        x -= 1
    return x


def linear_resize_weights(in_size: int, out_size: int) -> torch.Tensor:
    """[in_size, out_size] float32 weights of ``jax.image.resize(method=
    "linear")`` along one axis (``jax.image.compute_weight_mat`` at scale
    out / in, translation 0, antialias on)."""
    scale = np.float32(out_size / in_size)
    inv_scale = np.float32(1.0) / scale
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = (torch.arange(out_size, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(in_size, dtype=torch.float32)[:, None]).abs()
    w = torch.clamp_min(1.0 - x / kernel_scale, 0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def interpolate_pos_embed(
    pos_embed: torch.Tensor,
    num_extra_tokens: int,
    new_num_patches: Optional[int] = None,
    spatial_dims: int = 3,
    new_grid: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """A [1, T, C] position embedding resized to another grid; the first
    ``num_extra_tokens`` (CLS, registers) pass through unchanged.

    The source grid must be cubic. The target is the cube of
    ``new_num_patches`` or ``new_grid=(gh, gw, gd)``, which may be
    non-cubic. The identity returns ``pos_embed`` itself. The resize runs
    in float32 on ``pos_embed``'s device and returns its dtype."""
    embed_dim = pos_embed.shape[-1]
    orig_num_patches = pos_embed.shape[-2] - num_extra_tokens
    orig_size = nth_root(orig_num_patches, spatial_dims)
    if orig_size**spatial_dims != orig_num_patches:
        raise ValueError(
            f"interpolate_pos_embed requires a cubic source grid; got "
            f"{orig_num_patches} patches (not a perfect {spatial_dims}-cube)")
    if new_grid is not None:
        new_grid = tuple(int(g) for g in new_grid)
        if len(new_grid) != spatial_dims:
            raise ValueError(f"new_grid {new_grid} vs spatial_dims {spatial_dims}")
    else:
        if new_num_patches is None:
            raise ValueError("pass new_num_patches or new_grid")
        new_size = nth_root(new_num_patches, spatial_dims)
        if new_size**spatial_dims != new_num_patches:
            raise ValueError(
                f"target count {new_num_patches} is not a perfect "
                f"{spatial_dims}-cube; pass new_grid=(gh, gw, gd) instead")
        new_grid = (new_size,) * spatial_dims
    if new_grid == (orig_size,) * spatial_dims:
        return pos_embed

    extra = pos_embed[:, :num_extra_tokens]
    tokens = pos_embed[:, num_extra_tokens:].float().reshape(
        (orig_size,) * spatial_dims + (embed_dim,))
    letters = "xyz"[:spatial_dims]
    for axis, n in enumerate(new_grid):  # one [in, out] product per axis that changes
        if n == orig_size:
            continue
        w = linear_resize_weights(orig_size, n).to(tokens.device)
        src = letters + "c"
        dst = src.replace(letters[axis], "o")
        tokens = torch.einsum(f"{src},{letters[axis]}o->{dst}", tokens, w)
    tokens = tokens.reshape(1, int(np.prod(new_grid)), embed_dim).to(pos_embed.dtype)
    return torch.cat([extra, tokens], dim=1)
