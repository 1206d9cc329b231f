"""Uniform random token masking for the MAE.

Port of the JAX package's ``ops/masking.py:18-48`` (reference:
src/models/mae.py:194-218): iid uniform noise per token, a stable argsort
for the shuffle, keep the first ``int(L * (1 - mask_ratio))`` tokens, and
derive the binary mask and the restore indices. The noise [N, L] can be
passed in, so a test gives the port the noise ``jax.random`` drew.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def random_masking(
    x: torch.Tensor, mask_ratio: float, generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mask tokens of x [N, L, D].

    Returns x_masked [N, len_keep, D], mask [N, L] in x's dtype (1 = removed,
    original token order), ids_restore [N, L] and ids_keep [N, len_keep]."""
    N, L, D = x.shape
    len_keep = int(L * (1 - mask_ratio))
    if noise is None:
        noise = torch.rand((N, L), generator=generator, device=x.device)
    elif noise.shape != (N, L):
        raise ValueError(f"noise must be [{N}, {L}], got {tuple(noise.shape)}")
    noise = noise.to(x.device)
    ids_shuffle = torch.argsort(noise, dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    ids_keep = ids_shuffle[:, :len_keep]
    x_masked = torch.gather(x, 1, ids_keep[:, :, None].expand(-1, -1, D))
    mask = torch.ones((N, L), dtype=x.dtype, device=x.device)
    mask[:, :len_keep] = 0
    mask = torch.gather(mask, 1, ids_restore)
    return x_masked, mask, ids_restore, ids_keep
