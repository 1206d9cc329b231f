"""Multi-crop forward for DINO.

Port of the JAX package's ``models/multicrop.py:22-54`` (reference:
src/utils/misc.py:447-484 ``MultiCropWrapper``): consecutive crops of one
full spatial shape go through the backbone as one batch, the CLS feature of
each crop is kept, and the head runs once over all of them. At the shipped
config every crop is resized to 96^3, so the student's crops make one
batched pass and the teacher's two global crops another.

``DINOModel`` holds a backbone and a head under those names, the layout of
the JAX package's ``{'backbone', 'head'}`` parameter tree.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
from torch import nn

from headct_foundation_tpu_torch.parallel import mesh


def multicrop_forward(backbone: Callable, head: Callable, crops: Sequence[torch.Tensor],
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """crops: [B, C, H, W, D] batches -> head output [len(crops) * B, K], crop
    order kept. ``backbone(x, generator, cls_only=True)`` returns (the CLS
    features [N, C], hidden states); ``generator`` draws its dropout masks,
    each pass's as the global batch's blocks of crops
    (``mesh.global_dropout``)."""
    features: List[torch.Tensor] = []
    start = 0
    while start < len(crops):
        end = start
        shape = crops[start].shape[2:]
        while end < len(crops) and crops[end].shape[2:] == shape:
            end += 1
        with mesh.global_dropout(end - start):
            cls, _ = backbone(torch.cat(list(crops[start:end]), dim=0), generator,
                              cls_only=True)
        features.append(cls)  # the CLS feature of each crop
        start = end
    return head(torch.cat(features, dim=0))


class DINOModel(nn.Module):
    """A student or teacher network: ``backbone`` (the ViT) and ``head``."""

    def __init__(self, backbone: nn.Module, head: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.head = head

    def forward(self, crops: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return multicrop_forward(self.backbone, self.head, crops, generator)
