"""Downstream classification heads.

Port of the JAX package's ``models/classifier.py:24-115`` (reference:
src/models/classifier.py:7-100):

* ``LinearClassifier``: an affine-free ``TorchBatchNorm`` (eps 1e-6, the JAX
  momentum 0.9) over the CLS features, then a Linear.
* ``AttentionClassifier``: a learned query token cross-attending over all
  tokens, with an affine-free BatchNorm before (over the batch and the
  tokens, channels last) and after, the mean over the queries, then a
  Linear. The reference pre-scales q by ``D**-0.5`` and then attends with
  the default scale, so the effective scale is ``1/D``. Its ``Tq = 1`` query
  is below ``pallas_min_t()``, so ``ops.attention`` gives it the plain
  attention, as the JAX package gives it XLA's: the head launches no kernel.

The BatchNorm statistics are the global batch's under ``torch.distributed``
(``models/layers.py TorchBatchNorm``), as the JAX package's BatchNorm under
jit sees the whole sharded batch. Parameters are float32 and computed in
``dtype``; each BatchNorm returns float32. Names are ``tree_to_torch``'s:
``bn``, ``bn1``, ``bn2`` (``running_mean``, ``running_var``), ``wkv``,
``linear``, ``cls_token``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from headct_foundation_tpu_torch.models.layers import Linear, TorchBatchNorm, trunc_normal_
from headct_foundation_tpu_torch.ops.attention import dot_product_attention


@torch.no_grad()
def _lecun_normal_(linear: nn.Linear, generator: Optional[torch.Generator]) -> None:
    """flax ``nn.Dense``'s default init: a normal of variance 1 / fan_in
    truncated at 2 std (std corrected for the truncation), zero bias."""
    std = math.sqrt(1.0 / linear.in_features) / 0.87962566103423978
    nn.init.trunc_normal_(linear.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
    if linear.bias is not None:
        linear.bias.zero_()


class LinearClassifier(nn.Module):
    def __init__(self, dim: int, num_classes: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.bn = TorchBatchNorm(dim, eps=1e-6)
        self.linear = Linear(dim, num_classes, dtype=dtype)

    def init_weights(self, generator: Optional[torch.Generator] = None) -> "LinearClassifier":
        _lecun_normal_(self.linear, generator)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, C] features -> [B, num_classes] logits in ``dtype``."""
        return self.linear(self.bn(x))


class AttentionClassifier(nn.Module):
    def __init__(self, dim: int, num_classes: int, num_heads: int = 12, qkv_bias: bool = False,
                 qk_scale: Optional[float] = None, num_queries: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.num_queries = num_queries
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.dtype = dtype
        self.cls_token = nn.Parameter(torch.zeros(1, num_queries, dim))
        self.bn1 = TorchBatchNorm(dim, eps=1e-6)
        self.wkv = Linear(dim, 2 * dim, bias=qkv_bias, dtype=dtype)
        self.bn2 = TorchBatchNorm(dim, eps=1e-6)
        self.linear = Linear(dim, num_classes, dtype=dtype)

    def init_weights(self, generator: Optional[torch.Generator] = None
                     ) -> "AttentionClassifier":
        trunc_normal_(self.cls_token, std=0.02, generator=generator)
        _lecun_normal_(self.wkv, generator)
        _lecun_normal_(self.linear, generator)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, N, C] tokens -> [B, num_classes] logits in ``dtype``."""
        B, N, C = x.shape
        H, nq = self.num_heads, self.num_queries
        q = self.cls_token.to(self.dtype).expand(B, nq, C).reshape(B, nq, H, C // H)
        kv = self.wkv(self.bn1(x)).reshape(B, N, 2, H, C // H)
        # the reference's pre-scaled q, then the default 1/sqrt(D): 1/D in all
        y = dot_product_attention(q * self.scale, kv[:, :, 0], kv[:, :, 1])
        y = self.bn2(y.reshape(B, nq, C)).mean(dim=1)
        return self.linear(y)
