"""Normalization layers.

* ``LayerNorm``: torch-default epsilon (1e-5), statistics in float32, the
  result cast back to the input dtype before the affine.
* ``RMSNorm`` matches the Llama-style reference (reference:
  src/models/layers.py:11-54): normalize in float32, cast back, then scale.
* ``make_norm`` resolves the ``NORM_LAYER`` config string; like the JAX
  package's ``make_norm``, RMSNorm always takes eps 1e-6.

Parameter names follow the reference torch modules (``weight``, ``bias``),
which is what the JAX package's ``tree_to_torch`` emits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.dim = dim
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (self.dim,), eps=self.eps).to(x.dtype)
        return y * self.weight.to(x.dtype) + self.bias.to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        norm = xf * torch.reciprocal(
            torch.sqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + self.eps)
        )
        return norm.to(x.dtype) * self.weight.to(x.dtype)


def make_norm(norm_layer: str, dim: int, eps: float = 1e-5) -> nn.Module:
    """Build a norm module from a config string ('layernorm' | 'rmsnorm')."""
    norm_layer = norm_layer.lower()
    if norm_layer == "layernorm":
        return LayerNorm(dim, eps=eps)
    if norm_layer == "rmsnorm":
        return RMSNorm(dim, eps=1e-6)
    raise ValueError(f"Unknown norm layer: {norm_layer}")
