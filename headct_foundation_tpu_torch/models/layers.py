"""Normalization layers, the compute-dtype Linear and the initializers.

* ``LayerNorm``: torch-default epsilon (1e-5), statistics in float32, the
  result cast back to the input dtype before the affine.
* ``RMSNorm`` matches the Llama-style reference (reference:
  src/models/layers.py:11-54): normalize in float32, cast back, then scale.
* ``make_norm`` resolves the ``NORM_LAYER`` config string; like the JAX
  package's ``make_norm``, RMSNorm always takes eps 1e-6.

* ``Linear``: flax ``nn.Dense(dtype=..., param_dtype=float32)``: the
  parameters stay float32 and the input, weight and bias are cast to the
  compute ``dtype`` at use, so the output is in ``dtype``.
* ``trunc_normal_`` / ``xavier_uniform_``: the JAX package's initializers
  (``models/layers.py:135`` truncated normal, std 0.02 clipped at 2 std;
  flax ``xavier_uniform``), drawn from an explicit ``torch.Generator``.

Parameter names follow the reference torch modules (``weight``, ``bias``),
which is what the JAX package's ``tree_to_torch`` emits.
"""

from __future__ import annotations

import math
from typing import Optional

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


class Linear(nn.Linear):
    """``nn.Linear`` with float32 parameters computed in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


@torch.no_grad()
def trunc_normal_(t: torch.Tensor, std: float = 0.02,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Normal(0, std) truncated to +-2 std."""
    return nn.init.trunc_normal_(t, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)


@torch.no_grad()
def xavier_uniform_(weight: torch.Tensor,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """U(-b, b), b = sqrt(6 / (fan_in + fan_out)), for a [out, in] weight."""
    bound = math.sqrt(6.0 / (weight.shape[0] + weight.shape[1]))
    return weight.uniform_(-bound, bound, generator=generator)
