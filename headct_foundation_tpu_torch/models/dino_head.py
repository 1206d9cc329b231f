"""DINO projection head.

Port of the JAX package's ``models/dino_head.py:20-99`` (reference:
src/models/dino_head.py:7-41): an MLP of ``nlayers`` Linears with GELU
between them, an L2 normalisation in float32 (floor 1e-12), then a
weight-normalised last Linear onto the prototypes.

* ``WeightNormDense`` keeps torch's ``weight_norm`` split as two parameters,
  ``weight_v`` [out, in] and ``weight_g`` [out, 1], so reference checkpoints
  map one to one and the frozen gain (``NORM_LAST_LAYER``) is an optimizer
  mask. The norm is taken in float32 and the weight then cast for the product.
* ``DINOHead``'s Linears sit at ``mlp.0``, ``mlp.2``, ... (the reference's
  ``nn.Sequential`` with GELU between them), the names the JAX package's
  ``tree_to_torch`` gives ``mlp_0``, ``mlp_1``, ...; parameters are float32,
  computed in ``dtype``.
* ``use_bn=True`` (the BatchNorm head) raises NotImplementedError (ROADMAP
  A.10: the head's BatchNorm layers, their statistics in the DINO state and
  checkpoints). The shipped config sets ``DINO.USE_BN: False``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from headct_foundation_tpu_torch.models.attention import gelu
from headct_foundation_tpu_torch.models.layers import Linear, trunc_normal_


class _GELU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gelu(x)


class WeightNormDense(nn.Module):
    """A Linear without bias whose weight is g * v / ||v|| (row norms)."""

    def __init__(self, in_dim: int, out_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight_v = nn.Parameter(torch.zeros(out_dim, in_dim))
        self.weight_g = nn.Parameter(torch.ones(out_dim, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        v32 = self.weight_v.float()
        w = self.weight_g.float() * v32 / torch.linalg.vector_norm(v32, dim=1, keepdim=True)
        return x.to(self.dtype) @ w.to(self.dtype).t()


class DINOHead(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, use_bn: bool = False,
                 norm_last_layer: bool = True, nlayers: int = 3, hidden_dim: int = 2048,
                 bottleneck_dim: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        if use_bn:
            raise NotImplementedError(
                "DINO.USE_BN: True (the BatchNorm head) is not ported yet (ROADMAP A.10). "
                "Set DINO.USE_BN: False")
        self.norm_last_layer = norm_last_layer  # read by the engine's trainable mask
        nlayers = max(nlayers, 1)
        dims = [in_dim] + [hidden_dim] * (nlayers - 1) + [bottleneck_dim]
        layers = []
        for i in range(nlayers):
            if i:
                layers.append(_GELU())
            layers.append(Linear(dims[i], dims[i + 1], dtype=dtype))
        self.mlp = nn.Sequential(*layers)
        self.last_layer = WeightNormDense(bottleneck_dim, out_dim, dtype=dtype)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> "DINOHead":
        """The JAX head's initializers: truncated normal (std 0.02) kernels
        and ``weight_v``, zero biases, unit ``weight_g``."""
        for mod in self.mlp:
            if isinstance(mod, nn.Linear):
                trunc_normal_(mod.weight, generator=generator)
                mod.bias.zero_()
        trunc_normal_(self.last_layer.weight_v, generator=generator)
        self.last_layer.weight_g.fill_(1.0)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = self.mlp(x).float()
        x = x32 / torch.clamp_min(torch.linalg.vector_norm(x32, dim=-1, keepdim=True), 1e-12)
        return self.last_layer(x.to(self.last_layer.dtype))
