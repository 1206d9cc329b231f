"""3D Vision Transformer backbone.

Port of the JAX package's ``models/vit.py`` (reference:
src/models/vit.py:25-173): patch embed -> prepend CLS -> register tokens
after CLS (arXiv 2309.16588) -> N pre-norm blocks, collecting each block's
output -> final norm (eps 1e-6) -> optional Tanh classification head.
``forward`` returns ``(x, hidden_states_out)`` like the reference.

Parameter names are the reference torch names that the JAX package's
``tree_to_torch`` emits (``blocks.3.attn.qkv.weight``, ``cls_token``, ...),
so an exported JAX parameter tree loads with ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from headct_foundation_tpu_torch.models.attention import AttentionBlock
from headct_foundation_tpu_torch.models.layers import make_norm
from headct_foundation_tpu_torch.models.patch_embed import PatchEmbeddingBlock
from headct_foundation_tpu_torch.models.pos_embed import _to_tuple


class ViT(nn.Module):
    def __init__(
        self,
        in_chans: int,
        img_size: Union[int, Sequence[int]],
        patch_size: Union[int, Sequence[int]],
        hidden_size: int = 768,
        mlp_dim: int = 3072,
        num_layers: int = 12,
        num_heads: int = 12,
        pos_embed: str = "learnable",
        classification: bool = False,
        num_classes: int = 2,
        num_register_tokens: int = 0,
        post_activation: str = "Tanh",
        qkv_bias: bool = False,
        norm_layer: str = "layernorm",
    ):
        super().__init__()
        if hidden_size % num_heads != 0:
            raise ValueError("hidden_size should be divisible by num_heads.")
        if num_register_tokens < 0:
            raise ValueError("num_register_tokens must be >= 0")
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_register_tokens = num_register_tokens
        self.patch_size = _to_tuple(patch_size, 3)
        self.classification = classification
        self.post_activation = post_activation
        self.patch_embedding = PatchEmbeddingBlock(
            img_size=_to_tuple(img_size, 3),
            patch_size=self.patch_size,
            in_channels=in_chans,
            hidden_size=hidden_size,
            pos_embed=pos_embed,
        )
        self.cls_token = nn.Parameter(torch.zeros(1, 1, hidden_size))
        if num_register_tokens:
            self.register_tokens = nn.Parameter(torch.zeros(1, num_register_tokens, hidden_size))
        else:
            self.register_tokens = None
        self.blocks = nn.ModuleList(
            AttentionBlock(hidden_size, mlp_dim, num_heads, qkv_bias=qkv_bias,
                           norm_layer=norm_layer)
            for _ in range(num_layers)
        )
        self.norm = make_norm(norm_layer, hidden_size, eps=1e-6)
        if classification:
            self.classification_head = nn.Linear(hidden_size, num_classes)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> "ViT":
        """Random init drawn from ``generator``, following the JAX package's
        initializers: xavier-uniform Linear weights, zero biases, truncated
        normal (std 0.02) patch and learnable position embeddings, unit norms,
        zero CLS/register tokens. The sincos embedding stays fixed."""
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                bound = math.sqrt(6.0 / (mod.in_features + mod.out_features))
                mod.weight.uniform_(-bound, bound, generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
        pe = self.patch_embedding
        nn.init.trunc_normal_(pe.patch_embeddings.weight, std=0.02, a=-0.04, b=0.04,
                              generator=generator)
        pe.patch_embeddings.bias.zero_()
        if pe.position_embeddings is not None and pe.position_embeddings.requires_grad:
            nn.init.trunc_normal_(pe.position_embeddings, std=0.02, a=-0.04, b=0.04,
                                  generator=generator)
        return self

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        x = self.patch_embedding(x)
        B = x.shape[0]
        tokens = [self.cls_token.to(x.dtype).expand(B, -1, -1)]
        if self.register_tokens is not None:
            tokens.append(self.register_tokens.to(x.dtype).expand(B, -1, -1))
        tokens.append(x)
        x = torch.cat(tokens, dim=1)

        hidden_states_out: List[torch.Tensor] = []
        for blk in self.blocks:
            x = blk(x)
            hidden_states_out.append(x)
        x = self.norm(x)

        if self.classification:
            logits = self.classification_head(x[:, 0])
            if self.post_activation == "Tanh":
                logits = torch.tanh(logits)
            return logits, hidden_states_out
        return x, hidden_states_out
