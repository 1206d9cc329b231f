"""3D Vision Transformer backbone.

Port of the JAX package's ``models/vit.py`` (reference:
src/models/vit.py:25-173): patch embed -> prepend CLS -> register tokens
after CLS (arXiv 2309.16588) -> N pre-norm blocks, collecting each block's
output -> final norm (eps 1e-6) -> optional Tanh classification head.
``forward`` returns ``(x, hidden_states_out)`` like the reference.

Parameters are float32; ``dtype`` is the compute dtype (float32 for serving,
bfloat16 for DINO training, as the JAX engine's ``build_vit_model``), cast
at use as in ``models/mae.py``. ``remat`` (``PARALLEL.REMAT``) recomputes the
MLP half of every block in the backward (JAX ``models/vit.py:102-117``).
``lora`` adds the rank-128 adapters on q and v of every block (the
downstream ``TRAIN.LORA``). Dropout at ``dropout_rate`` runs after the patch
embedding and in every block in ``train()`` mode, its masks drawn from the
``generator`` handed to ``forward``; ``eval()`` is deterministic.
``set_save_attn(True)`` makes every block keep its attention
probabilities as ``blocks[i].attn.att_mat`` [B, H, T, T] float32, computed
unfused without a kernel (JAX ``models/vit.py:49,108``). An input of
another spatial size than ``img_size`` takes its position embedding
interpolated to its own patch grid (``models/patch_embed.py``).

Under ``seq`` parallelism (``parallel/mesh.py``) the block stack runs on
this rank's ceil(T / s) tokens (``comm.split_tokens`` after the tokens are
put together, attention against the keys of every rank, as the MAE's
trunks), and the normed tokens are gathered back: all of them, or with
``cls_only`` the CLS token alone (what the DINO head and the linear
classifier read); ``hidden_states_out`` then holds this rank's tokens.

Parameter names are the reference torch names that the JAX package's
``tree_to_torch`` emits (``blocks.3.attn.qkv.weight``, ``cls_token``, ...),
so an exported JAX parameter tree loads with ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from headct_foundation_tpu_torch.models.attention import AttentionBlock
from headct_foundation_tpu_torch.models.layers import Linear, label_dropout_sites, make_norm
from headct_foundation_tpu_torch.models.patch_embed import PatchEmbeddingBlock
from headct_foundation_tpu_torch.models.pos_embed import _to_tuple
from headct_foundation_tpu_torch.parallel import comm, mesh


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
        dropout_rate: float = 0.0,
        remat: bool = False,
        lora: bool = False,
        dtype: torch.dtype = torch.float32,
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
            dropout_rate=dropout_rate,
            dtype=dtype,
        )
        self.cls_token = nn.Parameter(torch.zeros(1, 1, hidden_size))
        if num_register_tokens:
            self.register_tokens = nn.Parameter(torch.zeros(1, num_register_tokens, hidden_size))
        else:
            self.register_tokens = None
        self.blocks = nn.ModuleList(
            AttentionBlock(hidden_size, mlp_dim, num_heads, qkv_bias=qkv_bias,
                           norm_layer=norm_layer, dropout_rate=dropout_rate,
                           remat_mlp=remat, lora=lora, dtype=dtype)
            for _ in range(num_layers)
        )
        self.norm = make_norm(norm_layer, hidden_size, eps=1e-6)
        if classification:
            self.classification_head = Linear(hidden_size, num_classes, dtype=dtype)
        label_dropout_sites(self)

    def set_save_attn(self, on: bool) -> bool:
        """Turn ``save_attn`` on or off in every block; returns the previous
        setting (of the first block) and drops any kept ``att_mat``."""
        prev = bool(self.blocks[0].attn.save_attn) if len(self.blocks) else False
        for blk in self.blocks:
            blk.attn.save_attn = bool(on)
            blk.attn.att_mat = None
        return prev

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> "ViT":
        """Random init drawn from ``generator``, following the JAX package's
        initializers: xavier-uniform Linear weights, zero biases, truncated
        normal (std 0.02) patch and learnable position embeddings, unit norms,
        zero CLS/register tokens, LoRA's A from N(0, 1) and B zero. The
        sincos embedding stays fixed."""
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
        for blk in self.blocks:
            if blk.attn.lora_q is not None:
                blk.attn.lora_q.init_weights(generator)
                blk.attn.lora_v.init_weights(generator)
        return self

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                cls_only: bool = False) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """(tokens [B, T, C], or the CLS token [B, C] with ``cls_only``;
        with ``classification`` the logits) and the blocks' outputs."""
        x = self.patch_embedding(x, generator)
        B = x.shape[0]
        tokens = [self.cls_token.to(x.dtype).expand(B, -1, -1)]
        if self.register_tokens is not None:
            tokens.append(self.register_tokens.to(x.dtype).expand(B, -1, -1))
        tokens.append(x)
        x = torch.cat(tokens, dim=1)

        m = mesh.current()
        group, t = m.group("seq"), x.shape[1]
        hidden_states_out: List[torch.Tensor] = []
        if group is not None:
            x = comm.split_tokens(x, group, mesh.tokens_per_rank(t, m.size("seq")))
        with mesh.token_shard(t) if group is not None else contextlib.nullcontext():
            for blk in self.blocks:
                x = blk(x, generator)
                hidden_states_out.append(x)
        x = self.norm(x)
        if cls_only or self.classification:  # the CLS token is rank 0's first
            x = comm.gather_tokens(x[:, :1], group)[:, 0]
        else:
            x = comm.gather_tokens(x, group, t)

        if self.classification:
            logits = self.classification_head(x)
            if self.post_activation == "Tanh":
                logits = torch.tanh(logits)
            return logits, hidden_states_out
        return x, hidden_states_out
