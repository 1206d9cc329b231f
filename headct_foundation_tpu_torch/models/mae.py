"""3D Masked Autoencoder with a ViT backbone.

Port of the JAX package's ``models/mae.py:77-282`` (reference:
src/models/mae.py:20-316):

* encoder: patch embed (+ sincos position embedding) -> random masking
  (keep 25%) -> CLS -> blocks -> norm;
* decoder: linear projection -> learned mask tokens put back in place by
  ``ids_restore`` -> + decoder CLS and the fixed sincos decoder position
  embedding -> blocks -> norm -> voxel prediction head -> drop CLS;
* loss: per-patch MSE on the masked patches only, with the optional
  per-patch normalisation of the target (``norm_pix_loss``, unbiased
  variance as the reference's ``target.var``) and ``loss_dtype``.

Parameters are float32; ``dtype`` is the compute dtype (bfloat16 for
training, as the JAX engine's ``build_mae_model``). Module and parameter
names are those ``utils/torch_interop.state_dict_from_jax`` emits for the
JAX model's tree. The sincos position embeddings are frozen parameters
(``requires_grad=False``), as in the reference.

``remat`` (config ``PARALLEL.REMAT``) recomputes the MLP half of every
encoder and decoder block in the backward (JAX ``models/mae.py:54,70,149``).

``forward(imgs, noise=None, generator=None)`` returns (loss, pred, mask).
The masking noise [B, L] is drawn from ``generator`` unless passed in.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from headct_foundation_tpu_torch.models.attention import AttentionBlock
from headct_foundation_tpu_torch.models.layers import (
    Linear,
    make_norm,
    trunc_normal_,
    xavier_uniform_,
)
from headct_foundation_tpu_torch.models.patch_embed import PatchEmbeddingBlock, patchify3d
from headct_foundation_tpu_torch.models.pos_embed import (
    _to_tuple,
    build_sincos_position_embedding,
)
from headct_foundation_tpu_torch.ops.masking import random_masking

_LOSS_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class MaskedAutoencoderViT(nn.Module):
    def __init__(
        self,
        input_size: Union[int, Sequence[int]],
        patch_size: Union[int, Sequence[int]],
        mask_ratio: float,
        in_chans: int = 1,
        dropout_rate: float = 0.0,
        spatial_dims: int = 3,
        pos_embed: str = "learnable",
        encoder_depth: int = 12,
        encoder_embed_dim: int = 768,
        encoder_mlp_dim: int = 3072,
        encoder_num_heads: int = 12,
        decoder_depth: int = 8,
        decoder_embed_dim: int = 768,
        decoder_mlp_dim: int = 3072,
        decoder_num_heads: int = 16,
        norm_pix_loss: bool = False,
        loss_dtype: str = "float32",
        use_bias: bool = False,
        norm_layer: str = "layernorm",
        remat: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if spatial_dims != 3:
            raise ValueError("the MAE is built for 3D volumes")
        if loss_dtype not in _LOSS_DTYPES:
            raise ValueError(f"loss_dtype {loss_dtype!r} is not one of {sorted(_LOSS_DTYPES)}")
        self.input_size = _to_tuple(input_size, 3)
        self.patch_size = _to_tuple(patch_size, 3)
        self.grid_size = tuple(i // p for i, p in zip(self.input_size, self.patch_size))
        self.mask_ratio = mask_ratio
        self.norm_pix_loss = norm_pix_loss
        self.loss_dtype = _LOSS_DTYPES[loss_dtype]
        self.dtype = dtype
        num_patches = int(np.prod(self.grid_size))
        patch_dim = int(np.prod(self.patch_size))

        self.cls_token = nn.Parameter(torch.zeros(1, 1, encoder_embed_dim))
        self.decoder_cls_token = nn.Parameter(torch.zeros(1, 1, decoder_embed_dim))
        if pos_embed == "sincos":
            pe = build_sincos_position_embedding(self.grid_size, decoder_embed_dim, spatial_dims)
            self.decoder_pos_embed = nn.Parameter(torch.from_numpy(pe), requires_grad=False)
        else:
            self.decoder_pos_embed = nn.Parameter(torch.zeros(1, num_patches, decoder_embed_dim))
        self.mask_token = nn.Parameter(torch.zeros(1, 1, decoder_embed_dim))

        self.patch_embedding = PatchEmbeddingBlock(
            img_size=self.input_size, patch_size=self.patch_size, in_channels=in_chans,
            hidden_size=encoder_embed_dim, pos_embed=pos_embed, dropout_rate=dropout_rate,
            dtype=dtype)
        self.blocks = nn.ModuleList(
            AttentionBlock(encoder_embed_dim, encoder_mlp_dim, encoder_num_heads,
                           qkv_bias=use_bias, norm_layer=norm_layer,
                           dropout_rate=dropout_rate, remat_mlp=remat, dtype=dtype)
            for _ in range(encoder_depth))
        self.decoder_blocks = nn.ModuleList(
            AttentionBlock(decoder_embed_dim, decoder_mlp_dim, decoder_num_heads,
                           qkv_bias=use_bias, norm_layer=norm_layer,
                           dropout_rate=dropout_rate, remat_mlp=remat, dtype=dtype)
            for _ in range(decoder_depth))
        self.norm = make_norm(norm_layer, encoder_embed_dim)
        self.decoder_norm = make_norm(norm_layer, decoder_embed_dim)
        self.decoder_embed = Linear(encoder_embed_dim, decoder_embed_dim, bias=use_bias,
                                    dtype=dtype)
        self.decoder_pred = Linear(decoder_embed_dim, patch_dim * in_chans, bias=use_bias,
                                   dtype=dtype)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> "MaskedAutoencoderViT":
        """The JAX model's initializers, drawn from ``generator``: truncated
        normal (std 0.02) tokens, patch kernel and learnable position
        embeddings; xavier-uniform Linear weights; zero biases; unit norms.
        The sincos embeddings stay fixed."""
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                xavier_uniform_(mod.weight, generator)
                if mod.bias is not None:
                    mod.bias.zero_()
        for p in (self.cls_token, self.decoder_cls_token, self.mask_token,
                  self.patch_embedding.patch_embeddings.weight):
            trunc_normal_(p, generator=generator)
        self.patch_embedding.patch_embeddings.bias.zero_()
        for p in (self.decoder_pos_embed, self.patch_embedding.position_embeddings):
            if p is not None and p.requires_grad:
                trunc_normal_(p, generator=generator)
        return self

    def patchify(self, x: torch.Tensor) -> torch.Tensor:
        return patchify3d(x, self.patch_size)

    def encode_prefix(
        self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """patch embed -> random masking -> prepend CLS."""
        x = self.patch_embedding(x)
        x, mask, ids_restore, _ = random_masking(x, self.mask_ratio, generator, noise)
        cls = self.cls_token.to(x.dtype).expand(x.shape[0], -1, -1)
        return torch.cat([cls, x], dim=1), mask, ids_restore

    def forward_encoder(
        self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x, mask, ids_restore = self.encode_prefix(x, noise, generator)
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x), mask, ids_restore

    def decode_prefix(self, x: torch.Tensor, ids_restore: torch.Tensor) -> torch.Tensor:
        """decoder embed -> mask tokens put back in token order -> + decoder
        CLS / position embedding (JAX ``models/mae.py:213-235``)."""
        x = self.decoder_embed(x)
        B, _, C = x.shape
        L = ids_restore.shape[1]
        mask_tokens = self.mask_token.to(x.dtype).expand(B, L + 1 - x.shape[1], C)
        x_ = torch.cat([x[:, 1:], mask_tokens], dim=1)
        x_ = torch.gather(x_, 1, ids_restore[:, :, None].expand(-1, -1, C))
        x = torch.cat([x[:, :1], x_], dim=1)
        dec_pe = torch.cat([self.decoder_cls_token, self.decoder_pos_embed], dim=1)
        return x + dec_pe.to(x.dtype)

    def forward_decoder(self, x: torch.Tensor, ids_restore: torch.Tensor) -> torch.Tensor:
        x = self.decode_prefix(x, ids_restore)
        for blk in self.decoder_blocks:
            x = blk(x)
        return self.decoder_pred(self.decoder_norm(x))[:, 1:]

    def forward_loss(self, imgs: torch.Tensor, pred: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
        ldt = self.loss_dtype
        target = self.patchify(imgs).to(ldt)
        if self.norm_pix_loss:
            t32 = target.float()
            mean = t32.mean(dim=-1, keepdim=True)
            n = target.shape[-1]
            var = (t32 - mean).square().sum(dim=-1, keepdim=True) / max(n - 1, 1)
            target = ((target - mean) / torch.sqrt(var + 1.0e-6)).to(ldt)
        loss = (pred.to(ldt) - target).square().mean(dim=-1, dtype=torch.float32)
        mask = mask.float()
        return (loss * mask).sum() / mask.sum()

    def forward(
        self, imgs: torch.Tensor, noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        latent, mask, ids_restore = self.forward_encoder(imgs, noise, generator)
        pred = self.forward_decoder(latent, ids_restore)
        return self.forward_loss(imgs, pred, mask), pred, mask
