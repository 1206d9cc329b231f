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

``forward(imgs, noise=None, generator=None, dropout_generator=None)``
returns (loss, pred, mask). The masking noise [B, L] is drawn from
``generator`` unless passed in. Dropout (JAX ``:193``, ``:42-80``: after the
patch embedding and in every encoder and decoder block; none on the
attention probabilities) runs in ``train()`` mode at ``dropout_rate`` above
0, its masks drawn from ``dropout_generator``; ``eval()`` and rate 0 draw
nothing.

The forward splits as the JAX model's does (``:188-260``): ``encode_prefix``
-> the encoder trunk -> ``encode_suffix`` -> ``decode_prefix`` -> the decoder
trunk -> ``decode_suffix`` -> ``forward_loss``, so that the ``pipe`` step
(``engines/mae_engine.py pipelined_loss``) runs the trunks through
``parallel/pipeline.py`` and everything else as here. Every block comes from
``mae_encoder_block`` / ``mae_decoder_block`` (JAX ``:42-80``), which the
pipelined trunks share, so the two forwards cannot drift.

Under ``seq`` parallelism (``parallel/mesh.py``) the two trunks hold each
rank's ceil(T / s) tokens (``trunk``); the patch embedding, masking, the
unshuffle and the targets run on the whole sequence at the trunks' edges
(JAX's ``encode_prefix`` / ``decode_prefix`` split, ``:188-248``), the
encoder's tokens gathered after ``decoder_embed``. ``pred`` is then this
rank's patches, and the loss, the masked MSE over the global masked
patches, is the sum of the ranks' shares. Under ``tensor`` parallelism the
blocks split their heads and MLP columns (``models/attention.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from headct_foundation_tpu_torch.models.attention import AttentionBlock
from headct_foundation_tpu_torch.models.layers import (
    Linear,
    label_dropout_sites,
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
from headct_foundation_tpu_torch.parallel import comm, mesh

_LOSS_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def mae_encoder_block(m: "MaskedAutoencoderViT") -> AttentionBlock:
    """The encoder block the model builds (JAX ``mae_encoder_block``): the
    one factory of the unpipelined and the pipelined trunks."""
    return AttentionBlock(m.encoder_embed_dim, m.encoder_mlp_dim, m.encoder_num_heads,
                          qkv_bias=m.use_bias, norm_layer=m.norm_layer,
                          dropout_rate=m.dropout_rate, remat_mlp=m.remat, dtype=m.dtype)


def mae_decoder_block(m: "MaskedAutoencoderViT") -> AttentionBlock:
    """Decoder twin of ``mae_encoder_block``."""
    return AttentionBlock(m.decoder_embed_dim, m.decoder_mlp_dim, m.decoder_num_heads,
                          qkv_bias=m.use_bias, norm_layer=m.norm_layer,
                          dropout_rate=m.dropout_rate, remat_mlp=m.remat, dtype=m.dtype)


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
        self.encoder_embed_dim, self.encoder_mlp_dim = encoder_embed_dim, encoder_mlp_dim
        self.encoder_num_heads = encoder_num_heads
        self.decoder_embed_dim, self.decoder_mlp_dim = decoder_embed_dim, decoder_mlp_dim
        self.decoder_num_heads = decoder_num_heads
        self.use_bias, self.norm_layer = use_bias, norm_layer
        self.dropout_rate, self.remat = dropout_rate, remat
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
        self.blocks = nn.ModuleList(mae_encoder_block(self) for _ in range(encoder_depth))
        self.decoder_blocks = nn.ModuleList(mae_decoder_block(self)
                                            for _ in range(decoder_depth))
        self.norm = make_norm(norm_layer, encoder_embed_dim)
        self.decoder_norm = make_norm(norm_layer, decoder_embed_dim)
        self.decoder_embed = Linear(encoder_embed_dim, decoder_embed_dim, bias=use_bias,
                                    dtype=dtype)
        self.decoder_pred = Linear(decoder_embed_dim, patch_dim * in_chans, bias=use_bias,
                                   dtype=dtype)
        label_dropout_sites(self)

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
        dropout_generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """patch embed -> random masking -> prepend CLS."""
        x = self.patch_embedding(x, dropout_generator)
        x, mask, ids_restore, _ = random_masking(x, self.mask_ratio, generator, noise)
        cls = self.cls_token.to(x.dtype).expand(x.shape[0], -1, -1)
        return torch.cat([cls, x], dim=1), mask, ids_restore

    def trunk(self, blocks: nn.ModuleList, x: torch.Tensor,
              dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The block stack. Under ``seq`` parallelism x [B, T, C] is whole on
        every rank and the result is this rank's ceil(T / s) tokens: the
        blocks run on them, attention against the keys of all ranks."""
        m = mesh.current()
        group = m.group("seq")
        if group is None:
            for blk in blocks:
                x = blk(x, dropout_generator)
            return x
        t = x.shape[1]
        x = comm.split_tokens(x, group, mesh.tokens_per_rank(t, m.size("seq")))
        with mesh.token_shard(t):
            for blk in blocks:
                x = blk(x, dropout_generator)
        return x

    def encode_suffix(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x)

    def forward_encoder(
        self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        dropout_generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x, mask, ids_restore = self.encode_prefix(x, noise, generator, dropout_generator)
        return self.encode_suffix(self.trunk(self.blocks, x, dropout_generator)), mask, ids_restore

    def unshuffle(self, x: torch.Tensor, ids_restore: torch.Tensor) -> torch.Tensor:
        """Mask tokens put back in token order -> + decoder CLS / position
        embedding, on the embedded [B, 1 + kept, C] encoder output."""
        B, _, C = x.shape
        L = ids_restore.shape[1]
        mask_tokens = self.mask_token.to(x.dtype).expand(B, L + 1 - x.shape[1], C)
        x_ = torch.cat([x[:, 1:], mask_tokens], dim=1)
        x_ = torch.gather(x_, 1, ids_restore[:, :, None].expand(-1, -1, C))
        x = torch.cat([x[:, :1], x_], dim=1)
        dec_pe = torch.cat([self.decoder_cls_token, self.decoder_pos_embed], dim=1)
        return x + dec_pe.to(x.dtype)

    def decode_prefix(self, x: torch.Tensor, ids_restore: torch.Tensor) -> torch.Tensor:
        """decoder embed -> mask tokens put back in token order -> + decoder
        CLS / position embedding (JAX ``models/mae.py:213-235``). Under
        ``seq`` ``x`` is this rank's encoder tokens, gathered after the
        embedding into the 1 + kept tokens of the whole sequence."""
        L = ids_restore.shape[1]
        x = comm.gather_tokens(self.decoder_embed(x), mesh.current().group("seq"),
                               1 + int(L * (1 - self.mask_ratio)))
        return self.unshuffle(x, ids_restore)

    def seq_patches(self, num_patches: int) -> slice:
        """The patches whose decoder tokens this rank holds (all of them on
        one ``seq`` rank): its share of tokens 1 .. L of the L + 1."""
        m = mesh.current()
        t = num_patches + 1
        n = mesh.tokens_per_rank(t, m.size("seq"))
        lo = m.coord("seq") * n
        return slice(max(lo, 1) - 1, max(min(lo + n, t), 1) - 1)

    def decode_suffix(self, x: torch.Tensor) -> torch.Tensor:
        """decoder norm -> prediction head -> this rank's patches
        (``seq_patches``): every patch, the CLS dropped, on one ``seq`` rank."""
        x = self.decoder_pred(self.decoder_norm(x))
        p = self.seq_patches(int(np.prod(self.grid_size)))
        lo = mesh.current().coord("seq") * x.shape[1]  # this rank's first token
        return x[:, p.start + 1 - lo:p.stop + 1 - lo]

    def forward_decoder(self, x: torch.Tensor, ids_restore: torch.Tensor,
                        dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The prediction of this rank's patches (``decode_suffix``)."""
        return self.decode_suffix(self.trunk(self.decoder_blocks,
                                             self.decode_prefix(x, ids_restore),
                                             dropout_generator))

    def forward_loss(self, imgs: torch.Tensor, pred: torch.Tensor, mask: torch.Tensor,
                     patches: slice = slice(None)) -> torch.Tensor:
        """The masked MSE; ``pred`` holds the patches ``patches`` of the
        image (a share of them under ``seq``), whose loss is divided by the
        masked patches of the whole image."""
        ldt = self.loss_dtype
        target = self.patchify(imgs)[:, patches].to(ldt)
        if self.norm_pix_loss:
            t32 = target.float()
            mean = t32.mean(dim=-1, keepdim=True)
            n = target.shape[-1]
            var = (t32 - mean).square().sum(dim=-1, keepdim=True) / max(n - 1, 1)
            target = ((target - mean) / torch.sqrt(var + 1.0e-6)).to(ldt)
        loss = (pred.to(ldt) - target).square().mean(dim=-1, dtype=torch.float32)
        mask = mask.float()
        return (loss * mask[:, patches]).sum() / mask.sum()

    def forward(
        self, imgs: torch.Tensor, noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        dropout_generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(loss, pred, mask): ``forward_encoder``, ``forward_decoder``, then
        ``forward_loss`` on this rank's patches. Under ``seq`` ``pred`` is
        this rank's patches and the loss the sum of the ranks' shares (its
        gradient stays each rank's own)."""
        latent, mask, ids_restore = self.forward_encoder(imgs, noise, generator,
                                                         dropout_generator)
        pred = self.forward_decoder(latent, ids_restore, dropout_generator)
        loss = self.forward_loss(imgs, pred, mask, self.seq_patches(mask.shape[1]))
        return comm.reduce_from_group(loss, mesh.current().group("seq")), pred, mask
