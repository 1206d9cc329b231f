"""Transformer blocks: fused-QKV self-attention, MLP, pre-norm block.

Port of the JAX package's ``models/attention.py`` (reference:
src/models/attentionblock.py:24-99):

* ``LoraLinear`` (JAX ``:41-65``): the low-rank delta ``(x @ A^T) @ B^T``,
  ``lora_matrix_B`` [out, r] zero-initialised, ``lora_matrix_A`` [r, in]
  drawn from N(0, 1) (reference: src/models/attentionblock.py:6-22). Under
  tensor parallelism B keeps the rows of this rank's heads and the rank-r
  activation ``x @ A^T`` passes ``copy_to_group``, so A's gradient and the
  input's are the sums over the ranks' heads.
* ``SelfAttention``: one [C, 3C] qkv projection reshaped as (B, N, 3, H, D),
  attention through ``ops.attention``, a ``proj`` that always has a bias,
  then dropout. With ``lora`` (rank 128, JAX ``:100-106``) the deltas of
  ``lora_q`` and ``lora_v`` are added to q and v after the head split: q
  and v are then fresh contiguous tensors while k stays a strided view of
  the fused projection, which the kernels read through per-tensor strides.
* ``MLPBlock``: Linear -> GELU -> Dropout -> Linear -> Dropout (MONAI
  MLPBlock, biases on).
* ``AttentionBlock``: x + attn(att_norm(x)); x + mlp(ffn_norm(x)). With
  ``remat_mlp`` (config ``PARALLEL.REMAT``, JAX ``models/attention.py:170-213``)
  the MLP half runs under ``torch.utils.checkpoint``: its [B, T, mlp_dim]
  activations are recomputed in the backward instead of stored. Attention
  stays outside the checkpoint, as in JAX, so its kernels are not re-run.

GELU is the tanh approximation unless ``HEADCT_EXACT_GELU=1`` (erf), read
at call time, as in the JAX package. Every projection is a ``layers.Linear``:
float32 parameters computed in ``dtype`` (JAX ``models/attention.py:91-163``,
flax ``dtype`` / ``param_dtype``), so with ``dtype=bfloat16`` the residual
stream is bfloat16.

``save_attn`` (JAX ``:68-120``; reference: src/models/attentionblock.py:36,
62-64): the attention is computed unfused, ``softmax(float32(q k^T D^-1/2))``
after LoRA's deltas, and the probabilities are kept as the attribute
``att_mat`` [B, H, T, T] float32; the output is ``probs.to(q.dtype) @ v``.
It never calls ``dot_product_attention``, so no kernel runs: leave it off
outside visualisation.

Dropout (JAX ``:130``, ``:154``, ``:163``) runs in ``train()`` mode at a rate
above 0, its masks drawn from the ``generator`` handed to ``forward`` (a
missing one raises: no mask comes from the global RNG); ``eval()`` and
rate 0 are deterministic. The MLP's two masks are drawn before a
``remat_mlp`` checkpoint, so its recomputation applies the same ones.

Tensor parallelism (``shard_block_``, the JAX rule table's Megatron split):
qkv and ``linear1`` are column-parallel, ``proj`` and ``linear2``
row-parallel with one all-reduce over ``tensor`` after each
(``layers.column_parallel`` / ``row_parallel``); the attention runs the
kernels unchanged on this rank's H / t heads. Without a group every
projection is the plain ``Linear`` call it was.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from typing import Optional

from headct_foundation_tpu_torch.models.layers import (
    Linear,
    column_parallel,
    dropout,
    keep_mask,
    make_norm,
    row_parallel,
)
from headct_foundation_tpu_torch.ops.attention import dot_product_attention
from headct_foundation_tpu_torch.parallel.comm import copy_to_group
from headct_foundation_tpu_torch.utils.misc import widen


def gelu(x: torch.Tensor) -> torch.Tensor:
    exact = os.environ.get("HEADCT_EXACT_GELU", "0") == "1"
    return F.gelu(x, approximate="none" if exact else "tanh")


class LoraLinear(nn.Module):
    """``x @ (B @ A)^T`` as two skinny products, B zero-initialised."""

    def __init__(self, in_features: int, out_features: int, r: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.tensor_group = None  # set by shard_block_ under tensor parallelism
        self.lora_matrix_B = nn.Parameter(torch.zeros(out_features, r))
        self.lora_matrix_A = nn.Parameter(torch.zeros(r, in_features))

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> "LoraLinear":
        self.lora_matrix_B.zero_()
        self.lora_matrix_A.normal_(0.0, 1.0, generator=generator)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = copy_to_group(x.to(dt) @ self.lora_matrix_A.to(dt).t(), self.tensor_group)
        return h @ self.lora_matrix_B.to(dt).t()


class SelfAttention(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int = 12, qkv_bias: bool = False,
                 dropout: float = 0.0, lora: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        if hidden_size % num_heads:
            raise ValueError("hidden_size should be divisible by num_heads.")
        self.num_heads = num_heads  # this rank's heads under tensor parallelism
        self.head_dim = hidden_size // num_heads
        self.tensor_group = None  # set by shard_block_ under tensor parallelism
        self.save_attn = False  # set by ViT.set_save_attn
        self.att_mat: Optional[torch.Tensor] = None
        self.dropout_rate = dropout
        self.dropout_sites = (":0", ":1")  # set by label_dropout_sites
        self.qkv = Linear(hidden_size, 3 * hidden_size, bias=qkv_bias, dtype=dtype)
        if lora:
            self.lora_q = LoraLinear(hidden_size, hidden_size, r=128, dtype=dtype)
            self.lora_v = LoraLinear(hidden_size, hidden_size, r=128, dtype=dtype)
        else:
            self.lora_q = self.lora_v = None
        self.proj = Linear(hidden_size, hidden_size, bias=True, dtype=dtype)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        B, N, _ = x.shape
        H, D = self.num_heads, self.head_dim
        qkv = column_parallel(self.qkv, x, self.tensor_group).reshape(B, N, 3, H, D)
        # strided views of the fused projection; the kernel reads them in place
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if self.lora_q is not None:  # after the head split (reference :57-59)
            q = q + self.lora_q(x).reshape(B, N, H, D)
            v = v + self.lora_v(x).reshape(B, N, H, D)
        if self.save_attn:  # unfused, the probabilities kept: no kernel
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / float(D) ** 0.5)
            self.att_mat = torch.softmax(widen(logits), dim=-1)
            y = torch.einsum("bhqk,bkhd->bqhd", self.att_mat.to(q.dtype), v)
        else:
            y = dot_product_attention(q, k, v)
        y = row_parallel(self.proj, y.reshape(B, N, H * D), self.tensor_group)
        return dropout(y, self.dropout_rate if self.training else 0.0, generator,
                       site=self.dropout_sites[0])


class MLPBlock(nn.Module):
    def __init__(self, hidden_size: int, mlp_dim: int, dropout_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.dropout_sites = (":0", ":1")  # set by label_dropout_sites
        self.tensor_group = None  # set by shard_block_ under tensor parallelism
        self.linear1 = Linear(hidden_size, mlp_dim, dtype=dtype)
        self.linear2 = Linear(mlp_dim, hidden_size, dtype=dtype)

    def draw_masks(self, h: torch.Tensor, generator: Optional[torch.Generator]) -> tuple:
        """The two keep masks of input ``h``, drawn in the forward's order."""
        rate, (B, N, C) = self.dropout_rate, h.shape
        split = self.tensor_group is not None
        return (keep_mask((B, N, self.linear1.out_features), rate, generator, h.device,
                          self.dropout_sites[0], split),
                keep_mask((B, N, C), rate, generator, h.device, self.dropout_sites[1]))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                masks: Optional[tuple] = None) -> torch.Tensor:
        """The two dropout masks are drawn from ``generator``, or given as
        ``masks`` (``draw_masks``'). Under tensor parallelism ``linear1`` is
        column-parallel (its first mask this rank's columns of the global
        one) and ``linear2`` row-parallel (its mask whole on every rank)."""
        rate = self.dropout_rate if self.training else 0.0
        m1, m2 = masks if masks is not None else (None, None)
        group, sites = self.tensor_group, self.dropout_sites
        x = dropout(gelu(column_parallel(self.linear1, x, group)), rate, generator, m1,
                    sites[0], group is not None)
        return dropout(row_parallel(self.linear2, x, group), rate, generator, m2, sites[1])


class AttentionBlock(nn.Module):
    def __init__(self, hidden_size: int, mlp_dim: int, num_heads: int,
                 qkv_bias: bool = False, norm_layer: str = "layernorm",
                 dropout_rate: float = 0.0, remat_mlp: bool = False, lora: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.remat_mlp = remat_mlp
        self.att_norm = make_norm(norm_layer, hidden_size)
        self.attn = SelfAttention(hidden_size, num_heads, qkv_bias=qkv_bias,
                                  dropout=dropout_rate, lora=lora, dtype=dtype)
        self.ffn_norm = make_norm(norm_layer, hidden_size)
        self.mlp = MLPBlock(hidden_size, mlp_dim, dropout_rate=dropout_rate, dtype=dtype)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = x + self.attn(self.att_norm(x), generator)
        h = self.ffn_norm(x)
        if not (self.training and self.mlp.dropout_rate):  # no mask to draw
            if self.remat_mlp and torch.is_grad_enabled():
                return x + checkpoint(self.mlp, h, use_reentrant=False)
            return x + self.mlp(h)
        if self.remat_mlp and torch.is_grad_enabled():  # the recomputation applies the same
            masks = self.mlp.draw_masks(h, generator)
            return x + checkpoint(self.mlp, h, None, masks, use_reentrant=False)
        return x + self.mlp(h, generator)


def shard_block_(block: AttentionBlock, t: int, i: int, group) -> AttentionBlock:
    """Make ``block`` tensor rank ``i``'s of ``t`` (Megatron): its qkv and
    ``linear1`` keep their columns of the split (``parallel/mesh.py
    split_param``), ``proj`` and ``linear2`` their input columns, LoRA's
    ``lora_matrix_B`` the rows of this rank's heads, and the attention its
    H / t heads; norms, LoRA's A and the row-parallel biases stay whole.
    The parameters keep their objects (their data is replaced)."""
    from headct_foundation_tpu_torch.parallel.mesh import split_param

    attn, mlp = block.attn, block.mlp
    if attn.num_heads % t:
        raise ValueError(f"{attn.num_heads} heads do not split over tensor = {t}")
    mods = [("attn.qkv", attn.qkv), ("attn.proj", attn.proj),
            ("mlp.linear1", mlp.linear1), ("mlp.linear2", mlp.linear2)]
    if attn.lora_q is not None:
        mods += [("attn.lora_q", attn.lora_q), ("attn.lora_v", attn.lora_v)]
        attn.lora_q.tensor_group = attn.lora_v.tensor_group = group
    with torch.no_grad():
        for prefix, mod in mods:
            for leaf, p in mod.named_parameters(recurse=False):
                p.data = split_param(f"{prefix}.{leaf}", p.data, t, i)
            if isinstance(mod, nn.Linear):
                mod.out_features, mod.in_features = mod.weight.shape
    attn.num_heads //= t
    attn.tensor_group = mlp.tensor_group = group
    return block
