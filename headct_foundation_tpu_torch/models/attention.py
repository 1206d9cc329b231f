"""Transformer blocks: fused-QKV self-attention, MLP, pre-norm block.

Port of the JAX package's ``models/attention.py`` (reference:
src/models/attentionblock.py:24-99):

* ``SelfAttention``: one [C, 3C] qkv projection reshaped as (B, N, 3, H, D),
  attention through ``ops.attention``, a ``proj`` that always has a bias.
* ``MLPBlock``: Linear -> GELU -> Linear (MONAI MLPBlock, biases on).
* ``AttentionBlock``: x + attn(att_norm(x)); x + mlp(ffn_norm(x)). With
  ``remat_mlp`` (config ``PARALLEL.REMAT``, JAX ``models/attention.py:170-213``)
  the MLP half runs under ``torch.utils.checkpoint``: its [B, T, mlp_dim]
  activations are recomputed in the backward instead of stored. Attention
  stays outside the checkpoint, as in JAX, so its kernels are not re-run.

GELU is the tanh approximation unless ``HEADCT_EXACT_GELU=1`` (erf), read
at call time, as in the JAX package. Every projection is a ``layers.Linear``:
float32 parameters computed in ``dtype`` (JAX ``models/attention.py:91-163``,
flax ``dtype`` / ``param_dtype``), so with ``dtype=bfloat16`` the residual
stream is bfloat16. LoRA and ``save_attn`` are not ported yet; a dropout
rate above 0 raises (rate 0 in every shipped config).
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from headct_foundation_tpu_torch.models.layers import Linear, make_norm
from headct_foundation_tpu_torch.ops.attention import dot_product_attention


def gelu(x: torch.Tensor) -> torch.Tensor:
    exact = os.environ.get("HEADCT_EXACT_GELU", "0") == "1"
    return F.gelu(x, approximate="none" if exact else "tanh")


def _no_dropout(rate: float) -> None:
    if rate:
        raise NotImplementedError(
            "dropout is not ported yet (ROADMAP A); every shipped config uses rate 0")


class SelfAttention(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int = 12, qkv_bias: bool = False,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        if hidden_size % num_heads:
            raise ValueError("hidden_size should be divisible by num_heads.")
        _no_dropout(dropout)
        self.num_heads = num_heads
        self.qkv = Linear(hidden_size, 3 * hidden_size, bias=qkv_bias, dtype=dtype)
        self.proj = Linear(hidden_size, hidden_size, bias=True, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        H = self.num_heads
        qkv = self.qkv(x).reshape(B, N, 3, H, C // H)
        # strided views of the fused projection; the kernel reads them in place
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        y = dot_product_attention(q, k, v).reshape(B, N, C)
        return self.proj(y)


class MLPBlock(nn.Module):
    def __init__(self, hidden_size: int, mlp_dim: int, dropout_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        _no_dropout(dropout_rate)
        self.linear1 = Linear(hidden_size, mlp_dim, dtype=dtype)
        self.linear2 = Linear(mlp_dim, hidden_size, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(gelu(self.linear1(x)))


class AttentionBlock(nn.Module):
    def __init__(self, hidden_size: int, mlp_dim: int, num_heads: int,
                 qkv_bias: bool = False, norm_layer: str = "layernorm",
                 dropout_rate: float = 0.0, remat_mlp: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.remat_mlp = remat_mlp
        self.att_norm = make_norm(norm_layer, hidden_size)
        self.attn = SelfAttention(hidden_size, num_heads, qkv_bias=qkv_bias,
                                  dropout=dropout_rate, dtype=dtype)
        self.ffn_norm = make_norm(norm_layer, hidden_size)
        self.mlp = MLPBlock(hidden_size, mlp_dim, dropout_rate=dropout_rate, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.att_norm(x))
        h = self.ffn_norm(x)
        if self.remat_mlp and torch.is_grad_enabled():
            return x + checkpoint(self.mlp, h, use_reentrant=False)
        return x + self.mlp(h)
