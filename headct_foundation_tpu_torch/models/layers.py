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
* ``TorchBatchNorm`` (JAX ``models/layers.py:51-116``): BatchNorm over every
  axis but the last, with torch's running-statistics rule (the running
  variance is the unbiased one). Under ``torch.distributed`` the train-mode
  statistics are the global batch's (the JAX package's BatchNorm under jit
  sees the whole sharded batch): one differentiable all-reduce of the sums.
* ``dropout``: inverted dropout whose keep mask is drawn from an explicit
  generator, so a step is reproducible from its seed.

Parameter names follow the reference torch modules (``weight``, ``bias``),
which is what the JAX package's ``tree_to_torch`` emits.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
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


class _AllReduceSum(torch.autograd.Function):
    """Sum across the ranks; the backward sums the gradients the same way, so
    each rank's share of the global statistics gets every rank's gradient."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        x = x.clone()
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        g = g.clone()
        dist.all_reduce(g)
        return g


def _global_sum(x: torch.Tensor) -> torch.Tensor:
    if dist.is_initialized() and dist.get_world_size() > 1:
        return _AllReduceSum.apply(x)
    return x


class TorchBatchNorm(nn.Module):
    """BatchNorm over every axis but the last, in float32, with torch's
    running statistics (JAX ``models/layers.py:51-116``).

    ``momentum`` is torch's (0.1 is the JAX package's 0.9): running =
    (1 - momentum) running + momentum batch; the running variance takes the
    unbiased estimate n / (n - 1) var, as ``torch.nn.functional.batch_norm``
    stores it. Train mode normalises with the batch's mean and biased
    variance, taken in two passes (the JAX module's one-pass E[x^2] - E[x]^2
    loses digits where a channel's variance is small beside its mean), and
    raises on one value per channel; eval mode with the running statistics.
    Under ``torch.distributed`` the batch is the global one: the sums of
    each pass are all-reduced (every rank holds a batch of the same size).
    The output is float32 and there is no scale or bias, as the JAX
    classifiers ask (``dtype=float32``, ``use_scale`` / ``use_bias`` off).
    Buffers ``running_mean`` and
    ``running_var`` are the names ``tree_to_torch`` gives the JAX
    ``batch_stats`` ``mean`` and ``var``."""

    def __init__(self, num_features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            axes, c = tuple(range(x.dim() - 1)), x.shape[-1]
            # every rank holds a batch of the same size (the loaders pad to it)
            world = dist.get_world_size() if dist.is_initialized() else 1
            n = x.numel() // c * world
            if n <= 1:
                raise ValueError("TorchBatchNorm in train mode needs >1 value per channel; got "
                                 f"reduce count {n} for input shape {tuple(x.shape)}")
            # two passes, E[(x - E[x])^2]: the JAX module's E[x^2] - E[x]^2 cancels
            # where the channel's variance is small beside its mean
            mean = _global_sum(xf.sum(dim=axes)) / n
            var = _global_sum(torch.square(xf - mean).sum(dim=axes)) / n
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(m * mean)
                self.running_var.mul_(1.0 - m).add_(m * var * (n / (n - 1)))
        else:
            mean, var = self.running_mean, self.running_var
        return (xf - mean) * torch.rsqrt(var + self.eps)


def keep_mask(shape, rate: float, generator: Optional[torch.Generator],
              device) -> torch.Tensor:
    """A boolean mask keeping each element with probability 1 - ``rate``,
    drawn from ``generator`` (a missing generator raises)."""
    if generator is None:
        raise ValueError("dropout at a rate above 0 draws its mask from an explicit "
                         "torch.Generator; none was given")
    return torch.rand(shape, generator=generator, device=device) >= rate


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverted dropout (flax ``nn.Dropout``): each element kept with
    probability 1 - ``rate`` and scaled by 1 / (1 - rate), the mask ``keep``
    or else drawn from ``generator``. Rate 0 returns ``x``; rate 1 zeros it."""
    if not rate:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    if keep is None:
        keep = keep_mask(x.shape, rate, generator, x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))
