"""Normalization layers, the compute-dtype Linear and the initializers.

* ``LayerNorm``: torch-default epsilon (1e-5), statistics in float32 (in
  float64 for a float64 input: ``utils/misc.py widen``, as everywhere this
  module says float32), the result cast back to the input dtype before the
  affine.
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
  sees the whole sharded batch): one differentiable all-reduce of the sums
  over the batch's ranks (``data`` x ``fsdp``; the ``seq`` and ``tensor``
  ranks of a slice hold the same rows).
  ``affine`` and ``dtype`` give the DINO head's variant (a float32 scale and
  bias, the output in the head's compute dtype).
* ``dropout``: inverted dropout whose keep mask is drawn from an explicit
  generator, so a step is reproducible from its seed; under
  ``parallel.mesh.global_dropout`` the mask is this rank's slice of the
  global batch's. ``set_mask_hook`` (tests) hands in the masks by site
  (``label_dropout_sites``: the dropping module's name in the model).
* ``column_parallel`` / ``row_parallel``: the Megatron linears over the
  ``tensor`` group (``parallel/comm.py``).

Parameter names follow the reference torch modules (``weight``, ``bias``),
which is what the JAX package's ``tree_to_torch`` emits.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from headct_foundation_tpu_torch.parallel import comm, distributed, mesh
from headct_foundation_tpu_torch.utils.misc import widen


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.dim = dim
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(widen(x), (self.dim,), eps=self.eps).to(x.dtype)
        return y * self.weight.to(x.dtype) + self.bias.to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = widen(x)
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
    """Sum across the ranks of ``group``; the backward sums the gradients the
    same way, so each rank's share of the global statistics gets every
    rank's gradient."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _batch_ranks() -> int:
    """The ranks whose rows make the global batch: ``data`` x ``fsdp``."""
    return distributed.data_world() if dist.is_initialized() else 1


def _global_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the batch's ranks (``_batch_ranks`` of them)."""
    if _batch_ranks() == 1:
        return x
    return _AllReduceSum.apply(x, mesh.current().group("batch") if distributed.laid_out()
                               else None)


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
    By default the output is float32 and there is no scale or bias, as the
    JAX classifiers ask (``dtype=float32``, ``use_scale`` / ``use_bias``
    off). ``affine=True`` adds the float32 parameters ``weight`` (ones) and
    ``bias`` (zeros), applied in float32 after the normalisation, and
    ``dtype`` is the output's: the DINO head's BatchNorm (JAX
    ``models/dino_head.py:66-84``, ``use_scale`` / ``use_bias`` on, computed
    in the head's ``dtype``). Buffers ``running_mean`` and ``running_var``
    and the parameters are the names ``tree_to_torch`` gives the JAX
    ``batch_stats`` ``mean`` and ``var`` and params ``scale`` and ``bias``."""

    def __init__(self, num_features: int, momentum: float = 0.1, eps: float = 1e-5,
                 affine: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.dtype = dtype
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))
        else:
            self.weight = self.bias = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = widen(x)
        if self.training:
            axes, c = tuple(range(x.dim() - 1)), x.shape[-1]
            # every rank holds a batch of the same size (the loaders pad to it)
            n = x.numel() // c * _batch_ranks()
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
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        if self.weight is not None:
            y = y * self.weight + self.bias
        # a float64 input (the downstream main's float64 reference) stays float64
        return y.to(torch.float64 if xf.dtype == torch.float64 else self.dtype)


# A test-only source of dropout masks: hook(site, global shape) -> a boolean
# keep mask of that shape, or None to draw it (``set_mask_hook``).
_MASK_HOOK: Optional[Callable] = None


def set_mask_hook(hook: Optional[Callable]) -> Optional[Callable]:
    """Take every dropout mask from ``hook(site, shape)`` (tests hand in the
    masks they give the JAX model); returns the previous hook."""
    global _MASK_HOOK
    prev, _MASK_HOOK = _MASK_HOOK, hook
    return prev


def keep_mask(shape, rate: float, generator: Optional[torch.Generator], device,
              site: Optional[str] = None, cols_split: bool = False) -> torch.Tensor:
    """A boolean mask keeping each element with probability 1 - ``rate``,
    drawn from ``generator`` (a missing generator raises). Under
    ``parallel.mesh.global_dropout`` it is this rank's slice of the mask a
    single process draws for the global batch (``cols_split``: ``shape``'s
    last axis is this rank's columns of a column-parallel output).
    ``site`` names the mask for ``set_mask_hook``."""
    layout = mesh.dropout_slice(shape, cols_split)
    full = tuple(shape) if layout is None else layout[0]
    m = None if _MASK_HOOK is None or site is None else _MASK_HOOK(site, full)
    if m is None:
        if generator is None:
            raise ValueError("dropout at a rate above 0 draws its mask from an explicit "
                             "torch.Generator; none was given")
        m = torch.rand(full, generator=generator, device=device) >= rate
    m = torch.as_tensor(m, device=device)
    return m if layout is None else layout[1](m)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            keep: Optional[torch.Tensor] = None, site: Optional[str] = None,
            cols_split: bool = False) -> torch.Tensor:
    """Inverted dropout (flax ``nn.Dropout``): each element kept with
    probability 1 - ``rate`` and scaled by 1 / (1 - rate), the mask ``keep``
    or else ``keep_mask``'s. Rate 0 returns ``x``; rate 1 zeros it."""
    if not rate:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    if keep is None:
        keep = keep_mask(x.shape, rate, generator, x.device, site, cols_split)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def label_dropout_sites(model: nn.Module) -> nn.Module:
    """Give every module that drops out its name in ``model``
    (``dropout_sites``: "<name>:0", "<name>:1"), the keys of its masks for
    ``set_mask_hook``."""
    for name, mod in model.named_modules():
        if hasattr(mod, "dropout_sites"):
            mod.dropout_sites = (f"{name}:0", f"{name}:1")
    return model


def _f32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in float32 (float64 for float64 operands), accumulated there and
    not rounded to the operands' lower precision (``torch.mm``'s
    ``out_dtype`` on the card)."""
    if a.dtype in (torch.float32, torch.float64):
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _LinearF32(torch.autograd.Function):
    """x @ w.T with a float32 result, for a split linear whose partial sums
    meet across ranks: forward the product of x (cast to w's dtype, exact
    for the values a split linear is given) and w, unrounded; backward the
    input's gradient likewise in float32 when x is, rounded to x's dtype
    otherwise, and w's gradient in w's dtype as an unsplit linear's. The
    incoming gradient is that of an output rounded to w's dtype, so casting
    it there is exact."""

    @staticmethod
    def forward(ctx, x, w):
        xb = x.to(w.dtype)
        ctx.save_for_backward(xb, w)
        ctx.x_dtype = x.dtype
        return _f32_mm(xb.reshape(-1, xb.shape[-1]), w.t()).reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g):
        xb, w = ctx.saved_tensors
        gb = g.to(w.dtype).reshape(-1, g.shape[-1])
        gx = _f32_mm(gb, w).to(ctx.x_dtype).reshape(xb.shape)
        return gx, gb.t() @ xb.reshape(-1, xb.shape[-1])


def _split_linear(linear: "Linear", x: torch.Tensor) -> torch.Tensor:
    """``linear`` on its split weight, the product in float32 (``_LinearF32``)."""
    return _LinearF32.apply(x, linear.weight.to(linear.compute_dtype))


def _add_bias(linear: "Linear", y: torch.Tensor) -> torch.Tensor:
    """The bias in the compute dtype added to a float32 product, then one
    rounding to the compute dtype, as an unsplit linear's epilogue."""
    dt = linear.compute_dtype
    return (y if linear.bias is None else y + widen(linear.bias.to(dt))).to(dt)


def column_parallel(linear: "Linear", x: torch.Tensor, group) -> torch.Tensor:
    """A column-parallel linear (its output columns split over ``group``):
    backward the ranks' partial gradients of the input summed in float32
    and rounded once. Without a group it is ``linear(x)``."""
    if group is None:
        return linear(x)
    return _add_bias(linear, _split_linear(linear, comm.copy_to_group(widen(x), group)))


def row_parallel(linear: "Linear", x: torch.Tensor, group) -> torch.Tensor:
    """A row-parallel linear (its input columns split over ``group``): the
    partial products summed in float32 across the group and the whole bias
    added, then one rounding to the compute dtype. Without a group it is
    ``linear(x)``."""
    if group is None:
        return linear(x)
    return _add_bias(linear, comm.reduce_from_group(_split_linear(linear, x), group))
