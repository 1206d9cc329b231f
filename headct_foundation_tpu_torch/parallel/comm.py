"""Differentiable collectives of the ``seq`` and ``tensor`` axes.

* ``copy_to_group`` / ``reduce_from_group``: the Megatron pair. The first is
  the identity forward and an all-reduce (sum) of the gradient backward: it
  stands before a column-parallel linear, whose replicated input each rank
  differentiates for its own columns only. The second all-reduces forward
  and passes the gradient through backward: it follows a row-parallel
  linear, whose ranks each hold a partial sum of the output.
* ``gather_tokens``: all-gather along the token axis (dim 1) forward, and
  backward the sum of every rank's gradient of the gathered tensor, of which
  this rank keeps its own part (a reduce-scatter): the keys and values of
  the ``seq`` attention, and the encoder's tokens at the MAE's unshuffle.
* ``split_tokens``: this rank's ceil(T / s) tokens of a [B, T, ...] tensor
  every ``seq`` rank holds whole, the last rank's tail padded with zeros;
  backward the local gradient put back in place, zeros elsewhere. Each rank
  then holds a partial gradient of what came before the split, which the
  engine sums over ``seq`` with the parameters' gradients.
* ``gather_shards``: the ZeRO-3 pair of the ``fsdp`` axis. Forward the
  all-gather of a parameter's shards into the whole tensor (cast to the
  compute dtype first, so the bytes moved are the compute dtype's);
  backward the reduce-scatter (sum) of the whole tensor's gradient, in
  float32, onto this rank's shard (``parallel/fsdp.py``).

All of them are the identity when the group is None (an axis of 1).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from headct_foundation_tpu_torch.utils.misc import widen


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group``, in float32 for a lower-precision tensor."""
    y = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x.clone()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromGroup.apply(x, group)


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=1)


class _GatherTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[1]
        return _gather(x, group)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        i = dist.get_rank(ctx.group)
        if dist.get_backend(ctx.group) == "nccl":
            out = torch.empty((g.shape[0], ctx.n) + tuple(g.shape[2:]), dtype=g.dtype,
                              device=g.device)
            dist.reduce_scatter(out, list(g.split(ctx.n, dim=1)), group=ctx.group)
            return out, None
        return _all_reduce(g, ctx.group)[:, i * ctx.n:(i + 1) * ctx.n].contiguous(), None


def gather_tokens(x: torch.Tensor, group, t: Optional[int] = None) -> torch.Tensor:
    """[B, Tl, ...] on each rank -> [B, s Tl, ...] in rank order, cut to the
    first ``t`` tokens when given."""
    if group is None:
        return x if t is None else x[:, :t]
    y = _GatherTokens.apply(x, group)
    return y if t is None else y[:, :t]


class _SplitTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, tl):
        i = dist.get_rank(group)
        ctx.shape, ctx.lo = x.shape, i * tl
        part = x[:, ctx.lo:ctx.lo + tl]
        if part.shape[1] < tl:
            pad = x.new_zeros((x.shape[0], tl - part.shape[1]) + tuple(x.shape[2:]))
            part = torch.cat([part, pad], dim=1)
        return part.contiguous()

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        n = max(0, min(g.shape[1], ctx.shape[1] - ctx.lo))
        full[:, ctx.lo:ctx.lo + n] = g[:, :n]
        return full, None, None


def split_tokens(x: torch.Tensor, group, tl: int) -> torch.Tensor:
    return x if group is None else _SplitTokens.apply(x, group, tl)


def _all_gather_single(out: torch.Tensor, x: torch.Tensor, group) -> None:
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, x, group=group)


def _reduce_scatter_single(out: torch.Tensor, x: torch.Tensor, group) -> None:
    fn = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    fn(out, x, group=group)


def all_gather_shards(shard: torch.Tensor, group, dim: int,
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The whole tensor from every rank's ``shard`` (split along ``dim``, in
    rank order), in ``dtype`` (default the shard's); not differentiable."""
    x = shard.detach().to(dtype or shard.dtype).contiguous()
    n = _size(group)
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    _all_gather_single(out, x, group)
    return out.view((n,) + tuple(x.shape)).movedim(0, dim).flatten(dim, dim + 1) if dim \
        else out


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, group, dim, dtype):
        ctx.group, ctx.dim, ctx.shape, ctx.dtype = group, dim, shard.shape, shard.dtype
        return all_gather_shards(shard, group, dim, dtype)

    @staticmethod
    def backward(ctx, g):
        n, dim = _size(ctx.group), ctx.dim
        parts = widen(g).unflatten(dim, (n, ctx.shape[dim])).movedim(dim, 0).contiguous()
        out = parts.new_empty(ctx.shape)
        _reduce_scatter_single(out, parts.flatten(0, 1), ctx.group)
        return out.to(ctx.dtype), None, None, None


def gather_shards(shard: torch.Tensor, group, dim: int,
                  dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``all_gather_shards`` with the reduce-scatter backward (see above)."""
    return _GatherShards.apply(shard, group, dim, dtype or shard.dtype)
