"""ZeRO-3 over the ``fsdp`` axis: each rank stores only its shards of the
parameters, their gradients and their optimizer state, and gathers a
weight whole only while the module that uses it runs.

The JAX package has no counterpart: there GSPMD shards the parameters by
the rule table (``parallel/mesh.py:144-156``) and XLA inserts the gathers.
Here:

* ``shard_module_(module, mesh)`` keeps, of every parameter the rule table
  splits over ``fsdp`` (``mesh.fsdp_dim``: 2-D weights, all of them
  ``layers.Linear``'s), this rank's shard along that dimension, in place
  (the parameter objects stay, so the names, the optimizer and the
  checkpoints see them as before). It records the dimension on the owning
  Linear (``_fsdp_leaves``) and hooks the Linear: before its forward the
  shards are gathered whole in the Linear's compute dtype
  (``comm.gather_shards``, whose backward reduce-scatters the gradient onto
  the shard) and put in the parameter's place; after it the shards are put
  back, so the whole weight lives only while the Linear runs.
* The whole weights are not kept for the backward. The root module's
  forward runs under ``torch.autograd.graph.saved_tensors_hooks``: a tensor
  that autograd saves and that lies in a gathered weight's storage (the
  weight, its transpose) is packed as "gather it again" and re-gathered when
  the backward unpacks it. This was chosen over recomputing each block
  (``PARALLEL.REMAT``'s ``torch.utils.checkpoint``): it moves the same
  bytes again but recomputes nothing, so the attention kernels run once
  each, and it leaves ``REMAT`` an independent choice (inside a checkpointed
  MLP the checkpoint's own hooks take precedence and the recomputation
  gathers again through the Linear's hook).
* ``sharded_dims(module)`` names every split parameter with its dimension;
  ``split_groups(module, mesh)`` gives, per axis, the group and the
  parameters split over it: the per-parameter clip and Lamb take each norm
  over all of a parameter's shards through them.

Every ``fsdp`` rank of a data slice must run the same forwards in the same
order (every gather is a collective), as the engines do.

Why not PyTorch's ``fully_shard`` (FSDP2): the JAX layout keeps whole every
parameter that its rule table leaves unsharded or whose dimension does not
divide (biases, norms, tokens, embeddings, the DINO head's whole layers), and
``fully_shard`` shards every parameter of a module it wraps:
``shard_placement_fn`` may return only a ``Shard`` (a ``Replicate()`` is
refused as an invalid result), and the one way to keep a parameter whole,
``ignored_params``, leaves its gradient unreduced. Following JAX would then
take a second gradient path beside FSDP2's reduce-scatter, whose own divide
factor over ``fsdp`` would have to be matched to ``data_mean_``'s average
over data x fsdp. And its parameters become DTensors, where the port's
optimizers (foreach AdamW, Lion's B6 kernel, Lamb's and the clip's norms
over the ``fsdp`` and ``tensor`` groups), the explicit Megatron shards and
the checkpoints' whole-tree gather all work on plain tensors.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from headct_foundation_tpu_torch.parallel import comm
from headct_foundation_tpu_torch.parallel import mesh as mesh_lib

# A sharded model's gathered weights in use: storage address -> (shard,
# dim, dtype), how to gather each again. One dict per model, shared by its
# Linears' hooks and its root's pack hook.
Live = Dict[int, Tuple[torch.Tensor, int, torch.dtype]]


class _Regather:
    """A saved view of a gathered weight, packed as its shard."""

    __slots__ = ("shard", "dim", "dtype", "size", "stride", "offset")

    def __init__(self, info, t: torch.Tensor):
        self.shard, self.dim, self.dtype = info
        self.size, self.stride, self.offset = t.size(), t.stride(), t.storage_offset()

    def unpack(self) -> torch.Tensor:
        group = mesh_lib.current().group("fsdp")
        full = comm.all_gather_shards(self.shard, group, self.dim, self.dtype)
        return full.as_strided(self.size, self.stride, self.offset)


def _pack(live: Live, t: torch.Tensor):
    if not live or t.layout != torch.strided:
        return t
    info = live.get(t.untyped_storage().data_ptr())
    return t if info is None else _Regather(info, t)


def _unpack(x):
    return x.unpack() if isinstance(x, _Regather) else x


def _gather_hook(mod: nn.Module, args) -> None:
    group = mesh_lib.current().group("fsdp")
    mod._fsdp_shards = {}
    for leaf, dim in mod._fsdp_leaves.items():
        shard = mod._parameters[leaf]
        full = comm.gather_shards(shard, group, dim, mod.compute_dtype)
        mod._fsdp_live[full.untyped_storage().data_ptr()] = (shard.detach(), dim,
                                                             mod.compute_dtype)
        mod._fsdp_shards[leaf] = shard
        mod._parameters[leaf] = full


def _release_hook(mod: nn.Module, args, output) -> None:
    for leaf, shard in mod.__dict__.pop("_fsdp_shards", {}).items():
        full = mod._parameters[leaf]
        mod._fsdp_live.pop(full.untyped_storage().data_ptr(), None)
        mod._parameters[leaf] = shard


def _enter_regather(mod: nn.Module, args) -> None:
    ctx = torch.autograd.graph.saved_tensors_hooks(functools.partial(_pack, mod._fsdp_live),
                                                   _unpack)
    ctx.__enter__()
    mod.__dict__.setdefault("_fsdp_ctx", []).append(ctx)


def _exit_regather(mod: nn.Module, args, output) -> None:
    mod._fsdp_ctx.pop().__exit__(None, None, None)


def shard_module_(module: nn.Module, mesh: Optional[mesh_lib.Mesh] = None) -> nn.Module:
    """Keep this rank's ``fsdp`` shard of every parameter of ``module`` that
    the rule table splits (names as in ``module``), and hook the module to
    gather them at use (see the module docstring). A no-op at ``fsdp`` 1."""
    from headct_foundation_tpu_torch.models.layers import Linear

    mesh = mesh or mesh_lib.current()
    f, i = mesh.size("fsdp"), mesh.coord("fsdp")
    if f == 1:
        return module
    live: Live = {}
    module._fsdp_live = live
    for mod_name, mod in module.named_modules():
        leaves = {}
        for leaf, p in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            dim = mesh_lib.fsdp_dim(name, p.shape, f)
            if dim is None:
                continue
            if not isinstance(mod, Linear):
                raise TypeError(f"{name}: only a layers.Linear weight is split over fsdp, "
                                f"not a {type(mod).__name__}'s")
            p.data = mesh_lib.split_param(name, p.data, f, i, "fsdp", dim)
            leaves[leaf] = dim
        if leaves:
            mod._fsdp_leaves, mod._fsdp_live = leaves, live
            mod.register_forward_pre_hook(_gather_hook)
            mod.register_forward_hook(_release_hook, always_call=True)
    module.register_forward_pre_hook(_enter_regather)
    module.register_forward_hook(_exit_regather, always_call=True)
    return module


def sharded_dims(module: nn.Module) -> Dict[str, int]:
    """Parameter name -> the dimension it is split along over ``fsdp``."""
    return {f"{mod_name}.{leaf}" if mod_name else leaf: dim
            for mod_name, mod in module.named_modules()
            for leaf, dim in getattr(mod, "_fsdp_leaves", {}).items()}


def split_groups(module: nn.Module, mesh: Optional[mesh_lib.Mesh] = None
                 ) -> List[Tuple[object, List[nn.Parameter]]]:
    """(group, parameters split over it) for ``fsdp`` and ``tensor``, the
    axes above 1 that split any of ``module``'s parameters."""
    mesh = mesh or mesh_lib.current()
    if mesh.group("fsdp") is None and mesh.group("tensor") is None:
        return []  # one process's step pays no scan of the names
    dims = sharded_dims(module)
    named = list(module.named_parameters())
    out = []
    for axis, split in (("fsdp", lambda n: n in dims),
                        ("tensor", lambda n: mesh_lib.param_sharding(n) is not None)):
        params = [p for n, p in named if split(n)]
        if mesh.group(axis) is not None and params:
            out.append((mesh.group(axis), params))
    return out


def gather_module(module: nn.Module, meta: nn.Module,
                  mesh: Optional[mesh_lib.Mesh] = None) -> List[tuple]:
    """Fill ``meta`` (the same model built whole on the meta device) with
    ``module``'s parameters gathered whole (collective over ``fsdp`` and
    ``tensor``) and its buffers (whole on every rank, shared); returns
    (name, shard, dim, whole) for every parameter."""
    mesh = mesh or mesh_lib.current()
    dims = sharded_dims(module)
    pairs = []
    for name, p in module.named_parameters():
        dim = dims.get(name)
        whole = nn.Parameter(mesh_lib.all_gather_param(name, p.detach(), mesh, dim),
                             requires_grad=p.requires_grad)
        owner, _, leaf = name.rpartition(".")
        setattr(meta.get_submodule(owner), leaf, whole)
        pairs.append((name, p, dim, whole))
    for name, b in module.named_buffers():
        owner, _, leaf = name.rpartition(".")
        meta.get_submodule(owner)._buffers[leaf] = b
    return pairs


def gather_optimizer_state(optimizer: torch.optim.Optimizer, whole: torch.optim.Optimizer,
                           pairs: List[tuple], mesh: Optional[mesh_lib.Mesh] = None) -> None:
    """Put ``optimizer``'s per-parameter state, gathered whole, into
    ``whole`` (an optimizer over ``gather_module``'s whole parameters)."""
    mesh = mesh or mesh_lib.current()
    for name, p, dim, full in pairs:
        if p in optimizer.state:
            whole.state[full] = {
                k: mesh_lib.all_gather_param(name, v, mesh, dim)
                if isinstance(v, torch.Tensor) and v.shape == p.shape else v
                for k, v in sorted(optimizer.state[p].items())}


def load_module(module: nn.Module, whole: nn.Module, optimizer=None, whole_optimizer=None,
                mesh: Optional[mesh_lib.Mesh] = None) -> None:
    """Take this rank's shards of ``whole``'s parameters (and of
    ``whole_optimizer``'s state into ``optimizer``), and ``whole``'s
    buffers: ``gather_module``'s inverse."""
    mesh = mesh or mesh_lib.current()
    dims = sharded_dims(module)

    def shard(name, full):
        return mesh_lib.shard_param(name, full, mesh, dims.get(name))

    fulls = dict(whole.named_parameters())
    buffers = dict(whole.named_buffers())
    with torch.no_grad():
        for name, p in module.named_parameters():
            w = fulls[name]
            p.copy_(shard(name, w.detach()))
            if optimizer is not None:
                optimizer.state.pop(p, None)
                if whole_optimizer is not None and w in whole_optimizer.state:
                    optimizer.state[p] = {
                        k: shard(name, v) if isinstance(v, torch.Tensor) and v.shape == w.shape
                        else v for k, v in whole_optimizer.state[w].items()}
        for name, b in module.named_buffers():
            if buffers[name] is not b:
                b.copy_(buffers[name])
