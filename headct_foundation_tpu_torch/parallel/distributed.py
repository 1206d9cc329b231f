"""Training across processes: the counterpart of ``jax.process_index`` /
``process_count`` and of the JAX package's mesh, whose layout is
``parallel/mesh.py``'s.

* ``init_from_env`` starts the process group from the ``torchrun``
  environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``) with its address given explicitly
  (``tcp://MASTER_ADDR:MASTER_PORT``): NCCL on the card, gloo on the CPU,
  and makes the config's mesh the process's (``mesh.set_mesh``). Without
  ``WORLD_SIZE`` (or at 1) it starts nothing and the process is rank 0 of
  1. The world must be ``PARALLEL.DATA x FSDP x SEQ x PIPE x TENSOR``
  (``DATA`` -1: what the world leaves); a mismatch raises, as ``PIPE``
  above 1 with another model axis above 1 does.
* ``rank`` / ``world`` / ``local_rank`` serve the logger; ``data_rank`` /
  ``data_world`` (this rank's slice of the batch over ``data`` x ``fsdp``,
  as JAX's ``batch_sharding`` splits it) the loaders and the engines'
  draws, since the ``seq``, ``pipe`` and ``tensor`` ranks of one slice take
  the same batch.
* ``all_reduce_mean_`` averages tensors across the ranks of ``group``
  (default all) in place, in buckets of at most ``BUCKET_BYTES``
  flattened together, one ``all_reduce`` each; ``all_reduce_sum_`` sums
  them. The train step calls it once per update on the
  accumulated gradients, before the clip and the optimizer, so every rank
  takes the same update: the module is never wrapped in
  ``DistributedDataParallel``, its parameter names stay the model's, and
  the micro-batches need no ``no_sync``. ``data_mean_`` is that average
  over the batch's ranks (``data`` x ``fsdp``; ``data`` alone under
  ``pipe``, where ``fsdp`` is 1); the gradients of ``fsdp``
  shards, which the gather's backward has already summed over ``fsdp``,
  are summed over ``data`` only.
* ``all_reduce_sum_`` counts what it exchanges, always: ``.calls`` (one per
  ``dist.all_reduce``, a bucket each) and ``.bytes`` (the bucket's bytes),
  plain integers as the kernels' ``.launches`` counters are. ``data_mean_``
  runs its exchange and divide in the ``allreduce`` span
  (``utils/tracing.py``); one slice opens none.
"""

from __future__ import annotations

import os
from typing import List, Sequence

import torch
import torch.distributed as dist

from headct_foundation_tpu_torch.parallel import mesh
from headct_foundation_tpu_torch.utils import tracing

BUCKET_BYTES = 64 << 20


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def laid_out() -> bool:
    """True once a mesh is set (without one every rank is on ``data``)."""
    m = mesh.current()
    return m.sharded or m.size("data") > 1 or m.size("pipe") > 1


def data_rank() -> int:
    return mesh.current().batch_coord if laid_out() else rank()


def data_world() -> int:
    return mesh.current().batch_size if laid_out() else world()


def init_from_env(device_type: str, data_axis: int = -1, config=None) -> int:
    """Join the process group ``torchrun`` describes and set the process's
    mesh; returns the world size. ``data_axis`` is ``PARALLEL.DATA`` (-1:
    what the launcher gives); ``config`` lays out its whole ``PARALLEL``
    section instead (``seq`` and ``tensor`` too)."""
    size = int(os.environ.get("WORLD_SIZE", "1"))
    axes = dict(data=int(data_axis))
    if config is not None:
        p = config.PARALLEL
        axes = dict(data=int(p.DATA), fsdp=int(p.FSDP), seq=int(p.SEQ), pipe=int(p.PIPE),
                    tensor=int(p.TENSOR))
    mesh.layout(world=size, **axes)  # raises before any process group starts
    if size > 1 and not dist.is_initialized():
        addr = os.environ.get("MASTER_ADDR", "localhost")
        port = os.environ["MASTER_PORT"]
        dist.init_process_group(backend="nccl" if device_type == "cuda" else "gloo",
                                init_method=f"tcp://{addr}:{port}",
                                rank=int(os.environ["RANK"]), world_size=size)
    mesh.set_mesh(mesh.make_mesh(**axes))
    return world()


def shutdown() -> None:
    mesh.set_mesh(None)
    if dist.is_initialized():
        dist.destroy_process_group()


def _group_size(group) -> int:
    return world() if group is None else dist.get_world_size(group)


def _buckets(tensors: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
    out: List[List[torch.Tensor]] = []
    size = BUCKET_BYTES
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if (not out or size + nbytes > BUCKET_BYTES or out[-1][0].dtype != t.dtype
                or out[-1][0].device != t.device):
            out.append([])
            size = 0
        out[-1].append(t)
        size += nbytes
    return out


@torch.no_grad()
def all_reduce_sum_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Each tensor becomes its sum over the ranks of ``group`` (default all;
    a no-op over one rank)."""
    if _group_size(group) == 1:
        return
    for bucket in _buckets(list(tensors)):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=group)
        all_reduce_sum_.calls += 1
        all_reduce_sum_.bytes += flat.numel() * flat.element_size()
        offset = 0
        for t in bucket:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


all_reduce_sum_.calls = 0
all_reduce_sum_.bytes = 0


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Each tensor becomes its mean over the ranks of ``group`` (default all)."""
    n = _group_size(group)
    if n > 1:
        all_reduce_sum_(tensors, group)
        torch._foreach_div_(list(tensors), n)


def data_mean_(tensors: Sequence[torch.Tensor], sharded: Sequence[torch.Tensor] = ()) -> None:
    """Each tensor becomes its mean over the batch's ranks (``data`` x
    ``fsdp``; a no-op on one slice). The tensors also in ``sharded`` are
    gradients of ``fsdp`` shards, already summed over ``fsdp``: they are
    summed over ``data`` only, then divided alike."""
    n = data_world()
    if n == 1:
        return
    with tracing.span("allreduce"):
        if not laid_out():
            all_reduce_mean_(tensors)
            return
        m = mesh.current()
        ids = {id(t) for t in sharded}
        whole = [t for t in tensors if id(t) not in ids]
        shards = [t for t in tensors if id(t) in ids]
        if whole:
            all_reduce_sum_(whole, m.group("batch"))
        if shards and m.size("data") > 1:
            all_reduce_sum_(shards, m.group("data"))
        torch._foreach_div_(list(tensors), n)
