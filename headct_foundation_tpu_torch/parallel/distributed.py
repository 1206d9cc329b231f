"""Data-parallel training across processes: the counterpart of the JAX
package's ``data`` mesh axis and of ``jax.process_index`` / ``process_count``.

* ``init_from_env`` starts the process group from the ``torchrun``
  environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``) with its address given explicitly
  (``tcp://MASTER_ADDR:MASTER_PORT``): NCCL on the card, gloo on the CPU.
  Without ``WORLD_SIZE`` (or at 1) it starts nothing and the process is
  rank 0 of 1. ``PARALLEL.DATA`` is the world size the run asks for; a
  mismatch raises.
* ``rank`` / ``world`` / ``local_rank`` serve the loaders and the logger.
* ``all_reduce_mean_`` averages tensors across the ranks in place, in
  buckets of at most ``BUCKET_BYTES`` flattened together, one
  ``all_reduce`` each. The train step calls it once per update on the
  accumulated gradients, before the clip and the optimizer, so every rank
  takes the same update: the module is never wrapped in
  ``DistributedDataParallel``, its parameter names stay the model's, and
  the micro-batches need no ``no_sync``.
"""

from __future__ import annotations

import os
from typing import List, Sequence

import torch
import torch.distributed as dist

BUCKET_BYTES = 64 << 20


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def init_from_env(device_type: str, data_axis: int = -1) -> int:
    """Join the process group ``torchrun`` describes; returns the world size.

    ``data_axis`` is ``PARALLEL.DATA`` (-1: whatever the launcher gives)."""
    size = int(os.environ.get("WORLD_SIZE", "1"))
    if data_axis not in (-1, size):
        raise ValueError(f"PARALLEL.DATA = {data_axis} but the launcher started {size} "
                         f"processes; the port runs one process per data-parallel rank")
    if size == 1 or dist.is_initialized():
        return world()
    addr = os.environ.get("MASTER_ADDR", "localhost")
    port = os.environ["MASTER_PORT"]
    dist.init_process_group(backend="nccl" if device_type == "cuda" else "gloo",
                            init_method=f"tcp://{addr}:{port}",
                            rank=int(os.environ["RANK"]), world_size=size)
    return size


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


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
def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Each tensor becomes its mean over the ranks (a no-op at world 1)."""
    n = world()
    if n == 1:
        return
    for bucket in _buckets(list(tensors)):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat)
        flat.div_(n)
        offset = 0
        for t in bucket:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
