"""Host-to-device input pipeline: pinned, stream-ordered batch prefetch.

Port of the JAX package's ``data/pipeline.py``:

* ``DevicePrefetcher`` (JAX ``:93``) copies each host batch into pinned
  memory and onto the card on a side CUDA stream, in a background thread,
  ``depth`` batches ahead of the train loop, so the copy runs under the
  previous step's compute:

      loader threads (decode, cache) -> DevicePrefetcher (pinned H2D)
          -> train loop (launches only)

  The consumer's stream waits on each batch's copy through an event, and
  the device tensor is marked used on the consumer's stream
  (``record_stream``), so the allocator does not hand its memory out while
  the step still reads it. The pinned buffers are a ring of ``depth + 2``; a
  buffer is rewritten only after the copy out of it has completed. An error
  in the producer re-raises in the consumer. On a CPU device the batches
  pass through unchanged. For the downstream loaders (JAX
  ``downstream_engine.py:402-413 _wrap_loader``) ``device_fields=(0, 1)``
  carries the integer targets to the card beside the volumes, and the
  paths pass through.
* ``measure_h2d_mbps`` (``:29``) times several chunked pinned copies onto
  the card, best of ``tries``; ``resolve_wire_format`` (``:47``) turns
  ``DATA.WIRE_FORMAT: auto`` into ``hu8`` below ``DATA.WIRE_AUTO_MBPS``, else
  ``hu16``.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Any, Iterator, List, Optional

import numpy as np
import torch

from headct_foundation_tpu_torch.data.datasets import put_or_stop

CHUNK_BYTES = 16 << 20  # the probe's copy size; it makes several per try


def measure_h2d_mbps(device: torch.device, nbytes: int = 64 << 20, tries: int = 3) -> float:
    """Host-to-device rate (MB/s) of ``nbytes`` from pinned memory, copied
    as ``nbytes / CHUNK_BYTES`` chunks on one stream; best of ``tries``."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the host-to-device probe needs a CUDA device, got {device}")
    host = torch.zeros(nbytes // 2, dtype=torch.int16, pin_memory=True)
    dev = torch.empty_like(host, device=device)
    chunks = list(zip(host.split(CHUNK_BYTES // 2), dev.split(CHUNK_BYTES // 2)))
    best = float("inf")
    for _ in range(max(1, tries)):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for src, dst in chunks:
            dst.copy_(src, non_blocking=True)
        torch.cuda.synchronize(device)
        best = min(best, time.perf_counter() - t0)
    return nbytes / 1e6 / best


def resolve_wire_format(config, device: torch.device, probe_mbps: Optional[float] = None) -> str:
    """``DATA.WIRE_FORMAT``, with ``auto`` resolved from the measured
    host-to-device rate: ``hu8`` below ``DATA.WIRE_AUTO_MBPS``, else ``hu16``."""
    wire = str(config.DATA.WIRE_FORMAT)
    if wire != "auto":
        return wire
    mbps = measure_h2d_mbps(device) if probe_mbps is None else probe_mbps
    chosen = "hu8" if mbps < float(config.DATA.WIRE_AUTO_MBPS) else "hu16"
    logging.getLogger(__name__).info("WIRE_FORMAT=auto: measured H2D %.1f MB/s -> %s",
                                     mbps, chosen)
    return chosen


class _PinnedRing:
    """``n`` reusable pinned buffers, each with the event of the last copy
    out of it."""

    def __init__(self, n: int):
        self.bufs: List[Optional[torch.Tensor]] = [None] * n
        self.events: List[Optional[torch.cuda.Event]] = [None] * n
        self.i = 0

    def take(self, like: np.ndarray) -> tuple:
        i, self.i = self.i, (self.i + 1) % len(self.bufs)
        if self.events[i] is not None:
            self.events[i].synchronize()  # its last copy has completed
        src = torch.from_numpy(np.ascontiguousarray(like))
        buf = self.bufs[i]
        if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
            buf = self.bufs[i] = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        buf.copy_(src)
        return i, buf


class DevicePrefetcher:
    """Wrap an iterable of host batches (arrays, or tuples whose first field
    is the volume array, such as (volumes, paths)); yield the same structure
    with the volume on ``device``, and with it each field of a tuple batch
    named in ``device_fields``. Tensors already on the device pass through."""

    def __init__(self, loader: Any, device: torch.device, depth: int = 2,
                 device_fields: tuple = (0,)):
        self.loader = loader
        self.device = torch.device(device)
        self.depth = max(depth, 1)
        self.device_fields = tuple(device_fields)

    @classmethod
    def wrap(cls, loader: Any, device: torch.device, **kw) -> "DevicePrefetcher":
        return loader if isinstance(loader, cls) else cls(loader, device, **kw)

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.loader, "set_epoch"):
            self.loader.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self) -> Iterator[Any]:
        if self.device.type != "cuda":
            yield from self.loader
            return
        device = self.device if self.device.index is not None else torch.device(
            "cuda", torch.cuda.current_device())
        out_q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        copy_stream = torch.cuda.Stream(device)
        rings = {i: _PinnedRing(self.depth + 2) for i in self.device_fields}

        def place(arr, ring):
            """(device tensor, event of its copy) for one field of a batch."""
            if isinstance(arr, torch.Tensor) and arr.device == device:
                return arr, None
            slot, pinned = ring.take(arr.numpy() if isinstance(arr, torch.Tensor) else arr)
            with torch.cuda.stream(copy_stream):
                dev = pinned.to(device, non_blocking=True)
                done = torch.cuda.Event()
                done.record(copy_stream)
            ring.events[slot] = done
            return dev, done

        def producer():
            try:
                torch.cuda.set_device(device)
                for batch in self.loader:
                    if stop.is_set():
                        return
                    if isinstance(batch, tuple):
                        fields, devs, done = list(batch), [], None
                        for i in self.device_fields:
                            fields[i], done_i = place(batch[i], rings[i])
                            devs.append(fields[i])
                            done = done_i or done  # the last copy: the stream orders them
                        item = (tuple(fields), devs, done)
                    else:
                        dev, done = place(batch, rings[0])
                        item = (dev, [dev], done)
                    if not put_or_stop(out_q, item, stop):
                        return
            except Exception as e:  # re-raised in the consumer
                put_or_stop(out_q, e, stop)
            finally:
                put_or_stop(out_q, None, stop)

        thread = threading.Thread(target=producer, name="headct-prefetch", daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                batch, devs, done = item
                if done is not None:
                    consumer = torch.cuda.current_stream(device)
                    consumer.wait_event(done)
                    for dev in devs:
                        dev.record_stream(consumer)
                yield batch
        finally:
            stop.set()
            try:
                while True:
                    out_q.get_nowait()
            except queue.Empty:
                pass
            thread.join()
