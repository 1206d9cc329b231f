"""Spans of the port's own work on the host's monotonic clock.

``span(name, step=None)`` wraps one stage of training in a ``with`` block.

* Off (the default) it returns one shared no-op object: a flag test, no
  clock read, no allocation, no ``record_function``.
* On (``enable()``) each finished span leaves a ``Record``: its name, its
  start and end in ``time.perf_counter_ns()`` (CLOCK_MONOTONIC, which every
  process on the machine shares), the id of the span it was opened in, its
  step id and its thread. A span opened inside another takes its step id
  from that one. ``take()`` returns the finished records and clears them;
  ``disable()`` turns spans off again.
* Under a running ``torch.profiler`` a span also enters
  ``torch.profiler.record_function(name)``, so it appears as a
  ``user_annotation`` range in the profiler's own trace, on the clock of
  the kernels it launches.
* The ``allreduce`` span also records one CUDA event at its entry while
  spans are on and CUDA is initialised (no other span does);
  ``calibrate()`` gives an anchor that maps each such event's device time
  onto the spans' clock (``device_ns``).

The spans the port opens (README, "Tracing the port"): ``step`` and
``drain`` in each engine's ``train_one_epoch``; ``augment``, ``fwd`` and
``bwd`` in the MAE and DINO grad steps; ``allreduce`` in ``parallel/distributed.py
data_mean_``; ``update`` and, inside it, ``optimizer`` in the MAE and DINO
``apply_update``; ``setup.build``, ``setup.init_weights``,
``setup.to_device`` and ``setup.optimizer`` in ``create_train_state``;
``setup.kernels`` around a kernel library's build or load.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import torch

EVENT_SPANS = ("allreduce",)  # the spans that record a CUDA event at entry


@dataclass
class Record:
    name: str
    start: int                # ns, time.perf_counter_ns()
    end: int
    id: int
    parent: Optional[int]     # the id of the span it was opened in
    step: Optional[int]
    thread: int
    event: Any = None         # the CUDA event recorded at entry (EVENT_SPANS)


class _Off:
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


OFF = _Off()


class _Tracer:
    """The process's span state: on, the finished records and each thread's
    open spans."""

    def __init__(self):
        self.on = False
        self.records: List[Record] = []
        self.ids = itertools.count()
        self.local = threading.local()

    def open_spans(self) -> List[Record]:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack


_tracer = _Tracer()


def _profiling() -> bool:
    return bool(getattr(torch.autograd.profiler, "_is_profiler_enabled", False))


def _cuda_ready() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


class _Span:
    __slots__ = ("name", "step", "rec", "annotation")

    def __init__(self, name: str, step: Optional[int]):
        self.name, self.step = name, step
        self.annotation = None

    def __enter__(self) -> Record:
        stack = _tracer.open_spans()
        parent = stack[-1] if stack else None
        step = self.step if self.step is not None else (parent.step if parent else None)
        rec = Record(self.name, 0, 0, next(_tracer.ids), parent.id if parent else None, step,
                     threading.get_ident())
        stack.append(rec)
        if self.name in EVENT_SPANS and _cuda_ready():
            rec.event = torch.cuda.Event(enable_timing=True)
            rec.event.record()
        if _profiling():
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        self.rec = rec
        rec.start = time.perf_counter_ns()
        return rec

    def __exit__(self, *exc) -> bool:
        rec = self.rec
        rec.end = time.perf_counter_ns()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        stack = _tracer.open_spans()
        if stack and stack[-1] is rec:
            stack.pop()
        _tracer.records.append(rec)
        return False


def span(name: str, step: Optional[int] = None):
    """A context manager timing ``name`` (see the module); the shared no-op
    ``OFF`` while spans are off."""
    if not _tracer.on:
        return OFF
    return _Span(name, step)


def enable() -> None:
    _tracer.on = True


def disable() -> None:
    _tracer.on = False


def enabled() -> bool:
    return _tracer.on


def take() -> List[Record]:
    """The finished records in the order they finished; the store is cleared."""
    out, _tracer.records = _tracer.records, []
    return out


def calibrate() -> Optional[Tuple[Any, int]]:
    """(a CUDA event, the spans' clock in ns just after the device reached
    it): synchronise, record the event, wait for it, read the clock. None
    without an initialised CUDA device."""
    if not _cuda_ready():
        return None
    torch.cuda.synchronize()
    anchor = torch.cuda.Event(enable_timing=True)
    anchor.record()
    anchor.synchronize()
    return anchor, time.perf_counter_ns()


def device_ns(event: Any, anchor: Tuple[Any, int]) -> int:
    """The spans' clock when the device reached ``event`` (recorded after
    ``anchor``'s event; both complete)."""
    ev0, host0 = anchor
    return host0 + round(ev0.elapsed_time(event) * 1e6)
