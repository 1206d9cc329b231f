"""Profiling hook of the training loop.

``profile_trace`` is the counterpart of the JAX package's
``utils/misc.py:40``: with ``HEADCT_PROFILE_DIR`` set (or ``log_dir``
given) it records a ``torch.profiler`` trace (host and, on a card, CUDA
activity) of the block it wraps and writes it there as a Chrome trace
(``trace_<pid>.json``). The trainer wraps its first epoch in it.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str] = None) -> Iterator[None]:
    log_dir = log_dir or os.environ.get("HEADCT_PROFILE_DIR")
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))
