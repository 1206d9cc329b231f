"""The datalist split, the profiling hook of the training loop and the
"at least float32" dtype rule.

``datafold_read`` is the JAX package's ``utils/misc.py:19-37`` (the
reference's ``src/utils/misc.py:99-120``). ``profile_trace`` is the
counterpart of the JAX package's ``utils/misc.py:40``: with
``HEADCT_PROFILE_DIR`` set (or ``log_dir`` given) it records a
``torch.profiler`` trace (host and, on a card, CUDA activity) of the block
it wraps and writes it there as a Chrome trace
(``trace_<pid>.json``). The trainer wraps its first epoch in it. Spans
(``utils/tracing.py``) are on inside it, so the trace holds them as
``user_annotation`` ranges; their records in memory are dropped as it
ends, and spans go back off unless they were on before.

``wide_dtype`` / ``widen`` are the dtype in which the port computes what
it keeps "in float32" (norm statistics, losses, softmax, the split
linears' partial sums, optimizer moments): float32 for bfloat16 and
float32 tensors, float64 for float64 ones (``torch.promote_types`` with
float32). So the bfloat16 and float32 paths compute what a plain
``.float()`` gives, and the downstream main's float64 reference mode
(``main_downstream.run(argv, dtype=torch.float64)``) rounds nowhere to
float32.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Iterator, Optional

import torch

from headct_foundation_tpu_torch.utils import tracing


def wide_dtype(dtype: torch.dtype) -> torch.dtype:
    """float32, or float64 for a float64 ``dtype``."""
    return torch.promote_types(dtype, torch.float32)


def widen(x: torch.Tensor) -> torch.Tensor:
    """``x`` in ``wide_dtype(x.dtype)`` (itself when it is already there)."""
    return x.to(wide_dtype(x.dtype))


def datafold_read(datalist, basedir, fold: int = 0, key: str = "training"):
    """Split a MONAI-style datalist JSON into (train, val) by fold index:
    every string or list-of-string value of each record is joined onto
    ``basedir`` (empty strings left as they are); the records whose
    ``fold`` is ``fold`` are the validation set, the others training."""
    with open(datalist) as f:
        records = json.load(f)[key]
    for d in records:
        for k, v in d.items():
            if isinstance(v, list):
                d[k] = [os.path.join(basedir, item) for item in v]
            elif isinstance(v, str):
                d[k] = os.path.join(basedir, v) if v else v
    tr = [d for d in records if d.get("fold") != fold]
    val = [d for d in records if d.get("fold") == fold]
    return tr, val


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
    was_on = tracing.enabled()
    if not was_on:
        tracing.enable()
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield
    finally:
        if not was_on:
            tracing.disable()
            tracing.take()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))
