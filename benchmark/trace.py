"""Device time by layer from a ``torch.profiler`` Chrome trace.

The call-site attribution is a frozen copy of the measured package's
``tools/op_profile.py`` grouping: each device operation hangs from its
launch by correlation id; its frames are the Python calls open at the
launch, and a kernel launched in the backward pass also takes the frames of
the forward op that recorded its autograd node (the same sequence number).
``LAYERS`` names a layer by the first rule that matches the kernel's name
or its frames. ``parse`` returns per traced step the device milliseconds
of each layer, the busy and window seconds and the idle share, the NCCL
time during which no other kernel ran (exposed all-reduce), and the
breakdown: the top device operations and the idle gaps by what the host
was doing when each began.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

PACKAGE = "headct_foundation_tpu_torch/"
# (layer, kernel-name substrings, frame substrings), first match wins
LAYERS = [
    ("allreduce", ("nccl",), ()),
    ("prefetch", (), (PACKAGE + "data/pipeline.py",)),
    ("optimizer", (), ("/optim/", "Optimizer.step")),
    ("augment", (), (PACKAGE + "data/augment.py", PACKAGE + "data/device_preprocess.py")),
    ("attention", (), (PACKAGE + "ops/attention.py", PACKAGE + "ops/flash_attention.py")),
]
OTHER = "models"
_PY_FRAME = re.compile(r"^(.*\.py)\((\d+)\): (.*)$")
_BACKWARD = "autograd::engine::evaluate_function: "
_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCHES = ("cuda_runtime", "cuda_driver")
_RANGES = ("cpu_op", "python_function")
TOP = 10


def port_frame(frames: List[str]) -> Optional[str]:
    """The innermost frame in the measured package, as "module.py:line func"."""
    for f in frames:
        m = _PY_FRAME.match(f)
        path = m.group(1) if m else f
        if PACKAGE in path:
            rel = path[path.rindex(PACKAGE) + len(PACKAGE):]
            return f"{rel}:{m.group(2)} {m.group(3)}" if m else rel
    return None


def _seq(e: dict) -> int:
    return int(e.get("args", {}).get("Sequence number", -1))


def _sweep(trace: List[dict]) -> Tuple[Dict[Any, List[dict]], List[list]]:
    """The open ranges (outermost first) of the launching thread at each
    launch, by correlation id, and every op with its thread's stack."""
    threads: Dict[Any, List[dict]] = defaultdict(list)
    for e in trace:
        if e.get("ph") == "X" and e.get("cat") in _RANGES + _LAUNCHES:
            threads[(e.get("pid"), e.get("tid"))].append(e)
    launches: Dict[Any, List[dict]] = {}
    ops: List[list] = []
    for events in threads.values():  # each thread's ranges nest; threads overlap
        open_ranges: List[dict] = []
        for e in sorted(events, key=lambda e: (e["ts"], -e.get("dur", 0))):
            while open_ranges and open_ranges[-1]["ts"] + open_ranges[-1].get("dur", 0) <= e["ts"]:
                open_ranges.pop()
            if e["cat"] in _LAUNCHES:
                launches[e.get("args", {}).get("correlation")] = list(open_ranges)
                continue
            if e["cat"] == "cpu_op":
                ops.append([e, list(open_ranges)])
            open_ranges.append(e)
    return launches, ops


def _site(stack: List[dict]) -> Tuple[List[str], Optional[dict]]:
    """(the names of the ranges innermost first, down to any backward node;
    the innermost backward node)."""
    names: List[str] = []
    for e in reversed(stack):
        if e["name"].startswith(_BACKWARD):
            return names, e
        names.append(e["name"])
    return names, None


def layer_of(kernel: str, frames: List[str]) -> str:
    low = kernel.lower()
    for layer, names, sites in LAYERS:
        if any(n in low for n in names) or any(s in f for f in frames for s in sites):
            return layer
    return OTHER


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _covered(a: float, b: float, union: List[Tuple[float, float]], starts: List[float]) -> float:
    """How much of [a, b] the sorted disjoint ``union`` covers."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    got = 0.0
    while i < len(union) and union[i][0] < b:
        lo, hi = max(a, union[i][0]), min(b, union[i][1])
        got += max(0.0, hi - lo)
        i += 1
    return got


def parse(trace: List[dict], steps: int) -> Dict[str, Any]:
    launches, ops = _sweep(trace)
    forward: Dict[int, List[str]] = {}
    for op, stack in ops:
        names, node = _site(stack + [op])
        if _seq(op) >= 0 and node is None:
            forward.setdefault(_seq(op), names)
    device = [e for e in trace if e.get("ph") == "X" and e.get("cat") in _DEVICE]
    if not device:
        raise RuntimeError("the profile recorded no device operation")
    layer_us: Dict[str, float] = defaultdict(float)
    by_name: Dict[str, float] = defaultdict(float)
    nccl, other = [], []
    launch_thread = {e.get("args", {}).get("correlation"): (e.get("pid"), e.get("tid"))
                     for e in trace if e.get("cat") in _LAUNCHES}
    ender: Dict[float, Any] = {}  # a device op's start -> the thread that launched it
    for e in device:
        us = float(e.get("dur", 0))
        names, node = _site(launches.get(e.get("args", {}).get("correlation"), []))
        if node is not None:
            names = names + forward.get(_seq(node), [])
        layer = layer_of(e["name"], names)
        layer_us[layer] += us
        by_name[e["name"]] += us
        (nccl if layer == "allreduce" else other).append((e["ts"], e["ts"] + us))
        ender.setdefault(e["ts"], launch_thread.get(e.get("args", {}).get("correlation")))
    busy = _union(nccl + other)
    host = [e for e in trace if e.get("ph") == "X" and e.get("cat") in _RANGES]
    start = min([e["ts"] for e in host] + [busy[0][0]])
    end = busy[-1][1]
    window_us = end - start
    busy_us = sum(b - a for a, b in busy)
    compute = _union(other)
    starts = [a for a, _ in compute]
    exposed = sum((b - a) - _covered(a, b, compute, starts) for a, b in _union(nccl))
    gaps = [(a, b) for a, b in zip([start] + [b for _, b in busy], [a for a, _ in busy])
            if b > a]
    return {"steps": steps, "layer_ms": {k: v / steps / 1e3 for k, v in layer_us.items()},
            "busy_s": busy_us / 1e6, "window_s": window_us / 1e6,
            "idle_pct": 100.0 * (1.0 - busy_us / window_us),
            "allreduce_exposed_ms": exposed / steps / 1e3 if nccl else None,
            "breakdown": {"device_ops": [[n, us / 1e6] for n, us in sorted(
                              by_name.items(), key=lambda kv: -kv[1])[:TOP]],
                          "idle_gaps": _gaps_by_host(trace, gaps, ender)}}


def _gaps_by_host(trace: List[dict], gaps: List[Tuple[float, float]],
                  ender: Dict[float, Any]) -> List[list]:
    """Idle seconds summed by what the thread that launched the kernel ending
    each gap was in when the gap began: its innermost frame in the measured
    package, else its innermost op; the ``TOP`` largest."""
    threads: Dict[Any, List[dict]] = defaultdict(list)
    for e in trace:
        if e.get("ph") == "X" and e.get("cat") in _RANGES:
            threads[(e.get("pid"), e.get("tid"))].append(e)
    queries: Dict[Any, List[Tuple[float, float]]] = defaultdict(list)
    for a, b in gaps:
        queries[ender.get(b)].append((a, b))
    totals: Dict[str, float] = defaultdict(float)
    for thread, asked in queries.items():
        host = sorted(threads.get(thread, []), key=lambda e: (e["ts"], -e.get("dur", 0)))
        open_ranges: List[dict] = []
        j = 0
        for a, b in sorted(asked):
            while j < len(host) and host[j]["ts"] <= a:
                while (open_ranges and open_ranges[-1]["ts"] + open_ranges[-1].get("dur", 0)
                       <= host[j]["ts"]):
                    open_ranges.pop()
                open_ranges.append(host[j])
                j += 1
            live = [e for e in open_ranges if e["ts"] + e.get("dur", 0) > a]
            frames = [e["name"] for e in reversed(live) if e["cat"] == "python_function"]
            ops_open = [e["name"] for e in reversed(live) if e["cat"] == "cpu_op"]
            label = port_frame(frames) or (ops_open[0] if ops_open else "(no op open)")
            totals[label] += (b - a) / 1e6
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]]


def export(prof) -> List[dict]:
    """The profile's Chrome trace events (written to a temporary file and
    removed)."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
