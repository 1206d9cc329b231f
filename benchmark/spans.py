"""Per-layer readings from the measured package's own spans and counters.

The package (``headct_foundation_tpu_torch/utils/tracing.py``) records a span
for each stage of a step: ``step`` and ``drain`` in the epoch loop;
``augment``, ``fwd``, ``bwd``, ``allreduce``, ``update`` ⊃ ``optimizer`` inside
``step``; ``setup.*`` while the train state is built. Two traced stretches
read them (``span_run.py``):

* S: spans on (an event at each ``allreduce`` entry), no profiler. Host
  milliseconds per step by span (``host_ms``) and each step's all-reduce
  entry on the device, on the spans' clock, which every process on the
  machine shares (``entry_skew_ms`` over the ranks). The loop's period
  (``period_ms``) is the caller's: ``span_run`` times S's steps from their
  starts over all ``SPAN_STEPS`` intervals, which hold both of the
  stretch's loss drains; the complete steps' own ``step`` starts span one
  interval fewer, which holds one drain or two as the window fell.
* P: spans on under ``torch.profiler`` without stacks, where each span is a
  ``user_annotation`` range. A device operation belongs to the innermost
  span open on the thread that launched it; one launched on autograd's
  thread (a range ``autograd::engine::evaluate_function`` open at the
  launch) to the innermost span the loop thread had open at its launch;
  one launched elsewhere, or whose launch the trace lacks, to ``(other
  thread)`` (``device_ms``). Each idle gap between device operations goes
  to the innermost span the loop thread had open when it began, ``(no
  span)`` where none was (``idle_ms``). The loop thread is the one that
  holds the ``step`` ranges (most of them, if several do). Only the
  package's spans (``SPANS``, ``setup.*``) count: ``torch.optim`` opens
  ranges of its own (``Optimizer.step#AdamW.step``).

``counter_per_step`` reads the package's all-reduce counters
(``parallel/distributed.py all_reduce_sum_.calls`` / ``.bytes``) per step.

Records here are plain dicts (``plain``): name, start, end (ns), id, parent,
step, thread, and ``device`` (the entry event's time on the spans' clock, or
None). ``metrics`` turns every rank's reductions into the per-layer metrics
``UNITS`` names. Nothing here imports the measured package at module level,
so a checkout without spans reads nothing and raises nothing.
"""

from __future__ import annotations

import bisect
import statistics
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

from benchmark import trace

SPANS = ("step", "drain", "augment", "fwd", "bwd", "allreduce", "update", "optimizer")
NO_SPAN = "(no span)"
OTHER_THREAD = "(other thread)"
UNITS = {"step_host_ms": "ms", "fwd_host_ms": "ms", "bwd_host_ms": "ms", "update_host_ms": "ms",
         "drain_host_ms": "ms", "augment_span_ms": "ms", "optimizer_span_ms": "ms",
         "device_idle_span_pct": "%", "init_weights_s": "s", "allreduce_host_ms": "ms",
         "allreduce_skew_ms": "ms"}


def plain(records: Sequence[Any], anchor: Optional[Tuple[Any, int]] = None) -> List[dict]:
    """``tracing.Record``s as dicts, each entry event mapped onto the spans'
    clock through ``anchor`` (``tracing.calibrate()``; the device must have
    reached the events)."""
    from headct_foundation_tpu_torch.utils import tracing

    out = []
    for r in records:
        dev = None
        if r.event is not None and anchor is not None:
            dev = tracing.device_ns(r.event, anchor)
        out.append({"name": r.name, "start": r.start, "end": r.end, "id": r.id,
                    "parent": r.parent, "step": r.step, "thread": r.thread, "device": dev})
    return out


def complete_steps(records: List[dict]) -> List[dict]:
    """The records of the steps whose ``step`` span finished in the stretch
    (the spans of a step cut by the stretch's start carry no such step id)."""
    done = {r["step"] for r in records if r["name"] == "step" and r["parent"] is None}
    return [r for r in records if r["step"] in done]


def host_ms(records: List[dict]) -> Dict[str, float]:
    """Host milliseconds per complete step by span name (a span's whole
    interval, its children's included)."""
    rs = complete_steps(records)
    steps = sum(r["name"] == "step" and r["parent"] is None for r in rs)
    if not steps:
        return {}
    total: Dict[str, float] = defaultdict(float)
    for r in rs:
        total[r["name"]] += (r["end"] - r["start"]) / 1e6
    return {k: v / steps for k, v in total.items()}


def entries(records: List[dict], name: str = "allreduce") -> Dict[int, int]:
    """Each complete step's first ``name`` entry on the device (ns on the
    spans' clock)."""
    out: Dict[int, int] = {}
    for r in complete_steps(records):
        if r["name"] == name and r["device"] is not None:
            out[r["step"]] = min(out.get(r["step"], r["device"]), r["device"])
    return out


def entry_skew_ms(per_rank: List[Dict[int, int]]) -> Optional[float]:
    """Median over the steps every rank reached of the latest minus the
    earliest rank's entry, in ms."""
    if len(per_rank) < 2:
        return None
    shared = set.intersection(*(set(e) for e in per_rank))
    if not shared:
        return None
    return statistics.median(
        (max(e[s] for e in per_rank) - min(e[s] for e in per_rank)) / 1e6 for s in shared)


class _Open:
    """The innermost ``user_annotation`` range open at a time on one thread
    (the ranges of a thread nest)."""

    def __init__(self, ranges: List[dict]):
        self.ranges = sorted(ranges, key=lambda e: (e["ts"], -e.get("dur", 0)))
        self.starts = [e["ts"] for e in self.ranges]

    def at(self, t: float) -> Optional[str]:
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0:
            e = self.ranges[i]
            if e["ts"] + e.get("dur", 0) > t:
                return e["name"]
            i -= 1
        return None


def _annotations(events: List[dict]) -> Tuple[Any, Dict[Any, _Open]]:
    """(the loop thread, each thread's ranges)."""
    by_thread: Dict[Any, List[dict]] = defaultdict(list)
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and (e["name"] in SPANS or e["name"].startswith("setup."))):
            by_thread[(e.get("pid"), e.get("tid"))].append(e)
    steps = {th: sum(e["name"] == "step" for e in es) for th, es in by_thread.items()}
    loop = max(steps, key=steps.get) if steps and max(steps.values()) else None
    return loop, {th: _Open(es) for th, es in by_thread.items()}


def _device_ops(events: List[dict]) -> List[dict]:
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in trace._DEVICE]


def device_ms(events: List[dict], steps: int) -> Dict[str, float]:
    """Device milliseconds per step by the span that launched each operation
    (see the module), from a profile's Chrome trace events."""
    loop, open_at = _annotations(events)
    stacks, _ = trace._sweep(events)
    launch = {e.get("args", {}).get("correlation"): e for e in events
              if e.get("ph") == "X" and e.get("cat") in trace._LAUNCHES}
    total: Dict[str, float] = defaultdict(float)
    for op in _device_ops(events):
        corr = op.get("args", {}).get("correlation")
        at = launch.get(corr)
        label = OTHER_THREAD
        if at is not None and loop is not None:
            thread = (at.get("pid"), at.get("tid"))
            backward = any(r["name"].startswith(trace._BACKWARD) for r in stacks.get(corr, []))
            if thread == loop or backward:
                label = open_at[loop].at(at["ts"]) or NO_SPAN
        total[label] += float(op.get("dur", 0)) / 1e3
    return {k: v / steps for k, v in total.items()}


def busy_and_gaps(events: List[dict]) -> Tuple[float, List[Tuple[float, float]]]:
    """(the device's busy microseconds, the idle gaps between its operations)."""
    busy = trace._union([(e["ts"], e["ts"] + float(e.get("dur", 0))) for e in _device_ops(events)])
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]]
    return sum(b - a for a, b in busy), gaps


def idle_ms(events: List[dict], steps: int) -> Dict[str, float]:
    """Idle milliseconds per step between device operations, by the span
    the loop thread had open when each gap began."""
    loop, open_at = _annotations(events)
    _, gaps = busy_and_gaps(events)
    total: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        label = (open_at[loop].at(a) if loop is not None else None) or NO_SPAN
        total[label] += (b - a) / 1e3
    return {k: v / steps for k, v in total.items()}


def idle_span_pct(busy_ms_per_step: float, period_ms: float) -> float:
    """The device's idle share of an unprofiled step: 100 x (1 - the device's
    busy ms per step under the profiler / the step period with spans on and
    no profiler)."""
    return 100.0 * (1.0 - busy_ms_per_step / period_ms)


def reduce_rank(s_records: List[dict], p_events: List[dict], p_steps: int,
                setup: List[dict], period_ms: Optional[float]) -> Dict[str, Any]:
    """One rank's reductions of its S records, P trace and set-up spans;
    ``period_ms`` is S's mean step period."""
    busy_us, _ = busy_and_gaps(p_events)
    setup_s: Dict[str, float] = defaultdict(float)
    for r in setup:
        if r["name"].startswith("setup."):
            setup_s[r["name"]] += (r["end"] - r["start"]) / 1e9
    steps = sorted((r for r in complete_steps(s_records) if r["name"] == "step"),
                   key=lambda r: r["start"])
    return {"s_steps": len(steps), "s_step_ms": [(r["end"] - r["start"]) / 1e6 for r in steps],
            "host_ms": host_ms(s_records),
            "period_ms": period_ms, "entries": entries(s_records),
            "device_ms": device_ms(p_events, p_steps), "idle_ms": idle_ms(p_events, p_steps),
            "busy_ms": busy_us / 1e3 / p_steps if busy_us else None, "setup_s": dict(setup_s)}


def metrics(ranks: List[Dict[str, Any]]) -> Dict[str, float]:
    """The span metrics from every rank's ``reduce_rank`` (rank 0 first). On
    one card: the step's, the stages' and set-up's. On several: the step's
    host ms and the all-reduce's, means over the ranks, and the skew; there
    a NCCL kernel that waits for a slower rank counts as busy, so the idle
    share means nothing. A metric with nothing to read is left out."""
    r0 = ranks[0]
    host, dev = r0["host_ms"], r0["device_ms"]
    out: Dict[str, Optional[float]] = {
        "step_host_ms": _mean([r["host_ms"].get("step") for r in ranks])}
    if len(ranks) > 1:
        out.update(allreduce_host_ms=_mean([r["host_ms"].get("allreduce") for r in ranks]),
                   allreduce_skew_ms=entry_skew_ms([r["entries"] for r in ranks]))
    else:
        out.update({
            "fwd_host_ms": host.get("fwd"), "bwd_host_ms": host.get("bwd"),
            "update_host_ms": host.get("update"),
            "drain_host_ms": host.get("drain", 0.0) if host else None,
            "augment_span_ms": dev.get("augment"), "optimizer_span_ms": dev.get("optimizer"),
            "device_idle_span_pct": (idle_span_pct(r0["busy_ms"], r0["period_ms"])
                                     if r0["period_ms"] and r0["busy_ms"] else None),
            "init_weights_s": r0["setup_s"].get("setup.init_weights")})
    return {k: v for k, v in out.items() if v is not None}


def counter_per_step(run, key: str) -> Optional[float]:
    """Rank 0's ``all_reduce_sum_.<key>`` (``calls`` or ``bytes``, counted by
    the measured package since the process started) over every step the rank
    took: the compared steps, the window's and, in a traced run, the
    stretches after it (``profile["stretch_steps"]``, else two of
    ``trace_steps``). None on one card or where the package has no counter."""
    from headct_foundation_tpu_torch.parallel import distributed

    value = getattr(distributed.all_reduce_sum_, key, None)
    if value is None or run.world == 1:
        return None
    t = run.cell.traffic
    steps = int(t["compared_steps"]) + run.steps
    if run.profile is not None:
        steps += int(run.profile.get("stretch_steps", 2 * int(t["trace_steps"])))
    return value / steps


def _mean(xs: List[Optional[float]]) -> Optional[float]:
    return statistics.fmean(xs) if xs and all(x is not None for x in xs) else None
