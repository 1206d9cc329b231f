"""A traced run of one cell with the span stretches after the profiled ones.

    python -m benchmark.span_run --workload <cell> --seed <n> --seconds <s>

``benchmark.run --trace 1`` as it stands (the same set-up, window, profiled
stretches, reference, checks and last line), with the measured package's
spans (``spans.py``) read around it:

* spans are on through set-up (its ``setup.*`` spans) and off from the
  window's start, so the window and the two profiled stretches run as in
  ``benchmark.run``;
* after the profiled stretches ``SETTLE_STEPS`` steps, then the control C
  (spans off, no profiler), one step that turns spans on, S (spans, with
  their event at each all-reduce entry, no profiler) and P (spans under
  ``torch.profiler`` without stacks): ``SPAN_STEPS`` steps each
  (``2 x LOSS_FLUSH``: two loss drains a stretch). C and S, timed alike
  from their steps' starts, give what spans cost; S's period is the one
  the idle share divides by.

Standard error gets the host ms, device ms and idle ms per step by span and
the cost of spans (S's step period against C's and the window's median
interval);
the last line adds the span metrics of ``spans.UNITS`` to ``metrics`` and
``span_cost``. It wraps ``harness.Tracer``, ``data.TimedRing`` and
``run.result_line`` in this process and its ranks' processes only: what
``harness.py`` would carry to take these stretches in ``benchmark.run``.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from typing import Any, Dict, List, Optional

from benchmark import data, harness, run, spans, trace

SPAN_STEPS = 16  # 2 x the engines' LOSS_FLUSH
# On several cards each rank reduces the stacked profile for its own while,
# and the next steps wait for the slowest rank (on four H100s the first took
# 245-425 ms against 130): that wait stays out of S.
SETTLE_STEPS = 2
STRETCH = SETTLE_STEPS + 1 + 3 * SPAN_STEPS  # the steps after the profiled stretches
SETUP: List[dict] = []  # this rank's set-up spans


def _tracing():
    from headct_foundation_tpu_torch.utils import tracing

    return tracing


class SpanRing(data.TimedRing):
    """The window's loader with the settling steps and the two span stretches
    after its ``extra``; spans go off as the window opens."""

    def __init__(self, *args, extra: int = 0, **kw):
        super().__init__(*args, extra=extra + (STRETCH if extra else 0), **kw)

    def start(self) -> None:
        tracing = _tracing()
        SETUP.extend(spans.plain([r for r in tracing.take() if r.name.startswith("setup.")]))
        tracing.disable()
        super().start()


class SpanTracer(harness.Tracer):
    """``harness.Tracer``'s two stretches, then the settling steps, C, S and
    P (see the module)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.anchor: Any = None
        self.s_records: List[dict] = []
        self.p_events: Optional[List[dict]] = None
        self.starts: Dict[int, int] = {}  # each step's start (ns), C to P

    def __call__(self, n: int) -> None:
        if self.loader.timed is None:
            return
        tracing = _tracing()
        settle = self.compared + self.loader.timed + 2 * self.steps
        c_start = settle + SETTLE_STEPS
        s_start = c_start + SPAN_STEPS + 1
        if c_start <= n <= s_start + SPAN_STEPS:
            self.starts[n - c_start] = time.perf_counter_ns()
        if n < settle:
            super().__call__(n)
        if n == settle:
            self._stop()  # the stacked stretch, as harness.Tracer.result stops it
        if n == s_start - 1:
            tracing.enable()
            self.anchor = tracing.calibrate()
        elif n == s_start + SPAN_STEPS:
            harness._sync(self.device)
            self.s_records = spans.plain(tracing.take(), self.anchor)
            super()._start(stacks=False)

    def _stop(self) -> None:
        if len(self.parsed) < 2:
            super()._stop()
            return
        harness._sync(self.device)
        self.prof.stop()
        self.p_events = trace.export(self.prof)
        self.prof = None

    def result(self) -> dict:
        self._stop()
        _tracing().disable()
        _tracing().take()
        plain, stacked = self.parsed
        plain["layer_ms"] = stacked["layer_ms"]
        t, k = self.starts, SPAN_STEPS
        plain["spans"] = spans.reduce_rank(self.s_records, self.p_events, SPAN_STEPS, SETUP,
                                           (t[2 * k + 1] - t[k + 1]) / 1e6 / k)
        plain["spans"]["control_period_ms"] = (t[k] - t[0]) / 1e6 / k
        plain["stretch_steps"] = 2 * self.steps + STRETCH
        return plain


def _result_line(cell, results: List[dict], *args, **kw) -> dict:
    line = _plain_result_line(cell, results, *args, **kw)
    ranks = [r["profile"]["spans"] for r in results]
    r0 = ranks[0]
    for label, key in (("host", "host_ms"), ("device", "device_ms"), ("idle", "idle_ms")):
        print(f"span {label} ms per step: {json.dumps(_rounded(r0[key]))}", file=sys.stderr)
    print(f"span set-up seconds: {json.dumps(_rounded(r0['setup_s']))}", file=sys.stderr)
    if len(ranks) > 1:
        print("span host ms per step by rank: "
              + json.dumps([_rounded(r["host_ms"]) for r in ranks]), file=sys.stderr)
    for i, (r, s) in enumerate(zip(results, ranks)):
        print(f"rank {i}: window dispatch ms {statistics.fmean(r['host_ms']):.3f}, window median "
              f"interval ms {statistics.median(r['intervals_ms']):.3f}, S period ms "
              f"{s['period_ms']:.3f}, S step host ms {[round(x, 1) for x in s['s_step_ms']]}",
              file=sys.stderr)
    values = spans.metrics(ranks)
    line["metrics"].update({k: {"value": v, "unit": spans.UNITS[k]} for k, v in values.items()})
    median = statistics.median(results[0]["intervals_ms"]) if results[0]["intervals_ms"] else None
    line["span_cost"] = {"s_period_ms": r0["period_ms"], "window_median_ms": median,
                         "control_period_ms": r0["control_period_ms"]}
    print(f"span cost: S period {r0['period_ms']} ms, C period (spans off) "
          f"{r0['control_period_ms']} ms, window median interval {median} ms", file=sys.stderr)
    return line


def _rounded(d: dict) -> dict:
    return {k: round(v, 4) for k, v in sorted(d.items(), key=lambda kv: -kv[1])}


_plain_result_line = run.result_line


def install() -> None:
    """Swap the stretches and the last line in (this process)."""
    harness.Tracer = SpanTracer
    data.TimedRing = SpanRing
    run.result_line = _result_line
    _tracing().enable()


def _start_ranks(module: str, argv, chips: int, rank: int):
    return _plain_start_ranks("benchmark.span_run", argv, chips, rank)


_plain_start_ranks = run.start_ranks


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv) + ["--trace", "1"]  # the last one counts
    install()
    run.start_ranks = _start_ranks
    return run.main(argv)


if __name__ == "__main__":
    sys.exit(main())
