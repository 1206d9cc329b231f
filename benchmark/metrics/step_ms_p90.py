"""The 90th percentile, over every window step of every card, of the time
between consecutive step-end CUDA events (the first from the window's
start event)."""

import statistics


def read(run):
    if len(run.intervals_ms) < 10:
        return None
    return statistics.quantiles(run.intervals_ms, n=10, method="inclusive")[-1]
