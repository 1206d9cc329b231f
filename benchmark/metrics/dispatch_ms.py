"""Mean host milliseconds of one call of the CLI's step inside the epoch
loop (the benchmark's clock around each call, every card's window steps)."""

import statistics


def read(run):
    return statistics.fmean(run.host_ms) if run.host_ms else None
