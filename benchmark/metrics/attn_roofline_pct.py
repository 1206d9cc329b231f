"""The least time one step's attention needs (``counts.attention_bound_s``
of the cell's attention shapes: each call the larger of its operations at
the bf16 peak and its bytes at the memory peak) over the device time per
traced step at the attention dispatch's call sites, in %."""

from benchmark import counts


def read(run):
    peak = run.peak
    if run.profile is None or peak is None:
        return None
    spent = run.profile["layer_ms"].get("attention")
    if not spent:
        return None
    calls = counts.attention_calls(run.cell.engine, run.run_cfg, run.batch)
    return 100.0 * 1e3 * counts.attention_bound_s(calls, peak) / spent
