"""Megabytes (1e6 bytes) rank 0's ``all_reduce_sum_`` handed to
``dist.all_reduce`` per step: the measured package's own counter over every
step of the run (``spans.counter_per_step``), the flat buckets of the float32
gradients and the loss."""

from benchmark import spans


def read(run):
    b = spans.counter_per_step(run, "bytes")
    return None if b is None else b / 1e6
