"""``dist.all_reduce`` calls of rank 0's ``all_reduce_sum_`` per step (one a
bucket of at most ``BUCKET_BYTES``): the measured package's own counter over
every step of the run (``spans.counter_per_step``)."""

from benchmark import spans


def read(run):
    return spans.counter_per_step(run, "calls")
