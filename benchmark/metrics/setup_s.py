"""Seconds from the start of the (rank-0) process to the window's first
step: imports, kernel builds and loads, the state, the weights, the ring
and the compared warm-up steps."""


def read(run):
    return run.setup_s
