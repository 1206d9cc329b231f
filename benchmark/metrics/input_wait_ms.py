"""The epoch loop's own ``data_time``: mean milliseconds a step waited on
the prefetcher for its batch (averaged over the cards)."""


def read(run):
    return 1e3 * run.data_time_s
