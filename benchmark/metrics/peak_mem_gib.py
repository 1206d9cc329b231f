"""The largest ``torch.cuda.max_memory_allocated`` over the cell's cards,
reset as the window opens, in GiB."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
