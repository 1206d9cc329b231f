"""Per traced step, the NCCL kernels' time during which no other kernel ran
on rank 0's card: the gradient average that no compute hides."""


def read(run):
    if run.profile is None or run.world == 1:
        return None
    return run.profile["allreduce_exposed_ms"]
