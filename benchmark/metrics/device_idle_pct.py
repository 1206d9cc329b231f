"""Share of the traced stretch (rank 0's card) in which no device operation
ran."""


def read(run):
    return None if run.profile is None else run.profile["idle_pct"]
