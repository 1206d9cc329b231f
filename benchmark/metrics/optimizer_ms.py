"""Device milliseconds per traced step under the optimizer's step
(``torch.optim`` and the package's ``optim/`` call sites)."""


def read(run):
    if run.profile is None:
        return None
    return run.profile["layer_ms"].get("optimizer") or None
