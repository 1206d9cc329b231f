"""Device milliseconds per traced step at the on-card windowing and
augmentation call sites (``data/device_preprocess.py``, ``data/augment.py``)."""


def read(run):
    if run.profile is None:
        return None
    return run.profile["layer_ms"].get("augment") or None
