"""HU window constants of the preprocessing chain.

The windows and their math ((x - a_min) / (a_max - a_min), clipped to
[0, 1]) match the reference (src/data/transforms.py:8-36, 119-134) and the
JAX package's ``data/transforms.py:31-33``. The rest of the host-side
transform chain is not ported yet: the serving path preprocesses on the
device (``data/device_preprocess.py``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# (center, width) windows for the 3-channel stack: brain, subdural, bone
# (reference: src/data/transforms.py:130).
WINDOW_SIZES_3CH = [(40, 80), (80, 200), (600, 2800)]
# 1-channel variant: center 40, +-150 (reference: src/data/transforms.py:120-128).
WINDOW_1CH = (40 - 150, 40 + 150)


def window_params(in_channels: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-channel (low, high) HU bounds as float32 arrays."""
    if in_channels == 1:
        lows, highs = [WINDOW_1CH[0]], [WINDOW_1CH[1]]
    elif in_channels == 3:
        lows = [c - w // 2 for c, w in WINDOW_SIZES_3CH]
        highs = [c + w // 2 for c, w in WINDOW_SIZES_3CH]
    else:
        raise NotImplementedError(f"Channel size {in_channels} is not implemented.")
    return np.asarray(lows, np.float32), np.asarray(highs, np.float32)
