"""HU window constants and the hu16 / hu8 wire encodings.

The windows and their math ((x - a_min) / (a_max - a_min), clipped to
[0, 1]) match the reference (src/data/transforms.py:8-36, 119-134) and the
JAX package's ``data/transforms.py:31-33``.

The wire formats (JAX ``data/transforms.py:65-123``) carry one scalar field
of Hounsfield units per voxel; the training step expands it to the window
stack on the device (``data/device_preprocess.py wire_to_compute``):

* hu16: HU clamped to [-800, 2000] (the union of every window's range, so
  the clamp changes no windowed value), then round(HU * 10) as int16.
* hu8: 256 monotone HU levels, 30-HU steps below -20, 1-HU steps over the
  soft-tissue windows [-20, 180], ~62.8-HU steps up to 2000; a voxel codes
  to the nearest level.

Each has its decode and its error-shielding placeholder, a value that
windows to 0 in every channel, as the zero volume of the windowed format
does (reference: src/data/datasets.py:70-96). The host decoder of the
scan itself is the native library (``data/native_loader.py``); the JAX
package's scipy chain is not ported.
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


HU16_SCALE = 10.0
HU16_CLAMP = (-800.0, 2000.0)
HU16_PLACEHOLDER = np.int16(HU16_CLAMP[0] * HU16_SCALE)

HU8_TABLE = np.concatenate(
    [
        np.linspace(-800.0, -20.0, 27)[:-1],
        np.arange(-20.0, 181.0, 1.0),
        np.linspace(180.0, 2000.0, 30)[1:],
    ]
).astype(np.float32)
assert HU8_TABLE.shape == (256,)
_HU8_MIDPOINTS = (HU8_TABLE[1:] + HU8_TABLE[:-1]) / 2.0
HU8_PLACEHOLDER = np.uint8(0)  # decodes to -800 HU


def hu16_encode(hu: np.ndarray) -> np.ndarray:
    """float HU -> int16 wire values (clamp + fixed-point round)."""
    q = np.clip(np.asarray(hu, np.float32), *HU16_CLAMP)
    return np.round(q * HU16_SCALE).astype(np.int16)


def hu8_encode(hu: np.ndarray) -> np.ndarray:
    """float HU -> uint8 companded wire codes (nearest table level)."""
    q = np.clip(np.asarray(hu, np.float32), HU8_TABLE[0], HU8_TABLE[-1])
    return np.searchsorted(_HU8_MIDPOINTS, q).astype(np.uint8)


def hu16_decode(q: np.ndarray) -> np.ndarray:
    """int16 wire values -> float32 HU."""
    return np.asarray(q, np.float32) / HU16_SCALE


def hu8_decode(q: np.ndarray) -> np.ndarray:
    """uint8 wire codes -> float32 HU (table lookup)."""
    return HU8_TABLE[np.asarray(q)]
