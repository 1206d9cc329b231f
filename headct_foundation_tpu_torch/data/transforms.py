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

Each has its decode, its host window stack (``hu16_window_stack``,
``hu8_window_stack``: the on-device expansion's reference) and its
error-shielding placeholder, a value that
windows to 0 in every channel, as the zero volume of the windowed format
does (reference: src/data/datasets.py:70-96).

The host decoder of a scan is the native library (``data/native_loader.py``)
by default. The disk cache's ``python`` backend (``HEADCT_NATIVE=0``, or a
non-cubic ROI, which the native chain does not take) is the JAX package's
numpy/scipy chain, copied from its ``data/transforms.py:139-296``
(reference: src/data/transforms.py:108-178, MONAI's ``loading_transforms``):
``load_and_preprocess`` (NIfTI -> RAS -> 1 mm spline-3 resample ->
CropForeground(x > 0) -> window stack -> "area" resize -> float16, [C,
*roi]) and ``load_and_preprocess_hu16`` (the same without the windows: the
raw HU resized, then ``hu16_encode``, [1, *roi] int16), and the
reference's factory ``loading_transforms``. Its outputs are byte-equal to
the JAX package's.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from headct_foundation_tpu_torch.data.nifti import load_nifti, orientation_ras

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


def hu16_window_stack(q: np.ndarray, in_channels: int) -> np.ndarray:
    """Host reference of the on-device expansion of an hu16 volume: [1, H,
    W, D] int16 wire -> [C, H, W, D] float32 in [0, 1] (JAX
    ``data/transforms.py:131-137``)."""
    _check_one_channel(q)
    return window_stack(hu16_decode(q[0]), in_channels)


def hu8_window_stack(q: np.ndarray, in_channels: int) -> np.ndarray:
    """The same for an hu8 volume: [1, H, W, D] uint8 wire -> [C, H, W, D]
    float32 in [0, 1] (JAX ``data/transforms.py:113-118``)."""
    _check_one_channel(q)
    return window_stack(hu8_decode(q[0]), in_channels)


def _check_one_channel(q: np.ndarray) -> None:
    if q.ndim != 4 or q.shape[0] != 1:
        raise ValueError(f"expected one wire volume [1, H, W, D], got {q.shape}")


# ---------------------------------------------------------------------------
# The scipy chain (the disk cache's ``python`` backend).
# ---------------------------------------------------------------------------

def scale_intensity_range(x: np.ndarray, a_min: float, a_max: float, b_min: float = 0.0,
                          b_max: float = 1.0, clip: bool = True) -> np.ndarray:
    """MONAI ScaleIntensityRange: linear map [a_min, a_max] -> [b_min, b_max]."""
    y = (x.astype(np.float32) - a_min) / (a_max - a_min)
    y = y * (b_max - b_min) + b_min
    if clip:
        y = np.clip(y, b_min, b_max)
    return y


def window_stack(x: np.ndarray, in_channels: int) -> np.ndarray:
    """HU windowing -> [C, H, W, D] in [0, 1]."""
    assert x.ndim == 3, x.shape
    if in_channels == 1:
        return scale_intensity_range(x, *WINDOW_1CH)[None]
    if in_channels == 3:
        return np.stack([scale_intensity_range(x, c - w // 2, c + w // 2)
                         for c, w in WINDOW_SIZES_3CH], axis=0)
    raise NotImplementedError(f"Channel size {in_channels} is not implemented.")


def resample_to_spacing(x: np.ndarray, spacing: Sequence[float],
                        new_spacing: Sequence[float] = (1.0, 1.0, 1.0),
                        order: int = 3) -> np.ndarray:
    """Resample a 3D volume to isotropic spacing with spline interpolation
    (reference Spacingd pixdim=(1,1,1), mode=3)."""
    from scipy import ndimage

    zoom = [s / ns for s, ns in zip(spacing, new_spacing)]
    if np.allclose(zoom, 1.0, atol=1e-3):
        return x
    return ndimage.zoom(x, zoom=zoom, order=order, mode="nearest", prefilter=True)


def crop_foreground(x: np.ndarray, select_fn: Callable[[np.ndarray], np.ndarray] = lambda v: v > 0,
                    margin: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Crop to the bounding box of foreground voxels (MONAI CropForeground
    defaults: select_fn = x > 0, margin 0). Returns (cropped, start, end)."""
    mask = select_fn(x)
    if not mask.any():
        return x, np.zeros(3, dtype=int), np.asarray(x.shape, dtype=int)
    coords = np.nonzero(mask)
    start = np.array([max(int(c.min()) - margin, 0) for c in coords])
    end = np.array([min(int(c.max()) + 1 + margin, s) for c, s in zip(coords, x.shape)])
    sl = tuple(slice(s, e) for s, e in zip(start, end))
    return x[sl], start, end


def area_resize(x: np.ndarray, out_shape: Sequence[int]) -> np.ndarray:
    """'area'-mode resize (adaptive average pooling), separable per axis:
    torch ``F.interpolate(mode='area')``, MONAI Resize's default, averages
    input cells [floor(i L / O), ceil((i + 1) L / O)) per output cell.
    Channel-first input: [C, H, W, D] -> [C, *out_shape]."""
    assert x.ndim == 4, x.shape
    out = x.astype(np.float32)
    for axis, o in enumerate(out_shape, start=1):
        if out.shape[axis] == o:
            continue
        out = _adaptive_avg_axis(out, axis, o)
    return out


def _adaptive_avg_axis(x: np.ndarray, axis: int, out: int) -> np.ndarray:
    length = x.shape[axis]
    moved = np.moveaxis(x, axis, 0)
    starts = (np.arange(out) * length) // out
    ends = -(-((np.arange(out) + 1) * length) // out)  # ceil
    # cumulative sum along the axis for O(1) range means
    csum = np.concatenate([np.zeros((1,) + moved.shape[1:], dtype=np.float64),
                           np.cumsum(moved, axis=0)], axis=0)
    pooled = (csum[ends] - csum[starts]) / (ends - starts).reshape((-1,) + (1,) * (moved.ndim - 1))
    return np.moveaxis(pooled.astype(x.dtype), 0, axis)


def resize_with_pad_or_crop(x: np.ndarray, out_shape: Sequence[int]) -> np.ndarray:
    """MONAI ResizeWithPadOrCrop: center-crop axes that are too long,
    symmetrically zero-pad axes that are too short. Channel-first [C, ...]."""
    assert x.ndim == len(out_shape) + 1
    out = x
    for axis, target in enumerate(out_shape, start=1):
        size = out.shape[axis]
        if size > target:
            start = (size - target) // 2
            sl = [slice(None)] * out.ndim
            sl[axis] = slice(start, start + target)
            out = out[tuple(sl)]
        elif size < target:
            before = (target - size) // 2
            pad = [(0, 0)] * out.ndim
            pad[axis] = (before, target - size - before)
            out = np.pad(out, pad)
    return out


def _load_ras_1mm(path: str, spacing: Optional[Sequence[float]]) -> np.ndarray:
    """NIfTI -> RAS -> resampled to ``spacing`` (None: as stored) ->
    foreground crop: the chain's common head."""
    img = load_nifti(path)
    data = np.asarray(img.data, dtype=np.float32)
    if data.ndim == 4:  # drop a trailing singleton (time) dim
        data = data[..., 0]
    assert data.ndim == 3, f"{path}: expected 3D volume, got {data.shape}"
    data, affine = orientation_ras(data, img.affine)
    vox = np.linalg.norm(affine[:3, :3], axis=0)
    if spacing is not None:
        data = resample_to_spacing(data, vox, spacing)
    return crop_foreground(data)[0]


def load_and_preprocess(path: str, roi: Sequence[int], in_channels: int,
                        spacing: Optional[Sequence[float]] = (1.0, 1.0, 1.0)) -> np.ndarray:
    """The training chain: NIfTI path -> [C, *roi] float16 in [0, 1]."""
    channels = window_stack(_load_ras_1mm(path, spacing), in_channels)
    return area_resize(channels, roi).astype(np.float16)


def load_and_preprocess_hu16(path: str, roi: Sequence[int],
                             spacing: Optional[Sequence[float]] = (1.0, 1.0, 1.0)) -> np.ndarray:
    """The hu16 chain: NIfTI path -> [1, *roi] int16 fixed-point HU (the
    windows are applied on the device at train time)."""
    return hu16_encode(area_resize(_load_ras_1mm(path, spacing)[None], roi))


def loading_transforms(roi: Sequence[int], in_channels: int) -> Callable[[str], np.ndarray]:
    """The reference's factory (src/data/transforms.py:108; JAX
    ``data/transforms.py:297-306``): a callable path -> preprocessed [C,
    *roi] float16 volume."""

    def _load(path: str) -> np.ndarray:
        return load_and_preprocess(path, roi, in_channels)

    return _load


def extract_feature_preprocess(path: str, roi: Sequence[int], in_channels: int) -> np.ndarray:
    """The feature-extraction order (reference notebook cells 7-12): the raw
    HU resized before the windows -> [C, *roi] float32."""
    resized = area_resize(_load_ras_1mm(path, (1.0, 1.0, 1.0))[None], roi)[0]
    return window_stack(resized, in_channels).astype(np.float32)
