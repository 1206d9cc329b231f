"""On-device preprocessing for feature extraction.

Port of the JAX package's ``data/device_preprocess.py`` for the
feature-extraction ("notebook") order:

  host:   NIfTI decode -> RAS orient
  device: cubic resample to 1 mm   = 3 per-axis matmuls
  device: foreground bbox + 'area' crop-resize operators
  device: crop + 'area' resize to the ROI = 3 per-axis matmuls (the crop is
          folded into the resize operator, so nothing is gathered)
  device: HU window stack (elementwise)

The per-axis cubic operator is exact scipy parity by construction: it is
``scipy.ndimage.zoom`` applied to an identity matrix (resampling is linear
in the input, so the zoom of eye(n) is the operator, B-spline prefilter and
boundary handling included). The 'area' operator reproduces torch
``F.interpolate(mode='area')`` cell averaging. Foreground bbox semantics
match MONAI ``CropForeground`` defaults (x > 0, margin 0; an empty
foreground keeps the whole axis).

Unlike the JAX version, volumes are not padded to 128-multiples: that
bucketing existed to share jit compilations, and eager PyTorch compiles
nothing. The "training" and "hu16" orders are not ported yet.

The training step's entry cast is here too (JAX ``:169-219``):
``wire_to_compute`` turns a wire batch (hu16 int16, hu8 uint8 or already
windowed) into [B, C, ...] volumes in the compute dtype, windowing first, as
the per-step intensity augmentation expects windowed volumes.
"""

from __future__ import annotations

import functools
import os
import threading
from typing import List, Sequence, Union

import numpy as np
import torch
from scipy import ndimage

from headct_foundation_tpu_torch.data.nifti import load_nifti, load_nifti_bytes, orientation_ras
from headct_foundation_tpu_torch.data.transforms import HU8_TABLE, HU16_SCALE, window_params

Source = Union[str, os.PathLike, bytes]


@functools.lru_cache(maxsize=256)
def cubic_axis_operator(n_in: int, zoom: float) -> np.ndarray:
    """[n_out, n_in] operator == scipy.ndimage.zoom(x, zoom, order=3,
    mode='nearest', prefilter=True) along one axis. Exact by linearity:
    columns are the zoom of basis vectors."""
    eye = np.eye(n_in, dtype=np.float64)
    m = ndimage.zoom(eye, (zoom, 1.0), order=3, mode="nearest", prefilter=True)
    return np.ascontiguousarray(m, dtype=np.float32)


def area_axis_operator(n_full: int, start: int, end: int, n_out: int) -> np.ndarray:
    """[n_out, n_full] operator: crop [start, end) then 'area'-resize to n_out
    (uniform average over cells [floor(i*L/O), ceil((i+1)*L/O)))."""
    L = end - start
    m = np.zeros((n_out, n_full), dtype=np.float32)
    idx = np.arange(n_out)
    s = (idx * L) // n_out
    e = -(-((idx + 1) * L) // n_out)
    for i in range(n_out):
        m[i, start + s[i]: start + e[i]] = 1.0 / (e[i] - s[i])
    return m


def device_area_ops(vol: torch.Tensor, roi: Sequence[int]) -> List[torch.Tensor]:
    """Foreground bbox + 'area' crop-resize operators, computed from the
    volume on its own device (no host round trip): the same integer cell
    arithmetic as ``area_axis_operator``, with the bounds from ``vol > 0``."""
    fg = vol > 0
    ops = []
    for axis in range(3):
        n, n_out = vol.shape[axis], int(roi[axis])
        others = tuple(i for i in range(3) if i != axis)
        f = fg.any(dim=others[1]).any(dim=others[0]).to(torch.int32)  # [n]
        any_f = f.any()
        start = torch.where(any_f, torch.argmax(f), 0)
        last = n - 1 - torch.argmax(f.flip(0))
        end = torch.where(any_f, last + 1, n)
        length = end - start
        i = torch.arange(n_out, device=vol.device)[:, None]   # out cells
        j = torch.arange(n, device=vol.device)[None, :]       # in cells
        s_i = (i * length) // n_out                            # floor(i*L/O)
        e_i = -((-(i + 1) * length) // n_out)                  # ceil((i+1)*L/O)
        w = ((j >= start + s_i) & (j < start + e_i)).to(torch.float32)
        ops.append(w / (e_i - s_i).to(torch.float32))
    return ops


class DevicePreprocessor:
    """NIfTI path or bytes -> windowed [C, *roi] float32 tensor on ``device``,
    in the feature-extraction order: resample -> crop-foreground -> area
    resize -> window (the notebook's order; SURVEY.md section 3.4)."""

    _OPS_CAP = 96

    def __init__(self, roi: Sequence[int], in_channels: int, device: Union[str, torch.device]):
        self.roi = tuple(int(r) for r in roi)
        self.in_channels = in_channels
        self.device = torch.device(device)
        lows, highs = window_params(in_channels)
        self._lo = torch.from_numpy(lows).to(self.device)[:, None, None, None]
        self._hi = torch.from_numpy(highs).to(self.device)[:, None, None, None]
        # Device-resident cubic operators: scans from one scanner share
        # (shape, spacing), so each operator ships once. FIFO-capped; guarded
        # because the server's handler threads preprocess concurrently.
        self._ops: dict = {}
        self._ops_lock = threading.Lock()

    def _cubic_op(self, n: int, zoom: float) -> torch.Tensor:
        key = (n, round(zoom, 9))
        with self._ops_lock:
            op = self._ops.get(key)
        if op is None:
            op = torch.from_numpy(cubic_axis_operator(n, zoom)).to(self.device)
            with self._ops_lock:
                if len(self._ops) >= self._OPS_CAP:
                    self._ops.pop(next(iter(self._ops)))
                self._ops[key] = op
        return op

    @staticmethod
    def _decode(source: Source):
        img = load_nifti_bytes(source) if isinstance(source, bytes) else load_nifti(source)
        data = np.asarray(img.data, dtype=np.float32)
        if data.ndim == 4:  # drop a trailing singleton (time) dim
            data = data[..., 0]
        if data.ndim != 3:
            raise ValueError(f"expected a 3D volume, got shape {data.shape}")
        return orientation_ras(data, img.affine)

    def __call__(self, source: Source) -> torch.Tensor:
        data, affine = self._decode(source)
        zooms = [float(z) for z in np.linalg.norm(affine[:3, :3], axis=0)]
        host = np.ascontiguousarray(data, dtype=np.float32)
        # CT voxels are integral HU in practice: when the volume is exactly
        # int16, ship half the bytes and widen on the device.
        as_int = host.astype(np.int16)
        if np.array_equal(as_int.astype(np.float32), host):
            vol = torch.from_numpy(as_int).to(self.device).to(torch.float32)
        else:
            vol = torch.from_numpy(host).to(self.device)
        if not np.allclose(zooms, 1.0, atol=1e-3):  # 1 mm already: nothing to resample
            mh, mw, md = (self._cubic_op(n, z) for n, z in zip(vol.shape, zooms))
            vol = torch.einsum("ah,hwd->awd", mh, vol)
            vol = torch.einsum("bw,awd->abd", mw, vol)
            vol = torch.einsum("cd,abd->abc", md, vol)
        ah, aw, ad = device_area_ops(vol, self.roi)
        r = torch.einsum("ah,hwd->awd", ah, vol)
        r = torch.einsum("bw,awd->abd", aw, r)
        r = torch.einsum("cd,abd->abc", ad, r)
        return torch.clamp((r[None] - self._lo) / (self._hi - self._lo), 0.0, 1.0)


def _window(hu: torch.Tensor, in_channels: int) -> torch.Tensor:
    """[B, 1, ...] float32 HU -> [B, C, ...] window stack in [0, 1]."""
    lows, highs = window_params(in_channels)
    shape = (1, -1) + (1,) * (hu.dim() - 2)
    lo = torch.from_numpy(lows).to(hu.device).reshape(shape)
    hi = torch.from_numpy(highs).to(hu.device).reshape(shape)
    return torch.clamp((hu - lo) / (hi - lo), 0.0, 1.0)


def device_hu16_window(batch: torch.Tensor, in_channels: int) -> torch.Tensor:
    """[B, 1, H, W, D] int16 fixed-point HU -> [B, C, H, W, D] float32 in [0, 1]."""
    if batch.dim() != 5 or batch.shape[1] != 1:
        raise ValueError(f"hu16 batches are [B, 1, H, W, D], got {tuple(batch.shape)}")
    return _window(batch.to(torch.float32) * np.float32(1.0 / HU16_SCALE), in_channels)


def device_hu8_window(batch: torch.Tensor, in_channels: int) -> torch.Tensor:
    """[B, 1, H, W, D] uint8 companded HU codes -> [B, C, H, W, D] float32 in [0, 1]."""
    if batch.dim() != 5 or batch.shape[1] != 1:
        raise ValueError(f"hu8 batches are [B, 1, H, W, D], got {tuple(batch.shape)}")
    table = torch.from_numpy(HU8_TABLE).to(batch.device)
    return _window(table[batch.long()], in_channels)


def wire_to_compute(batch: torch.Tensor, config, in_channels: int,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Wire-format batch -> [B, C, ...] volumes in ``dtype``, per
    ``config.DATA.WIRE_FORMAT``: 'hu16' and 'hu8' expand the window stack
    on the device first; 'windowed' batches only cast."""
    wire = (str(getattr(config.DATA, "WIRE_FORMAT", "windowed"))
            if config is not None else "windowed")
    if wire == "hu16":
        return device_hu16_window(batch, in_channels).to(dtype)
    if wire == "hu8":
        return device_hu8_window(batch, in_channels).to(dtype)
    return batch.to(dtype)
