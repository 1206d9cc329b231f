"""Device-side augmentation: the MAE's and DINO's multi-crop.

Port of the JAX package's ``data/augment.py`` (reference:
src/data/transforms.py:39-105, 181-255):

* ``mae_augment`` (``:246``, ``mae3d_transforms``): per sample, a flip along
  each spatial axis with p = 0.1, then an additive intensity shift drawn
  from U(-0.1, 0.1) applied with p = 0.5 and added in the batch's dtype;
  with ``reshape=False`` also ``rand_gaussian_smooth`` (p = 0.2).
* ``rand_gaussian_smooth`` (``:88``): per sample a separable Gaussian blur
  with a sigma per axis drawn from U(0.5, 1.0), 9 taps, zero padding. Each
  axis is one batched product against a per-sample band matrix of the taps
  (``_blur_axis``), which is the JAX package's "SAME" convolution.
* ``rand_adjust_contrast`` (``:112``, MONAI RandAdjustContrast): a gamma
  from U(0.2, 1.0) over the per-sample intensity range.
* ``crop_and_resize`` (``:136``): a per-sample box resampled to a fixed
  shape as three batched products against per-sample weight matrices, with
  reads outside the volume giving 0 (the zero canvas is never made). Mode
  ``"area"`` (integer boxes, the exact adaptive-average weights of MONAI's
  ``Resized``) or ``"linear"`` (continuous boxes, the trilinear hat). The
  weights are built in float32 and cast to the volume's dtype, as the JAX
  package does (1/3 is 0.333984 in bfloat16).
* ``dino_multicrop`` (``:273``): 2 global crops (boxes of side U[112, 224]
  anywhere on the 224^3 canvas the volume sits centred in; flips with
  p = 0.2, a shift of U(-0.2, 0.2) with p = 0.5, then the blur on the first
  and the contrast on the second) and N local ones (U[64, 112] inside the
  centre 192^3), each resized to ``final_size``.

Every random function is split into ``draw_*`` (the per-sample decisions,
from an explicit ``torch.Generator``) and its application, so a test can
hand the port the decisions that ``jax.random`` drew for the JAX package.
Volumes are [B, C, H, W, D].
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from headct_foundation_tpu_torch.utils.misc import wide_dtype

FLIP_PROB = 0.1
SHIFT_OFFSET = 0.1
SHIFT_PROB = 0.5
SMOOTH_SIGMA, SMOOTH_PROB, SMOOTH_RADIUS = (0.5, 1.0), 0.2, 4
CONTRAST_GAMMA, CONTRAST_PROB = (0.2, 1.0), 0.2
DINO_FLIP_PROB, DINO_SHIFT_OFFSET = 0.2, 0.2
CANVAS = 224  # the DINO pad/crop canvas (reference: transforms.py:73)
LOCAL_CANVAS = 192  # the centre crop the local crops come from (transforms.py:94)

Decisions = Dict[str, torch.Tensor]


def _uniform(generator: Optional[torch.Generator], device, shape, lo: float = 0.0,
             hi: float = 1.0) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device)
    return u if (lo, hi) == (0.0, 1.0) else lo + u * (hi - lo)


def draw_mae_augment(batch: int, generator: Optional[torch.Generator],
                     device: torch.device, smooth: bool = False) -> Decisions:
    """The per-sample decisions of one ``mae_augment`` call:
    ``flip`` bool [3, B] (spatial axes 1, 2, 3), ``shift`` float32 [B] and
    ``shift_on`` bool [B]; with ``smooth`` also the blur's ``sigma`` [3, B]
    and ``smooth_on`` [B]. The batch is the last axis of each."""
    out = {
        "flip": _uniform(generator, device, (3, batch)) < FLIP_PROB,
        "shift": (_uniform(generator, device, (batch,)) * 2.0 - 1.0) * SHIFT_OFFSET,
        "shift_on": _uniform(generator, device, (batch,)) < SHIFT_PROB,
    }
    if smooth:
        blur = draw_gaussian_smooth(batch, generator, device)
        out.update(sigma=blur["sigma"].t(), smooth_on=blur["on"])
    return out


def rand_flip(x: torch.Tensor, do: torch.Tensor, axis: int) -> torch.Tensor:
    """Flip the samples where ``do`` [B] is set along spatial ``axis``
    (1-indexed after the channel axis)."""
    view = (-1,) + (1,) * (x.dim() - 1)
    return torch.where(do.reshape(view), torch.flip(x, dims=(axis + 1,)), x)


def rand_shift_intensity(x: torch.Tensor, shift: torch.Tensor,
                         do: torch.Tensor) -> torch.Tensor:
    """x + shift [B] (cast to x's dtype) where ``do`` [B] is set."""
    view = (-1,) + (1,) * (x.dim() - 1)
    return torch.where(do.reshape(view), x + shift.to(x.dtype).reshape(view), x)


def apply_mae_augment(x: torch.Tensor, decisions: Decisions) -> torch.Tensor:
    for axis in range(3):
        x = rand_flip(x, decisions["flip"][axis].to(x.device), axis + 1)
    x = rand_shift_intensity(x, decisions["shift"].to(x.device),
                             decisions["shift_on"].to(x.device))
    if "sigma" in decisions:
        x = rand_gaussian_smooth(x, decisions["sigma"].t().to(x.device),
                                 decisions["smooth_on"].to(x.device))
    return x


def mae_augment(x: torch.Tensor, generator: Optional[torch.Generator] = None,
                reshape: bool = True) -> torch.Tensor:
    """Train-time MAE augmentation with decisions drawn from ``generator``;
    ``reshape=False`` adds the Gaussian smoothing."""
    return apply_mae_augment(x, draw_mae_augment(x.shape[0], generator, x.device,
                                                 smooth=not reshape))


# ---------------------------------------------------------------------------
# Gaussian smoothing and contrast
# ---------------------------------------------------------------------------

def _gaussian_kernel(sigma: torch.Tensor, radius: int) -> torch.Tensor:
    """Normalised float32 taps [..., 2 radius + 1] for each sigma [...]."""
    t = torch.arange(-radius, radius + 1, dtype=torch.float32, device=sigma.device)
    k = torch.exp(-0.5 * torch.square(t / torch.clamp_min(sigma.float(), 1e-3)[..., None]))
    return k / k.sum(dim=-1, keepdim=True)


_AXIS_EQ = ("boi,bcijk->bcojk", "boj,bcijk->bciok", "bok,bcijk->bcijo")


def _resample_axis(x: torch.Tensor, w: torch.Tensor, axis: int) -> torch.Tensor:
    """x [B, C, H, W, D] with spatial ``axis`` (0-2) mapped through the
    per-sample matrices w [B, out, in], in x's dtype."""
    return torch.einsum(_AXIS_EQ[axis], w.to(x.dtype), x)


def _blur_axis(x: torch.Tensor, kernel: torch.Tensor, axis: int) -> torch.Tensor:
    """The zero-padded ("SAME") correlation of each sample of x with its taps
    kernel [B, 2r + 1] along spatial ``axis``, as a product with the band
    matrix W[b, o, i] = kernel[b, i - o + r]."""
    n, taps = x.shape[2 + axis], kernel.shape[-1]
    pos = torch.arange(n, device=x.device)
    idx = pos[None, :] - pos[:, None] + taps // 2  # [out, in]
    inside = (idx >= 0) & (idx < taps)
    band = kernel[:, idx.clamp(0, taps - 1)] * inside
    return _resample_axis(x, band.to(x.dtype), axis)


def draw_gaussian_smooth(batch: int, generator: Optional[torch.Generator], device,
                         sigma_range: Tuple[float, float] = SMOOTH_SIGMA,
                         prob: float = SMOOTH_PROB) -> Decisions:
    """``sigma`` float32 [B, 3] (one per spatial axis) and ``on`` bool [B]."""
    return {"sigma": _uniform(generator, device, (batch, 3), *sigma_range),
            "on": _uniform(generator, device, (batch,)) < prob}


def rand_gaussian_smooth(x: torch.Tensor, sigma: torch.Tensor, do: torch.Tensor,
                         radius: int = SMOOTH_RADIUS) -> torch.Tensor:
    """Blur the samples where ``do`` [B] is set with sigma [B, 3] per axis."""
    out = x
    for axis in range(3):
        out = _blur_axis(out, _gaussian_kernel(sigma[:, axis], radius), axis)
    return torch.where(do.reshape(-1, 1, 1, 1, 1), out, x)


def draw_adjust_contrast(batch: int, generator: Optional[torch.Generator], device,
                         gamma_range: Tuple[float, float] = CONTRAST_GAMMA,
                         prob: float = CONTRAST_PROB) -> Decisions:
    """``gamma`` float32 [B] and ``on`` bool [B]."""
    return {"gamma": _uniform(generator, device, (batch,), *gamma_range),
            "on": _uniform(generator, device, (batch,)) < prob}


def rand_adjust_contrast(x: torch.Tensor, gamma: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """((x - min) / range) ** gamma * range + min per sample where ``do`` is
    set; the power and what follows it in float32, as the JAX package's type
    promotion does with a float32 gamma (in float64 for a float64 x), then
    cast to x's dtype."""
    view = (-1,) + (1,) * (x.dim() - 1)
    dims = tuple(range(1, x.dim()))
    mn, mx = x.amin(dim=dims, keepdim=True), x.amax(dim=dims, keepdim=True)
    span = torch.clamp_min(mx - mn, 1e-7)
    t = torch.clamp((x - mn) / span, 1e-7, 1.0)
    w = wide_dtype(x.dtype)
    adj = torch.pow(t.to(w), gamma.to(w).reshape(view)) * span.to(w) + mn.to(w)
    return torch.where(do.reshape(view), adj.to(x.dtype), x)


# ---------------------------------------------------------------------------
# Fused crop + resize, and the multi-crop
# ---------------------------------------------------------------------------

def crop_and_resize(x: torch.Tensor, start: torch.Tensor, size: torch.Tensor,
                    out_shape: Sequence[int], mode: str = "linear") -> torch.Tensor:
    """Resample each sample's box (start, size [B, 3] float32 voxels; outside
    the volume reads 0) to ``out_shape``. ``"area"``: output cell o of a
    length-L box averages input cells [floor(o L / O), ceil((o + 1) L / O));
    ``"linear"``: the hat kernel at in = start + (o + 0.5) L / O - 0.5. The
    weights are float32 (float64 for a float64 x)."""
    if mode not in ("linear", "area"):
        raise ValueError(f"unknown crop_and_resize mode {mode!r}")
    wide = wide_dtype(x.dtype)
    start, size = start.to(x.device, wide), size.to(x.device, wide)
    out = x
    for ax in range(3):
        o = int(out_shape[ax])
        i_idx = torch.arange(x.shape[2 + ax], dtype=wide, device=x.device)
        o_idx = torch.arange(o, dtype=wide, device=x.device)
        if mode == "area":
            length = size[:, ax, None]                                    # [B, 1]
            s_idx = torch.floor(o_idx[None, :] * length / o)              # [B, out]
            e_idx = torch.ceil((o_idx[None, :] + 1.0) * length / o)
            abs_s = start[:, ax, None] + s_idx
            abs_e = start[:, ax, None] + e_idx
            inside = ((i_idx[None, None, :] >= abs_s[:, :, None])
                      & (i_idx[None, None, :] < abs_e[:, :, None]))
            count = torch.clamp_min(e_idx - s_idx, 1.0)[:, :, None]
            w = inside / count
        else:
            c = start[:, ax, None] + (o_idx[None, :] + 0.5) * (size[:, ax, None] / o) - 0.5
            w = torch.clamp(1.0 - torch.abs(c[:, :, None] - i_idx[None, None, :]), 0.0, 1.0)
        out = _resample_axis(out, w.to(x.dtype), ax)
    return out


def _rand_box(batch: int, min_size: float, max_size: float, canvas_lo: float,
              canvas_hi: float, generator: Optional[torch.Generator], device,
              integer: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample, per-axis (start, size) [B, 3] float32: size ~ U[min, max]
    (with ``integer``, uniform over the integers min..max, MONAI's
    RandSpatialCrop) and the start uniform over the placements in
    [canvas_lo, canvas_hi)."""
    if integer:
        size = torch.randint(int(min_size), int(max_size) + 1, (batch, 3), generator=generator,
                             device=device).float()
        u = _uniform(generator, device, (batch, 3))
        return canvas_lo + torch.floor(u * ((canvas_hi - canvas_lo) - size + 1.0)), size
    size = _uniform(generator, device, (batch, 3), min_size, max_size)
    u = _uniform(generator, device, (batch, 3))
    return canvas_lo + u * ((canvas_hi - canvas_lo) - size), size


def draw_flip_and_noise(batch: int, generator: Optional[torch.Generator], device) -> Decisions:
    """A global crop's flips (``flip`` bool [B, 3], p = 0.2) and shift
    (``shift`` [B] from U(-0.2, 0.2), ``shift_on`` [B], p = 0.5)."""
    return {"flip": _uniform(generator, device, (batch, 3)) < DINO_FLIP_PROB,
            "shift": _uniform(generator, device, (batch,), -DINO_SHIFT_OFFSET,
                              DINO_SHIFT_OFFSET),
            "shift_on": _uniform(generator, device, (batch,)) < SHIFT_PROB}


def _dino_flip_and_noise(x: torch.Tensor, decisions: Decisions) -> torch.Tensor:
    """Flips along the 3 spatial axes, then the shift (reference:
    transforms.py:58-63)."""
    for axis in range(3):
        x = rand_flip(x, decisions["flip"][:, axis].to(x.device), axis + 1)
    return rand_shift_intensity(x, decisions["shift"].to(x.device),
                                decisions["shift_on"].to(x.device))


def draw_dino_multicrop(batch: int, generator: Optional[torch.Generator], device,
                        volume_size: int, global_crop_size: int = 112,
                        local_crop_size: int = 64, local_crops_number: int = 2,
                        mode: str = "area") -> List[Decisions]:
    """One dict per crop, every tensor with the batch as its first axis:
    ``start`` and ``size`` [B, 3] in volume coordinates; the global crops
    also ``draw_flip_and_noise``'s decisions, and the first the blur's
    (``sigma`` [B, 3], ``smooth_on``), the second the contrast's (``gamma``,
    ``contrast_on``)."""
    integer = mode == "area"
    offset = (CANVAS - volume_size) // 2 if integer else (CANVAS - volume_size) / 2.0
    crops: List[Decisions] = []
    for gi in range(2):
        start, size = _rand_box(batch, global_crop_size, CANVAS, 0.0, CANVAS, generator,
                                device, integer)
        d = {"start": start - offset, "size": size,
             **draw_flip_and_noise(batch, generator, device)}
        if gi == 0:
            blur = draw_gaussian_smooth(batch, generator, device)
            d.update(sigma=blur["sigma"], smooth_on=blur["on"])
        else:
            contrast = draw_adjust_contrast(batch, generator, device)
            d.update(gamma=contrast["gamma"], contrast_on=contrast["on"])
        crops.append(d)
    lo = (CANVAS - LOCAL_CANVAS) // 2 if integer else (CANVAS - LOCAL_CANVAS) / 2.0
    for _ in range(local_crops_number):
        start, size = _rand_box(batch, local_crop_size, global_crop_size, lo, lo + LOCAL_CANVAS,
                                generator, device, integer)
        crops.append({"start": start - offset, "size": size})
    return crops


def apply_dino_multicrop(x: torch.Tensor, decisions: Sequence[Decisions],
                         final_size: Sequence[int] = (96, 96, 96),
                         mode: str = "area") -> List[torch.Tensor]:
    """The crops of ``draw_dino_multicrop``'s decisions, each [B, C, *final_size]."""
    crops = []
    for d in decisions:
        crop = crop_and_resize(x, d["start"], d["size"], final_size, mode=mode)
        if "flip" in d:
            crop = _dino_flip_and_noise(crop, d)
        if "sigma" in d:
            crop = rand_gaussian_smooth(crop, d["sigma"].to(x.device),
                                        d["smooth_on"].to(x.device))
        if "gamma" in d:
            crop = rand_adjust_contrast(crop, d["gamma"].to(x.device),
                                        d["contrast_on"].to(x.device))
        crops.append(crop)
    return crops


def dino_multicrop(x: torch.Tensor, generator: Optional[torch.Generator] = None,
                   final_size: Sequence[int] = (96, 96, 96), global_crop_size: int = 112,
                   local_crop_size: int = 64, local_crops_number: int = 2,
                   mode: str = "area") -> List[torch.Tensor]:
    """2 global + ``local_crops_number`` local crops of each volume, drawn
    from ``generator``."""
    decisions = draw_dino_multicrop(x.shape[0], generator, x.device, x.shape[-1],
                                    global_crop_size, local_crop_size, local_crops_number, mode)
    return apply_dino_multicrop(x, decisions, final_size, mode)
