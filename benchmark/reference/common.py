"""Layers, input windowing, augmentation, optimizer and schedules of the
plain reference, as functions over a dict of float32 parameters named as
the published torch checkpoints name them (``blocks.3.attn.qkv.weight``).

Every matrix product goes through ``operands``: unchanged at
``precision="float32"``, rounded to float8 e4m3 (per-tensor scale, the
gradient passed straight through) for the ``"fp8"`` control.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

# the recipe's CT windows (centre, width) in HU: brain, subdural, bone
WINDOWS_3CH = [(40, 80), (80, 200), (600, 2800)]
HU16_SCALE = 10.0  # hu16 wire: int16 = round(HU * 10)
FP8_MAX = 448.0    # largest float8 e4m3 value


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` through float8 e4m3 with a per-tensor scale (amax -> 448),
    back in float32; the gradient passes straight through."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return t + (q - t.detach())


def operands(precision: str, *ts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    if precision == "float32":
        return ts
    if precision == "fp8":
        return tuple(fp8_round(t) for t in ts)
    raise ValueError(f"unknown precision {precision!r}")


def linear(x: torch.Tensor, P: Params, name: str, precision: str) -> torch.Tensor:
    x, w = operands(precision, x, P[f"{name}.weight"])
    return F.linear(x, w, P.get(f"{name}.bias"))


def layer_norm(x: torch.Tensor, P: Params, name: str, eps: float) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), P[f"{name}.weight"], P[f"{name}.bias"], eps)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation the recipe's MLPs use."""
    return F.gelu(x, approximate="tanh")


def attention(x: torch.Tensor, P: Params, name: str, heads: int, precision: str) -> torch.Tensor:
    """Fused-qkv self-attention: softmax(q k^T / sqrt(D)) v, then proj."""
    B, N, C = x.shape
    D = C // heads
    qkv = linear(x, P, f"{name}.qkv", precision).reshape(B, N, 3, heads, D)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # [B, H, N, D]
    q, k, v = operands(precision, q, k, v)
    probs = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(D), dim=-1)
    y = (probs @ v).transpose(1, 2).reshape(B, N, C)
    return linear(y, P, f"{name}.proj", precision)


def block(x: torch.Tensor, P: Params, name: str, heads: int, precision: str,
          eps: float = 1e-5) -> torch.Tensor:
    """Pre-norm transformer block: x + attn(LN(x)); x + MLP(LN(x))."""
    x = x + attention(layer_norm(x, P, f"{name}.att_norm", eps), P, f"{name}.attn", heads,
                      precision)
    h = layer_norm(x, P, f"{name}.ffn_norm", eps)
    h = linear(gelu(linear(h, P, f"{name}.mlp.linear1", precision)), P,
               f"{name}.mlp.linear2", precision)
    return x + h


def patch_embed(x: torch.Tensor, P: Params, name: str, patch: int,
                precision: str) -> torch.Tensor:
    """A stride-``patch`` convolution, tokens in (h, w, d) row-major order."""
    x, w = operands(precision, x, P[f"{name}.weight"])
    y = F.conv3d(x, w, P[f"{name}.bias"], stride=patch)
    return y.flatten(2).transpose(1, 2)


def patchify(x: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, C, H, W, D] -> [B, patches, p^3 C], each patch's voxels in
    (ph, pw, pd, C) order (the MAE3D reference's permute)."""
    B, C, H, W, D = x.shape
    g = (H // patch, W // patch, D // patch)
    x = x.reshape(B, C, g[0], patch, g[1], patch, g[2], patch)
    return x.permute(0, 2, 4, 6, 3, 5, 7, 1).reshape(B, g[0] * g[1] * g[2], patch ** 3 * C)


def sincos_embedding(grid: int, dim: int, temperature: float = 10000.0) -> np.ndarray:
    """The fixed 3D sin-cos position embedding [1, grid^3, dim] of the MAE3D
    reference (src/utils/pos_embed.py; its first meshgrid axis is named
    for w)."""
    pos_dim = dim // 6
    omega = 1.0 / (temperature ** (np.arange(pos_dim, dtype=np.float64) / pos_dim))
    a, b, c = np.meshgrid(*(np.arange(grid, dtype=np.float64),) * 3, indexing="ij")
    outs = [np.outer(g.ravel(), omega) for g in (a, b, c)]
    emb = np.concatenate([f(o) for o in (outs[1], outs[0], outs[2]) for f in (np.sin, np.cos)],
                         axis=1)
    return emb[None].astype(np.float32)


def window_hu16(wire: torch.Tensor) -> torch.Tensor:
    """[B, 1, R, R, R] int16 (HU x 10) -> [B, 3, R, R, R] float32 in [0, 1]:
    the brain, subdural and bone windows."""
    hu = wire.float() * np.float32(1.0 / HU16_SCALE)
    chans = [torch.clamp((hu - (c - w // 2)) / float(w - (w % 2)), 0.0, 1.0)
             for c, w in WINDOWS_3CH]
    return torch.cat(chans, dim=1)


def flip_where(x: torch.Tensor, on: torch.Tensor, dim: int) -> torch.Tensor:
    view = (-1,) + (1,) * (x.dim() - 1)
    return torch.where(on.reshape(view), torch.flip(x, dims=(dim,)), x)


def shift_where(x: torch.Tensor, shift: torch.Tensor, on: torch.Tensor) -> torch.Tensor:
    view = (-1,) + (1,) * (x.dim() - 1)
    return torch.where(on.reshape(view), x + shift.reshape(view), x)


def gaussian_blur(x: torch.Tensor, sigma: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """Each sample [C, ...] of x blurred with its own sigma [B, 3] per axis:
    a normalised (2 radius + 1)-tap Gaussian, zero padding."""
    out = []
    t = torch.arange(-radius, radius + 1, dtype=torch.float32, device=x.device)
    for b in range(x.shape[0]):
        v = x[b:b + 1]
        for axis in range(3):
            k = torch.exp(-0.5 * (t / sigma[b, axis].clamp_min(1e-3)) ** 2)
            k = (k / k.sum()).to(x.dtype)
            shape = [1, 1, 1, 1, 1]
            shape[2 + axis] = k.numel()
            pad = [0, 0, 0, 0, 0, 0]
            pad[2 * (2 - axis)] = pad[2 * (2 - axis) + 1] = radius
            C = v.shape[1]
            v = F.conv3d(F.pad(v, pad), k.reshape(shape).expand(C, 1, *shape[2:]), groups=C)
        out.append(v)
    return torch.cat(out)


def adjust_contrast(x: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """Per sample: ((x - min) / range) ** gamma * range + min."""
    dims = tuple(range(1, x.dim()))
    view = (-1,) + (1,) * (x.dim() - 1)
    mn, mx = x.amin(dim=dims, keepdim=True), x.amax(dim=dims, keepdim=True)
    span = (mx - mn).clamp_min(1e-7)
    t = ((x - mn) / span).clamp(1e-7, 1.0)
    return t ** gamma.reshape(view) * span + mn


def crop_area(x: torch.Tensor, start: torch.Tensor, size: torch.Tensor,
              out: int) -> torch.Tensor:
    """Each sample's integer box [start, start + size) (voxels, reads outside
    the volume are 0) averaged down to out^3 by adaptive average pooling
    (MONAI's ``Resized(mode="area")``)."""
    crops = []
    n = x.shape[2:]
    for b in range(x.shape[0]):
        s = [int(v) for v in start[b].tolist()]
        L = [int(v) for v in size[b].tolist()]
        box = x.new_zeros((x.shape[1], *L))
        src = [slice(max(s[a], 0), min(s[a] + L[a], n[a])) for a in range(3)]
        dst = [slice(r.start - s[a], r.stop - s[a]) for a, r in enumerate(src)]
        if all(r.stop > r.start for r in src):
            box[(slice(None), *dst)] = x[(b, slice(None), *src)]
        crops.append(F.adaptive_avg_pool3d(box[None], out))
    return torch.cat(crops)


# ---------------------------------------------------------------------------
# optimizer and schedules
# ---------------------------------------------------------------------------

def adamw_(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
           state: List[dict], step: int, lr: float, wd: float, betas: Tuple[float, float],
           eps: float = 1e-8) -> None:
    """Decoupled-decay Adam, update ``step`` (1-based), in place."""
    b1, b2 = betas
    with torch.no_grad():
        for p, g, s in zip(params, grads, state):
            if not s:
                s["m"], s["v"] = torch.zeros_like(p), torch.zeros_like(p)
            p.mul_(1.0 - lr * wd)
            s["m"].mul_(b1).add_(g, alpha=1.0 - b1)
            s["v"].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = (s["v"].sqrt() / math.sqrt(1.0 - b2 ** step)).add_(eps)
            p.addcdiv_(s["m"], denom, value=-lr / (1.0 - b1 ** step))


def cosine_lr(step: int, base: float, warmup: int, total: int, end: float) -> float:
    """Linear warm-up from 0, then a half cosine down to ``end``."""
    if step < warmup:
        return step / max(1.0, warmup) * base
    progress = (step - warmup) / max(1.0, total - warmup)
    return max(0.0, end + (base - end) * 0.5 * (1.0 + math.cos(math.pi * progress)))


def cosine_values(base: float, final: float, n: int) -> np.ndarray:
    """``n`` values of a half cosine from ``base`` to ``final`` (no warm-up)."""
    i = np.arange(n)
    return final + 0.5 * (base - final) * (1 + np.cos(np.pi * i / n))
