"""Attention paths against sequence length, and the dispatch thresholds they
imply: the port's counterpart of the JAX repository's
``tools/sweep_vmem_attention.py`` and ``tools/sweep_blocked_attention.py``.

    python -m headct_foundation_tpu_torch.tools.sweep_attention [--device cpu]

The JAX sweeps turn TPU tiling knobs (the VMEM kernel's batch-head block,
the blocked kernels' BLOCK_Q / BLOCK_K). The port's tiles are compile-time
constants of its CUDA kernels, so this sweep is over what the dispatch
chooses between (``ops/attention.py``, ``ops/flash_attention.py``):

* ``plain``: the plain attention through autograd (below ``pallas_min_t()``);
* ``whole``: ``FusedAttention``, the whole-sequence kernels B1 / B2 (square
  T <= ``VMEM_PATH_MAX_T``; a longer sequence is left out of that point and
  named in ``left_out``);
* ``blocked``: ``BlockedFusedAttention``, B3 forward, B4 / B5 backward.

Each point is a bfloat16 shape (``POINTS``: the JAX sweeps' flagship and
192^3 shapes, the 96^3 MAE encoder at its training batch of 64 with q, k
and v strided views of one [B, T, 3, H, D] projection as ``SelfAttention``
hands them over (``FUSED``), and a T grid around both thresholds); each path is timed
forward and forward+backward (``bench_attention.time_path``), and its O,
dQ, dK and dV are held against the plain path's (``agreement``: float32
elementwise within the kernels' limits, bfloat16 normwise within 1e-2). One
JSON line per point; the last line adds the crossover T each threshold's
grid implies. Runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from headct_foundation_tpu_torch.bench import device_info, launches_since
from headct_foundation_tpu_torch.engines.mae_engine import kernel_launches
from headct_foundation_tpu_torch.feature_extraction import resolve_device
from headct_foundation_tpu_torch.ops import flash_attention as fa
from headct_foundation_tpu_torch.ops.attention import pallas_min_t
from headct_foundation_tpu_torch.tools.bench_attention import fwd_bwd, inputs, time_path

ITERS = 10
MIN_T_GRID = [(32, t, 12, 64) for t in (65, 129, 192, 257, 513)]   # around pallas_min_t
MAX_T_GRID = [(2, t, 12, 64) for t in (769, 1025, 1281)]           # around VMEM_PATH_MAX_T
POINTS = [  # (label, [B, T, H, D])
    ("mae_enc", (32, 129, 12, 64)),
    ("mae_enc_b64_fused", (64, 129, 12, 64)),
    ("mae_dec", (32, 513, 16, 48)),
    ("dino_vit", (16, 517, 12, 64)),
    ("enc_192", (2, 1025, 12, 64)),
    ("dec_192", (2, 4097, 16, 48)),
    *((f"min_t_grid T={s[1]}", s) for s in MIN_T_GRID),
    *((f"max_t_grid T={s[1]}", s) for s in MAX_T_GRID),
]
FUSED = {"mae_enc_b64_fused"}  # points whose q, k, v are views of one projection
PATHS = {
    "plain": lambda q, k, v: fa.fused_attention_reference(q, k, v)[0],
    "whole": lambda q, k, v: fa.FusedAttention.apply(q, k, v, None)[0],
    "blocked": lambda q, k, v: fa.BlockedFusedAttention.apply(q, k, v, None)[0],
}
# (atol, rtol) elementwise in float32, the kernels' limits (PERF.md section 2)
F32_TOL = {"o": (2e-5, 1e-4), "grad": (1e-4, 1e-3)}
BF16_REL_L2 = 1e-2


def left_out(path: str, shape: Sequence[int]) -> Optional[str]:
    """Why ``path`` cannot take ``shape``, or None."""
    if path == "whole" and shape[1] > fa.VMEM_PATH_MAX_T:
        return f"T = {shape[1]} > VMEM_PATH_MAX_T = {fa.VMEM_PATH_MAX_T}"
    return None


def agreement(got: Sequence[torch.Tensor], ref: Sequence[torch.Tensor],
              dtype: torch.dtype) -> Dict[str, Any]:
    """(o, dq, dk, dv) of a path against the plain path's: max |diff| and
    ||diff|| / ||ref|| of each, and whether all are within the limits."""
    out: Dict[str, Any] = {"ok": True}
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, ref):
        a, b = a.float(), b.float()
        err = (a - b).abs()
        rel = ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
        if dtype == torch.float32:
            atol, rtol = F32_TOL["o" if name == "o" else "grad"]
            ok = bool((err <= atol + rtol * b.abs()).all())
        else:
            ok = rel <= BF16_REL_L2
        out[name] = {"max_abs": err.max().item(), "rel_l2": rel}
        out["ok"] = out["ok"] and ok
    return out


def fused_inputs(shape: Sequence[int], dtype: torch.dtype, device: torch.device,
                 seed: int = 0) -> Tuple[torch.Tensor, ...]:
    """As ``bench_attention.inputs``, but q, k and v are the strided views
    [:, :, 0], [:, :, 1] and [:, :, 2] of one [B, T, 3, H, D] tensor that
    requires gradients."""
    B, T, H, D = shape
    g = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(B, T, 3, H, D, device=device, generator=g).to(dtype).requires_grad_()
    do = torch.randn(*shape, device=device, generator=g).to(dtype)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], do


def point(label: str, shape: Sequence[int], device: torch.device, iters: int = ITERS,
          dtype: torch.dtype = torch.bfloat16, fused: bool = False) -> Dict[str, Any]:
    """Every path that can take ``shape``: its times, its launches and its
    agreement with the plain path. Raises when a path disagrees. ``fused``:
    q, k and v are views of one projection (``fused_inputs``)."""
    q, k, v, do = (fused_inputs if fused else inputs)(shape, dtype, device)
    ref = fwd_bwd(PATHS["plain"], q, k, v, do)
    res: Dict[str, Any] = {"point": label, "shape": list(shape), "dtype": str(dtype)[6:],
                           "fused": fused, "paths": {}, "left_out": {}}
    for path, apply in PATHS.items():
        why = left_out(path, shape)
        if why:
            res["left_out"][path] = why
            continue
        entry: Dict[str, Any] = {}
        if path != "plain":
            entry["agreement"] = agreement(fwd_bwd(apply, q, k, v, do), ref, dtype)
            if not entry["agreement"]["ok"]:
                raise RuntimeError(f"sweep_attention: {path} disagrees with the plain path at "
                                   f"{list(shape)} {dtype}: {entry['agreement']}")
        before = kernel_launches()
        entry.update(time_path(apply, q, k, v, do, device, iters))
        entry["launches"] = {n: c for n, c in launches_since(before).items() if c}
        res["paths"][path] = entry
    return res


def dispatch_kernel(res: Dict[str, Any]) -> Optional[str]:
    """The kernel path the dispatch would take at this point."""
    return "whole" if "whole" in res["paths"] else "blocked"


def crossovers(results: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """The thresholds the grids imply, from forward+backward times:
    ``pallas_min_t``, the least grid T from which the kernel path the
    dispatch would take beats the plain path at that T and every larger
    one; ``VMEM_PATH_MAX_T``, the largest grid T up to which the whole path
    beats the blocked one wherever both ran."""
    by = {tuple(r["shape"]): r for r in results}
    ms = lambda r, p: r["paths"][p]["fwd_bwd_ms"]
    min_grid = [by[tuple(s)] for s in MIN_T_GRID if tuple(s) in by]
    implied_min = None
    for r in reversed(min_grid):
        if ms(r, dispatch_kernel(r)) < ms(r, "plain"):
            implied_min = r["shape"][1]
        else:
            break
    both = sorted((r for r in results if "whole" in r["paths"] and "blocked" in r["paths"]
                   and r["shape"][0] == 2), key=lambda r: r["shape"][1])
    implied_max = None
    for r in both:
        if ms(r, "whole") < ms(r, "blocked"):
            implied_max = r["shape"][1]
        else:
            break
    return {
        "pallas_min_t": {"current": pallas_min_t(), "implied": implied_min,
                         "grid": [{"T": r["shape"][1], "plain_ms": ms(r, "plain"),
                                   "kernel": dispatch_kernel(r),
                                   "kernel_ms": ms(r, dispatch_kernel(r))} for r in min_grid]},
        "VMEM_PATH_MAX_T": {"current": fa.VMEM_PATH_MAX_T, "implied": implied_max,
                            "whole_max_t": fa.VMEM_PATH_MAX_T,
                            "grid": [{"T": r["shape"][1],
                                      **{p: r["paths"][p]["fwd_bwd_ms"] for p in r["paths"]}}
                                     for r in results if r["shape"][0] == 2]},
    }


def run(points: Sequence = POINTS, iters: int = ITERS, device=None,
        dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    device = resolve_device(device)
    info = device_info(device)
    results = []
    for label, shape in points:
        res = point(label, shape, device, iters, dtype, fused=label in FUSED)
        print(json.dumps({**res, "device": info}), flush=True)
        results.append(res)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return {"points": results, "crossovers": crossovers(results), "device": info,
            "iters": iters}


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    result = run(device=args.device)
    print(json.dumps({"crossovers": result["crossovers"], "device": result["device"]}),
          flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
