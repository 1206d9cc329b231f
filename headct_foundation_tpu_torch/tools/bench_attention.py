"""Attention forward and backward at the workloads' shapes: the port's
counterpart of the JAX repository's ``tools/bench_attention.py``.

    python -m headct_foundation_tpu_torch.tools.bench_attention [--device cpu]

At the JAX tool's shapes (``SHAPES``: the MAE encoder [32,129,12,64], the
MAE decoder [32,513,16,48] and the DINO student [128,513,12,64], bfloat16)
it times three paths on the same inputs and incoming gradient:

* ``kernel``: ``ops.flash_attention.FusedAttention`` (B1 forward, B2
  backward);
* ``plain``: the port's plain attention through autograd, what the
  dispatch takes below ``pallas_min_t()`` (the counterpart of XLA's fused
  attention in the JAX tool);
* ``sdpa``: ``torch.nn.functional.scaled_dot_product_attention``, the
  library's call, as a yardstick only (no training or serving path of the
  port calls it).

Each is timed forward alone and forward+backward: CUDA events, median of
``ITERS`` calls after 3 warm-up calls. TF/s use the JAX tool's count:
4 B H T^2 D operations forward, 3.5 times that forward+backward. Prints one
JSON line per shape, with the card's name and power limit and the kernel
path's launches, and one with every shape last. Runs on ``cuda`` unless
``--device cpu`` is given (the kernel path is then the plain versions and
the times are the CPU's).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from headct_foundation_tpu_torch.bench import device_info, launches_since, sync
from headct_foundation_tpu_torch.engines.mae_engine import kernel_launches
from headct_foundation_tpu_torch.feature_extraction import resolve_device
from headct_foundation_tpu_torch.ops.flash_attention import (
    FusedAttention,
    fused_attention_reference,
)

ITERS = 20
SHAPES = [  # (name, [B, T, H, D]) as in the JAX tool
    ("mae_encoder", (32, 129, 12, 64)),
    ("mae_decoder", (32, 513, 16, 48)),
    ("dino_student", (128, 513, 12, 64)),
]


def sdpa(q, k, v):
    """The library's attention on [B, T, H, D] views."""
    return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                          v.transpose(1, 2)).transpose(1, 2)


PATHS: Dict[str, Callable] = {
    "kernel": lambda q, k, v: FusedAttention.apply(q, k, v, None)[0],
    "plain": lambda q, k, v: fused_attention_reference(q, k, v)[0],
    "sdpa": sdpa,
}


def time_ms(fn: Callable[[], Any], device: torch.device, iters: int = ITERS,
            warmup: int = 3) -> float:
    """Median time of one call: CUDA events around each call on a card, the
    host clock on the CPU."""
    for _ in range(warmup):
        fn()
    sync(device)
    if device.type != "cuda":
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    events = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    sync(device)
    return statistics.median(a.elapsed_time(b) for a, b in events)


def inputs(shape: Sequence[int], dtype: torch.dtype, device: torch.device,
           seed: int = 0) -> Tuple[torch.Tensor, ...]:
    """q, k, v (requiring gradients) and the incoming gradient, standard
    normal from a seeded generator."""
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v, do = (torch.randn(*shape, device=device, generator=g).to(dtype) for _ in range(4))
    return q.requires_grad_(), k.requires_grad_(), v.requires_grad_(), do


def fwd_bwd(apply: Callable, q, k, v, do) -> Tuple[torch.Tensor, ...]:
    """o and the gradients of q, k, v under the incoming ``do``."""
    o = apply(q, k, v)
    return (o, *torch.autograd.grad(o, (q, k, v), do))


def time_path(apply: Callable, q, k, v, do, device: torch.device, iters: int) -> Dict[str, float]:
    """Forward alone (no graph kept) and forward+backward, ms per call."""
    def fwd():
        with torch.no_grad():
            apply(q, k, v)

    return {"fwd_ms": time_ms(fwd, device, iters),
            "fwd_bwd_ms": time_ms(lambda: fwd_bwd(apply, q, k, v, do), device, iters)}


def run(shapes: Sequence = SHAPES, iters: int = ITERS, device=None,
        dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    device = resolve_device(device)
    info = device_info(device)
    out: Dict[str, Any] = {}
    for name, shape in shapes:
        B, T, H, D = shape
        q, k, v, do = inputs(shape, dtype, device)
        flops_fwd = 4 * B * H * T * T * D
        res: Dict[str, Any] = {"shape": list(shape), "dtype": str(dtype)[6:]}
        for label, apply in PATHS.items():
            before = kernel_launches()
            t = time_path(apply, q, k, v, do, device, iters)
            launched = {n: c for n, c in launches_since(before).items() if c}
            res[label] = {**t, "tf_s_fwd": flops_fwd / t["fwd_ms"] / 1e9,
                          "tf_s_fwd_bwd": flops_fwd * 3.5 / t["fwd_bwd_ms"] / 1e9,
                          "launches": launched}
        ref = fwd_bwd(PATHS["plain"], q, k, v, do)
        for label in ("kernel", "sdpa"):
            got = fwd_bwd(PATHS[label], q, k, v, do)
            res[label]["max_abs_diff_vs_plain"] = max(
                (a.float() - b.float()).abs().max().item() for a, b in zip(got, ref))
        print(json.dumps({name: res, "device": info}), flush=True)
        out[name] = res
        del q, k, v, do, ref, got
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return {"shapes": out, "device": info, "iters": iters}


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    result = run(device=args.device)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
