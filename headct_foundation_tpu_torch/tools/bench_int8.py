"""int8 against bfloat16 matrix products at the MAE's shapes: the port's
counterpart of the JAX repository's ``tools/bench_int8.py``.

    python -m headct_foundation_tpu_torch.tools.bench_int8 [--tokens 16416] [--device cpu]

The shapes are the JAX tool's (``:63-66``): ``mae_mlp`` [B*T, 768] x [768,
3072] and ``qkv_proj`` [B*T, 768] x [768, 2304] with B*T = 32 x 513. Each
of three variants is timed as a chain of ``CHAIN`` dependent products (the
JAX tool's ``_chain``): each product's full sum picks the shift of the
next product's rows, so every output element is read and no product can
start before the last one ends. CUDA events time the chain, the best of
``RUNS`` after a warm one gives the time a product (the sum and the row
gather included, as in the JAX tool):

* ``bf16``: ``a @ w.t()`` in bfloat16 (cuBLAS);
* ``int8_prequant``: operands quantised ahead, ``torch._int_mm`` to int32;
* ``int8_dynamic``: what a training step would run, the JAX tool's formula
  (``:86-103``): per-tensor scales max|x| / 127, round, clip to +-127,
  the int8 product, the int32 sum times both scales, in bfloat16.

Beside the chains, ``*_alone_ms`` times the bf16 and the prequantised int8
product alone: CHAIN calls on the same operands back to back.

The JAX package computes these products with XLA's ``dot_general``, not a
Pallas kernel, so the library's GEMM is the counterpart here. The second
operand is held as a [N, K] weight and used transposed, the layout whose
int8 product cuBLASLt takes directly. ``check_exact`` holds the int8
product against an int64 product of a row slice on the host. Prints one
line per shape and one JSON line with the device, ms, TF/s (TOP/s for
int8) beside the card's dense peaks and the two speedups. Runs on ``cuda``
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from headct_foundation_tpu_torch.bench import device_info
from headct_foundation_tpu_torch.feature_extraction import resolve_device

RUNS = 3
CHAIN = 16  # products per timed chain
TOKENS = 32 * 513
DENSE_PEAK = {"bf16_TFs": 989.0, "int8_TOPs": 1979.0}  # H100 SXM, dense


def shapes(tokens: int = TOKENS) -> List[tuple]:
    return [("mae_mlp", (tokens, 768), (768, 3072)), ("qkv_proj", (tokens, 768), (768, 2304))]


def bf16_product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return a @ w.t()


def int8_prequant(a8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """The pure int8 product of quantised operands, int32 out."""
    return torch._int_mm(a8, w8.t())


def quantize(x: torch.Tensor) -> tuple:
    """(int8 codes, float32 scale): the scale max|x| / 127, the codes
    round(x / scale) clipped to +-127 (the JAX tool's formula)."""
    s = x.abs().max().float() / 127.0
    return torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8), s


def int8_dynamic(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Dynamic per-tensor quantisation, the int8 product and the
    dequantisation, in bfloat16 (JAX ``tools/bench_int8.py:86-103``)."""
    qa, sa = quantize(a)
    qw, sw = quantize(w)
    acc = torch._int_mm(qa, qw.t())
    return (acc.float() * (sa * sw)).to(torch.bfloat16)


def _chain(op: Callable, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """CHAIN dependent products: each one's full sum picks the next
    operand's row shift (0 or 1). Returns the last sum."""
    rows = torch.arange(a.shape[0], device=a.device)
    carry, tot = a, None
    for _ in range(CHAIN):
        tot = op(carry, w).sum(dtype=torch.float32)  # one read of the product, no copy
        shift = tot.to(torch.int64).remainder(2)
        carry = carry.index_select(0, (rows + shift).remainder(a.shape[0]))
    return tot


def _alone(op: Callable, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """CHAIN products of the same operands back to back, no sum between."""
    for _ in range(CHAIN):
        out = op(a, w)
    return out.view(-1)[0]


def time_chain(op: Callable, a: torch.Tensor, w: torch.Tensor, device: torch.device,
               runs: int = RUNS, chain: Callable = _chain) -> float:
    """Seconds a product: the best of ``runs`` timed chains after a warm one
    (CUDA events on the card, the host clock on the CPU)."""
    float(chain(op, a, w).item())
    best = float("inf")
    for _ in range(runs):
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            v = chain(op, a, w)
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        else:
            import time

            t0 = time.perf_counter()
            v = chain(op, a, w)
            seconds = time.perf_counter() - t0
        float(v.item())
        best = min(best, seconds / CHAIN)
    return best


def check_exact(a8: torch.Tensor, w8: torch.Tensor, rows: int = 16) -> int:
    """The int8 product's first ``rows`` rows against an int64 product on
    the host; returns the largest difference (0 when exact)."""
    got = int8_prequant(a8, w8)[:rows].cpu().long()
    want = a8[:rows].cpu().long() @ w8.cpu().long().t()
    return int((got - want).abs().max())


def run(device=None, tokens: int = TOKENS, runs: int = RUNS, seed: int = 0) -> dict:
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    report: Dict[str, dict] = {}
    for name, a_shape, b_shape in shapes(tokens):
        a = torch.from_numpy(rng.randn(*a_shape).astype(np.float32)).to(device, torch.bfloat16)
        w = torch.from_numpy(rng.randn(*b_shape).astype(np.float32).T.copy()).to(
            device, torch.bfloat16)  # [N, K]
        a8 = torch.from_numpy(rng.randint(-127, 127, a_shape).astype(np.int8)).to(device)
        w8 = torch.from_numpy(rng.randint(-127, 127, b_shape).astype(np.int8).T.copy()).to(device)
        max_diff = check_exact(a8, w8)
        if max_diff:
            raise RuntimeError(f"{name}: the int8 product is {max_diff} off the int64 product")
        t_bf16 = time_chain(bf16_product, a, w, device, runs)
        t_int8 = time_chain(int8_prequant, a8, w8, device, runs)
        t_dyn = time_chain(int8_dynamic, a, w, device, runs)
        alone_bf16 = time_chain(bf16_product, a, w, device, runs, _alone)
        alone_int8 = time_chain(int8_prequant, a8, w8, device, runs, _alone)
        flops = 2 * a_shape[0] * a_shape[1] * b_shape[1]
        report[name] = {
            "shape": [list(a_shape), list(b_shape)],
            "bf16_ms": t_bf16 * 1e3,
            "bf16_TFs": flops / t_bf16 / 1e12,
            "int8_prequant_ms": t_int8 * 1e3,
            "int8_prequant_TOPs": flops / t_int8 / 1e12,
            "int8_dynamic_ms": t_dyn * 1e3,
            "speedup_prequant": t_bf16 / t_int8,
            "speedup_dynamic": t_bf16 / t_dyn,
            "bf16_alone_ms": alone_bf16 * 1e3,
            "int8_prequant_alone_ms": alone_int8 * 1e3,
            "speedup_prequant_alone": alone_bf16 / alone_int8,
            "int8_exact_rows": 16,
        }
        print(name, json.dumps(report[name]), flush=True)
    return {"device": device_info(device), "dense_peak": DENSE_PEAK, "chain": CHAIN,
            "report": report}


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tokens", type=int, default=TOKENS, help="rows of the first operand")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    result = run(args.device, args.tokens)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
