"""Ablations of the bfloat16 attention backward on the card: which part of its
work holds it back.

    python -m headct_foundation_tpu_torch.tools.ablate_attention_bwd [--package DIR ...]
                                                              (one CUDA card, nvcc)

For each entry of ABLATIONS, copies the package into a temporary directory, takes one part of the work
out of ``csrc/flash_bwd_sm90.cuh`` (the exponentials, the walked tiles'
copies after the ring's first fill, the wait for the fixed tiles, the
first or the second products, the stores), builds the backward's libraries
there and times B2 and B8 at the 96^3 MAE decoder's shape and B4 and B5 at
the 192^3 MAE's decoder and encoder shapes, in device time (``cuda_ms`` behind a
device sleep), beside the backward of ``scaled_dot_product_attention`` at
B2's shape (its forward+backward minus its forward). An ablated kernel's
outputs are wrong; only its time is read.

``--package DIR`` times that copy of the package instead of this one, with
no ablation (another tree, such as the parent commit's or a variant of the
kernels); given more than once, the copies are timed in the order given, so
that two trees compare within one run on one card. Prints a line per run
and, last, one JSON object. Raises without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from headct_foundation_tpu_torch.tools.ablate_attention_fwd import ablate

PKG = Path(__file__).resolve().parents[1]
HEADER = "csrc/flash_bwd_sm90.cuh"
_EXP_DKV = "ex2(fmaf(s[4 * j + e], c, -lse_q * kLog2e))"
_EXP_DQ = "ex2(fmaf(s[4 * j + e], c, neg_lse2[e >> 1]))"
# A step taken out behind a condition that never holds (B >= 1) but that the
# compiler cannot see through, so that the work feeding it stays in.
_NEVER = "if (a.B < 0) "
# name -> (text of the header, its replacement); every text must occur
ABLATIONS = {
    "none": [],
    "no exponentials": [(_EXP_DKV, "fmaf(s[4 * j + e], c, -lse_q * kLog2e)"),
                        (_EXP_DQ, "fmaf(s[4 * j + e], c, neg_lse2[e >> 1])")],
    "no walked copies after the first fill": [
        ("warp_load_tile<DP, CH>(tile + (is_", "if (i < kStages) warp_load_tile<DP, CH>(tile + (is_")],
    "no wait for the fixed tiles": [("    bar_wait(fixed, 0);\n", "")],
    "no S, dP products": [
        ("wgmma_ss<NT>(s, kmajor(sm.base,", _NEVER + "wgmma_ss<NT>(s, kmajor(sm.base,"),
        ("wgmma_ss<NT>(dp, kmajor(sm.base", _NEVER + "wgmma_ss<NT>(dp, kmajor(sm.base")],
    "no dV, dK, dQ products": [("wgmma_rs<DP>(", _NEVER + "wgmma_rs<DP>(")],
    "no stores": [("store_rows<DP>(", _NEVER + "store_rows<DP>(")],
}
# (name, q/k/v shape [B, T, H, D], what is timed)
SHAPES = [("B2 [32,513,16,48]", (32, 513, 16, 48), "fused_attention_bwd"),
          ("B8 [32,513,16,48]", (32, 513, 16, 48), "tm_attention_bwd"),
          ("SDPA backward [32,513,16,48]", (32, 513, 16, 48), "sdpa_backward"),
          ("B4 [2,4097,16,48]", (2, 4097, 16, 48), "blocked_attention_dkv"),
          ("B5 [2,4097,16,48]", (2, 4097, 16, 48), "blocked_attention_dq"),
          ("B4 [2,1025,12,64]", (2, 1025, 12, 64), "blocked_attention_dkv"),
          ("B5 [2,1025,12,64]", (2, 1025, 12, 64), "blocked_attention_dq")]
AHEAD = 2_000_000  # device-side sleep before each timed call, in clock cycles

# Run inside the copy, with the shapes as a JSON argument: their device times
# as one JSON line. It uses only what every version of the package has.
RUN = r"""
import json, sys, torch
from headct_foundation_tpu_torch.ops import _build, flash_attention as fa
from headct_foundation_tpu_torch.tools import experimental_tm_attention as tm
from headct_foundation_tpu_torch.tools.bench_tm_attention import cuda_ms

shapes, ahead = json.loads(sys.argv[1]), int(sys.argv[2])
_build.build_all(["flash_attention_bwd", "flash_attention_blocked_bwd", "tm_attention"])
sdpa = torch.nn.functional.scaled_dot_product_attention
out = {}
for name, (B, T, H, D), what in shapes:
    g = torch.Generator(device="cuda").manual_seed(1)
    qkv = torch.randn(B, T, 3, H, D, device="cuda", generator=g).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = torch.randn(B, T, H, D, device="cuda", generator=g).to(torch.bfloat16)
    if what == "sdpa_backward":
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        dot = do.transpose(1, 2)
        out[name] = (cuda_ms(lambda: sdpa(qt, kt, vt).backward(dot), ahead=ahead)
                     - cuda_ms(lambda: sdpa(qt, kt, vt), ahead=ahead))
        continue
    o, lse = fa.blocked_attention_reference(q, k, v)
    o = o.to(torch.bfloat16)
    if what == "fused_attention_bwd":
        out[name] = cuda_ms(lambda: fa.fused_attention_bwd(q, k, v, o, do, lse), ahead=ahead)
    elif what == "tm_attention_bwd":  # token-major: contiguous operands, lse [B, H, T]
        q, k, v, o = (x.contiguous() for x in (q, k, v, o))
        lse = lse.reshape(B, H, T)
        out[name] = cuda_ms(lambda: tm.tm_attention_bwd(q, k, v, o, do, lse), ahead=ahead)
    else:
        delta = fa.attention_delta(o, do)
        fn = getattr(fa, what)
        out[name] = cuda_ms(lambda: fn(q, k, v, do, lse, delta), iters=10, ahead=ahead)
    del qkv, q, k, v, do, o, lse
    torch.cuda.empty_cache()
print("TIMES " + json.dumps(out), flush=True)
"""


def time_package(package: Path, edits=()) -> dict:
    """Device ms at each of SHAPES of a copy of ``package`` with ``edits``
    applied to its HEADER."""
    with tempfile.TemporaryDirectory() as tmp:
        copy = Path(tmp) / PKG.name
        shutil.copytree(package, copy, ignore=shutil.ignore_patterns("__pycache__"))
        if edits:
            header = copy / HEADER
            header.write_text(ablate(header.read_text(), edits))
        r = subprocess.run([sys.executable, "-c", RUN, json.dumps(SHAPES), str(AHEAD)], cwd=tmp,
                           text=True, capture_output=True, env=dict(os.environ, PYTHONPATH=tmp),
                           timeout=900)
    times = [ln for ln in r.stdout.splitlines() if ln.startswith("TIMES ")]
    if r.returncode != 0 or not times:
        raise RuntimeError(f"timing {package} failed (exit {r.returncode}):\n{r.stderr[-3000:]}")
    return json.loads(times[-1][len("TIMES "):])


def run(packages=()) -> dict:
    """Device ms of each shape under each ablation, or of each package copy
    given, by run name."""
    if not torch.cuda.is_available():
        raise RuntimeError("ablate_attention_bwd times CUDA kernels and needs an NVIDIA GPU")
    runs = ([(f"package {p}", Path(p), ()) for p in packages] if packages else
            [(n, PKG, edits) for n, edits in ABLATIONS.items()])
    results = {}
    for name, package, edits in runs:
        results[name] = time_package(package, edits)
        print(f"{name}: device ms " + ", ".join(
            f"{shape} {ms:.4f}" for shape, ms in results[name].items()), flush=True)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", action="append", default=[],
                    help="time this copy of the package instead (repeatable)")
    args = ap.parse_args(argv)
    results = run(args.package)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "runs": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
