"""Ablations of the bfloat16 attention forward on the card: which part of its
work holds it back.

    python -m headct_foundation_tpu_torch.tools.ablate_attention_fwd   (one CUDA card, nvcc)

For each entry of ABLATIONS, copies the package into a temporary directory,
takes one part of the work out of ``csrc/flash_fwd_sm90.cuh`` (the
exponentials, the K/V copies after the ring's first fill, the rest of the
softmax, one of the two products), builds the forward's libraries there and
times B3 at the 192^3 MAE's decoder and encoder shapes and B1 at the 96^3
decoder's, in device time (``cuda_ms`` behind a device sleep). An ablated
kernel's outputs are wrong; only its time is read. Prints a line per
ablation and, last, one JSON object. Raises without CUDA.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parents[1]
HEADER = "csrc/flash_fwd_sm90.cuh"
_EXP = "ex2(fmaf(s[4 * j + 2 * half{}], c, -m_new))"
# name -> (text of the header, its replacement); every text must occur
ABLATIONS = {
    "none": [],
    "no exponentials": [(_EXP.format(""), "fmaf(s[4 * j + 2 * half], c, -m_new)"),
                        (_EXP.format(" + 1"), "fmaf(s[4 * j + 2 * half + 1], c, -m_new)")],
    "no K/V copies after the first fill": [
        ("      warp_load_tile<DP, CH>(stage(i)",
         "      if (i < kStages) warp_load_tile<DP, CH>(stage(i)")],
    "no softmax but the exponentials": [
        ("    if (online_softmax<NT>(s, m, l, alpha, c, i * NT, kv_len)) scale_rows<DP>(o, alpha);",
         "    for (int e = 0; e < NT / 2; ++e) s[e] = ex2(s[e]);")],
    "no S = Q K^T": [("wgmma_ss<NT>(s, kmajor(qt, 64, kk), kmajor(kt, NT, kk), kk);", ";")],
    "no O += P V": [("wgmma_rs<DP>(o, p[kk], mnmajor<DP>(kt + L::kWalkTile, NT, kk), 1);", ";")],
}
# (name, q/k/v shape [B, T, H, D], wrapper in ops.flash_attention)
SHAPES = [("B3 [2,4097,16,48]", (2, 4097, 16, 48), "blocked_fused_attention"),
          ("B3 [2,1025,12,64]", (2, 1025, 12, 64), "blocked_fused_attention"),
          ("B1 [32,513,16,48]", (32, 513, 16, 48), "fused_attention")]
AHEAD = 2_000_000  # device-side sleep before each timed call, in clock cycles

# Run inside the copy: the three shapes' device times as one JSON line.
RUN = r"""
import json, sys, torch
from headct_foundation_tpu_torch.ops import _build, flash_attention as fa
from headct_foundation_tpu_torch.tools.bench_tm_attention import cuda_ms
from headct_foundation_tpu_torch.tools.ablate_attention_fwd import AHEAD, SHAPES

_build.build_all(["flash_attention_fwd", "flash_attention_blocked_fwd"])
g = torch.Generator(device="cuda").manual_seed(1)
out = {}
for name, (B, T, H, D), wrapper in SHAPES:
    qkv = torch.randn(B, T, 3, H, D, device="cuda", generator=g).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    fn = getattr(fa, wrapper)
    out[name] = cuda_ms(lambda: fn(q, k, v), ahead=AHEAD)
print("TIMES " + json.dumps(out), flush=True)
"""


def ablate(source: str, edits) -> str:
    """The header with every (text, replacement) of ``edits`` applied; raises
    ValueError where a text is not in it."""
    for old, new in edits:
        if old not in source:
            raise ValueError(f"{HEADER} no longer holds {old!r}")
        source = source.replace(old, new)
    return source


def run() -> dict:
    """Device ms of each shape under each ablation."""
    if not torch.cuda.is_available():
        raise RuntimeError("ablate_attention_fwd times CUDA kernels and needs an NVIDIA GPU")
    results = {}
    for name, edits in ABLATIONS.items():
        with tempfile.TemporaryDirectory() as tmp:
            copy = Path(tmp) / PKG.name
            shutil.copytree(PKG, copy, ignore=shutil.ignore_patterns("__pycache__"))
            header = copy / HEADER
            header.write_text(ablate(header.read_text(), edits))
            r = subprocess.run([sys.executable, "-c", RUN], cwd=tmp, text=True,
                               capture_output=True, env=dict(os.environ, PYTHONPATH=tmp),
                               timeout=900)
        times = [ln for ln in r.stdout.splitlines() if ln.startswith("TIMES ")]
        if r.returncode != 0 or not times:
            raise RuntimeError(f"ablation {name!r} failed (exit {r.returncode}):\n"
                               f"{r.stderr[-3000:]}")
        results[name] = json.loads(times[-1][len("TIMES "):])
        print(f"ablation {name}: device ms " + ", ".join(
            f"{shape} {ms:.4f}" for shape, ms in results[name].items()), flush=True)
    return results


def main() -> int:
    results = run()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "ablations": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
