"""Ablations of the attention forward on the card: which part of its work
holds it back.

    python -m headct_foundation_tpu_torch.tools.ablate_attention_fwd [--dtype float32]
        [--package DIR ...]                                   (one CUDA card, nvcc)

For each entry of ABLATIONS (bfloat16, the default) or F32_ABLATIONS
(``--dtype float32``), copies the package into a temporary directory, takes
one part of the work out of the forward's CUDA header, builds the forward's
libraries there and times the forward in device time (``cuda_ms`` behind a
device sleep). bfloat16: ``csrc/flash_fwd_sm90.cuh`` without the
exponentials, the K/V copies after the ring's first fill, the rest of the
softmax or one of the two products, timed as B3 at the 192^3 MAE's decoder
and encoder shapes and B1 at the 96^3 decoder's. float32:
``csrc/flash_fwd_f32_sm90.cuh`` without the exponentials (of the softmax it
shares with the bfloat16 kernel), the K/V copies after the first fill, the
hi/lo split of the K tiles, S = Q K^T, O += P V or the products of a lo part
(leaving one TF32 product each), timed as B1 at the serving shape. An
ablated kernel's outputs are wrong; only its time is read.

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

PKG = Path(__file__).resolve().parents[1]
HEADER = "csrc/flash_fwd_sm90.cuh"
F32_HEADER = "csrc/flash_fwd_f32_sm90.cuh"
_EXP = "ex2(fmaf(s[4 * j + 2 * half{}], c, -m_new))"
_NO_EXP = [(_EXP.format(""), "fmaf(s[4 * j + 2 * half], c, -m_new)"),
           (_EXP.format(" + 1"), "fmaf(s[4 * j + 2 * half + 1], c, -m_new)")]
# name -> (text of HEADER, its replacement); every text must occur
ABLATIONS = {
    "none": [],
    "no exponentials": _NO_EXP,
    "no K/V copies after the first fill": [
        ("      warp_load_tile<DP, CH>(stage(i)",
         "      if (i < kStages) warp_load_tile<DP, CH>(stage(i)")],
    "no softmax but the exponentials": [
        ("    if (online_softmax<NT>(s, m, l, alpha, c, i * NT, kv_len)) scale_rows<DP>(o, alpha);",
         "    for (int e = 0; e < NT / 2; ++e) s[e] = ex2(s[e]);")],
    "no S = Q K^T": [("wgmma_ss<NT>(s, kmajor(qt, 64, kk), kmajor(kt, NT, kk), kk);", ";")],
    "no O += P V": [("wgmma_rs<DP>(o, p[kk], mnmajor<DP>(kt + L::kWalkTile, NT, kk), 1);", ";")],
}
_S_LO = ("wgmma_tf32<NT>(s, kmajor(q_lo, 64, kk), kmajor(k_hi, NT, kk), kk);",
         "wgmma_tf32<NT>(s, kmajor(q_hi, 64, kk), kmajor(k_lo, NT, kk), 1);")
_S_HI = "wgmma_tf32<NT>(s, kmajor(q_hi, 64, kk), kmajor(k_hi, NT, kk), 1);"
_PV_LO = ("wgmma_rs_tf32<DP>(o, p_lo[kk], kmajor(vt_hi, DP, kk), 1);",
          "wgmma_rs_tf32<DP>(o, p_hi[kk], kmajor(vt_lo, DP, kk), 1);")
_PV_HI = "wgmma_rs_tf32<DP>(o, p_hi[kk], kmajor(vt_hi, DP, kk), 1);"
# name -> (header, text, its replacement); the exponentials are in the softmax
# the float32 kernel takes from HEADER
F32_ABLATIONS = {
    "none": [],
    "no exponentials": [(HEADER, old, new) for old, new in _NO_EXP],
    "no K/V copies after the first fill": [(F32_HEADER, "        copy(i);\n", "")],
    "no split of the K tiles": [
        (F32_HEADER, "split_chunk(sm, swz4(k_tile(j), NT, r0 + n * kStep, c), L::kKTile, 1.f);",
         "(void)0;")],
    "no S = Q K^T": [(F32_HEADER, text, ";") for text in (*_S_LO, _S_HI)],
    "no O += P V": [(F32_HEADER, text, ";") for text in (*_PV_LO, _PV_HI)],
    "no lo products": [(F32_HEADER, _S_LO[0], ";"), (F32_HEADER, _S_LO[1], ";"),
                       (F32_HEADER, _S_HI, _S_HI.replace(", 1);", ", kk);")),
                       (F32_HEADER, _PV_LO[0], ";"), (F32_HEADER, _PV_LO[1], ";")],
}
# (name, q/k/v shape [B, T, H, D], wrapper in ops.flash_attention)
SHAPES = [("B3 [2,4097,16,48]", (2, 4097, 16, 48), "blocked_fused_attention"),
          ("B3 [2,1025,12,64]", (2, 1025, 12, 64), "blocked_fused_attention"),
          ("B1 [32,513,16,48]", (32, 513, 16, 48), "fused_attention")]
F32_SHAPES = [("B1 f32 [8,513,12,64]", (8, 513, 12, 64), "fused_attention")]
AHEAD = 2_000_000  # device-side sleep before each timed call, in clock cycles

# Run inside the copy, with the shapes and the dtype as arguments: their
# device times as one JSON line.
RUN = r"""
import json, sys, torch
from headct_foundation_tpu_torch.ops import _build, flash_attention as fa
from headct_foundation_tpu_torch.tools.bench_tm_attention import cuda_ms

shapes, dtype, ahead = json.loads(sys.argv[1]), getattr(torch, sys.argv[2]), int(sys.argv[3])
_build.build_all(sorted({"fused_attention": "flash_attention_fwd",
                         "blocked_fused_attention": "flash_attention_blocked_fwd"}[w]
                        for _, _, w in shapes))
g = torch.Generator(device="cuda").manual_seed(1)
out = {}
for name, (B, T, H, D), wrapper in shapes:
    qkv = torch.randn(B, T, 3, H, D, device="cuda", generator=g).to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    fn = getattr(fa, wrapper)
    out[name] = cuda_ms(lambda: fn(q, k, v), ahead=ahead)
print("TIMES " + json.dumps(out), flush=True)
"""


def ablate(source: str, edits) -> str:
    """The header with every (text, replacement) of ``edits`` applied; raises
    ValueError where a text is not in it."""
    for old, new in edits:
        if old not in source:
            raise ValueError(f"the header no longer holds {old!r}")
        source = source.replace(old, new)
    return source


def by_header(edits) -> dict:
    """(header, text, replacement) edits grouped as {header: [(text, replacement)]}."""
    grouped = {}
    for header, old, new in edits:
        grouped.setdefault(header, []).append((old, new))
    return grouped


def time_package(package: Path, edits_by_header: dict, script: str, *args: str) -> dict:
    """Device ms by shape that ``script`` prints (its last ``TIMES`` line),
    run with ``args`` in a copy of ``package`` whose headers have
    ``edits_by_header`` ({header: [(text, replacement)]}) applied."""
    with tempfile.TemporaryDirectory() as tmp:
        copy = Path(tmp) / PKG.name
        shutil.copytree(package, copy, ignore=shutil.ignore_patterns("__pycache__"))
        for header, edits in edits_by_header.items():
            path = copy / header
            path.write_text(ablate(path.read_text(), edits))
        r = subprocess.run([sys.executable, "-c", script, *args], cwd=tmp, text=True,
                           capture_output=True, env=dict(os.environ, PYTHONPATH=tmp),
                           timeout=900)
    times = [ln for ln in r.stdout.splitlines() if ln.startswith("TIMES ")]
    if r.returncode != 0 or not times:
        raise RuntimeError(f"timing {package} failed (exit {r.returncode}):\n{r.stderr[-3000:]}")
    return json.loads(times[-1][len("TIMES "):])


def time_runs(runs, script: str, *args: str) -> dict:
    """time_package of each (name, package, edits_by_header) of ``runs`` in
    turn, printed as it comes, by name."""
    results = {}
    for name, package, edits_by_header in runs:
        results[name] = time_package(package, edits_by_header, script, *args)
        print(f"{name}: device ms " + ", ".join(
            f"{shape} {ms:.4f}" for shape, ms in results[name].items()), flush=True)
    return results


def run(dtype: str = "bfloat16", packages=()) -> dict:
    """Device ms of each shape under each ablation of the ``dtype`` forward,
    or of each package copy given, by run name."""
    if not torch.cuda.is_available():
        raise RuntimeError("ablate_attention_fwd times CUDA kernels and needs an NVIDIA GPU")
    if dtype == "float32":
        ablations, shapes = F32_ABLATIONS, F32_SHAPES
    else:
        ablations = {n: [(HEADER, *e) for e in edits] for n, edits in ABLATIONS.items()}
        shapes = SHAPES
    runs = ([(f"package {p}", Path(p), {}) for p in packages] if packages else
            [(f"ablation {n}", PKG, by_header(edits)) for n, edits in ablations.items()])
    return time_runs(runs, RUN, json.dumps(shapes), dtype, str(AHEAD))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16",
                    help="which forward to ablate")
    ap.add_argument("--package", action="append", default=[],
                    help="time this copy of the package instead (repeatable)")
    args = ap.parse_args(argv)
    results = run(args.dtype, args.package)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "dtype": args.dtype,
                      "runs": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
