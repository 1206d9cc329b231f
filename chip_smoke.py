#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py          (from the repository root; needs one CUDA card)

Phases, each printing a line; any failure raises and exits non-zero:

1. device  - requires CUDA; prints the card's name and power limit.
2. build   - builds every CUDA kernel of the port from ``csrc/`` with nvcc
             (one process per source, all started together).
3. kernels - holds each kernel against its plain PyTorch version on the card
             at the main path's shapes and at ragged ones, and times the
             kernel, the plain version and the one PyTorch call that computes
             the same function (``library_ms``; the port never calls it).
4. slice   - the embedding server at full width: ViT-B/12 at 96^3, 3
             channels, random weights from a seeded generator, behind
             ``build_server(max_batch=8)``; 8 concurrent POSTs of synthetic
             head-CT scans. Checks 200s, finite 768-d embeddings equal to the
             same volumes run with the plain attention, and that the kernel
             ran 12 times per server forward (counts set to 0 just before).
5. report  - a JSON line of the kernels, the card line, then the result line.

Float32 matmuls and convolutions are pinned to full float32 (TF32 off for
cuBLAS and cuDNN): the serving forward is float32, like the JAX package's.
"""

from __future__ import annotations

import http.client
import json
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # H100 SXM, dense
PEAK_BYTES = 3.35e12
SERVING = (8, 513, 12, 64)
KERNEL_CASES = [  # (shape [B, T, H, D], dtype, atol, rtol) for O; LSE at 1e-4 / 1e-4
    (SERVING, torch.float32, 2e-5, 1e-4),               # serving path, every ViT-B block
    ((8, 513, 16, 48), torch.bfloat16, 2e-2, 2e-2),     # MAE decoder (next slice)
    ((2, 129, 3, 32), torch.float32, 2e-5, 1e-4),       # ragged tiles
    ((2, 9, 3, 12), torch.float32, 2e-5, 1e-4),
]
N_REQUESTS = 8
EMBED_ATOL = 1e-3  # kernel vs plain attention through 12 float32 blocks


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def attention_bound_ms(shape, dtype) -> tuple:
    """Least time for the work: 4*B*H*T^2*D operations at the type's peak, or
    q, k, v read once plus o and lse written once at the memory rate."""
    B, T, H, D = shape
    ops = 4 * B * H * T * T * D
    nbytes = 4 * B * T * H * D * torch.tensor([], dtype=dtype).element_size() + B * H * T * 4
    t_ops, t_bytes = ops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def synthetic_scan(seed: int) -> np.ndarray:
    """A head-CT-like int16 volume [256, 256, 40] in HU: air, a skull shell,
    brain tissue with noise, placed off-centre so the foreground crop acts."""
    rng = np.random.RandomState(seed)
    shape = (256, 256, 40)
    c = np.array([128 + rng.randint(-20, 20), 128 + rng.randint(-20, 20), 20])
    r = np.array([90 + rng.randint(0, 20), 105 + rng.randint(0, 20), 24])
    grid = np.ogrid[: shape[0], : shape[1], : shape[2]]
    d = sum(((g - ci) / ri) ** 2 for g, ci, ri in zip(grid, c, r))
    vol = np.full(shape, -1000.0, np.float32)
    vol[d < 1.0] = 1000.0                                   # skull
    brain = d < 0.8
    vol[brain] = 35.0 + 8.0 * rng.randn(int(brain.sum()))  # grey/white matter
    return np.round(vol).astype(np.int16)


def phase_kernels(fused_attention, fused_attention_reference) -> dict:
    results = {}
    for shape, dtype, atol, rtol in KERNEL_CASES:
        B, T, H, D = shape
        g = torch.Generator(device="cuda").manual_seed(1)
        qkv = torch.randn(B, T, 3, H, D, device="cuda", generator=g).to(dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # strided, as the model passes them
        o, lse = fused_attention(q, k, v)
        torch.cuda.synchronize()
        o_ref, lse_ref = fused_attention_reference(q, k, v)
        err_o = (o.float() - o_ref.float()).abs()
        err_lse = (lse - lse_ref).abs()
        ok = bool((err_o <= atol + rtol * o_ref.float().abs()).all()
                  and (err_lse <= 1e-4 + 1e-4 * lse_ref.abs()).all())
        print(f"kernel flash_attention_fwd {list(shape)} {str(dtype)[6:]}: max_abs_err "
              f"o={err_o.max().item():.3e} lse={err_lse.max().item():.3e} "
              f"(tolerance o atol {atol} rtol {rtol}, lse atol 1e-4 rtol 1e-4) "
              f"{'ok' if ok else 'FAILED'}", flush=True)
        check(ok, f"flash_attention_fwd disagrees with its plain version at {shape} {dtype}")
        row = {"max_abs_err": err_o.max().item()}
        if T == 513:  # the main path's shapes: time kernel, plain version and library call
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            row["ms"] = cuda_ms(lambda: fused_attention(q, k, v))
            row["plain_ms"] = cuda_ms(lambda: fused_attention_reference(q, k, v))
            row["library_ms"] = cuda_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt))
            row["bound_ms"], row["bound_by"] = attention_bound_ms(shape, dtype)
            print(f"timing flash_attention_fwd {list(shape)} {str(dtype)[6:]}: "
                  f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
                  f"scaled_dot_product_attention {row['library_ms']:.4f} ms, bound "
                  f"{row['bound_ms']:.4f} ms by {row['bound_by']} "
                  f"({100 * row['bound_ms'] / row['ms']:.1f}% of bound)", flush=True)
        results[(shape, dtype)] = row
    return results


def post_scans(port: int, blobs) -> list:
    out = [None] * len(blobs)

    def hit(i):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        t0 = time.perf_counter()
        try:
            conn.request("POST", "/embed", body=blobs[i])
            resp = conn.getresponse()
            body = json.loads(resp.read())
            out[i] = (resp.status, body, time.perf_counter() - t0)
        finally:
            conn.close()

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(len(blobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
        check(not t.is_alive(), "a request did not finish")
    check(all(r is not None for r in out), "a request failed before its reply")
    return out


def phase_slice(workdir: Path) -> dict:
    """Drive the server at full width; returns each kernel's launches in it."""
    from headct_foundation_tpu_torch.data.nifti import save_nifti
    from headct_foundation_tpu_torch.feature_extraction import FeatureExtractor
    from headct_foundation_tpu_torch.ops import attention as port_attn
    from headct_foundation_tpu_torch.ops.flash_attention import fused_attention
    from headct_foundation_tpu_torch.serve_features import build_server

    t0 = time.perf_counter()
    fe = FeatureExtractor(device="cuda", seed=0)  # ViT-B/12 @ 96^3, 3 channels, sincos
    warm = torch.zeros((N_REQUESTS, 3, 96, 96, 96), device="cuda")
    fe(warm)
    torch.cuda.synchronize()
    print(f"slice set-up: FeatureExtractor(ViT-B/12, 96^3, seed 0) on {fe.device} and warm "
          f"forward in {time.perf_counter() - t0:.2f} s", flush=True)

    paths = []
    for i in range(N_REQUESTS):
        p = workdir / f"scan{i}.nii.gz"
        save_nifti(str(p), synthetic_scan(i), np.diag([0.5, 0.5, 1.0, 1.0]), dtype=np.int16)
        paths.append(p)
    blobs = [p.read_bytes() for p in paths]

    server, batcher = build_server(fe, host="127.0.0.1", port=0, max_batch=N_REQUESTS,
                                   window_ms=20.0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        # the main path's run: every kernel count is 0 just before it
        fused_attention.launches = 0
        t0 = time.perf_counter()
        replies = post_scans(server.server_address[1], blobs)
        wall = time.perf_counter() - t0
        launches = {"flash_attention_fwd": fused_attention.launches}
        forwards = batcher.batches
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
        thread.join(timeout=30)

    for i, (status, body, _) in enumerate(replies):
        check(status == 200, f"request {i}: HTTP {status} {body}")
        emb = np.asarray(body["embedding"], np.float32)
        check(emb.shape == (768,) and bool(np.isfinite(emb).all()),
              f"request {i}: embedding shape {emb.shape} or non-finite values")
    check(forwards >= 1 and launches["flash_attention_fwd"] == 12 * forwards,
          f"flash_attention_fwd ran {launches['flash_attention_fwd']} times in "
          f"{forwards} server forwards; expected 12 per forward")
    lat = sorted(r[2] * 1e3 for r in replies)
    print(f"slice: {N_REQUESTS} POST /embed of 256x256x40 int16 scans at 0.5x0.5x1.0 mm -> "
          f"200 x{N_REQUESTS}, 768-d finite; {forwards} server forwards "
          f"(batched_with {[r[1]['batched_with'] for r in replies]}); flash_attention_fwd "
          f"launches {launches['flash_attention_fwd']} = 12 per forward; latency p50 "
          f"{statistics.median(lat):.1f} ms max {lat[-1]:.1f} ms; "
          f"{N_REQUESTS / wall:.2f} volumes/s", flush=True)

    # The same volumes with the attention forced to the plain version.
    vols = torch.stack([fe.preprocess(p) for p in paths])
    prev = port_attn.set_attention_backend("plain")
    try:
        ref = fe.cls_embedding(vols)
    finally:
        port_attn.set_attention_backend(prev)
    got = np.stack([np.asarray(r[1]["embedding"], np.float32) for r in replies])
    err = float(np.abs(got - ref).max())
    print(f"slice: embeddings vs plain-attention forward: max_abs_err {err:.3e} "
          f"(tolerance {EMBED_ATOL})", flush=True)
    check(err <= EMBED_ATOL, "server embeddings disagree with the plain-attention forward")

    # Where the time goes (device times from CUDA events, batch 8).
    prep_ms = cuda_ms(lambda: fe.preprocess(blobs[0]), iters=5, warmup=1)
    fwd_ms = cuda_ms(lambda: fe(vols), iters=5, warmup=1)
    prev = port_attn.set_attention_backend("plain")
    try:
        fwd_plain_ms = cuda_ms(lambda: fe(vols), iters=5, warmup=1)
    finally:
        port_attn.set_attention_backend(prev)
    print(f"breakdown: preprocess one scan (decode + device ops) {prep_ms:.2f} ms; forward "
          f"batch {N_REQUESTS}: {fwd_ms:.2f} ms with the kernel, {fwd_plain_ms:.2f} ms with "
          f"the plain attention", flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False  # full float32 matmuls
    torch.backends.cudnn.allow_tf32 = False        # and convolutions
    card = card_line()
    print(f"device: {card} | torch {torch.__version__} CUDA {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    from headct_foundation_tpu_torch.ops import _build
    from headct_foundation_tpu_torch.ops.flash_attention import (
        fused_attention,
        fused_attention_reference,
    )

    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {sorted(_build.SOURCES)} with nvcc for sm_90a in "
          f"{time.perf_counter() - t0:.2f} s (set-up)", flush=True)
    for name, log in sorted(_build.build_logs.items()):  # ptxas -v, per instantiation
        used = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"build: {name} ptxas registers {used} spill-store bytes {spills}", flush=True)

    kernel_rows = phase_kernels(fused_attention, fused_attention_reference)
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        launches = phase_slice(Path(tmp))["flash_attention_fwd"]

    serving = kernel_rows[(SERVING, torch.float32)]
    check(launches > 0, "flash_attention_fwd was not launched on the main path")
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "headct_foundation_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "headct_foundation_tpu/ops/flash_attention.py:60",
        "launches": launches,
        "max_abs_err": serving["max_abs_err"],
        "ms": serving["ms"],
        "plain_ms": serving["plain_ms"],
        "bound_ms": serving["bound_ms"],
        "bound_by": serving["bound_by"],
        "library_ms": serving["library_ms"],
    }]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
