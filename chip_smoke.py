#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py          (from the repository root; needs one CUDA card)

Phases, each printing a line; any failure raises and exits non-zero:

1. device  - requires CUDA; prints the card's name and power limit.
2. build   - builds every CUDA kernel of the port from ``csrc/`` with nvcc
             (one process per source, all started together).
3. kernels - holds each kernel against its plain PyTorch version on the card
             at the main paths' shapes and at ragged ones, and times the
             kernel, the plain version and the one PyTorch call that computes
             the same function (``library_ms``; the port never calls it).
4. slice   - the embedding server at full width: ViT-B/12 at 96^3, 3
             channels, random weights from a seeded generator, behind
             ``build_server(max_batch=8)``; 8 concurrent POSTs of synthetic
             head-CT scans. Checks 200s, finite 768-d embeddings equal to the
             same volumes run with the plain attention, and that the forward
             kernel ran 12 times per server forward (counts set to 0 just
             before).
5. train   - the MAE pretraining step at full width (configs/mae/mae_HeadCT.yaml:
             ViT-B/12 encoder, 8-block decoder of width 768 with 16 heads,
             96^3, bf16 compute, AdamW with cosine warm-up) on batch 32 of
             synthetic hu16 head phantoms: one step's loss and gradients with
             the kernels against the plain attention (bf16 and float32), then
             ``train_one_epoch`` over 6 batches and ``val_one_epoch`` over 1,
             checking finite losses, moved parameters and 8 forward + 8
             backward kernel launches per train step, 8 forward per eval
             batch (counts set to 0 just before each); then step time,
             throughput, peak memory, a breakdown (CUDA events) and the
             device time by kernel group over 2 profiled steps.
6. report  - a JSON line of the kernels, the card line, then the result line.

Float32 matmuls and convolutions are pinned to full float32 (TF32 off for
cuBLAS and cuDNN): the serving forward is float32, like the JAX package's.
"""

from __future__ import annotations

import http.client
import json
import logging
import math
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
MAE_DECODER = (32, 513, 16, 48)
KERNEL_CASES = [  # (shape [B, T, H, D], dtype, atol, rtol) for O; LSE at 1e-4 / 1e-4
    (SERVING, torch.float32, 2e-5, 1e-4),               # serving path, every ViT-B block
    (MAE_DECODER, torch.bfloat16, 2e-2, 2e-2),          # MAE decoder, every block
    ((2, 129, 3, 32), torch.float32, 2e-5, 1e-4),       # ragged tiles
    ((2, 9, 3, 12), torch.float32, 2e-5, 1e-4),
    ((2, 129, 3, 32), torch.bfloat16, 2e-2, 2e-2),      # the tensor-core path's other
    ((2, 9, 3, 12), torch.bfloat16, 2e-2, 2e-2),        # head-dim paddings (32, 16,
    ((2, 200, 2, 64), torch.bfloat16, 2e-2, 2e-2),      # 64, 128)
    ((2, 70, 2, 128), torch.bfloat16, 2e-2, 2e-2),
]
BWD_CASES = [  # (shape, dtype, atol, rtol) for dq, dk, dv against the plain backward
    (MAE_DECODER, torch.bfloat16, 2e-2, 2e-2),          # MAE decoder (main path)
    (MAE_DECODER, torch.float32, 1e-4, 1e-3),
    ((2, 129, 3, 32), torch.float32, 1e-4, 1e-3),       # ragged tiles
    ((2, 9, 3, 12), torch.float32, 1e-4, 1e-3),
    ((2, 129, 3, 32), torch.bfloat16, 2e-2, 2e-2),      # the tensor-core path's other
    ((2, 9, 3, 12), torch.bfloat16, 2e-2, 2e-2),        # head-dim paddings (32, 16,
    ((2, 200, 2, 64), torch.bfloat16, 2e-2, 2e-2),      # 64, 128)
    ((2, 70, 2, 128), torch.bfloat16, 2e-2, 2e-2),
]
MAE_CONFIG = "configs/mae/mae_HeadCT.yaml"
TRAIN_BATCH = 32          # the JAX bench's batch per chip (bench.py:54)
TRAIN_BATCHES, VAL_BATCHES, WARMUP_STEPS = 6, 1, 2
TRAIN_TOL = {  # kernel vs plain attention, one step, same weights and randomness
    torch.bfloat16: {"loss_rel": 1e-2, "grad_cos": 0.99},
    torch.float32: {"loss_rel": 1e-4, "grad_rel_max": 1e-3},
}
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


def attention_bound_ms(shape, dtype, backward: bool = False) -> tuple:
    """Least time for the work, the larger of operations at the type's dense
    peak and bytes at the memory rate. Forward: 4*B*H*T^2*D operations; q, k,
    v read once, o and lse written once. Backward: 10*B*H*T^2*D operations
    (5 products); q, k, v, o, dO and lse read once, dq, dk, dv written once."""
    B, T, H, D = shape
    elt = torch.tensor([], dtype=dtype).element_size()
    ops = (10 if backward else 4) * B * H * T * T * D
    nbytes = (8 if backward else 4) * B * T * H * D * elt + B * H * T * 4
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


def phase_bwd_kernels(fused_attention, fused_attention_bwd, fused_attention_bwd_reference) -> dict:
    """The backward kernel against its plain version; timed at the main path's shape."""
    results = {}
    for shape, dtype, atol, rtol in BWD_CASES:
        B, T, H, D = shape
        g = torch.Generator(device="cuda").manual_seed(2)
        qkv = torch.randn(B, T, 3, H, D, device="cuda", generator=g).to(dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # strided, as the model passes them
        o, lse = fused_attention(q, k, v)
        do = torch.randn(B, T, H, D, device="cuda", generator=g).to(dtype)
        got = fused_attention_bwd(q, k, v, o, do, lse)
        torch.cuda.synchronize()
        want = fused_attention_bwd_reference(q, k, v, o, do, lse)
        errs, ok = [], True
        for a, b in zip(got, want):
            err = (a.float() - b.float()).abs()
            errs.append(err.max().item())
            ok &= bool((err <= atol + rtol * b.float().abs()).all())
        print(f"kernel flash_attention_bwd {list(shape)} {str(dtype)[6:]}: max_abs_err "
              f"dq={errs[0]:.3e} dk={errs[1]:.3e} dv={errs[2]:.3e} (tolerance atol {atol} "
              f"rtol {rtol}) {'ok' if ok else 'FAILED'}", flush=True)
        check(ok, f"flash_attention_bwd disagrees with its plain version at {shape} {dtype}")
        row = {"max_abs_err": max(errs)}
        if shape == MAE_DECODER and dtype == torch.bfloat16:
            row["ms"] = cuda_ms(lambda: fused_attention_bwd(q, k, v, o, do, lse))
            row["plain_ms"] = cuda_ms(
                lambda: fused_attention_bwd_reference(q, k, v, o, do, lse), iters=10)
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
            dot = do.transpose(1, 2)
            sdpa = torch.nn.functional.scaled_dot_product_attention

            def fwd_bwd():
                sdpa(qt, kt, vt).backward(dot)

            fwd_ms = cuda_ms(lambda: sdpa(qt, kt, vt))
            row["library_ms"] = cuda_ms(fwd_bwd) - fwd_ms
            row["bound_ms"], row["bound_by"] = attention_bound_ms(shape, dtype, backward=True)
            print(f"timing flash_attention_bwd {list(shape)} {str(dtype)[6:]}: kernel "
                  f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, backward of "
                  f"scaled_dot_product_attention {row['library_ms']:.4f} ms (measured as its "
                  f"forward+backward minus its forward, {fwd_ms:.4f} ms), bound "
                  f"{row['bound_ms']:.4f} ms "
                  f"by {row['bound_by']} ({100 * row['bound_ms'] / row['ms']:.1f}% of bound)",
                  flush=True)
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


def head_phantoms(seed: int, n: int, size: int = 96) -> np.ndarray:
    """n head-like hu16 wire volumes [n, 1, size^3] int16: air, a skull
    shell, brain tissue with noise, each ellipsoid placed and sized at random."""
    from headct_foundation_tpu_torch.data.transforms import hu16_encode

    rng = np.random.RandomState(seed)
    g = (np.arange(size, dtype=np.float32) - size / 2) / (size / 2)
    x, y, z = g[:, None, None], g[None, :, None], g[None, None, :]
    out = np.empty((n, 1, size, size, size), np.int16)
    for i in range(n):
        c = rng.uniform(-0.1, 0.1, 3).astype(np.float32)
        r = rng.uniform(0.65, 0.9, 3).astype(np.float32)
        d = ((x - c[0]) / r[0]) ** 2 + ((y - c[1]) / r[1]) ** 2 + ((z - c[2]) / r[2]) ** 2
        hu = np.where(d < 1.0, 1000.0, -1000.0).astype(np.float32)
        brain = d < 0.8
        hu[brain] = 35.0 + 8.0 * rng.randn(int(brain.sum())).astype(np.float32)
        out[i, 0] = hu16_encode(hu)
    return out


def loss_and_grads(model, wire, cfg, draws, backend: str, names) -> tuple:
    """One step's loss and the gradients of ``names`` under ``backend``."""
    from headct_foundation_tpu_torch.data.augment import apply_mae_augment
    from headct_foundation_tpu_torch.data.device_preprocess import wire_to_compute
    from headct_foundation_tpu_torch.ops import attention as port_attn

    prev = port_attn.set_attention_backend(backend)
    try:
        model.zero_grad(set_to_none=True)
        batch = apply_mae_augment(wire_to_compute(wire, cfg, cfg.MAE.IN_CHANS), draws["augment"])
        loss, _, _ = model(batch, noise=draws["noise"])
        loss.backward()
        params = dict(model.named_parameters())
        grads = {n: params[n].grad.detach().clone() for n in names}
        model.zero_grad(set_to_none=True)
        return loss.item(), grads
    finally:
        port_attn.set_attention_backend(prev)


def compare_backends(model, wire, cfg, draws, dtype) -> dict:
    """Kernel against plain attention on the same step: loss and every
    decoder gradient (the decoder is where the kernels run)."""
    names = [n for n, p in model.named_parameters()
             if p.requires_grad and (n.startswith("decoder") or n == "mask_token")]
    loss_k, g_k = loss_and_grads(model, wire, cfg, draws, "kernel", names)
    loss_p, g_p = loss_and_grads(model, wire, cfg, draws, "plain", names)
    rel = abs(loss_k - loss_p) / abs(loss_p)
    cos = min(torch.nn.functional.cosine_similarity(
        g_k[n].flatten().double(), g_p[n].flatten().double(), dim=0).item() for n in names)
    grad_rel = max(((g_k[n] - g_p[n]).abs().max() / g_p[n].abs().max().clamp_min(1e-30)).item()
                   for n in names)
    tol = TRAIN_TOL[dtype]
    ok = rel <= tol["loss_rel"] and (cos >= tol["grad_cos"] if "grad_cos" in tol
                                     else grad_rel <= tol["grad_rel_max"])
    print(f"train: kernel vs plain attention, one step at {str(dtype)[6:]}: loss {loss_k:.6f} vs "
          f"{loss_p:.6f} (relative {rel:.3e}, tolerance {tol['loss_rel']}); over "
          f"{len(names)} decoder gradient tensors min cosine {cos:.6f}, max "
          f"|dg|/max|g| {grad_rel:.3e} (tolerance "
          f"{'cosine >= ' + str(tol['grad_cos']) if 'grad_cos' in tol else 'max |dg| <= ' + str(tol['grad_rel_max']) + ' max|g|'}) "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    check(ok, f"kernel and plain attention disagree on the training step at {dtype}")
    return {"loss_rel": rel, "grad_cos_min": cos, "grad_rel_max": grad_rel}


PROFILE_GROUPS = [  # (group, substrings of a kernel name), first match wins
    ("attention kernels B1/B2", ("flash_fwd", "dkv_", "dq_", "delta_kernel")),
    ("GEMMs", ("gemm", "nvjet", "xmma", "cutlass", "cublas", "matmul")),
    ("AdamW", ("adam", "multi_tensor")),
    ("softmax / norms / reductions", ("softmax", "norm", "reduce")),
]


def profile_steps(step, state, wire, step_ms: float, n: int = 2) -> None:
    """Device time by kernel group over n train steps (torch.profiler), and
    the device busy share: summed kernel time per step over the unprofiled
    median step time ``step_ms`` (the profiler slows the host)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            state, _ = step(state, wire, 0)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    groups, total, top = {}, 0.0, []
    for ev in prof.key_averages():
        # kernels only: an annotated range on the device timeline (such as
        # "Optimizer.step#AdamW.step") would count its kernels twice
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA \
                or getattr(ev, "is_user_annotation", False):
            continue
        us = float(getattr(ev, "self_device_time_total", 0.0))
        total += us
        name = ev.key.lower()
        group = next((g for g, keys in PROFILE_GROUPS if any(k in name for k in keys)),
                     "elementwise and other")
        groups[group] = groups.get(group, 0.0) + us
        top.append((us, ev.key[:70]))
    if total <= 0:
        print("profile: the profiler recorded no device time; busy share not measured",
              flush=True)
        return
    parts = ", ".join(f"{g} {us / n / 1e3:.2f} ms ({100 * us / total:.1f}%)"
                      for g, us in sorted(groups.items(), key=lambda kv: -kv[1]))
    per_step = total / n / 1e3
    print(f"profile (torch.profiler, {n} train steps): device time per step {per_step:.2f} ms "
          f"(host time per profiled step {wall_us / n / 1e3:.2f} ms); busy share against the "
          f"unprofiled median step {100 * per_step / step_ms:.1f}%; by kernel group: {parts}",
          flush=True)
    print("profile: top kernels per step: " + "; ".join(
        f"{us / n / 1e3:.2f} ms {name}" for us, name in sorted(top, reverse=True)[:8]),
        flush=True)


def phase_train(bwd_ms: float, fwd_ms: float) -> dict:
    """Drive the MAE pretraining step at full width; returns each kernel's
    launches in the train and eval runs."""
    from headct_foundation_tpu_torch.config import default_config
    from headct_foundation_tpu_torch.data.augment import draw_mae_augment
    from headct_foundation_tpu_torch.data.device_preprocess import wire_to_compute
    from headct_foundation_tpu_torch.engines import mae_engine
    from headct_foundation_tpu_torch.ops.flash_attention import (
        fused_attention,
        fused_attention_bwd,
    )

    cfg = default_config()
    cfg.merge_from_file(str(ROOT / MAE_CONFIG))
    cfg.DATA.WIRE_FORMAT = "hu16"
    total = TRAIN_BATCHES + 5  # the epoch, then the timed steps
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    state, _ = mae_engine.create_train_state(cfg, total, WARMUP_STEPS, seed=0, device=dev)
    n_params = sum(p.numel() for p in state.model.parameters() if p.requires_grad)
    wires = [head_phantoms(100 + i, TRAIN_BATCH, cfg.MAE.INPUT_SIZE)
             for i in range(TRAIN_BATCHES + VAL_BATCHES)]
    torch.cuda.synchronize()
    dec = cfg.MAE
    print(f"train set-up: MAE from {MAE_CONFIG} (encoder {dec.ENCODER_DEPTH}x"
          f"{dec.ENCODER_EMBED_DIM}/{dec.ENCODER_NUM_HEADS} heads, decoder {dec.DECODER_DEPTH}x"
          f"{dec.DECODER_EMBED_DIM}/{dec.DECODER_NUM_HEADS} heads, {dec.INPUT_SIZE}^3 patch "
          f"{dec.PATCH_SIZE}, {dec.IN_CHANS} channels), {n_params} trainable parameters, "
          f"seed 0, bf16 compute; {len(wires)} synthetic hu16 batches of "
          f"{list(wires[0].shape)} int16 in {time.perf_counter() - t0:.2f} s", flush=True)

    # Kernel against plain attention on one step, same weights and randomness.
    g = mae_engine.step_generator(dev, 7, 0, 0)
    n_tok = int(np.prod(state.model.grid_size))
    draws = {"noise": torch.rand((TRAIN_BATCH, n_tok), generator=g, device=dev),
             "augment": draw_mae_augment(TRAIN_BATCH, g, dev)}
    wire0 = torch.from_numpy(wires[0]).to(dev)
    compare = {torch.bfloat16: compare_backends(state.model, wire0, cfg, draws, torch.bfloat16)}
    m32 = mae_engine.build_mae_model(cfg, dtype=torch.float32).to(dev)
    m32.load_state_dict(state.model.state_dict())
    for n, p in m32.named_parameters():
        p.requires_grad_(dict(state.model.named_parameters())[n].requires_grad)
    compare[torch.float32] = compare_backends(m32, wire0, cfg, draws, torch.float32)
    del m32
    torch.cuda.empty_cache()

    # The main path's run: every kernel count is 0 just before it.
    log = logging.getLogger("chip_smoke.train")
    before = {n: p.detach().clone() for n, p in state.model.named_parameters() if p.requires_grad}
    step = mae_engine.make_train_step(augment=True, config=cfg)
    torch.cuda.reset_peak_memory_stats()
    fused_attention.launches = fused_attention_bwd.launches = 0
    t0 = time.perf_counter()
    state, stats = mae_engine.train_one_epoch(cfg, state, step, wires[:TRAIN_BATCHES], 0, 0, 1,
                                              logger=log)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    train_launches = {"flash_attention_fwd": fused_attention.launches,
                      "flash_attention_bwd": fused_attention_bwd.launches}
    peak = torch.cuda.max_memory_allocated()
    fused_attention.launches = fused_attention_bwd.launches = 0
    val = mae_engine.val_one_epoch(cfg, state, mae_engine.make_eval_step(cfg),
                                   wires[TRAIN_BATCHES:], 0, 0, 1, logger=log)
    val_launches = {"flash_attention_fwd": fused_attention.launches,
                    "flash_attention_bwd": fused_attention_bwd.launches}

    depth = cfg.MAE.DECODER_DEPTH
    check(state.step == TRAIN_BATCHES and math.isfinite(stats["loss"])
          and math.isfinite(val["loss"]), f"train/val losses not finite: {stats} {val}")
    check(train_launches == {"flash_attention_fwd": depth * TRAIN_BATCHES,
                             "flash_attention_bwd": depth * TRAIN_BATCHES},
          f"training launches {train_launches}; expected {depth} of each per step")
    check(val_launches == {"flash_attention_fwd": depth * VAL_BATCHES, "flash_attention_bwd": 0},
          f"eval launches {val_launches}; expected {depth} forward per batch")
    params = dict(state.model.named_parameters())
    unmoved = [n for n, p in before.items() if torch.equal(p, params[n].detach())]
    check(not unmoved, f"parameters that did not move in {TRAIN_BATCHES} steps: {unmoved[:5]}")
    print(f"train: train_one_epoch over {TRAIN_BATCHES} batches of {TRAIN_BATCH} in "
          f"{epoch_s:.2f} s, mean loss {stats['loss']:.6f}, mean lr {stats['lr']:.3e}; "
          f"val_one_epoch over {VAL_BATCHES} batch: loss {val['loss']:.6f}; all finite; every "
          f"trainable tensor moved; launches train {train_launches} = {depth} + {depth} per "
          f"step, eval {val_launches} = {depth} per batch; peak memory "
          f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated)", flush=True)

    # Step time: host clock around synchronised steps (warm).
    times = []
    for i in range(5):
        wire = torch.from_numpy(wires[i % TRAIN_BATCHES]).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, wire, 0)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(times)

    # Breakdown (CUDA events): input, forward+backward, optimizer.
    model = state.model
    wire = torch.from_numpy(wires[0]).to(dev)
    from headct_foundation_tpu_torch.data.augment import apply_mae_augment
    prep_ms = cuda_ms(lambda: apply_mae_augment(
        wire_to_compute(wire, cfg, cfg.MAE.IN_CHANS), draws["augment"]), iters=5, warmup=1)
    batch = apply_mae_augment(wire_to_compute(wire, cfg, cfg.MAE.IN_CHANS), draws["augment"])

    def fwd_bwd():
        model(batch, noise=draws["noise"])[0].backward()

    fb_ms = cuda_ms(fwd_bwd, iters=5, warmup=1)
    opt_ms = cuda_ms(state.optimizer.step, iters=5, warmup=1)
    state.optimizer.zero_grad(set_to_none=True)
    print(f"train: median step {step_ms:.2f} ms over {len(times)} synchronised steps "
          f"({', '.join(f'{t:.1f}' for t in times)}), {TRAIN_BATCH / step_ms * 1e3:.2f} volumes/s; "
          f"breakdown: window+augment {prep_ms:.2f} ms, forward+backward {fb_ms:.2f} ms "
          f"(of which flash_attention_fwd {depth} x {fwd_ms:.4f} = {depth * fwd_ms:.2f} ms and "
          f"flash_attention_bwd {depth} x {bwd_ms:.4f} = {depth * bwd_ms:.2f} ms, from the "
          f"kernel timings), AdamW step {opt_ms:.2f} ms", flush=True)
    profile_steps(step, state, wire, step_ms)
    return {"train": train_launches, "eval": val_launches, "compare": compare}


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
        fused_attention_bwd,
        fused_attention_bwd_reference,
        fused_attention_reference,
    )

    logging.basicConfig(level=logging.INFO, format="%(message)s", stream=sys.stdout)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {sorted(_build.SOURCES)} with nvcc for sm_90a in "
          f"{time.perf_counter() - t0:.2f} s (set-up)", flush=True)
    for name, log in sorted(_build.build_logs.items()):  # ptxas -v, per instantiation
        used = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"build: {name} ptxas registers {used} spill-store bytes {spills}", flush=True)

    kernel_rows = phase_kernels(fused_attention, fused_attention_reference)
    bwd_rows = phase_bwd_kernels(fused_attention, fused_attention_bwd,
                                 fused_attention_bwd_reference)
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        serve_launches = phase_slice(Path(tmp))["flash_attention_fwd"]
    fwd_mae = kernel_rows[(MAE_DECODER, torch.bfloat16)]
    bwd_mae = bwd_rows[(MAE_DECODER, torch.bfloat16)]
    train = phase_train(bwd_mae["ms"], fwd_mae["ms"])

    fwd_launches = {"serving": serve_launches,
                    "training": train["train"]["flash_attention_fwd"],
                    "eval": train["eval"]["flash_attention_fwd"]}
    bwd_launches = {"training": train["train"]["flash_attention_bwd"]}
    check(all(n > 0 for n in fwd_launches.values()),
          f"flash_attention_fwd was not launched on every main path: {fwd_launches}")
    check(bwd_launches["training"] > 0, "flash_attention_bwd was not launched on the main path")

    def row(name, replaces, launches, by_path, r, shape, dtype):
        return {"name": name, "route": "cuda",
                "source": f"headct_foundation_tpu_torch/csrc/{name}.cu",
                "replaces": replaces, "launches": launches, "launches_by_path": by_path,
                "shape": list(shape), "dtype": str(dtype)[6:],
                **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")}}

    serving = kernel_rows[(SERVING, torch.float32)]
    print(json.dumps({"kernels": [
        row("flash_attention_fwd", "headct_foundation_tpu/ops/flash_attention.py:60",
            sum(fwd_launches.values()), fwd_launches, serving, SERVING, torch.float32),
        row("flash_attention_bwd", "headct_foundation_tpu/ops/flash_attention.py:86",
            bwd_launches["training"], bwd_launches, bwd_mae, MAE_DECODER, torch.bfloat16),
    ]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
