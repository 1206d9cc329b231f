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
             Every output is held elementwise; a bfloat16 one also normwise,
             ||kernel - plain|| / ||plain|| <= BF16_REL_L2. The forward (B1;
             bf16 on the wgmma kernel of csrc/flash_fwd_sm90.cuh) is held at
             the serving and MAE decoder shapes and at the edges of its
             64-key tiles and 128-row blocks, head dims 12 to 128 and a
             misaligned view; two runs must be bit-identical. The blocked
             kernels B3 (forward), B4 (dK, dV) and B5 (dQ) are held at the
             192^3 MAE's shapes, in float32, with rectangular q/k and a kv_len
             that masks whole key tiles, at head dims 12 to 128, at the
             edges of their 64-row tiles and on misaligned views; their
             masked dK, dV must be exactly 0 and two runs of B3, B4 and B5
             bit-identical. The backward B2 (bf16 on the wgmma passes of
             csrc/flash_bwd_sm90.cuh, B4's and B5's kernels) is held at the
             MAE decoder's shape, at the edges of its 64-row tiles, head dims
             12 to 128 and a misaligned view; two runs bit-identical.
             ptxas's report (registers, spills, shared memory) of every
             wgmma instantiation (the forward, the dK/dV and dQ passes) is
             printed after the build, a spill failing the run. B1 bf16, B2,
             B3-B5 and B8 are timed on an idle stream and behind a device
             sleep, beside their bound and their exponentials' floor.
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
6. stretch - the long-context MAE step of configs/mae/mae_HeadCT_192.yaml at
             full width (192^3, patch 12: encoder T=1025 at 12 heads x 64,
             decoder T=4097 at 16 heads x 48) on batches of 2 synthetic hu16
             phantoms: one step at batch 1 with the kernels against the plain
             attention (bf16 and float32, every trainable gradient), then 6
             train steps and 1 eval batch with exactly 20 B3 + 20 B4 + 20 B5
             launches per train step, 20 B3 per eval batch and no B1 or B2;
             then the same timings as the train phase.
7. lion    - the 96^3 MAE of the train phase trained by the fused Lion update
             (TRAIN.OPTIMIZER Lion, LION_FUSED True, GRAD_CLIP 1.0): kernel B6
             against its plain version first (bit for bit, at the model's
             shapes and at ragged ones), then 6 train steps and 1 eval batch
             with exactly one B6 launch per trainable tensor per step and 8
             B1 + 8 B2 per step (the attention comparison is the train
             phase's); on the run's state, every tensor's B6 output bit for
             bit against its plain version and the fused optimizer step bit
             for bit against those outputs, then the unfused step against
             it; B6 timed over every trainable tensor; the same timings as
             the train phase.
8. tm      - the token-major attention tool: kernels B7 and B8 against their
             plain versions at the tool's four shapes (bf16) and at float32
             and ragged ones, and against B1 and B2 on the same inputs (bit
             for bit: the same tile code), then ``tools.bench_tm_attention``
             at its four shapes.
9. report  - a JSON line of the kernels, the card line, then the result line.

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

from headct_foundation_tpu_torch.tools.bench_tm_attention import SHAPES as TM_BENCH_SHAPES
from headct_foundation_tpu_torch.tools.bench_tm_attention import cuda_ms

ROOT = Path(__file__).resolve().parent

PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # H100 SXM, dense
PEAK_BYTES = 3.35e12
SERVING = (8, 513, 12, 64)
MAE_DECODER = (32, 513, 16, 48)
KERNEL_CASES = [  # (shape [B, T, H, D], dtype, atol, rtol, storage offset) for O; LSE at
    # 1e-4 / 1e-4; reruns bit-identical. q, k, v are strided views of one [B, T, 3, H, D].
    # The bf16 cases from the block edges on hold the wgmma forward's 64-key tiles and
    # 128-row blocks (T one below, at and one above each), head dims 12 (the 8-byte copy
    # route, several key tiles) and 128, and a view whose start (4 elements in) breaks the
    # 16-byte alignment of every operand.
    (SERVING, torch.float32, 2e-5, 1e-4, 0),               # serving path, every ViT-B block
    (MAE_DECODER, torch.bfloat16, 2e-2, 2e-2, 0),          # MAE decoder, every block
    ((2, 129, 3, 32), torch.float32, 2e-5, 1e-4, 0),       # ragged tiles
    ((2, 9, 3, 12), torch.float32, 2e-5, 1e-4, 0),
    ((2, 129, 3, 32), torch.bfloat16, 2e-2, 2e-2, 0),      # the tensor-core path's other
    ((2, 9, 3, 12), torch.bfloat16, 2e-2, 2e-2, 0),        # head-dim paddings (32, 16,
    ((2, 200, 2, 64), torch.bfloat16, 2e-2, 2e-2, 0),      # 64, 128)
    ((2, 70, 2, 128), torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 63, 2, 48), torch.bfloat16, 2e-2, 2e-2, 0),       # block edges
    ((2, 64, 2, 48), torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 65, 2, 48), torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 127, 2, 64), torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 128, 2, 64), torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 200, 2, 12), torch.bfloat16, 2e-2, 2e-2, 0),      # head dims 12 and 128
    ((2, 130, 2, 128), torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 129, 3, 64), torch.bfloat16, 2e-2, 2e-2, 4),      # misaligned view
]
BWD_CASES = [  # (shape, dtype, atol, rtol, storage offset) for dq, dk, dv against the plain
    # backward; reruns bit-identical. q, k, v are strided views of one [B, T, 3, H, D]. The
    # bf16 cases from the block edges on hold the wgmma passes (csrc/flash_bwd_sm90.cuh) at
    # the whole-sequence shapes: T one below, at and one above their 64-row tiles and the
    # decoder's T = 513 (one real row in the last tile), head dims 16 to 128, the 8-byte
    # copy route (D = 12 over several tiles) and a view whose start (4 elements in) breaks
    # the 16-byte alignment of every operand.
    (MAE_DECODER, torch.bfloat16, 2e-2, 2e-2, 0),          # MAE decoder (main path)
    (MAE_DECODER, torch.float32, 1e-4, 1e-3, 0),
    ((2, 129, 3, 32), torch.float32, 1e-4, 1e-3, 0),       # ragged tiles
    ((2, 9, 3, 12), torch.float32, 1e-4, 1e-3, 0),
    ((2, 129, 3, 32), torch.bfloat16, 2e-2, 2e-2, 0),      # the head-dim paddings 32, 16,
    ((2, 9, 3, 12), torch.bfloat16, 2e-2, 2e-2, 0),        # 64 and 128
    ((2, 200, 2, 64), torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 70, 2, 128), torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 63, 2, 48), torch.bfloat16, 2e-2, 2e-2, 0),       # block edges
    ((2, 64, 2, 48), torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 65, 2, 48), torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 127, 2, 48), torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 128, 2, 48), torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 129, 2, 48), torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 513, 2, 48), torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 200, 2, 12), torch.bfloat16, 2e-2, 2e-2, 0),      # head dims 12 (8-byte copies)
    ((2, 129, 2, 16), torch.bfloat16, 2e-2, 2e-2, 0),      # to 128
    ((2, 200, 2, 32), torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 130, 2, 64), torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 130, 2, 128), torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 129, 3, 64), torch.bfloat16, 2e-2, 2e-2, 4),      # misaligned view
]
STRETCH_DECODER = (2, 4097, 16, 48)   # 192^3 MAE: 4096 patches + CLS, 16 heads x 48
STRETCH_ENCODER = (2, 1025, 12, 64)   # 1024 kept after 75% masking + CLS, 12 heads x 64
BLOCKED_CASES = [  # (q [B, Tq, H, D], Tk, kv_len, dtype, atol, rtol, storage offset) for O;
    # LSE at 1e-4 / 1e-4; dq, dk, dv at BLOCKED_BWD_TOL. kv_len 70 of 700 masks ten whole
    # 64-key tiles. The bf16 cases from the block edges on hold B4/B5's 64-row blocks: Tq
    # and kv_len one below, at and one above a multiple of 64 and 128, head dims 16 to 128,
    # and the 8-byte copy route (D = 12; an offset of 4 elements breaks the 16-byte
    # alignment of every operand). Square q, k, v are strided views of one [B, T, 3, H, D].
    (STRETCH_DECODER, 4097, None, torch.bfloat16, 2e-2, 2e-2, 0),  # every stretch decoder block
    (STRETCH_ENCODER, 1025, None, torch.bfloat16, 2e-2, 2e-2, 0),  # every stretch encoder block
    (STRETCH_ENCODER, 1025, None, torch.float32, 2e-5, 1e-4, 0),
    ((2, 300, 3, 32), 700, 650, torch.float32, 2e-5, 1e-4, 0),     # rectangular, kv_len
    ((2, 300, 3, 32), 700, 70, torch.float32, 2e-5, 1e-4, 0),
    ((2, 300, 3, 32), 700, 650, torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 300, 3, 32), 700, 70, torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 1100, 2, 12), 1100, None, torch.bfloat16, 2e-2, 2e-2, 0),  # head dims 12 and 128
    ((2, 200, 2, 128), 1500, 1300, torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 200, 2, 128), 1500, 1300, torch.float32, 2e-5, 1e-4, 0),
    ((2, 127, 2, 64), 257, 128, torch.bfloat16, 2e-2, 2e-2, 0),    # block edges
    ((2, 128, 2, 64), 257, 129, torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 129, 2, 64), 257, 127, torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 129, 2, 16), 129, None, torch.bfloat16, 2e-2, 2e-2, 0),   # head dims 16 to 128
    ((2, 200, 2, 32), 200, None, torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 300, 2, 48), 300, None, torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 130, 2, 128), 130, None, torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 129, 3, 64), 129, None, torch.bfloat16, 2e-2, 2e-2, 4),   # misaligned views
    ((2, 100, 2, 64), 300, 250, torch.bfloat16, 2e-2, 2e-2, 4),
    ((2, 63, 2, 48), 130, 65, torch.bfloat16, 2e-2, 2e-2, 0),      # the forward's 64-key
    ((2, 64, 2, 48), 130, 63, torch.bfloat16, 2e-2, 2e-2, 0),      # tile edges
    ((2, 65, 2, 48), 130, 64, torch.bfloat16, 2e-2, 2e-2, 0),
]
BLOCKED_BWD_TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (2e-2, 2e-2)}
# A bfloat16 output is also held normwise: ||a - b|| / ||b|| against its plain
# version. The elementwise 2e-2 + 2e-2|x| is as large as a typical |o|, |dq|,
# |dk|, |dv| at 4097 keys (about 0.026), so it would pass a kernel that skips
# one 64-key or 64-query tile (about 1/8 of the norm at 4097 tokens).
BF16_REL_L2 = 1e-2
# Kernel B6 (fused Lion) against its plain version, bit for bit: (shape, p and
# g dtype). [3072, 768] and [768] are the MAE's MLP weight and a bias, [2359299]
# an odd length (a scalar tail of 3), [700] and [1] ragged ones.
LION_CASES = [((3072, 768), torch.float32), ((768,), torch.float32), ((700,), torch.float32),
              ((1,), torch.float32), ((2359299,), torch.float32), ((3072, 768), torch.bfloat16)]
LION_SCALARS = (1.5e-4, 0.05, 0.9, 0.95)  # lr, wd, b1, b2 of the MAE recipe
# Unfused against fused Lion on one step: the unfused branch forms 1 - b1 in
# float64 (as the JAX package's does), one float32 step from the kernel's, so
# a sign within an ulp of 0 may flip: this share of parameter elements may
# differ (15 of the MAE's 150.3 M), and the momenta agree within LION_M_REL *
# max|m|. The fused step itself is held bit for bit.
LION_FLIP_SHARE, LION_M_REL = 1e-7, 1e-6
# Device-side sleep queued before timing B6 and the blocked kernels (cuda_ms
# ``ahead``), in clock cycles: about 1 ms and 15 ms at the H100's 1.98 GHz,
# above the host's time to launch one kernel call (tens of microseconds) and
# one B6 call per trainable tensor (~6 ms).
AHEAD_ONE, AHEAD_ALL = 2_000_000, 30_000_000
# Kernels B7, B8 (token-major): (shape, dtype, forward atol, rtol, backward atol,
# rtol). Every shape of the tm bench (its main path) in bf16, MAE_DECODER
# among them, then float32 and ragged ones.
TM_CASES = [(shape, torch.bfloat16, 2e-2, 2e-2, 2e-2, 2e-2) for _, shape in TM_BENCH_SHAPES] + [
    ((8, 513, 12, 64), torch.float32, 2e-5, 1e-4, 1e-4, 1e-3),
    ((2, 70, 4, 32), torch.float32, 2e-5, 1e-4, 1e-4, 1e-3),
    ((2, 129, 2, 128), torch.bfloat16, 2e-2, 2e-2, 2e-2, 2e-2)]
MAE_CONFIG = "configs/mae/mae_HeadCT.yaml"
STRETCH_CONFIG = "configs/mae/mae_HeadCT_192.yaml"
TRAIN_BATCH = 32          # the JAX bench's batch per chip (bench.py:54)
TRAIN_BATCHES, VAL_BATCHES, WARMUP_STEPS = 6, 1, 2
STRETCH_COMPARE_BATCH = 1  # autograd through the plain attention keeps ~3 [B,16,4097,4097]
                           # float32 tensors per decoder block
TRAIN_TOL = {  # kernel vs plain attention, one step, same weights and randomness
    torch.bfloat16: {"loss_rel": 1e-2, "grad_cos": 0.99},
    torch.float32: {"loss_rel": 1e-4, "grad_rel_max": 1e-3},
}
N_REQUESTS = 8
EMBED_ATOL = 1e-3  # kernel vs plain attention through 12 float32 blocks


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    """Normwise relative error ||a - b|| / ||b||, in float32."""
    b = b.float()
    return ((a.float() - b).norm() / b.norm().clamp_min(1e-30)).item()


def within(a: torch.Tensor, b: torch.Tensor, atol: float, rtol: float, dtype) -> tuple:
    """(elementwise ok, normwise ok, max |a - b|, ||a - b|| / ||b||) of a
    kernel's output a against its plain version b; float32 outputs are held
    elementwise only."""
    err = (a.float() - b.float()).abs()
    rel = rel_l2(a, b)
    return (bool((err <= atol + rtol * b.float().abs()).all()),
            dtype != torch.bfloat16 or rel <= BF16_REL_L2, err.max().item(), rel)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def attention_bound_ms(shape, dtype, backward: bool = False) -> tuple:
    """Least time for the work, the larger of operations at the type's dense
    peak and bytes at the memory rate. Forward: 4*B*H*T^2*D operations; q, k,
    v read once, o and lse written once. Backward: 10*B*H*T^2*D operations
    (5 products); q, k, v, o, dO and lse read once, dq, dk, dv written once."""
    B, T, H, D = shape
    elt = torch.tensor([], dtype=dtype).element_size()
    ops = (10 if backward else 4) * B * H * T * T * D
    nbytes = (8 if backward else 4) * B * T * H * D * elt + B * H * T * 4
    return bound_ms(ops, nbytes, dtype)


def bound_ms(ops: float, nbytes: float, dtype) -> tuple:
    t_ops, t_bytes = ops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def blocked_bound_ms(name: str, q_shape, tk: int, kv_len, dtype) -> tuple:
    """Least time of one blocked kernel on these inputs, counting the L =
    kv_len keys it reads. B3 (flash_attention_blocked_fwd): 4*B*H*Tq*L*D
    operations (S, P.V); q and L rows of k, v read, o and lse written. B4
    (flash_attention_blocked_dkv): 8*B*H*Tq*L*D (S, dP, dV, dK); q, dO, L rows
    of k, v, lse and delta read, dk, dv (Tk rows) written. B5
    (flash_attention_blocked_dq): 6*B*H*Tq*L*D (S, dP, dQ); the same reads, dq
    written."""
    B, Tq, H, D = q_shape
    L = tk if kv_len is None else kv_len
    row = B * H * D * torch.tensor([], dtype=dtype).element_size()  # one token, all heads
    rows_f32 = B * H * Tq * 4                                       # lse or delta
    mult, nbytes = {
        "flash_attention_blocked_fwd": (4, (2 * Tq + 2 * L) * row + rows_f32),
        "flash_attention_blocked_dkv": (8, (2 * Tq + 2 * L + 2 * tk) * row + 2 * rows_f32),
        "flash_attention_blocked_dq": (6, (3 * Tq + 2 * L) * row + 2 * rows_f32),
    }[name]
    return bound_ms(mult * B * H * Tq * L * D, nbytes, dtype)


def exp_floor_ms(q_shape, n_keys: int) -> float:
    """Least time of the exponentials of one attention pass (the forward, B4
    or B5): one per P element, B*H*Tq*n_keys, at 16 a clock on each SM's
    special function units (the card's SM count and its maximum SM clock)."""
    B, Tq, H, _ = q_shape
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return B * H * Tq * n_keys / (sms * 16 * mhz * 1e6) * 1e3


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


def norm_note(dtype) -> str:
    return f" and rel_l2 {BF16_REL_L2}" if dtype == torch.bfloat16 else ""


def phase_kernels(fused_attention, fused_attention_reference) -> dict:
    results = {}
    for shape, dtype, atol, rtol, offset in KERNEL_CASES:
        B, T, H, D = shape
        g = torch.Generator(device="cuda").manual_seed(1)
        qkv = randn_at((B, T, 3, H, D), offset, g, dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # strided, as the model passes them
        o, lse = fused_attention(q, k, v)
        again = fused_attention(q, k, v)
        torch.cuda.synchronize()
        o_ref, lse_ref = fused_attention_reference(q, k, v)
        elem_ok, norm_ok, err_o, rel_o = within(o, o_ref, atol, rtol, dtype)
        err_lse = (lse - lse_ref).abs()
        same = torch.equal(o, again[0]) and torch.equal(lse, again[1])
        ok = (elem_ok and norm_ok and same
              and bool((err_lse <= 1e-4 + 1e-4 * lse_ref.abs()).all()))
        at = f" offset {offset}" if offset else ""
        print(f"kernel flash_attention_fwd {list(shape)} {str(dtype)[6:]}{at}: max_abs_err "
              f"o={err_o:.3e} lse={err_lse.max().item():.3e}, rel_l2 o={rel_o:.3e} "
              f"(tolerance o atol {atol} rtol {rtol}{norm_note(dtype)}, lse atol 1e-4 rtol "
              f"1e-4); reruns bit-identical {same} {'ok' if ok else 'FAILED'}", flush=True)
        check(ok, f"flash_attention_fwd disagrees with its plain version at {shape} {dtype} "
                  f"offset {offset}")
        row = {"max_abs_err": err_o}
        if T == 513:  # the main path's shapes: time kernel, plain version and library call
            time_fwd(fused_attention, fused_attention_reference, row, q, k, v, shape, dtype)
        results[(shape, dtype)] = row
    return results


def time_fwd(fused_attention, fused_attention_reference, row, q, k, v, shape, dtype) -> None:
    """Kernel, plain version, bound and library call (scaled_dot_product_attention's
    forward) of B1 at a main-path shape, on an idle stream (``ms``,
    ``library_ms``); at bfloat16 also behind a device sleep (``ms_device``,
    ``library_ms_device``: the device's time alone) beside the exp floor."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    row["ms"] = cuda_ms(lambda: fused_attention(q, k, v))
    row["plain_ms"] = cuda_ms(lambda: fused_attention_reference(q, k, v))
    row["library_ms"] = cuda_ms(lambda: sdpa(qt, kt, vt))
    row["bound_ms"], row["bound_by"] = attention_bound_ms(shape, dtype)
    device = ""
    if dtype == torch.bfloat16:
        row["ms_device"] = cuda_ms(lambda: fused_attention(q, k, v), ahead=AHEAD_ONE)
        row["library_ms_device"] = cuda_ms(lambda: sdpa(qt, kt, vt), ahead=AHEAD_ONE)
        floor = exp_floor_ms(shape, shape[1])
        device = (f"; behind a device sleep kernel {row['ms_device']:.4f} ms, "
                  f"scaled_dot_product_attention {row['library_ms_device']:.4f} ms "
                  f"({row['ms_device'] / row['library_ms_device']:.2f}x); exp floor "
                  f"{floor:.4f} ms (one exponential per P element, B*H*T^2 = "
                  f"{shape[0] * shape[2] * shape[1] ** 2}, at 16 per SM per clock), "
                  f"{100 * floor / row['ms_device']:.1f}% of the kernel's device time")
    print(f"timing flash_attention_fwd {list(shape)} {str(dtype)[6:]}: "
          f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
          f"scaled_dot_product_attention {row['library_ms']:.4f} ms "
          f"({row['ms'] / row['library_ms']:.2f}x), on an idle stream; bound "
          f"{row['bound_ms']:.4f} ms by {row['bound_by']} "
          f"({100 * row['bound_ms'] / row['ms']:.1f}% of bound){device}", flush=True)


def phase_bwd_kernels(fused_attention, fused_attention_bwd, fused_attention_bwd_reference) -> dict:
    """B2 against its plain version at every BWD_CASES case, on the kernel
    forward's o and lse; two runs bit-identical. Timed at the main path's
    shape."""
    results = {}
    for shape, dtype, atol, rtol, offset in BWD_CASES:
        B, T, H, D = shape
        g = torch.Generator(device="cuda").manual_seed(2)
        qkv = randn_at((B, T, 3, H, D), offset, g, dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # strided, as the model passes them
        o, lse = fused_attention(q, k, v)
        do = randn_at((B, T, H, D), offset, g, dtype)
        got = fused_attention_bwd(q, k, v, o, do, lse)
        again = fused_attention_bwd(q, k, v, o, do, lse)
        torch.cuda.synchronize()
        want = fused_attention_bwd_reference(q, k, v, o, do, lse)
        errs, rels, ok = [], [], True
        for a, b in zip(got, want):
            elem_ok, norm_ok, err, rel = within(a, b, atol, rtol, dtype)
            errs.append(err)
            rels.append(rel)
            ok &= elem_ok and norm_ok
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        ok &= same
        at = f" offset {offset}" if offset else ""
        print(f"kernel flash_attention_bwd {list(shape)} {str(dtype)[6:]}{at}: max_abs_err "
              f"dq={errs[0]:.3e} dk={errs[1]:.3e} dv={errs[2]:.3e}, rel_l2 dq={rels[0]:.3e} "
              f"dk={rels[1]:.3e} dv={rels[2]:.3e} (tolerance atol {atol} rtol {rtol}"
              f"{norm_note(dtype)}); reruns bit-identical {same} {'ok' if ok else 'FAILED'}",
              flush=True)
        check(ok, f"flash_attention_bwd disagrees with its plain version at {shape} {dtype} "
                  f"offset {offset}")
        row = {"max_abs_err": max(errs)}
        if shape == MAE_DECODER and dtype == torch.bfloat16:
            time_bwd(fused_attention_bwd, fused_attention_bwd_reference, row, q, k, v, o, do,
                     lse, shape, dtype)
        results[(shape, dtype)] = row
    return results


def time_bwd(fused_attention_bwd, fused_attention_bwd_reference, row, q, k, v, o, do, lse,
             shape, dtype) -> None:
    """Kernel, plain version, bound and library call (scaled_dot_product_attention's
    backward, its forward+backward minus its forward) of B2 at the main path's
    shape, on an idle stream (``ms``, ``library_ms``) and behind a device sleep
    (``ms_device``, ``library_ms_device``: the device's time alone) beside the
    exp floor of its two passes."""
    row["ms"] = cuda_ms(lambda: fused_attention_bwd(q, k, v, o, do, lse))
    row["ms_device"] = cuda_ms(lambda: fused_attention_bwd(q, k, v, o, do, lse), ahead=AHEAD_ONE)
    row["plain_ms"] = cuda_ms(lambda: fused_attention_bwd_reference(q, k, v, o, do, lse),
                              iters=10)
    fwd_ms, fwd_dev, row["library_ms"], row["library_ms_device"] = sdpa_backward_ms(q, k, v, do)
    row["bound_ms"], row["bound_by"] = attention_bound_ms(shape, dtype, backward=True)
    floor = 2 * exp_floor_ms(shape, shape[1])
    print(f"timing flash_attention_bwd {list(shape)} {str(dtype)[6:]}: kernel "
          f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, backward of "
          f"scaled_dot_product_attention {row['library_ms']:.4f} ms "
          f"({row['ms'] / row['library_ms']:.2f}x; measured as its forward+backward minus its "
          f"forward, {fwd_ms:.4f} ms), on an idle stream; bound {row['bound_ms']:.4f} ms by "
          f"{row['bound_by']} ({100 * row['bound_ms'] / row['ms']:.1f}% of bound); behind a "
          f"device sleep kernel {row['ms_device']:.4f} ms, scaled_dot_product_attention "
          f"backward {row['library_ms_device']:.4f} ms "
          f"({row['ms_device'] / row['library_ms_device']:.2f}x; forward {fwd_dev:.4f} ms); exp "
          f"floor {floor:.4f} ms (one exponential per P element in each of the two passes, "
          f"2*B*H*T^2 = {2 * shape[0] * shape[2] * shape[1] ** 2}, at 16 per SM per clock), "
          f"{100 * floor / row['ms_device']:.1f}% of the kernel's device time", flush=True)


def sdpa_backward_ms(q, k, v, do) -> tuple:
    """(forward ms, forward device ms, backward ms, backward device ms) of
    scaled_dot_product_attention on these inputs: its backward is timed as
    its forward+backward minus its forward, on an idle stream and behind a
    device sleep. The port never calls it."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2)

    def fwd_bwd():
        sdpa(qt, kt, vt).backward(dot)

    fwd_ms = cuda_ms(lambda: sdpa(qt, kt, vt))
    fwd_dev = cuda_ms(lambda: sdpa(qt, kt, vt), ahead=AHEAD_ONE)
    return (fwd_ms, fwd_dev, cuda_ms(fwd_bwd) - fwd_ms,
            cuda_ms(fwd_bwd, ahead=AHEAD_ONE) - fwd_dev)


def randn_at(shape, offset: int, g, dtype) -> torch.Tensor:
    """A [shape] tensor on the card starting ``offset`` elements into its storage."""
    n = math.prod(shape)
    return torch.randn(n + offset, device="cuda", generator=g).to(dtype)[offset:].view(shape)


def blocked_inputs(shape, tk: int, dtype, seed: int, offset: int = 0) -> tuple:
    """q, k, v (strided views of one [B, T, 3, H, D] tensor when square, as
    the model passes them) and an incoming gradient, on the card, each
    starting ``offset`` elements into its storage."""
    B, T, H, D = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    if tk == T:
        qkv = randn_at((B, T, 3, H, D), offset, g, dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        q = randn_at((B, T, H, D), offset, g, dtype)
        k, v = (randn_at((B, tk, H, D), offset, g, dtype) for _ in range(2))
    return q, k, v, randn_at((B, T, H, D), offset, g, dtype)


def phase_blocked_kernels() -> dict:
    """B3, B4 and B5 against their plain versions at every BLOCKED_CASES case;
    timed at the two stretch shapes. Returns {(kernel, shape): row}."""
    from headct_foundation_tpu_torch.ops import flash_attention as fa

    results = {}
    for shape, tk, kv_len, dtype, atol, rtol, offset in BLOCKED_CASES:
        q, k, v, do = blocked_inputs(shape, tk, dtype, seed=3, offset=offset)
        o, lse = fa.blocked_fused_attention(q, k, v, kv_len=kv_len)
        delta = fa.attention_delta(o, do)
        dk, dv = fa.blocked_attention_dkv(q, k, v, do, lse, delta, kv_len=kv_len)
        dq = fa.blocked_attention_dq(q, k, v, do, lse, delta, kv_len=kv_len)
        again = (*fa.blocked_fused_attention(q, k, v, kv_len=kv_len),
                 *fa.blocked_attention_dkv(q, k, v, do, lse, delta, kv_len=kv_len),
                 fa.blocked_attention_dq(q, k, v, do, lse, delta, kv_len=kv_len))
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.blocked_attention_reference(q, k, v, kv_len=kv_len)
        err_lse = (lse - lse_ref).abs()
        # o against its plain version; the backward passes against theirs on
        # the kernel's o, lse
        want = (*fa.blocked_attention_dkv_reference(q, k, v, do, lse, delta, kv_len=kv_len),
                fa.blocked_attention_dq_reference(q, k, v, do, lse, delta, kv_len=kv_len))
        batol, brtol = BLOCKED_BWD_TOL[dtype]
        res = [within(o, o_ref, atol, rtol, dtype)] + [
            within(a, b, batol, brtol, dtype) for a, b in zip((dk, dv, dq), want)]
        elem_ok = all(r[0] for r in res) and bool((err_lse <= 1e-4 + 1e-4 * lse_ref.abs()).all())
        norm_ok = all(r[1] for r in res)
        errs, rels = [r[2] for r in res], [r[3] for r in res]
        same = all(torch.equal(a, b) for a, b in zip((o, lse, dk, dv, dq), again))
        masked_zero = kv_len is None or not (dk[:, kv_len:].any() or dv[:, kv_len:].any())
        ok = elem_ok and norm_ok and same and masked_zero
        at = f" offset {offset}" if offset else ""
        print(f"kernel blocked B3/B4/B5 q {list(shape)} k/v length {tk} kv_len {kv_len} "
              f"{str(dtype)[6:]}{at}: max_abs_err o={errs[0]:.3e} lse={err_lse.max().item():.3e} "
              f"dk={errs[1]:.3e} dv={errs[2]:.3e} dq={errs[3]:.3e}, rel_l2 o={rels[0]:.3e} "
              f"dk={rels[1]:.3e} dv={rels[2]:.3e} dq={rels[3]:.3e} (tolerance o atol {atol} "
              f"rtol {rtol}, lse 1e-4/1e-4, grads atol {batol} rtol {brtol}: "
              f"{'ok' if elem_ok else 'FAILED'}{norm_note(dtype)}: "
              f"{'ok' if norm_ok else 'FAILED'}); B3/B4/B5 reruns bit-identical {same}; masked "
              f"dk/dv exactly 0 {masked_zero} {'ok' if ok else 'FAILED'}", flush=True)
        check(ok, f"blocked kernels disagree with their plain versions at {shape} {tk} "
                  f"{kv_len} {dtype} offset {offset}")
        rows = {"flash_attention_blocked_fwd": {"max_abs_err": errs[0]},
                "flash_attention_blocked_dkv": {"max_abs_err": max(errs[1:3])},
                "flash_attention_blocked_dq": {"max_abs_err": errs[3]}}
        if shape in (STRETCH_DECODER, STRETCH_ENCODER) and dtype == torch.bfloat16:
            time_blocked(fa, rows, q, k, v, o, do, lse, delta, shape, dtype)
        for name, row in rows.items():
            results[(name, shape, dtype)] = row
        del q, k, v, o, do, lse, delta, dk, dv, dq, again, want, o_ref, lse_ref, res
        torch.cuda.empty_cache()
    return results


def time_blocked(fa, rows, q, k, v, o, do, lse, delta, shape, dtype) -> None:
    """Kernel, plain version and bound of B3, B4 and B5 at a main-path shape;
    the library call: scaled_dot_product_attention's forward for B3, and its
    backward against delta + B4 + B5 together. Kernels, library calls and
    the port's backward are timed on an idle stream (``ms``, ``library_ms``,
    ``backward_ms``, ``library_backward_ms``: events that bracket the host's
    launch work too) and behind a device sleep (the same keys with
    ``_device``: device time alone; at the encoder's shape a launch from the
    host takes about as long as the kernel)."""
    def both(fn):
        return cuda_ms(fn, iters=10), cuda_ms(fn, iters=10, ahead=AHEAD_ONE)

    calls = {
        "flash_attention_blocked_fwd": (lambda: fa.blocked_fused_attention(q, k, v),
                                        lambda: fa.blocked_attention_reference(q, k, v)),
        "flash_attention_blocked_dkv": (
            lambda: fa.blocked_attention_dkv(q, k, v, do, lse, delta),
            lambda: fa.blocked_attention_dkv_reference(q, k, v, do, lse, delta)),
        "flash_attention_blocked_dq": (
            lambda: fa.blocked_attention_dq(q, k, v, do, lse, delta),
            lambda: fa.blocked_attention_dq_reference(q, k, v, do, lse, delta)),
    }
    for name, (kernel, plain) in calls.items():
        rows[name]["ms"], rows[name]["ms_device"] = both(kernel)
        rows[name]["plain_ms"] = cuda_ms(plain, iters=3, warmup=1)
        rows[name]["bound_ms"], rows[name]["bound_by"] = blocked_bound_ms(
            name, shape, shape[1], None, dtype)
        rows[name]["library_ms"] = None
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2)
    fwd_ms, fwd_dev = both(lambda: sdpa(qt, kt, vt))
    rows["flash_attention_blocked_fwd"]["library_ms"] = fwd_ms
    rows["flash_attention_blocked_fwd"]["library_ms_device"] = fwd_dev
    sdpa_bwd_ms, sdpa_bwd_dev = (t - f for t, f in
                                 zip(both(lambda: sdpa(qt, kt, vt).backward(dot)),
                                     (fwd_ms, fwd_dev)))

    def port_bwd():
        d = fa.attention_delta(o, do)
        fa.blocked_attention_dkv(q, k, v, do, lse, d)
        fa.blocked_attention_dq(q, k, v, do, lse, d)

    bwd_ms, bwd_dev = both(port_bwd)
    for name in ("flash_attention_blocked_dkv", "flash_attention_blocked_dq"):
        rows[name].update(backward_ms=bwd_ms, backward_ms_device=bwd_dev,  # delta + B4 + B5
                          library_backward_ms=sdpa_bwd_ms,
                          library_backward_ms_device=sdpa_bwd_dev)
    floor = exp_floor_ms(shape, shape[1])
    for name, r in rows.items():
        print(f"timing {name} {list(shape)} {str(dtype)[6:]}: kernel {r['ms']:.4f} ms on an "
              f"idle stream ({r['ms_device']:.4f} ms behind a device sleep), plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
              f"({100 * r['bound_ms'] / r['ms']:.1f}% of bound; "
              f"{100 * r['bound_ms'] / r['ms_device']:.1f}% of the device time)", flush=True)
        print(f"timing {name} {list(shape)} {str(dtype)[6:]}: exp floor {floor:.4f} ms "
              f"(one exponential per P element, B*H*Tq*Tk = "
              f"{shape[0] * shape[2] * shape[1] ** 2}, at 16 per SM per clock), "
              f"{100 * floor / r['ms_device']:.1f}% of the kernel's device time", flush=True)
    print(f"timing blocked backward {list(shape)} {str(dtype)[6:]}: delta (torch) + B4 + B5 "
          f"{bwd_ms:.4f} ms ({bwd_ms / sdpa_bwd_ms:.2f}x) against the backward of "
          f"scaled_dot_product_attention {sdpa_bwd_ms:.4f} ms (its forward+backward minus its "
          f"forward, {fwd_ms:.4f} ms), on an idle stream; behind a device sleep {bwd_dev:.4f} "
          f"ms ({bwd_dev / sdpa_bwd_dev:.2f}x) against {sdpa_bwd_dev:.4f} ms ({fwd_dev:.4f} ms); "
          f"B3 {rows['flash_attention_blocked_fwd']['ms']:.4f} ms against its forward",
          flush=True)


def lion_bound_ms(n: int, dtype) -> tuple:
    """Least time of B6 over n elements: p, g, m read and delta, m_new written
    once (20 bytes per element with float32 p and g, 14 with bfloat16), and
    8 float32 operations per element."""
    elt = torch.tensor([], dtype=dtype).element_size()
    return bound_ms(8 * n, n * (3 * elt + 8), torch.float32)


def phase_lion_kernel() -> dict:
    """B6 against its plain version at every LION_CASES case, bit for bit,
    with m_new written to a new tensor and over m in place; timed at the
    MAE's [3072, 768] float32 weight."""
    from headct_foundation_tpu_torch.ops.lion_kernel import (
        lion_update_leaf,
        lion_update_leaf_reference,
    )

    row = {"max_abs_err": 0.0}
    for shape, dtype in LION_CASES:
        g = torch.Generator(device="cuda").manual_seed(5)
        p = torch.randn(shape, device="cuda", generator=g).to(dtype)
        grad = (1e-2 * torch.randn(shape, device="cuda", generator=g)).to(dtype)
        m = 1e-3 * torch.randn(shape, device="cuda", generator=g)
        delta, m_new = lion_update_leaf(p, grad, m, *LION_SCALARS)
        m_in_place = m.clone()
        delta_in_place, _ = lion_update_leaf(p, grad, m_in_place, *LION_SCALARS, m_out=m_in_place)
        torch.cuda.synchronize()
        want = lion_update_leaf_reference(p, grad, m, *LION_SCALARS)
        errs = [(a.float() - b.float()).abs().max().item() for a, b in zip((delta, m_new), want)]
        differ = (delta != want[0]).float().mean().item()
        same = (torch.equal(delta, want[0]) and torch.equal(m_new, want[1])
                and torch.equal(delta_in_place, delta) and torch.equal(m_in_place, m_new))
        print(f"kernel lion_update {list(shape)} p/g {str(dtype)[6:]}: max_abs_err "
              f"delta={errs[0]:.3e} m_new={errs[1]:.3e}, share of delta elements differing "
              f"{differ:.3e}; bit-identical to the plain version, in place over m too: {same} "
              f"{'ok' if same else 'FAILED'}", flush=True)
        check(same, f"lion_update disagrees with its plain version at {shape} {dtype}")
        row["max_abs_err"] = max(row["max_abs_err"], *errs)
        if shape == LION_CASES[0][0] and dtype == torch.float32:
            row["ms"] = cuda_ms(lambda: lion_update_leaf(p, grad, m, *LION_SCALARS),
                                ahead=AHEAD_ONE)
            row["plain_ms"] = cuda_ms(
                lambda: lion_update_leaf_reference(p, grad, m, *LION_SCALARS), ahead=AHEAD_ONE)
            # on an idle stream, with the host's launch work
            row["ms_idle_stream"] = cuda_ms(lambda: lion_update_leaf(p, grad, m, *LION_SCALARS))
            row["bound_ms"], row["bound_by"] = lion_bound_ms(p.numel(), dtype)
            row["library_ms"] = None  # no one PyTorch call computes a Lion update
            print(f"timing lion_update {list(shape)} float32: kernel {row['ms']:.4f} ms, plain "
                  f"{row['plain_ms']:.4f} ms (launches queued behind a device sleep), no "
                  f"library call; kernel {row['ms_idle_stream']:.4f} ms on an idle stream "
                  f"(host launch work included); bound {row['bound_ms']:.4f} ms by "
                  f"{row['bound_by']} ({100 * row['bound_ms'] / row['ms']:.1f}% of bound)",
                  flush=True)
    return row


def phase_tm_kernels() -> dict:
    """B7 and B8 against their plain versions (held as B1 and B2 are) at every
    TM_CASES case, the tm bench's four shapes among them, and against B1 and
    B2 on the same contiguous inputs, bit for bit (the same tile code over the
    same strides); two runs of B8 bit-identical. Timed at the MAE decoder's
    shape. Returns {kernel: row}."""
    from headct_foundation_tpu_torch.ops import flash_attention as fa
    from headct_foundation_tpu_torch.tools import experimental_tm_attention as tm

    rows = {"tm_attention_fwd": {"max_abs_err": 0.0}, "tm_attention_bwd": {"max_abs_err": 0.0}}
    for shape, dtype, fatol, frtol, batol, brtol in TM_CASES:
        g = torch.Generator(device="cuda").manual_seed(6)
        q, k, v, do = (torch.randn(shape, device="cuda", generator=g).to(dtype) for _ in range(4))
        o, lse = tm.tm_attention_fwd(q, k, v)
        grads = tm.tm_attention_bwd(q, k, v, o, do, lse)
        again = tm.tm_attention_bwd(q, k, v, o, do, lse)
        o_b1, lse_b1 = fa.fused_attention(q, k, v)
        grads_b2 = fa.fused_attention_bwd(q, k, v, o_b1, do, lse_b1)
        torch.cuda.synchronize()
        o_ref, lse_ref = tm.tm_attention_fwd_reference(q, k, v)
        want = tm.tm_attention_bwd_reference(q, k, v, o, do, lse)
        res = [within(o, o_ref, fatol, frtol, dtype)] + [
            within(a, b, batol, brtol, dtype) for a, b in zip(grads, want)]
        err_lse = (lse - lse_ref).abs()
        elem_ok = all(r[0] for r in res) and bool((err_lse <= 1e-4 + 1e-4 * lse_ref.abs()).all())
        norm_ok = all(r[1] for r in res)
        rerun = all(torch.equal(a, b) for a, b in zip(grads, again))
        as_b1_b2 = (torch.equal(o, o_b1) and torch.equal(lse.flatten(), lse_b1.flatten())
                    and all(torch.equal(a, b) for a, b in zip(grads, grads_b2)))
        ok = elem_ok and norm_ok and rerun and as_b1_b2
        errs, rels = [r[2] for r in res], [r[3] for r in res]
        print(f"kernel tm_attention B7/B8 {list(shape)} {str(dtype)[6:]}: max_abs_err "
              f"o={errs[0]:.3e} lse={err_lse.max().item():.3e} dq={errs[1]:.3e} "
              f"dk={errs[2]:.3e} dv={errs[3]:.3e}, rel_l2 o={rels[0]:.3e} dq={rels[1]:.3e} "
              f"dk={rels[2]:.3e} dv={rels[3]:.3e} (tolerance o atol {fatol} rtol {frtol}, lse "
              f"1e-4/1e-4, grads atol {batol} rtol {brtol}: {'ok' if elem_ok else 'FAILED'}"
              f"{norm_note(dtype)}: {'ok' if norm_ok else 'FAILED'}); B8 reruns bit-identical "
              f"{rerun}; equal to B1/B2 bit for bit {as_b1_b2} {'ok' if ok else 'FAILED'}",
              flush=True)
        check(ok, f"tm_attention kernels disagree at {shape} {dtype}")
        rows["tm_attention_fwd"]["max_abs_err"] = max(rows["tm_attention_fwd"]["max_abs_err"],
                                                      errs[0])
        rows["tm_attention_bwd"]["max_abs_err"] = max(rows["tm_attention_bwd"]["max_abs_err"],
                                                      *errs[1:])
        if shape == MAE_DECODER and dtype == torch.bfloat16:
            time_tm(tm, rows, q, k, v, o, do, lse, shape, dtype)
        del q, k, v, do, o, lse, grads, again, o_b1, lse_b1, grads_b2, want, o_ref, lse_ref
        torch.cuda.empty_cache()
    return rows


def time_tm(tm, rows, q, k, v, o, do, lse, shape, dtype) -> None:
    """Kernel, plain version, bound and library call of B7 and B8: the
    library call is scaled_dot_product_attention's forward for B7 and its
    backward (forward+backward minus forward) for B8, on an idle stream
    (``ms``, ``library_ms``); B8 and its library call also behind a device
    sleep (``ms_device``, ``library_ms_device``)."""
    fwd, bwd = rows["tm_attention_fwd"], rows["tm_attention_bwd"]
    fwd["ms"] = cuda_ms(lambda: tm.tm_attention_fwd(q, k, v))
    fwd["plain_ms"] = cuda_ms(lambda: tm.tm_attention_fwd_reference(q, k, v))
    bwd["ms"] = cuda_ms(lambda: tm.tm_attention_bwd(q, k, v, o, do, lse))
    bwd["ms_device"] = cuda_ms(lambda: tm.tm_attention_bwd(q, k, v, o, do, lse),
                               ahead=AHEAD_ONE)
    bwd["plain_ms"] = cuda_ms(lambda: tm.tm_attention_bwd_reference(q, k, v, o, do, lse),
                              iters=10)
    fwd["library_ms"], _, bwd["library_ms"], bwd["library_ms_device"] = sdpa_backward_ms(
        q, k, v, do)
    for r, backward in ((fwd, False), (bwd, True)):
        r["bound_ms"], r["bound_by"] = attention_bound_ms(shape, dtype, backward)
    for name, r in rows.items():
        device = (f"; behind a device sleep kernel {r['ms_device']:.4f} ms, library "
                  f"{r['library_ms_device']:.4f} ms" if "ms_device" in r else "")
        print(f"timing {name} {list(shape)} {str(dtype)[6:]}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, scaled_dot_product_attention "
              f"{'backward' if r is bwd else 'forward'} {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']} "
              f"({100 * r['bound_ms'] / r['ms']:.1f}% of bound){device}", flush=True)


def phase_tm_bench() -> dict:
    """The token-major A/B tool at its four shapes; every shape's out and
    gradients must equal the whole-sequence kernels' bit for bit. Returns
    each kernel's launches in it."""
    from headct_foundation_tpu_torch.tools import bench_tm_attention

    zero_launches()  # the tool's run: every kernel count is 0 just before it
    t0 = time.perf_counter()
    shapes = bench_tm_attention.run()
    counts = launches()
    bad = [n for n, r in shapes.items() if not r["bit_identical"]]
    check(not bad, f"bench_tm_attention: FusedAttentionTM differs from FusedAttention at {bad}")
    print(f"tm bench: {len(shapes)} shapes in {time.perf_counter() - t0:.2f} s, every one "
          f"bit-identical to FusedAttention; launches {counts}; speedup of FusedAttentionTM "
          f"{ {n: round(r['speedup_tm'], 4) for n, r in shapes.items()} }", flush=True)
    return counts


def lion_step_checks(state) -> dict:
    """On the Lion path's state and gradients: each trainable tensor's B6
    output (delta and m_new) bit for bit against its plain version; one
    optimizer step fused from cloned parameters, gradients and momenta, whose
    parameters and momenta must be p + delta and m_new of those B6 outputs
    bit for bit; the same step unfused (at most LION_FLIP_SHARE of the
    parameter elements differ, the momenta within LION_M_REL * max|m|); then
    B6 timed over every trainable tensor, one launch each as the optimizer
    makes them."""
    from headct_foundation_tpu_torch.ops.lion_kernel import (
        lion_update_leaf,
        lion_update_leaf_reference,
    )
    from headct_foundation_tpu_torch.optim.optimizers import Lion

    group = state.optimizer.param_groups[0]
    lr, wd, (b1, b2) = group["lr"], group["weight_decay"], group["betas"]
    params = [p for p in group["params"] if p.grad is not None]
    after = []
    for fused in (True, False):
        clones = [p.detach().clone() for p in params]
        opt = Lion(clones, lr=lr, betas=group["betas"], weight_decay=wd, fused=fused)
        for c, p in zip(clones, params):
            c.grad = p.grad.clone()
            opt.state[c]["exp_avg"] = state.optimizer.state[p]["exp_avg"].clone()
        opt.step()
        after.append((clones, [opt.state[c]["exp_avg"] for c in clones]))
        del opt
    (p_f, m_f), (p_u, m_u) = after
    as_plain = as_step = 0
    for p, pf, mf in zip(params, p_f, m_f):
        m = state.optimizer.state[p]["exp_avg"]
        delta, m_new = lion_update_leaf(p, p.grad, m, lr, wd, b1, b2)
        want = lion_update_leaf_reference(p, p.grad, m, lr, wd, b1, b2)
        as_plain += torch.equal(delta, want[0]) and torch.equal(m_new, want[1])
        as_step += torch.equal(pf, p + delta) and torch.equal(mf, m_new)
    n = sum(p.numel() for p in params)
    differ = sum(int((a != b).sum()) for a, b in zip(p_f, p_u))
    m_rel = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                for a, b in zip(m_f, m_u))
    ok = (as_plain == as_step == len(params) and differ <= LION_FLIP_SHARE * n
          and m_rel <= LION_M_REL)
    print(f"lion: B6 on the run's state, bit-identical to its plain version in {as_plain} of "
          f"{len(params)} tensors (delta and m_new), and the fused step's parameters and "
          f"momenta equal p + delta and m_new bit for bit in {as_step}; unfused against fused "
          f"from cloned state: {differ} of {n} parameter elements differ ({differ / n:.3e}, "
          f"tolerance {LION_FLIP_SHARE}), momenta max |dm|/max|m| {m_rel:.3e} (tolerance "
          f"{LION_M_REL}) {'ok' if ok else 'FAILED'}", flush=True)
    check(ok, "B6, the fused Lion step and the unfused one disagree on the run's state")
    del after, p_f, m_f, p_u, m_u

    moms = [state.optimizer.state[p]["exp_avg"].clone() for p in params]

    def every_tensor():
        for p, m in zip(params, moms):
            lion_update_leaf(p, p.grad, m, lr, wd, b1, b2, m_out=m)

    all_ms = cuda_ms(every_tensor, iters=5, warmup=1, ahead=AHEAD_ALL)
    idle_ms = cuda_ms(every_tensor, iters=5, warmup=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    every_tensor()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    bound, by = lion_bound_ms(n, torch.float32)
    print(f"lion: B6 over all {len(params)} trainable tensors ({n} float32 elements), one "
          f"launch each: {all_ms:.4f} ms of device time (CUDA events, launches queued behind a "
          f"device sleep), {idle_ms:.4f} ms from the first launch to the last on an idle "
          f"stream, {host_ms:.2f} ms on the host clock to launch and finish them; bound "
          f"{bound:.4f} ms by {by} ({100 * bound / all_ms:.1f}% of bound)", flush=True)
    return {"tensors": len(params), "elements": n, "ms": all_ms, "ms_idle_stream": idle_ms,
            "host_ms": host_ms, "bound_ms": bound, "bit_identical_tensors": as_plain,
            "flip_share": differ / n, "m_rel": m_rel}


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


def compare_backends(model, wire, cfg, draws, dtype, every: bool = False,
                     label: str = "train") -> dict:
    """Kernel against plain attention on the same step: loss and every
    decoder gradient (where the 96^3 step runs its kernels), or every
    trainable gradient with ``every``."""
    names = [n for n, p in model.named_parameters()
             if p.requires_grad and (every or n.startswith("decoder") or n == "mask_token")]
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
    print(f"{label}: kernel vs plain attention, one step at {str(dtype)[6:]}: loss {loss_k:.6f} vs "
          f"{loss_p:.6f} (relative {rel:.3e}, tolerance {tol['loss_rel']}); over "
          f"{len(names)} {'trainable' if every else 'decoder'} gradient tensors min cosine "
          f"{cos:.6f}, max "
          f"|dg|/max|g| {grad_rel:.3e} (tolerance "
          f"{'cosine >= ' + str(tol['grad_cos']) if 'grad_cos' in tol else 'max |dg| <= ' + str(tol['grad_rel_max']) + ' max|g|'}) "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    check(ok, f"kernel and plain attention disagree on the training step at {dtype}")
    return {"loss_rel": rel, "grad_cos_min": cos, "grad_rel_max": grad_rel}


PROFILE_GROUPS = [  # (group, substrings of a kernel name), first match wins
    # B3-B5 instantiate the shared kernels with the tag "Blocked" in their names
    ("attention kernels B3/B4/B5", ("blocked",)),
    ("attention kernels B1/B2", ("flash_fwd", "dkv_", "dq_", "delta_kernel")),
    ("GEMMs", ("gemm", "nvjet", "xmma", "cutlass", "cublas", "matmul")),
    ("per-parameter clip norms", ("lpnorm",)),
    ("AdamW", ("adam", "multi_tensor")),
    ("fused Lion B6", ("lion_kernel",)),
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
        top.append((us, ev.key[:100]))
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


def kernel_wrappers() -> dict:
    """Each kernel's wrapper, whose ``launches`` counts its CUDA launches."""
    from headct_foundation_tpu_torch.ops import flash_attention as fa
    from headct_foundation_tpu_torch.ops.lion_kernel import lion_update_leaf
    from headct_foundation_tpu_torch.tools import experimental_tm_attention as tm

    return {"flash_attention_fwd": fa.fused_attention,
            "flash_attention_bwd": fa.fused_attention_bwd,
            "flash_attention_blocked_fwd": fa.blocked_fused_attention,
            "flash_attention_blocked_dkv": fa.blocked_attention_dkv,
            "flash_attention_blocked_dq": fa.blocked_attention_dq,
            "lion_update": lion_update_leaf,
            "tm_attention_fwd": tm.tm_attention_fwd,
            "tm_attention_bwd": tm.tm_attention_bwd}


def zero_launches() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


def launches() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def phase_train(label: str, config: str, batch: int, compare_batch: int, seed0: int,
                per_step: dict, per_eval: dict, kernel_note: str, overrides=(),
                compare: bool = True) -> dict:
    """Drive one MAE pretraining configuration at full width; returns every
    kernel's launches in the train and eval runs. ``overrides`` are config
    keys and values merged over the YAML. ``per_step`` and ``per_eval`` are
    the launches expected of each kernel per train step and per eval batch (0
    for a kernel not named); the fused Lion update adds one B6 launch per
    trainable tensor per step. ``compare_batch`` is the batch of the
    kernel-vs-plain attention step, run when ``compare``. That step checks
    every trainable gradient where the blocked kernels run (in the 192^3
    encoder and decoder), the decoder's otherwise (the 96^3 encoder takes the
    plain attention)."""
    from headct_foundation_tpu_torch.config import default_config
    from headct_foundation_tpu_torch.data.augment import apply_mae_augment, draw_mae_augment
    from headct_foundation_tpu_torch.data.device_preprocess import wire_to_compute
    from headct_foundation_tpu_torch.engines import mae_engine

    cfg = default_config()
    cfg.merge_from_file(str(ROOT / config))
    cfg.merge_from_list(["DATA.WIRE_FORMAT", "hu16", *overrides])
    total = TRAIN_BATCHES + 5  # the epoch, then the timed steps
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    state, _ = mae_engine.create_train_state(cfg, total, WARMUP_STEPS, seed=0, device=dev)
    n_params = sum(p.numel() for p in state.model.parameters() if p.requires_grad)
    n_tensors = sum(p.requires_grad for p in state.model.parameters())
    optimizer = type(state.optimizer).__name__
    if optimizer == "Lion" and cfg.TRAIN.LION_FUSED:
        per_step = {**per_step, "lion_update": n_tensors}
    wires = [head_phantoms(seed0 + i, batch, cfg.MAE.INPUT_SIZE)
             for i in range(TRAIN_BATCHES + VAL_BATCHES)]
    torch.cuda.synchronize()
    m = cfg.MAE
    print(f"{label} set-up: MAE from {config} (encoder {m.ENCODER_DEPTH}x"
          f"{m.ENCODER_EMBED_DIM}/{m.ENCODER_NUM_HEADS} heads, decoder {m.DECODER_DEPTH}x"
          f"{m.DECODER_EMBED_DIM}/{m.DECODER_NUM_HEADS} heads, {m.INPUT_SIZE}^3 patch "
          f"{m.PATCH_SIZE}, {m.IN_CHANS} channels), {n_params} trainable parameters in "
          f"{n_tensors} tensors, seed 0, bf16 compute, {optimizer} (TRAIN.GRAD_CLIP "
          f"{cfg.TRAIN.GRAD_CLIP}, LION_FUSED {cfg.TRAIN.LION_FUSED}); {len(wires)} synthetic "
          f"hu16 batches of "
          f"{list(wires[0].shape)} int16 in {time.perf_counter() - t0:.2f} s", flush=True)

    g = mae_engine.step_generator(dev, 7, 0, 0)
    n_tok = int(np.prod(state.model.grid_size))
    if compare:  # kernel against plain attention on one step, same weights and randomness
        every = per_step.get("flash_attention_blocked_fwd", 0) > 0  # the encoder runs kernels
        draws = {"noise": torch.rand((compare_batch, n_tok), generator=g, device=dev),
                 "augment": draw_mae_augment(compare_batch, g, dev)}
        wire0 = torch.from_numpy(wires[0][:compare_batch]).to(dev)
        compare = {torch.bfloat16: compare_backends(state.model, wire0, cfg, draws,
                                                    torch.bfloat16, every, label)}
        m32 = mae_engine.build_mae_model(cfg, dtype=torch.float32).to(dev)
        m32.load_state_dict(state.model.state_dict())
        for n, p in m32.named_parameters():
            p.requires_grad_(dict(state.model.named_parameters())[n].requires_grad)
        compare[torch.float32] = compare_backends(m32, wire0, cfg, draws, torch.float32, every,
                                                  label)
        del m32
        torch.cuda.empty_cache()

    # The main path's run: every kernel count is 0 just before it.
    log = logging.getLogger(f"chip_smoke.{label}")
    before = {n: p.detach().clone() for n, p in state.model.named_parameters() if p.requires_grad}
    step = mae_engine.make_train_step(augment=True, config=cfg)
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    state, stats = mae_engine.train_one_epoch(cfg, state, step, wires[:TRAIN_BATCHES], 0, 0, 1,
                                              logger=log)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    train_launches = launches()
    peak = torch.cuda.max_memory_allocated()
    zero_launches()
    val = mae_engine.val_one_epoch(cfg, state, mae_engine.make_eval_step(cfg),
                                   wires[TRAIN_BATCHES:], 0, 0, 1, logger=log)
    val_launches = launches()

    check(state.step == TRAIN_BATCHES and math.isfinite(stats["loss"])
          and math.isfinite(val["loss"]), f"train/val losses not finite: {stats} {val}")
    want_train = {n: per_step.get(n, 0) * TRAIN_BATCHES for n in train_launches}
    want_eval = {n: per_eval.get(n, 0) * VAL_BATCHES for n in val_launches}
    check(train_launches == want_train,
          f"training launches {train_launches}; expected {want_train}")
    check(val_launches == want_eval, f"eval launches {val_launches}; expected {want_eval}")
    params = dict(state.model.named_parameters())
    unmoved = [n for n, p in before.items() if torch.equal(p, params[n].detach())]
    check(not unmoved, f"parameters that did not move in {TRAIN_BATCHES} steps: {unmoved[:5]}")
    print(f"{label}: train_one_epoch over {TRAIN_BATCHES} batches of {batch} in "
          f"{epoch_s:.2f} s, mean loss {stats['loss']:.6f}, mean lr {stats['lr']:.3e}; "
          f"val_one_epoch over {VAL_BATCHES} batch: loss {val['loss']:.6f}; all finite; every "
          f"trainable tensor moved; launches train {train_launches} = {per_step} per step, "
          f"eval {val_launches} = {per_eval} per batch, exactly; peak memory "
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
    aug = draw_mae_augment(batch, g, dev)
    noise = torch.rand((batch, n_tok), generator=g, device=dev)
    prep_ms = cuda_ms(lambda: apply_mae_augment(
        wire_to_compute(wire, cfg, cfg.MAE.IN_CHANS), aug), iters=5, warmup=1)
    vols = apply_mae_augment(wire_to_compute(wire, cfg, cfg.MAE.IN_CHANS), aug)

    def fwd_bwd():
        model(vols, noise=noise)[0].backward()

    fb_ms = cuda_ms(fwd_bwd, iters=5, warmup=1)
    lion = lion_step_checks(state) if optimizer == "Lion" and cfg.TRAIN.LION_FUSED else None
    opt_ms = cuda_ms(state.optimizer.step, iters=5, warmup=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state.optimizer.step()
    torch.cuda.synchronize()
    opt_host_ms = (time.perf_counter() - t0) * 1e3
    state.optimizer.zero_grad(set_to_none=True)
    print(f"{label}: median step {step_ms:.2f} ms over {len(times)} synchronised steps "
          f"({', '.join(f'{t:.1f}' for t in times)}), {batch / step_ms * 1e3:.2f} volumes/s; "
          f"breakdown: window+augment {prep_ms:.2f} ms, forward+backward {fb_ms:.2f} ms "
          f"(of which {kernel_note}, from the kernel timings), {optimizer} step {opt_ms:.2f} ms "
          f"(CUDA events; {opt_host_ms:.2f} ms on the host clock, synchronised)", flush=True)
    profile_steps(step, state, wire, step_ms)
    return {"train": train_launches, "eval": val_launches, "compare": compare, "lion": lion}


# Libraries holding wgmma kernels -> instantiations ptxas must report: the
# forward at 5 padded head dims x 2 copy widths in each of B1's, B3's and B7's
# library; the dK/dV and dQ passes at 5 x 2 each in B2's, B4/B5's and B8's.
WGMMA_BUILDS = {"flash_attention_fwd": 10, "flash_attention_blocked_fwd": 10,
                "flash_attention_bwd": 20, "flash_attention_blocked_bwd": 20,
                "tm_attention": 30}


def report_wgmma_build(_build) -> None:
    """ptxas's registers and spills of each instantiation of the wgmma
    kernels -- the forward (csrc/flash_fwd_sm90.cuh) and B4/B5
    (csrc/flash_bwd_sm90.cuh): head dim padded to DP, walked tile NT, copy
    width -- with its dynamic shared memory, and any line where ptxas says
    it serialized wgmma. A spill fails the run. A library built before this
    run is held by the report saved beside it."""
    import ctypes

    fwd_smem = _build.load("flash_attention_blocked_fwd").headct_flash_attention_blocked_fwd_smem
    fwd_smem.argtypes, fwd_smem.restype = [ctypes.c_longlong], ctypes.c_longlong
    bwd_smem = _build.load("flash_attention_blocked_bwd").headct_flash_attention_blocked_bwd_smem
    bwd_smem.argtypes, bwd_smem.restype = [ctypes.c_int, ctypes.c_longlong], ctypes.c_longlong
    kinds = {"flash_fwd_wgmma_kernel": ("forward", fwd_smem),
             "dkv_wgmma_kernel": ("dK/dV pass", lambda dp: bwd_smem(1, dp)),
             "dq_wgmma_kernel": ("dQ pass", lambda dp: bwd_smem(0, dp))}
    seen = {}
    for lib in WGMMA_BUILDS:
        log = _build.ptxas_log(lib)
        for line in log.splitlines():
            if "wgmma" in line and "serialized" in line:
                print(f"build: {lib}: ptxas: {line.strip()}", flush=True)
        for entry in log.split("Compiling entry function '")[1:]:
            name = entry.split("'")[0]
            kind = next((k for k in kinds if k in name), None)
            if kind is None:
                continue
            label, smem = kinds[kind]
            dp, nt, ch = (int(x) for x in re.findall(r"Li(\d+)E", name)[:3])
            regs = int(re.search(r"Used (\d+) registers", entry).group(1))
            spills = int(re.search(r"(\d+) bytes spill stores", entry).group(1))
            print(f"build: {lib} {label} {kind}<DP {dp}, NT {nt}, {2 * ch}-byte copies>: "
                  f"{regs} registers, {spills} bytes spill stores, {smem(dp)} bytes dynamic "
                  f"shared memory per block", flush=True)
            check(spills == 0, f"{kind} at DP {dp} in {lib} spills {spills} bytes")
            seen[lib] = seen.get(lib, 0) + 1
    check(seen == WGMMA_BUILDS,
          f"ptxas reported {seen} instantiations of the wgmma kernels; expected {WGMMA_BUILDS}")


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

    report_wgmma_build(_build)

    kernel_rows = phase_kernels(fused_attention, fused_attention_reference)
    bwd_rows = phase_bwd_kernels(fused_attention, fused_attention_bwd,
                                 fused_attention_bwd_reference)
    blocked_rows = phase_blocked_kernels()
    lion_row = phase_lion_kernel()
    tm_rows = phase_tm_kernels()
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        serve_launches = phase_slice(Path(tmp))["flash_attention_fwd"]
    fwd_mae = kernel_rows[(MAE_DECODER, torch.bfloat16)]
    bwd_mae = bwd_rows[(MAE_DECODER, torch.bfloat16)]
    depth = 8  # decoder blocks of both MAE configurations; the 96^3 encoder runs plain
    train = phase_train(
        "train", MAE_CONFIG, TRAIN_BATCH, TRAIN_BATCH, 100,
        {"flash_attention_fwd": depth, "flash_attention_bwd": depth},
        {"flash_attention_fwd": depth},
        f"flash_attention_fwd {depth} x {fwd_mae['ms']:.4f} = {depth * fwd_mae['ms']:.2f} ms "
        f"and flash_attention_bwd {depth} x {bwd_mae['ms']:.4f} = {depth * bwd_mae['ms']:.2f} ms")
    torch.cuda.empty_cache()

    blocked = ("flash_attention_blocked_fwd", "flash_attention_blocked_dkv",
               "flash_attention_blocked_dq")
    enc_blocks = 12
    def per_step(n):
        dec_ms = blocked_rows[(n, STRETCH_DECODER, torch.bfloat16)]["ms"]
        enc_ms = blocked_rows[(n, STRETCH_ENCODER, torch.bfloat16)]["ms"]
        return (f"{n} {depth} x {dec_ms:.4f} + {enc_blocks} x {enc_ms:.4f} = "
                f"{depth * dec_ms + enc_blocks * enc_ms:.2f} ms")

    note = "; ".join(per_step(n) for n in blocked)
    stretch = phase_train(
        "stretch", STRETCH_CONFIG, STRETCH_DECODER[0], STRETCH_COMPARE_BATCH, 200,
        {n: depth + enc_blocks for n in blocked}, {blocked[0]: depth + enc_blocks}, note)
    torch.cuda.empty_cache()

    # The 96^3 MAE trained by the fused Lion update; the train phase has
    # already held its attention kernels against the plain attention.
    lion = phase_train(
        "lion", MAE_CONFIG, TRAIN_BATCH, TRAIN_BATCH, 300,
        {"flash_attention_fwd": depth, "flash_attention_bwd": depth},
        {"flash_attention_fwd": depth},
        "flash_attention_fwd and flash_attention_bwd as in the train phase",
        overrides=["TRAIN.OPTIMIZER", "Lion", "TRAIN.LION_FUSED", True, "TRAIN.GRAD_CLIP", 1.0],
        compare=False)
    torch.cuda.empty_cache()
    tm_launches = phase_tm_bench()

    by_path = {
        "flash_attention_fwd": {"serving": serve_launches,
                                "training": train["train"]["flash_attention_fwd"],
                                "eval": train["eval"]["flash_attention_fwd"],
                                "lion training": lion["train"]["flash_attention_fwd"],
                                "lion eval": lion["eval"]["flash_attention_fwd"]},
        "flash_attention_bwd": {"training": train["train"]["flash_attention_bwd"],
                                "lion training": lion["train"]["flash_attention_bwd"]},
        "flash_attention_blocked_fwd": {"stretch training": stretch["train"][blocked[0]],
                                        "stretch eval": stretch["eval"][blocked[0]]},
        "flash_attention_blocked_dkv": {"stretch training": stretch["train"][blocked[1]]},
        "flash_attention_blocked_dq": {"stretch training": stretch["train"][blocked[2]]},
        "lion_update": {"lion training": lion["train"]["lion_update"]},
        "tm_attention_fwd": {"tm bench": tm_launches["tm_attention_fwd"]},
        "tm_attention_bwd": {"tm bench": tm_launches["tm_attention_bwd"]},
    }
    for name, paths in by_path.items():
        check(all(n > 0 for n in paths.values()),
              f"{name} was not launched on every main path: {paths}")

    def row(name, source, replaces, r, shape, dtype, **extra):
        """``replaces`` is a line of the JAX package's ops/flash_attention.py
        or a "file:line" of another TPU kernel."""
        if isinstance(replaces, int):
            replaces = f"headct_foundation_tpu/ops/flash_attention.py:{replaces}"
        return {"name": name, "route": "cuda",
                "source": f"headct_foundation_tpu_torch/csrc/{source}",
                "replaces": replaces,
                "launches": sum(by_path[name].values()), "launches_by_path": by_path[name],
                "shape": list(shape), "dtype": str(dtype)[6:],
                **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")}, **extra}

    def blocked_row(name, replaces):
        dec = blocked_rows[(name, STRETCH_DECODER, torch.bfloat16)]
        enc = blocked_rows[(name, STRETCH_ENCODER, torch.bfloat16)]
        err = max(r["max_abs_err"] for (n, _, _), r in blocked_rows.items() if n == name)
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "ms_device",
                "library_ms_device", "backward_ms", "backward_ms_device",
                "library_backward_ms", "library_backward_ms_device")
        # the bf16 kernels are in the sm_90a headers, their C entries in the .cu
        source, entry = (("flash_fwd_sm90.cuh", "flash_attention_blocked_fwd.cu")
                         if name == blocked[0] else
                         ("flash_bwd_sm90.cuh", "flash_attention_blocked_bwd.cu"))
        entry = {"entry": f"headct_foundation_tpu_torch/csrc/{entry}"}
        return row(name, source, replaces, {**dec, "max_abs_err": err}, STRETCH_DECODER, torch.bfloat16,
                   at_encoder_shape={"shape": list(STRETCH_ENCODER),
                                     **{k: enc[k] for k in keys if k in enc}},
                   **{k: dec[k] for k in keys[5:] if k in dec}, **entry)

    print(json.dumps({"kernels": [
        row("flash_attention_fwd", "flash_attention_fwd.cu", 60,
            kernel_rows[(SERVING, torch.float32)], SERVING, torch.float32,
            at_mae_decoder_shape={
                "shape": list(MAE_DECODER), "dtype": "bfloat16",
                "kernel_source": "headct_foundation_tpu_torch/csrc/flash_fwd_sm90.cuh",
                **{k: fwd_mae[k] for k in ("max_abs_err", "ms", "ms_device", "plain_ms",
                                           "bound_ms", "bound_by", "library_ms",
                                           "library_ms_device")}}),
        # bf16 B2 and B8 run the passes of the sm_90a header; their C entries are in the .cu
        row("flash_attention_bwd", "flash_bwd_sm90.cuh", 86, bwd_mae, MAE_DECODER,
            torch.bfloat16, entry="headct_foundation_tpu_torch/csrc/flash_attention_bwd.cu",
            **{k: bwd_mae[k] for k in ("ms_device", "library_ms_device")}),
        blocked_row(blocked[0], 256),
        blocked_row(blocked[1], 292),
        blocked_row(blocked[2], 342),
        row("lion_update", "lion_update.cu", "headct_foundation_tpu/ops/lion_kernel.py:31",
            lion_row, LION_CASES[0][0], torch.float32, all_trainable_tensors=lion["lion"]),
        row("tm_attention_fwd", "tm_attention.cu", "tools/experimental_tm_attention.py:55",
            tm_rows["tm_attention_fwd"], MAE_DECODER, torch.bfloat16),
        row("tm_attention_bwd", "flash_bwd_sm90.cuh", "tools/experimental_tm_attention.py:80",
            tm_rows["tm_attention_bwd"], MAE_DECODER, torch.bfloat16,
            entry="headct_foundation_tpu_torch/csrc/tm_attention.cu",
            **{k: tm_rows["tm_attention_bwd"][k] for k in ("ms_device", "library_ms_device")}),
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
