"""Operations and bytes the cells' work needs, counted from their shapes.

* ``forward_flops_per_volume``: the matrix products of one volume's
  forward pass (patch embedding, every projection and MLP, the two
  attention products, the heads), 2 per multiply-add; the DINO volume's
  counts each crop through the student and the two global crops through
  the teacher.
* ``model_flops_per_volume``: 3 x the trained forward (forward and
  backward, nothing recomputed) plus the teacher's forward, the numerator
  of ``step_mfu``.
* ``attention_calls``: every attention of one step as (B, H, Tq, Tk, D,
  backward); ``attention_bound_s``: the least time they need on the card,
  each the larger of its operations at the bf16 peak and its bytes at the
  memory peak. Forward 4 B H Tq Tk D operations, reading Q, K, V and
  writing O (bf16) and the log-sum-exp (float32); backward 10 B H Tq Tk D,
  reading Q, K, V, O, dO and the log-sum-exp, writing dQ, dK, dV.
* ``PEAKS``: the published dense peaks of the card by its name.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

PEAKS: Dict[str, Dict[str, float]] = {  # NVIDIA H100 SXM data sheet, dense, 700 W
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "bytes_per_s": 3.35e12},
}
BF16, F32 = 2, 4


def peaks(device_name: str) -> Optional[Dict[str, float]]:
    return PEAKS.get(device_name)


def _block_flops(t: int, c: int, mlp: int) -> float:
    """One pre-norm block on t tokens of width c: qkv, proj, the MLP and the
    two attention products."""
    return 2.0 * t * (3 * c * c + c * c + 2 * c * mlp) + 4.0 * t * t * c


def _mae_dims(cfg: dict) -> Tuple[dict, int, int, int]:
    m = cfg["MAE"]
    patches = (int(m["INPUT_SIZE"]) // int(m["PATCH_SIZE"])) ** 3
    keep = int(patches * (1 - float(m["MASK_RATIO"])))
    voxels = int(m["PATCH_SIZE"]) ** 3 * int(m["IN_CHANS"])
    return m, patches, keep, voxels


def forward_flops_per_volume(engine: str, cfg: dict) -> Dict[str, float]:
    """{"trained": the forward that is differentiated, "teacher": the
    forward that is not} for one volume."""
    if engine == "mae":
        m, L, keep, pv = _mae_dims(cfg)
        c, cd = int(m["ENCODER_EMBED_DIM"]), int(m["DECODER_EMBED_DIM"])
        f = 2.0 * L * pv * c                                       # patch embedding
        f += int(m["ENCODER_DEPTH"]) * _block_flops(keep + 1, c, int(m["ENCODER_MLP_DIM"]))
        f += 2.0 * (keep + 1) * c * cd                             # decoder embedding
        f += int(m["DECODER_DEPTH"]) * _block_flops(L + 1, cd, int(m["DECODER_MLP_DIM"]))
        f += 2.0 * (L + 1) * cd * pv                               # voxel head
        return {"trained": f, "teacher": 0.0}
    v, d = cfg["VIT"], cfg["DINO"]
    c, patch = int(v["HIDDEN_SIZE"]), int(v["PATCH_SIZE"])
    L = (int(v["INPUT_SIZE"]) // patch) ** 3
    t = L + 1 + int(v["NUM_REGISTER_TOKENS"])
    widths = ([c] + [int(d["HEAD_HIDDEN_DIM"])] * (int(d["HEAD_N_LAYERS"]) - 1)
              + [int(d["BOTTLENECK_DIM"]), int(d["HEAD_N_PROTOTYPES"])])
    crop = (2.0 * L * patch ** 3 * int(v["IN_CHANS"]) * c
            + int(v["NUM_LAYERS"]) * _block_flops(t, c, int(v["MLP_DIM"]))
            + sum(2.0 * a * b for a, b in zip(widths, widths[1:])))
    crops = 2 + int(d["LOCAL_CROP_NUM"])
    return {"trained": crops * crop, "teacher": 2 * crop}


def model_flops_per_volume(engine: str, cfg: dict) -> float:
    f = forward_flops_per_volume(engine, cfg)
    return 3.0 * f["trained"] + f["teacher"]


def attention_calls(engine: str, cfg: dict, batch: int) -> List[tuple]:
    """(B, H, Tq, Tk, D, backward) of every attention in one step of
    ``batch`` volumes on one card."""
    if engine == "mae":
        m, L, keep, _ = _mae_dims(cfg)
        enc = (batch, int(m["ENCODER_NUM_HEADS"]), keep + 1, keep + 1,
               int(m["ENCODER_EMBED_DIM"]) // int(m["ENCODER_NUM_HEADS"]), True)
        dec = (batch, int(m["DECODER_NUM_HEADS"]), L + 1, L + 1,
               int(m["DECODER_EMBED_DIM"]) // int(m["DECODER_NUM_HEADS"]), True)
        return [enc] * int(m["ENCODER_DEPTH"]) + [dec] * int(m["DECODER_DEPTH"])
    v, d = cfg["VIT"], cfg["DINO"]
    h = int(v["NUM_HEADS"])
    t = (int(v["INPUT_SIZE"]) // int(v["PATCH_SIZE"])) ** 3 + 1 + int(v["NUM_REGISTER_TOKENS"])
    hd = int(v["HIDDEN_SIZE"]) // h
    student = (batch * (2 + int(d["LOCAL_CROP_NUM"])), h, t, t, hd, True)
    teacher = (batch * 2, h, t, t, hd, False)
    return [student, teacher] * int(v["NUM_LAYERS"])


def attention_work(call: tuple) -> Tuple[float, float]:
    """(operations, bytes) of one attention call, forward and, where it is
    trained, backward."""
    B, H, tq, tk, D, backward = call
    q, kv, lse = B * H * tq * D * BF16, B * H * tk * D * BF16, B * H * tq * F32
    flops = 4.0 * B * H * tq * tk * D
    nbytes = float(q + 2 * kv + q + lse)                 # read Q, K, V; write O, LSE
    if backward:
        flops += 10.0 * B * H * tq * tk * D
        nbytes += 3 * q + 2 * kv + lse + q + 2 * kv      # read Q, O, dO, K, V, LSE; write dQ, dK, dV
    return flops, nbytes


def attention_bound_s(calls: List[tuple], peak: Dict[str, float]) -> float:
    total = 0.0
    for call in calls:
        flops, nbytes = attention_work(call)
        total += max(flops / peak["bf16_flops"], nbytes / peak["bytes_per_s"])
    return total
