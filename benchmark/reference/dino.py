"""The DINO pretraining step of the recipe (ViT-B/12 with registers), plain.

Windowed input -> 2 global and N local crops (integer boxes averaged down
to the input size; the global ones flipped and shifted, the first blurred,
the second contrast-adjusted; decisions injected) -> the teacher on the
global crops, the student on all -> ViT: patch embedding + fixed sin-cos,
CLS and register tokens, blocks, norm (eps 1e-6), the CLS feature -> head:
Linear-GELU-Linear-GELU-Linear, L2 normalisation, a weight-normalised
last layer onto the prototypes -> the DINO cross-entropy of the centred,
sharpened teacher against the student, same-view pairs skipped.
The update: AdamW with the scheduled LR and weight decay, the teacher's
EMA over every parameter, the centre's EMA (0.9) to the teacher's mean.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import common
from benchmark.reference.mae import block_spec

CENTER_MOMENTUM = 0.9
STUDENT_TEMP = 0.1


def dims(cfg: dict) -> dict:
    v, d = cfg["VIT"], cfg["DINO"]
    return dict(size=int(v["INPUT_SIZE"]), patch=int(v["PATCH_SIZE"]), chans=int(v["IN_CHANS"]),
                width=int(v["HIDDEN_SIZE"]), depth=int(v["NUM_LAYERS"]), mlp=int(v["MLP_DIM"]),
                heads=int(v["NUM_HEADS"]), registers=int(v["NUM_REGISTER_TOKENS"]),
                head_layers=int(d["HEAD_N_LAYERS"]), head_hidden=int(d["HEAD_HIDDEN_DIM"]),
                bottleneck=int(d["BOTTLENECK_DIM"]), prototypes=int(d["HEAD_N_PROTOTYPES"]),
                local_crops=int(d["LOCAL_CROP_NUM"]))


def spec(cfg: dict) -> List[tuple]:
    """(name, shape, init) of the student's parameters; "sincos" and "ones"
    of ``head.last_layer.weight_g`` are the frozen ones."""
    d = dims(cfg)
    g = d["size"] // d["patch"]
    c = d["width"]
    out = [("backbone.patch_embedding.patch_embeddings.weight",
            (c, d["chans"], d["patch"], d["patch"], d["patch"]), "normal"),
           ("backbone.patch_embedding.patch_embeddings.bias", (c,), "normal"),
           ("backbone.patch_embedding.position_embeddings", (1, g ** 3, c), "sincos"),
           ("backbone.cls_token", (1, 1, c), "normal"),
           ("backbone.register_tokens", (1, d["registers"], c), "normal")]
    for i in range(d["depth"]):
        out += block_spec(f"backbone.blocks.{i}", c, d["mlp"])
    out += [("backbone.norm.weight", (c,), "ones"), ("backbone.norm.bias", (c,), "zeros")]
    widths = [c] + [d["head_hidden"]] * (d["head_layers"] - 1) + [d["bottleneck"]]
    for i in range(d["head_layers"]):
        out += [(f"head.mlp.{2 * i}.weight", (widths[i + 1], widths[i]), "normal"),
                (f"head.mlp.{2 * i}.bias", (widths[i + 1],), "normal")]
    out += [("head.last_layer.weight_v", (d["prototypes"], d["bottleneck"]), "normal"),
            ("head.last_layer.weight_g", (d["prototypes"], 1), "frozen_ones")]
    return out


def frozen(cfg: dict, device) -> Dict[str, torch.Tensor]:
    d = dims(cfg)
    return {"backbone.patch_embedding.position_embeddings": torch.from_numpy(
                common.sincos_embedding(d["size"] // d["patch"], d["width"])).to(device),
            "head.last_layer.weight_g": torch.ones((d["prototypes"], 1), device=device)}


def crops(x: torch.Tensor, decisions: Sequence[Dict[str, torch.Tensor]],
          size: int) -> List[torch.Tensor]:
    out = []
    for d in decisions:
        c = common.crop_area(x, d["start"], d["size"], size)
        if "flip" in d:
            for axis in range(3):
                c = common.flip_where(c, d["flip"][:, axis], axis + 2)
            c = common.shift_where(c, d["shift"], d["shift_on"])
        if "sigma" in d:
            c = torch.where(d["smooth_on"].reshape(-1, 1, 1, 1, 1),
                            common.gaussian_blur(c, d["sigma"]), c)
        if "gamma" in d:
            c = torch.where(d["contrast_on"].reshape(-1, 1, 1, 1, 1),
                            common.adjust_contrast(c, d["gamma"]), c)
        out.append(c)
    return out


def network(P: Dict[str, torch.Tensor], x: torch.Tensor, cfg: dict,
            precision: str) -> torch.Tensor:
    """ViT CLS feature -> head logits, for a batch of crops."""
    d = dims(cfg)
    tok = common.patch_embed(x, P, "backbone.patch_embedding.patch_embeddings", d["patch"],
                             precision)
    tok = tok + P["backbone.patch_embedding.position_embeddings"]
    B = tok.shape[0]
    h = torch.cat([P["backbone.cls_token"].expand(B, -1, -1),
                   P["backbone.register_tokens"].expand(B, -1, -1), tok], dim=1)
    for i in range(d["depth"]):
        h = common.block(h, P, f"backbone.blocks.{i}", d["heads"], precision)
    h = common.layer_norm(h, P, "backbone.norm", 1e-6)[:, 0]
    for i in range(d["head_layers"]):
        if i:
            h = common.gelu(h)
        h = common.linear(h, P, f"head.mlp.{2 * i}", precision)
    h = h / torch.linalg.vector_norm(h, dim=-1, keepdim=True).clamp_min(1e-12)
    v = P["head.last_layer.weight_v"]
    w = P["head.last_layer.weight_g"] * v / torch.linalg.vector_norm(v, dim=1, keepdim=True)
    h, w = common.operands(precision, h, w)
    return h @ w.t()


def loss_terms(student: torch.Tensor, teacher: torch.Tensor, center: torch.Tensor, temp: float,
               ncrops: int) -> torch.Tensor:
    """The DINO loss: mean over the (teacher view, student view) pairs of
    different views of the batch mean cross-entropy."""
    s = (student / STUDENT_TEMP).chunk(ncrops)
    q = torch.softmax((teacher - center) / temp, dim=-1).detach().chunk(2)
    total, n = 0.0, 0
    for iq in range(2):
        for v in range(ncrops):
            if v != iq:
                total = total + torch.sum(-q[iq] * F.log_softmax(s[v], dim=-1), dim=-1).mean()
                n += 1
    return total / n


def forward(S: Dict[str, torch.Tensor], T: Dict[str, torch.Tensor], wire: torch.Tensor,
            draw: Sequence[dict], center: torch.Tensor, temp: float, cfg: dict,
            precision: str = "float32") -> Tuple[torch.Tensor, torch.Tensor]:
    """(the loss of a block of rows, the sum of the teacher's outputs over
    them) with the block's crop decisions."""
    d = dims(cfg)
    views = crops(common.window_hu16(wire), draw, d["size"])
    ncrops = len(views)
    with torch.no_grad():
        t_out = network(T, torch.cat(views[:2]), cfg, precision)
    s_out = network(S, torch.cat(views), cfg, precision)
    return loss_terms(s_out, t_out, center, temp, ncrops), t_out.sum(dim=0)


def schedules(cfg: dict, niter_per_ep: int) -> dict:
    t, dn = cfg["TRAIN"], cfg["DINO"]
    epochs = int(t["MAX_EPOCHS"])
    n = epochs * niter_per_ep
    warm = int(dn["WARMUP_TEACHER_EPOCHS"])
    return {"wd": common.cosine_values(float(t["WEIGHT_DECAY"]), float(t["WEIGHT_DECAY_END"]), n),
            "momentum": common.cosine_values(float(dn["MOMENTUM_TEACHER"]),
                                             float(dn["MOMENTUM_TEACHER_END"]), n),
            "temp": np.concatenate([np.linspace(float(dn["WARMUP_TEACHER_TEMP"]),
                                                float(dn["TEACHER_TEMP"]), warm),
                                    np.ones(max(epochs - warm, 0)) * float(dn["TEACHER_TEMP"])])}


def hyper(cfg: dict, step: int, niter_per_ep: int) -> Tuple[float, float]:
    """(lr, weight decay) of update ``step``; the decay is read in float32."""
    t = cfg["TRAIN"]
    total = niter_per_ep * int(t["MAX_EPOCHS"])
    warm = int(float(t["PER_WARMUP"]) * total)
    wd = schedules(cfg, niter_per_ep)["wd"]
    return (common.cosine_lr(step, float(t["BASE_LR"]), warm, total, float(t["MIN_LR"])),
            float(np.float32(wd[min(step, len(wd) - 1)])))
