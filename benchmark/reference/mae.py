"""The MAE pretraining step of the recipe (MAE3D over a ViT-B/12), plain.

Windowed input -> per-sample flips and intensity shift (the injected
decisions) -> patch embedding + fixed sin-cos position -> random masking
by the injected noise (stable argsort, keep 1 - MASK_RATIO) -> CLS ->
encoder blocks -> norm -> decoder embedding -> mask tokens put back ->
decoder CLS + fixed position -> decoder blocks -> norm -> voxel head ->
masked MSE against the patches of the augmented input.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from benchmark.reference import common


def dims(cfg: dict) -> dict:
    m = cfg["MAE"]
    return dict(size=int(m["INPUT_SIZE"]), patch=int(m["PATCH_SIZE"]), chans=int(m["IN_CHANS"]),
                enc=int(m["ENCODER_EMBED_DIM"]), enc_depth=int(m["ENCODER_DEPTH"]),
                enc_mlp=int(m["ENCODER_MLP_DIM"]), enc_heads=int(m["ENCODER_NUM_HEADS"]),
                dec=int(m["DECODER_EMBED_DIM"]), dec_depth=int(m["DECODER_DEPTH"]),
                dec_mlp=int(m["DECODER_MLP_DIM"]), dec_heads=int(m["DECODER_NUM_HEADS"]),
                mask_ratio=float(m["MASK_RATIO"]))


def block_spec(prefix: str, c: int, mlp: int) -> List[tuple]:
    return [(f"{prefix}.att_norm.weight", (c,), "ones"), (f"{prefix}.att_norm.bias", (c,), "zeros"),
            (f"{prefix}.attn.qkv.weight", (3 * c, c), "xavier"),
            (f"{prefix}.attn.qkv.bias", (3 * c,), "normal"),
            (f"{prefix}.attn.proj.weight", (c, c), "xavier"),
            (f"{prefix}.attn.proj.bias", (c,), "normal"),
            (f"{prefix}.ffn_norm.weight", (c,), "ones"), (f"{prefix}.ffn_norm.bias", (c,), "zeros"),
            (f"{prefix}.mlp.linear1.weight", (mlp, c), "xavier"),
            (f"{prefix}.mlp.linear1.bias", (mlp,), "normal"),
            (f"{prefix}.mlp.linear2.weight", (c, mlp), "xavier"),
            (f"{prefix}.mlp.linear2.bias", (c,), "normal")]


def spec(cfg: dict) -> List[tuple]:
    """(name, shape, init) of every parameter; init "sincos" marks the
    frozen position embeddings, which the weights leave out."""
    d = dims(cfg)
    g = d["size"] // d["patch"]
    L, pd = g ** 3, d["patch"] ** 3 * d["chans"]
    out = [("cls_token", (1, 1, d["enc"]), "normal"),
           ("decoder_cls_token", (1, 1, d["dec"]), "normal"),
           ("decoder_pos_embed", (1, L, d["dec"]), "sincos"),
           ("mask_token", (1, 1, d["dec"]), "normal"),
           ("patch_embedding.patch_embeddings.weight",
            (d["enc"], d["chans"], d["patch"], d["patch"], d["patch"]), "normal"),
           ("patch_embedding.patch_embeddings.bias", (d["enc"],), "normal"),
           ("patch_embedding.position_embeddings", (1, L, d["enc"]), "sincos")]
    for i in range(d["enc_depth"]):
        out += block_spec(f"blocks.{i}", d["enc"], d["enc_mlp"])
    for i in range(d["dec_depth"]):
        out += block_spec(f"decoder_blocks.{i}", d["dec"], d["dec_mlp"])
    out += [("norm.weight", (d["enc"],), "ones"), ("norm.bias", (d["enc"],), "zeros"),
            ("decoder_norm.weight", (d["dec"],), "ones"), ("decoder_norm.bias", (d["dec"],), "zeros"),
            ("decoder_embed.weight", (d["dec"], d["enc"]), "xavier"),
            ("decoder_embed.bias", (d["dec"],), "normal"),
            ("decoder_pred.weight", (pd, d["dec"]), "xavier"),
            ("decoder_pred.bias", (pd,), "normal")]
    return out


def frozen(cfg: dict, device) -> Dict[str, torch.Tensor]:
    d = dims(cfg)
    g = d["size"] // d["patch"]
    return {"patch_embedding.position_embeddings":
            torch.from_numpy(common.sincos_embedding(g, d["enc"])).to(device),
            "decoder_pos_embed": torch.from_numpy(common.sincos_embedding(g, d["dec"])).to(device)}


def augment(x: torch.Tensor, aug: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Flips along each spatial axis where ``flip`` [3, B], then the shift
    where ``shift_on``."""
    for axis in range(3):
        x = common.flip_where(x, aug["flip"][axis], axis + 2)
    return common.shift_where(x, aug["shift"], aug["shift_on"])


def loss(P: Dict[str, torch.Tensor], wire: torch.Tensor, draw: dict, cfg: dict,
         precision: str = "float32") -> torch.Tensor:
    """The masked MSE of a block of rows ([b, 1, R, R, R] hu16 wire) with
    their draws (``noise`` [b, L], ``augment``)."""
    d = dims(cfg)
    x = augment(common.window_hu16(wire), draw["augment"])
    tok = common.patch_embed(x, P, "patch_embedding.patch_embeddings", d["patch"], precision)
    tok = tok + P["patch_embedding.position_embeddings"]
    B, L, C = tok.shape
    keep = int(L * (1 - d["mask_ratio"]))
    ids_shuffle = torch.argsort(draw["noise"], dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    kept = torch.gather(tok, 1, ids_shuffle[:, :keep, None].expand(-1, -1, C))
    mask = torch.ones((B, L), device=tok.device)
    mask[:, :keep] = 0
    mask = torch.gather(mask, 1, ids_restore)
    h = torch.cat([P["cls_token"].expand(B, -1, -1), kept], dim=1)
    for i in range(d["enc_depth"]):
        h = common.block(h, P, f"blocks.{i}", d["enc_heads"], precision)
    h = common.layer_norm(h, P, "norm", 1e-5)
    h = common.linear(h, P, "decoder_embed", precision)
    Cd = h.shape[-1]
    rest = torch.cat([h[:, 1:], P["mask_token"].expand(B, L - keep, -1)], dim=1)
    rest = torch.gather(rest, 1, ids_restore[:, :, None].expand(-1, -1, Cd))
    h = torch.cat([h[:, :1], rest], dim=1)
    h = h + torch.cat([P["decoder_cls_token"], P["decoder_pos_embed"]], dim=1)
    for i in range(d["dec_depth"]):
        h = common.block(h, P, f"decoder_blocks.{i}", d["dec_heads"], precision)
    h = common.layer_norm(h, P, "decoder_norm", 1e-5)
    pred = common.linear(h, P, "decoder_pred", precision)[:, 1:]
    target = common.patchify(x, d["patch"])
    per_patch = (pred - target).square().mean(dim=-1)
    return (per_patch * mask).sum() / mask.sum()


def hyper(cfg: dict, step: int, niter_per_ep: int) -> Tuple[float, float]:
    """(lr, weight decay) of update ``step``: the cosine LR with warm-up."""
    t = cfg["TRAIN"]
    total = niter_per_ep * int(t["MAX_EPOCHS"])
    warm = int(float(t["PER_WARMUP"]) * total)
    return (common.cosine_lr(step, float(t["BASE_LR"]), warm, total, float(t["MIN_LR"])),
            float(t["WEIGHT_DECAY"]))
