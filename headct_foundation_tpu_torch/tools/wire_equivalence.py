"""hu8 against hu16, end to end: the port's counterpart of the JAX
repository's ``tools/wire_equivalence.py``.

    python -m headct_foundation_tpu_torch.tools.wire_equivalence --steps 300 \\
        [--batch 16] [--pool 64] [--cosine-scans 16] [--checkpoint CKPT] [--device cpu]

The voxel error of the hu8 wire is bounded by the data tests; this
measures what it does to training and to features, on the flagship model:

1. ``trajectory_ab``: ``--steps`` updates of the MAE train step
   (``configs/mae/mae_HeadCT.yaml``, augmentation on, the mains'
   effective-LR rule) from the same seed-0 weights, the same step seed and
   the same index draws, fed the same HU volumes on the hu16 and on the
   hu8 wire; the two loss series.
2. ``feature_cosine``: ViT-B/12 CLS embeddings through the bfloat16
   ``FeatureExtractor`` (random weights, or ``--checkpoint``) of the same
   volumes windowed from their hu8 and their hu16 codes; each scan's
   cosine.

The verdict fields are the JAX tool's (``:200-206``): ``equivalent_training``
(mean relative |dloss| <= 0.02) and ``equivalent_features`` (min cosine >=
0.999). They are results, not gates. The cosines are taken in float32
(``cls_embedding`` returns float32); the JAX tool takes them on the
bfloat16 arrays its extractor returns, where a sum over 768 products
loses most of its digits (its recorded 0.89 is that: an embedding's cosine
with itself reads about 0.91 there). Artifacts: ``<prefix>.json`` and, where matplotlib
imports, ``<prefix>.png`` (else ``png`` is null), the prefix
``build/study/wire_equivalence`` by default; the JSON names the device.
Runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from headct_foundation_tpu_torch.bench import config_at, device_info
from headct_foundation_tpu_torch.feature_extraction import resolve_device
from headct_foundation_tpu_torch.tools.trajectory import STUDY_DIR, write_json

LOSS_FLUSH = 16  # steps between batched loss reads


def make_hu_pool(n: int, roi: int, seed: int = 0) -> np.ndarray:
    """Structured volumes in HU [n, 1, roi, roi, roi]: smooth soft-tissue
    fields, bone-bright ellipsoids and an air pocket, content in every
    window's range."""
    from scipy.ndimage import zoom

    rng = np.random.RandomState(seed)
    pool = np.empty((n, 1, roi, roi, roi), np.float32)
    ax = np.arange(roi, dtype=np.float32)
    for i in range(n):
        coarse = rng.rand(6, 6, 6).astype(np.float32)
        vol = zoom(coarse, roi / 6.0, order=1)[:roi, :roi, :roi]
        vol = vol * 160.0 - 80.0  # soft tissue
        for _ in range(3):  # bone-bright structures
            c = rng.uniform(0.2 * roi, 0.8 * roi, 3)
            r = rng.uniform(roi / 12, roi / 6, 3)
            d2 = (((ax[:, None, None] - c[0]) / r[0]) ** 2
                  + ((ax[None, :, None] - c[1]) / r[1]) ** 2
                  + ((ax[None, None, :] - c[2]) / r[2]) ** 2)
            vol = vol + rng.uniform(800, 1800) * np.exp(-0.5 * d2)
        c = rng.uniform(0.3 * roi, 0.7 * roi, 3)  # air pocket
        d2 = (((ax[:, None, None] - c[0]) / (roi / 10)) ** 2
              + ((ax[None, :, None] - c[1]) / (roi / 10)) ** 2
              + ((ax[None, None, :] - c[2]) / (roi / 10)) ** 2)
        vol = vol - 1000.0 * np.exp(-0.5 * d2)
        pool[i, 0] = np.round(vol)
    return pool


def mae_config(batch: int, overrides=()):
    """The flagship MAE recipe with the mains' effective-LR rule at ``batch``."""
    cfg = config_at("configs/mae/mae_HeadCT.yaml", overrides)
    cfg.TRAIN.BASE_LR = cfg.TRAIN.BASE_LR * batch / 256
    cfg.TRAIN.MIN_LR = cfg.TRAIN.BASE_LR * 1e-3
    return cfg


def trajectory_ab(steps: int, batch: int, pool_hu: np.ndarray, device=None,
                  overrides=()) -> Dict[str, Any]:
    """The same state, seed and index draws on the hu16 and the hu8 wire;
    each wire's pool is held on the device. Returns both loss series and,
    under ``"launches"``, each run's kernel launches."""
    from headct_foundation_tpu_torch.data.transforms import hu8_encode, hu16_encode
    from headct_foundation_tpu_torch.engines import mae_engine

    device = resolve_device(device)
    results: Dict[str, Any] = {"launches": {}}
    for wire, encode in (("hu16", hu16_encode), ("hu8", hu8_encode)):
        cfg = mae_config(batch, ["DATA.WIRE_FORMAT", wire, *overrides])
        dev_pool = torch.from_numpy(encode(pool_hu)).to(device)
        state, _ = mae_engine.create_train_state(cfg, steps, max(1, steps // 20), seed=0,
                                                 device=device)
        step_fn = mae_engine.make_train_step(augment=True, config=cfg)
        losses: List[float] = []
        pending: List[torch.Tensor] = []
        rng_np = np.random.RandomState(7)
        before = mae_engine.kernel_launches()
        for _ in range(steps):
            idx = torch.from_numpy(rng_np.randint(0, len(pool_hu), size=batch)).to(device)
            state, metrics = step_fn(state, dev_pool.index_select(0, idx), 0)
            pending.append(metrics["loss"])
            if len(pending) >= LOSS_FLUSH:
                losses.extend(torch.stack(pending).float().cpu().tolist())
                pending = []
        if pending:
            losses.extend(torch.stack(pending).float().cpu().tolist())
        results["launches"][wire] = {k: v - before[k]
                                     for k, v in mae_engine.kernel_launches().items()}
        results[wire] = losses
        print(f"[wire-ab] {wire}: {losses[0]:.4f} -> {np.mean(losses[-10:]):.4f}", flush=True)
        del state
    return results


def extractor(roi: int, checkpoint: Optional[str] = None, device=None,
              dtype: torch.dtype = torch.bfloat16):
    """The ViT-B/12 extractor of the JAX tool (sincos, qkv bias, 3 channels)."""
    from headct_foundation_tpu_torch.feature_extraction import FeatureExtractor

    return FeatureExtractor(checkpoint_path=checkpoint, img_size=roi, patch_size=12, in_chans=3,
                            hidden_size=768, mlp_dim=3072, num_layers=12, num_heads=12,
                            pos_embed="sincos", qkv_bias=True, dtype=dtype, device=device)


def windows(chunk_hu: np.ndarray) -> tuple:
    """The [B, 3, R, R, R] window stacks of ``chunk_hu`` [B, 1, R, R, R] from
    its hu16 and its hu8 codes."""
    from headct_foundation_tpu_torch.data.transforms import (
        hu8_encode,
        hu8_window_stack,
        hu16_encode,
        hu16_window_stack,
    )

    w16 = np.stack([hu16_window_stack(hu16_encode(v), 3) for v in chunk_hu])
    w8 = np.stack([hu8_window_stack(hu8_encode(v), 3) for v in chunk_hu])
    return w16, w8


def feature_cosine(pool_hu: np.ndarray, batch: int = 4, checkpoint: Optional[str] = None,
                   device=None, ext=None) -> List[float]:
    """Each scan's cosine between its CLS embeddings from the hu16 and the
    hu8 windows, through the bfloat16 extractor (``ext``, or a new one)."""
    ext = ext if ext is not None else extractor(pool_hu.shape[-1], checkpoint, device)
    cos: List[float] = []
    for s in range(0, len(pool_hu), batch):
        w16, w8 = windows(pool_hu[s:s + batch])
        e16 = ext.cls_embedding(w16)
        e8 = ext.cls_embedding(w8)
        num = (e16 * e8).sum(axis=1)
        den = np.linalg.norm(e16, axis=1) * np.linalg.norm(e8, axis=1)
        cos.extend((num / (den + 1e-12)).tolist())
    return cos


def verdict(traj: Dict[str, Any], cos: List[float], steps: int, batch: int,
            checkpoint: Optional[str] = None) -> dict:
    """The JAX tool's result fields (``:184-207``) of the two series and the
    cosines."""
    import os

    l16 = np.asarray(traj["hu16"])
    l8 = np.asarray(traj["hu8"])
    d = np.abs(l8 - l16)
    scale = np.maximum(np.abs(l16), 1e-3)
    return {
        "steps": steps,
        "batch": batch,
        "loss_hu16_start": float(l16[0]),
        "loss_hu16_final": float(np.mean(l16[-10:])),
        "loss_hu8_final": float(np.mean(l8[-10:])),
        "max_abs_dloss": float(d.max()),
        "mean_rel_dloss": float((d / scale).mean()),
        "max_rel_dloss": float((d / scale).max()),
        "feature_cosine_min": float(np.min(cos)),
        "feature_cosine_mean": float(np.mean(cos)),
        "feature_encoder": ("trained:" + os.path.basename(checkpoint) if checkpoint
                            else "random-init"),
        "equivalent_training": bool(float((d / scale).mean()) <= 0.02),
        "equivalent_features": bool(float(np.min(cos)) >= 0.999),
        "losses_hu16": [round(x, 5) for x in l16.tolist()],
        "losses_hu8": [round(x, 5) for x in l8.tolist()],
    }


def save_png(result: dict, path: str) -> Optional[str]:
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    l16, l8 = np.asarray(result["losses_hu16"]), np.asarray(result["losses_hu8"])
    rel = np.abs(l8 - l16) / np.maximum(np.abs(l16), 1e-3)
    fig, axes = plt.subplots(1, 2, figsize=(11, 3.6), dpi=130)
    x = np.arange(1, len(l16) + 1)
    axes[0].plot(x, l16, color="#2563eb", lw=1.0, label="hu16 wire")
    axes[0].plot(x, l8, color="#d97706", lw=1.0, ls="--", label="hu8 wire")
    axes[0].set_xlabel("step")
    axes[0].set_ylabel("MAE loss")
    axes[0].set_title("flagship MAE trajectory: hu8 vs hu16 wire", fontsize=10)
    axes[0].legend(fontsize=8, frameon=False)
    axes[1].plot(x, np.maximum(rel, 1e-12), color="#6b7280", lw=0.9)
    axes[1].set_yscale("log")
    axes[1].set_xlabel("step")
    axes[1].set_ylabel("relative |Δloss|")
    axes[1].set_title(f"divergence (mean {result['mean_rel_dloss']:.2e}); feature cosine "
                      f"min {result['feature_cosine_min']:.5f}", fontsize=10)
    for ax in axes:
        ax.grid(True, color="#e5e7eb", lw=0.6)
        for s in ("top", "right"):
            ax.spines[s].set_visible(False)
    fig.tight_layout()
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
    return path


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--pool", type=int, default=64)
    ap.add_argument("--cosine-scans", type=int, default=16)
    ap.add_argument("--checkpoint", default=None,
                    help="trained weights for the feature cosine (a checkpoint of either "
                    "package); without it the cosine measures a random-init stack")
    ap.add_argument("--out-prefix", default=str(STUDY_DIR / "wire_equivalence"))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    t0 = time.time()
    pool = make_hu_pool(args.pool, 96)
    traj = trajectory_ab(args.steps, args.batch, pool, device)
    cos = feature_cosine(pool[: args.cosine_scans], checkpoint=args.checkpoint, device=device)
    result = verdict(traj, cos, args.steps, args.batch, args.checkpoint)
    result.update(wall_s=round(time.time() - t0, 1), backend=device.type,
                  device=device_info(device), launches=traj["launches"])
    result["png"] = save_png(result, args.out_prefix + ".png")
    write_json(args.out_prefix + ".json", result)
    print(json.dumps({k: v for k, v in result.items() if not k.startswith("losses")}),
          flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
