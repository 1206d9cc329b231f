"""Does class structure emerge in DINO's teacher at toy scale? The port's
counterpart of the JAX repository's ``tools/dino_semantics.py``.

    python -m headct_foundation_tpu_torch.tools.dino_semantics --epochs 40 \\
        --steps-per-epoch 100 [--batch 16] [--sched-epochs 150] [--device cpu]
    python -m headct_foundation_tpu_torch.tools.dino_semantics --scaling

The DINO engine's real epoch loop (``trajectory.run_dino``'s) at the
sharpening-regime tiny configuration (``tiny_cfg``: 24^3 global and 16^3
local crops of 32^3 fields, patch 12, a 2-layer width-48 ViT, 256
prototypes, teacher temperature 0.01), with every schedule built over
``--sched-epochs`` and the first ``--epochs`` run, on a pool of
``K_DATA`` latent classes (``trajectory.make_class_pool``). After each
epoch the teacher backbone's CLS features of a held-out probe pool of the
same classes give (``class_structure``):

* ``centroid_acc``: nearest-centroid (cosine) accuracy, centroids fit on
  half of each class, tested on the other half; chance 1 / K_DATA;
* ``within_cos`` / ``between_cos``: the mean same-class and cross-class
  cosine of the mean-centred features.

``--scaling`` runs three horizons (epochs / 4, / 2 and all). The tiny
configuration's sequences (T = 11) are below ``PALLAS_MIN_T``: no kernel
launches, as in the JAX tool. Artifacts: ``<prefix>.json`` and, where
matplotlib imports, ``<prefix>.png`` (else ``png`` is null), the prefix
``build/study/dino_semantics`` by default; the JSON names the device. Runs
on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from headct_foundation_tpu_torch.bench import device_info
from headct_foundation_tpu_torch.config import default_config
from headct_foundation_tpu_torch.feature_extraction import resolve_device
from headct_foundation_tpu_torch.tools.trajectory import (
    STUDY_DIR,
    RecordingRun,
    SyntheticLoader,
    make_class_pool,
    write_json,
)

K_DATA = 4          # latent data classes
FIELD = 32          # pool volumes are FIELD^3; global crops are ROI^3


def tiny_cfg():
    """The sharpening-regime tiny configuration (the JAX slow test
    ``test_dino_descends_below_lnk_in_sharpening_regime``'s): 256
    prototypes, a 2-layer ViT, teacher temperature 0.01."""
    cfg = default_config()
    cfg.MODEL.ROI = [24, 24, 24]
    cfg.MODEL.IN_CHANS = 1
    cfg.VIT.INPUT_SIZE = 24
    cfg.VIT.PATCH_SIZE = 12
    cfg.VIT.IN_CHANS = 1
    cfg.VIT.HIDDEN_SIZE = 48
    cfg.VIT.MLP_DIM = 96
    cfg.VIT.NUM_LAYERS = 2
    cfg.VIT.NUM_HEADS = 4
    cfg.VIT.NUM_REGISTER_TOKENS = 2
    cfg.VIT.USE_BIAS = True
    cfg.DINO.HEAD_N_PROTOTYPES = 256
    cfg.DINO.HEAD_HIDDEN_DIM = 64
    cfg.DINO.BOTTLENECK_DIM = 16
    cfg.DINO.LOCAL_CROP_NUM = 2
    cfg.DINO.GLOBAL_CROP_SIZE = [24, 24, 24]
    cfg.DINO.LOCAL_CROP_SIZE = [16, 16, 16]
    cfg.DINO.USE_BN = False
    cfg.DINO.TEACHER_TEMP = 0.01
    cfg.DINO.WARMUP_TEACHER_TEMP = 0.01
    cfg.DINO.WARMUP_TEACHER_EPOCHS = 0
    cfg.DINO.FREEZE_LAST_LAYER = 1
    cfg.TRAIN.BASE_LR = 5e-4
    cfg.TRAIN.MIN_LR = 5e-7
    cfg.TRAIN.GRAD_CLIP = 1.0
    return cfg


def make_probe_fn() -> Callable:
    """probe(state, vols) -> the teacher backbone's CLS features [B, C] in
    float32 (bfloat16 compute, no gradient)."""

    @torch.no_grad()
    def probe(state, vols: torch.Tensor) -> torch.Tensor:
        backbone = state.teacher.backbone
        was_training = backbone.training
        backbone.eval()
        try:
            tokens, _ = backbone(vols.to(state.device, torch.bfloat16))
        finally:
            backbone.train(was_training)
        return tokens[:, 0, :].float()

    return probe


def teacher_features(state, probe_fn: Callable, pool: np.ndarray, batch: int) -> np.ndarray:
    """The probe's features of every volume of ``pool``, in order; the last
    batch padded with its final volume, as the JAX tool pads it."""
    out = []
    n = len(pool)
    for s in range(0, n, batch):
        idx = np.arange(s, min(s + batch, n))
        real = len(idx)
        if real < batch:
            idx = np.concatenate([idx, np.full(batch - real, idx[-1])])
        vols = torch.from_numpy(np.asarray(pool[idx], np.float32))
        out.append(probe_fn(state, vols).cpu().numpy()[:real])
    return np.concatenate(out, axis=0)


def class_structure(feats: np.ndarray, labels: np.ndarray) -> tuple:
    """(centroid accuracy, within-class cosine, between-class cosine). The
    fit / test split alternates within each class (labels cycle i % K); the
    features are centred on the fit half's mean before the cosines (nearly
    collapsed teacher features all sit at cosine ~1 from the origin)."""
    idx = np.arange(len(feats))
    fit, ev = (idx // K_DATA) % 2 == 0, (idx // K_DATA) % 2 == 1
    f = feats - feats[fit].mean(axis=0, keepdims=True)
    f /= np.linalg.norm(f, axis=1, keepdims=True) + 1e-8
    cents = np.stack([f[fit & (labels == k)].mean(axis=0) for k in range(K_DATA)])
    cents /= np.linalg.norm(cents, axis=1, keepdims=True) + 1e-8
    pred = (f[ev] @ cents.T).argmax(axis=1)
    acc = float((pred == labels[ev]).mean())

    sims = f @ f.T
    same = labels[:, None] == labels[None, :]
    off = ~np.eye(len(f), dtype=bool)
    within = float(sims[same & off].mean())
    between = float(sims[~same].mean())
    return acc, within, between


def run(epochs: int, steps: int, batch: int, sched_epochs: int, seed: int = 1,
        on_epoch: Optional[Callable] = None, probe_n: int = 160, device=None,
        train_step: Optional[Callable] = None, on_state: Optional[Callable] = None):
    """The DINO epoch loop and each epoch's teacher diagnostics; returns
    (cfg, the recording, the diagnostics). ``train_step`` and ``on_state``
    as ``trajectory.run_dino``'s."""
    from headct_foundation_tpu_torch.engines import dino_engine

    device = resolve_device(device)
    cfg = tiny_cfg()
    horizon = sched_epochs * steps
    state = dino_engine.create_train_state(cfg, horizon, 30, niter_per_ep=steps, seed=seed,
                                           device=device)
    if on_state is not None:
        on_state(state)
    train_step = train_step or dino_engine.make_train_step(cfg)
    pool = make_class_pool(128, 1, FIELD, k_classes=K_DATA, seed=0, class_seed=0)
    probe = make_class_pool(probe_n, 1, FIELD, k_classes=K_DATA, seed=7, class_seed=0)
    probe_y = (np.arange(probe_n) % K_DATA).astype(np.int32)
    # the probe volumes enter at the global-crop size the backbone trains on
    r = cfg.MODEL.ROI[0]
    s0 = (FIELD - r) // 2
    probe_roi = probe[:, :, s0:s0 + r, s0:s0 + r, s0:s0 + r]
    probe_fn = make_probe_fn()

    loader = SyntheticLoader(pool, batch, steps)
    rec = RecordingRun()
    diags = []
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        state, stats = dino_engine.train_one_epoch(cfg, state, train_step, loader, seed, epoch,
                                                   sched_epochs, wandb_run=rec)
        rec.add_launches(stats["launches"])
        feats = teacher_features(state, probe_fn, probe_roi, batch)
        acc, within, between = class_structure(feats, probe_y)
        diags.append({
            "epoch": epoch,
            "step": (epoch + 1) * steps,
            "views": (epoch + 1) * steps * batch * (2 + cfg.DINO.LOCAL_CROP_NUM),
            "centroid_acc": round(acc, 4),
            "within_cos": round(within, 4),
            "between_cos": round(between, 4),
            "loss_tail": round(float(np.mean(rec.losses[-20:])), 4),
        })
        if on_epoch:
            on_epoch(diags)
        print(f"[dino-sem] epoch {epoch + 1}/{epochs} loss {diags[-1]['loss_tail']:.3f} "
              f"acc {acc:.3f} (chance {1 / K_DATA:.3f}) w/b {within:.3f}/{between:.3f}",
              flush=True)
    return cfg, rec, diags


def save_png(result: dict, path: str) -> Optional[str]:
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    runs = result["runs"]
    fig, axes = plt.subplots(1, 2, figsize=(11, 3.6), dpi=130)
    colors = ["#2563eb", "#059669", "#d97706"]
    ax = axes[0]
    for run_d, color in zip(runs, colors):
        losses = run_d["losses"]
        ax.plot(np.arange(1, len(losses) + 1), losses, color=color, lw=0.9,
                label=f"{run_d['total_steps']} steps")
    ax.axhline(np.log(256), color="#ef4444", lw=0.8, ls="--", label="ln K")
    ax.set_xlabel("step")
    ax.set_ylabel("DINO loss")
    ax.set_title("sharpening-regime loss (tiny scale, temp 0.01)", fontsize=10)
    ax.legend(fontsize=8, frameon=False)
    ax = axes[1]
    for run_d, color in zip(runs, colors):
        d = run_d["diags"]
        ax.plot([x["views"] for x in d], [x["centroid_acc"] for x in d], color=color, lw=1.6,
                marker="o", ms=3, label=f"{run_d['total_steps']} steps")
    ax.axhline(1 / K_DATA, color="#ef4444", lw=0.8, ls="--", label=f"chance (1/{K_DATA})")
    ax.set_xlabel("crop views seen")
    ax.set_ylabel("teacher centroid accuracy")
    ax.set_ylim(0, 1.02)
    ax.set_title("teacher-feature class structure vs views budget", fontsize=10)
    ax.legend(fontsize=8, frameon=False)
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
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--steps-per-epoch", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--sched-epochs", type=int, default=150)
    ap.add_argument("--scaling", action="store_true",
                    help="three horizons: the views-budget scaling measurement")
    ap.add_argument("--out-prefix", default=str(STUDY_DIR / "dino_semantics"))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    prefix = args.out_prefix
    t0 = time.time()

    horizons = ([(args.epochs // 4, args.steps_per_epoch),
                 (args.epochs // 2, args.steps_per_epoch),
                 (args.epochs, args.steps_per_epoch)]
                if args.scaling else [(args.epochs, args.steps_per_epoch)])
    runs = []
    launches: dict = {}
    for epochs, steps in horizons:
        cfg, rec, diags = run(epochs, steps, args.batch, args.sched_epochs, device=device)
        for k, v in rec.launches.items():
            launches[k] = launches.get(k, 0) + v
        runs.append({
            "total_steps": epochs * steps,
            "batch": args.batch,
            "losses": [round(v, 4) for v in rec.losses],
            "diags": diags,
            "final_acc": diags[-1]["centroid_acc"],
            "max_acc": max(d["centroid_acc"] for d in diags),
        })
        result = {
            "k_data": K_DATA,
            "chance": 1 / K_DATA,
            "teacher_temp": 0.01,
            "prototypes": 256,
            "runs": runs,
            "wall_s": round(time.time() - t0, 1),
            "backend": device.type,
            "device": device_info(device),
            "launches": launches,
        }
        write_json(prefix + ".json", result, indent=1)  # a partial result survives a timeout
    result["png"] = save_png(result, prefix + ".png")
    best = max(r["max_acc"] for r in runs)
    result["semantics_emerged"] = bool(best > 1 / K_DATA + 0.15)
    # emerged is not retained: at long horizons the toy teacher's class
    # structure can peak mid-run and erode as the centring wins back
    result["retained_at_end"] = bool(runs[-1]["final_acc"] > 1 / K_DATA + 0.1)
    write_json(prefix + ".json", result, indent=1)
    line = {
        "semantics_emerged": result["semantics_emerged"],
        "retained_at_end": result["retained_at_end"],
        "best_centroid_acc": best,
        "chance": 1 / K_DATA,
        "per_run_final": [(r["total_steps"], r["final_acc"]) for r in runs],
        "wall_s": result["wall_s"],
        "device": result["device"],
        "launches": launches,
    }
    print(json.dumps(line), flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
