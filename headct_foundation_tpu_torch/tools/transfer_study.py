"""Pretrain, then transfer: does MAE pretraining give useful features? The
port's counterpart of the JAX repository's ``tools/transfer_study.py``.

    python -m headct_foundation_tpu_torch.tools.transfer_study --scale tiny [--device cpu]
    python -m headct_foundation_tpu_torch.tools.transfer_study --scale flagship \\
        [--pretrain-steps 100] [--device-pool]

1. Pretrain the MAE (its real epoch loop, the mains' effective-LR rule) on
   an unlabeled corpus of ``K_CLASSES`` latent classes of warped-template
   volumes (``make_template_class_pool``; ``--corpus gratings`` the
   fine-orientation gratings, ``make_hard_class_pool``), then write the
   checkpoint (``save_checkpoint``, ``wait_for_saves``).
2. Probe the frozen encoder (``TRAIN.LOCK``) on class 0 against class 1
   through the downstream engine's train and val loops, warm-started
   through ``load_pretrained_into`` (the mains' content-routed path), and
   the same probe from a random-init encoder as the control; the best val
   AUROC of each.
3. Retrieval: CLS and mean-pooled patch features of a fresh K-class corpus
   (``extract_feats``), same-class mAP (``eval/retrieval.py``), pretrained
   against random.

``--scale tiny``: ViT width 96, 4 encoder and 2 decoder blocks at 32^3,
patch 8 (T = 65, on B1/B2 on a card; the masked encoder's 17 plain);
``flagship``: the shipped ``configs/mae/mae_HeadCT.yaml`` and
``configs/downstream/vit_HeadCT_rsna.yaml`` at 96^3. The checks, unless
``--no-assert``, are the JAX tool's (``:702-716``): both margins (AUROC and mAP, pretrained minus random) above
``--margin`` and the pretrained probe's best AUROC above ``--min-auroc``.
Artifacts: ``<prefix>.json`` and, where matplotlib imports, ``<prefix>.png``
(else ``png`` is null), and the checkpoint ``transfer_mae.ckpt`` beside
them; the prefix is ``build/study/transfer_mae`` by default. The JSON names
the device and each stage's kernel launches. Runs on ``cuda`` unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from headct_foundation_tpu_torch.bench import config_at, device_info
from headct_foundation_tpu_torch.feature_extraction import resolve_device
from headct_foundation_tpu_torch.tools.trajectory import (
    STUDY_DIR,
    DevicePoolLabeledLoader,
    DevicePoolLoader,
    RecordingRun,
    SyntheticLabeledLoader,
    SyntheticLoader,
    write_json,
)

K_CLASSES = 8  # pretrain and retrieval corpus classes; the probe takes 0 against 1


def make_hard_class_pool(n, in_chans, roi, k_classes=K_CLASSES, seed=0, class_seed=0,
                         noise=0.08, delta_deg=15.0):
    """Fine-grained gratings: every class shares two frequencies and a first
    direction; class k turns the second direction k x ``delta_deg`` degrees
    about a fixed axis. Random phases, smooth background jitter, voxel noise."""
    rng = np.random.RandomState(seed)
    r1 = np.random.RandomState(class_seed + 500)
    ax = np.arange(roi, dtype=np.float32) / roi
    xx, yy, zz = ax[:, None, None], ax[None, :, None], ax[None, None, :]
    d0 = r1.randn(3).astype(np.float32)
    d0 /= np.linalg.norm(d0)
    d1 = r1.randn(3).astype(np.float32)  # the rotation axis is orthogonal to it
    d1 -= d1 @ d0 * d0
    d1 /= np.linalg.norm(d1)
    rot_axis = np.cross(d0, d1)
    rot_axis /= np.linalg.norm(rot_axis)
    freqs = (3.0, 4.5)

    def _rot(v, axis, theta):  # Rodrigues
        return (v * np.cos(theta) + np.cross(axis, v) * np.sin(theta)
                + axis * (axis @ v) * (1 - np.cos(theta)))

    from scipy.ndimage import zoom

    dirs_per_class = [(d0, _rot(d1, rot_axis, np.deg2rad(delta_deg) * k))
                      for k in range(k_classes)]
    pool = np.empty((n, in_chans, roi, roi, roi), np.float16)
    for i in range(n):
        vol = np.full((roi, roi, roi), 0.5, np.float32)
        for g, d in enumerate(dirs_per_class[i % k_classes]):
            phase = rng.rand() * 2 * np.pi
            arg = 2 * np.pi * freqs[g] * (d[0] * xx + d[1] * yy + d[2] * zz)
            vol = vol + 0.16 * np.sin(arg + phase)
        coarse = rng.rand(4, 4, 4).astype(np.float32) - 0.5
        vol = vol + 0.12 * zoom(coarse, roi / 4.0, order=1)[:roi, :roi, :roi]
        vol = vol + noise * rng.randn(roi, roi, roi).astype(np.float32)
        vol = np.clip(vol, 0.0, 1.0)
        chans = [vol]
        while len(chans) < in_chans:
            c = len(chans)
            chans.append(np.clip(vol * (1.0 + 0.4 * c) - 0.15 * c, 0.0, 1.0))
        pool[i] = np.stack(chans[:in_chans]).astype(np.float16)
    return pool


def make_template_class_pool(n, in_chans, roi, k_classes=K_CLASSES, seed=0, class_seed=0,
                             noise=0.08, warp=0.12, delta_deg=None):
    """Anatomy-like classes: each class a template (a smooth field and a
    constellation of ellipsoids, from ``class_seed``), each instance a smooth
    random warp of it (amplitude ``warp`` x roi) with intensity jitter and
    voxel noise. ``delta_deg`` is accepted for the CLI and unused."""
    from scipy.ndimage import map_coordinates, zoom

    rng = np.random.RandomState(seed)
    ax = np.arange(roi, dtype=np.float32)
    templates = []
    for k in range(k_classes):
        r1 = np.random.RandomState(class_seed + 900 + k)
        coarse = r1.rand(6, 6, 6).astype(np.float32)
        t = zoom(coarse, roi / 6.0, order=1)[:roi, :roi, :roi]
        t = 0.25 + 0.3 * (t - t.min()) / (t.max() - t.min() + 1e-6)
        for _ in range(5):
            c = r1.uniform(0.2 * roi, 0.8 * roi, size=3)
            rr = r1.uniform(roi / 14, roi / 7, size=3)
            amp = r1.uniform(0.25, 0.45) * r1.choice([-1.0, 1.0])
            d2 = (((ax[:, None, None] - c[0]) / rr[0]) ** 2
                  + ((ax[None, :, None] - c[1]) / rr[1]) ** 2
                  + ((ax[None, None, :] - c[2]) / rr[2]) ** 2)
            t = t + amp * np.exp(-0.5 * d2)
        templates.append(np.clip(t, 0.0, 1.0))

    grid = np.meshgrid(ax, ax, ax, indexing="ij")
    pool = np.empty((n, in_chans, roi, roi, roi), np.float16)
    for i in range(n):
        disp = [zoom((rng.rand(3, 3, 3).astype(np.float32) - 0.5) * 2 * warp * roi, roi / 3.0,
                     order=1)[:roi, :roi, :roi] for _ in range(3)]
        coords = [np.clip(g + d, 0, roi - 1) for g, d in zip(grid, disp)]
        vol = map_coordinates(templates[i % k_classes], coords, order=1)
        coarse = rng.rand(4, 4, 4).astype(np.float32) - 0.5
        vol = vol + 0.1 * zoom(coarse, roi / 4.0, order=1)[:roi, :roi, :roi]
        vol = vol + noise * rng.randn(roi, roi, roi).astype(np.float32)
        vol = np.clip(vol, 0.0, 1.0)
        chans = [vol]
        while len(chans) < in_chans:
            c = len(chans)
            chans.append(np.clip(vol * (1.0 + 0.4 * c) - 0.15 * c, 0.0, 1.0))
        pool[i] = np.stack(chans[:in_chans]).astype(np.float16)
    return pool


class SequentialLabeledLoader:
    """Every sample once, in order (validation and retrieval batches); the
    last batch padded with its final sample, its fnames the real ones only."""

    def __init__(self, pool, labels, batch):
        self.pool = pool
        self.labels = labels
        self.batch = batch

    def set_epoch(self, epoch):
        pass

    def __len__(self):
        return -(-len(self.pool) // self.batch)

    def close(self):
        pass

    def indices(self):
        n = len(self.pool)
        for s in range(0, n, self.batch):
            idx = np.arange(s, min(s + self.batch, n))
            real = len(idx)
            if real < self.batch:
                idx = np.concatenate([idx, np.full(self.batch - real, idx[-1])])
            yield idx, real

    def rows(self, idx):
        return self.pool[idx]

    def __iter__(self):
        for idx, real in self.indices():
            yield self.rows(idx), self.labels[idx], [f"v{j}" for j in idx[:real]]


class DeviceSequentialLabeledLoader(SequentialLabeledLoader):
    """``SequentialLabeledLoader`` over a pool held on the device in float16."""

    def __init__(self, pool, labels, batch, device=None):
        super().__init__(pool, labels, batch)
        self.pool_dev = torch.from_numpy(np.asarray(pool, np.float16)).to(resolve_device(device))

    def rows(self, idx):
        return self.pool_dev.index_select(0, torch.from_numpy(idx).to(self.pool_dev.device))


def _cfgs(scale: str, classifier: str):
    """(MAE config, probe config) at ``scale``: the shipped recipes, or
    ``tiny``'s width-96, 4-block ViT at 32^3, patch 8."""
    mae = config_at("configs/mae/mae_HeadCT.yaml")
    probe = config_at("configs/downstream/vit_HeadCT_rsna.yaml")
    if scale == "tiny":
        for cfg in (mae, probe):
            cfg.MODEL.ROI = [32, 32, 32]
            cfg.VIT.INPUT_SIZE = 32
            cfg.VIT.IN_CHANS = 3
            cfg.VIT.HIDDEN_SIZE = 96
            cfg.VIT.MLP_DIM = 192
            cfg.VIT.NUM_LAYERS = 4
            cfg.VIT.NUM_HEADS = 4
            cfg.VIT.PATCH_SIZE = 8
        mae.MAE.INPUT_SIZE = 32
        mae.MAE.PATCH_SIZE = 8
        mae.MAE.IN_CHANS = 3
        mae.MAE.ENCODER_EMBED_DIM = 96
        mae.MAE.ENCODER_MLP_DIM = 192
        mae.MAE.ENCODER_DEPTH = 4
        mae.MAE.ENCODER_NUM_HEADS = 4
        mae.MAE.DECODER_EMBED_DIM = 96
        mae.MAE.DECODER_MLP_DIM = 192
        mae.MAE.DECODER_DEPTH = 2
        mae.MAE.DECODER_NUM_HEADS = 4
    probe.TRAIN.LOCK = True  # the frozen encoder: linear or attentive probing
    probe.TRAIN.CLASSIFIER = classifier
    probe.DATA.NUM_CLASSES = 2
    probe.MODEL.PRETRAINED = ""
    return mae, probe


def _add(total: Dict[str, int], launches: Dict[str, int]) -> None:
    for k, v in launches.items():
        total[k] = total.get(k, 0) + int(v)


def pretrain_mae(cfg, seed: int, pool, epochs: int, steps: int, batch: int, out_dir: str,
                 device_pool: bool = False, device=None, train_step=None, on_state=None):
    """The MAE epoch loop on the unlabeled corpus, then its checkpoint;
    returns (the checkpoint's path, the losses, the launches)."""
    from headct_foundation_tpu_torch.engines import mae_engine
    from headct_foundation_tpu_torch.utils.checkpoint import save_checkpoint, wait_for_saves

    device = resolve_device(device)
    cfg = cfg.clone()
    cfg.TRAIN.BASE_LR = cfg.TRAIN.BASE_LR * batch / 256  # the pretrain mains' rule
    cfg.TRAIN.MIN_LR = cfg.TRAIN.BASE_LR * 1e-3
    total = epochs * steps
    state, _ = mae_engine.create_train_state(cfg, total, int(cfg.TRAIN.PER_WARMUP * total),
                                             seed=seed, device=device)
    if on_state is not None:
        on_state(state)
    train_step = train_step or mae_engine.make_train_step(augment=True, config=cfg)
    loader = (DevicePoolLoader(pool, batch, steps, device=device) if device_pool
              else SyntheticLoader(pool, batch, steps))
    rec = RecordingRun()
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        state, stats = mae_engine.train_one_epoch(cfg, state, train_step, loader, seed, epoch,
                                                  epochs, wandb_run=rec)
        rec.add_launches(stats["launches"])
    path = save_checkpoint(state, epochs - 1, float(rec.losses[-1]), out_dir, "transfer_mae.ckpt")
    wait_for_saves()
    return path, rec.losses, rec.launches


def _probe_state(cfg, seed: int, total_steps: int, ckpt_path: Optional[str], device=None):
    """The downstream train state; with ``ckpt_path`` its backbone
    warm-started through ``load_pretrained_into``, as the mains do."""
    from headct_foundation_tpu_torch.engines import downstream_engine
    from headct_foundation_tpu_torch.utils.torch_interop import load_pretrained_into

    state = downstream_engine.create_train_state(
        cfg, total_steps, int(cfg.TRAIN.PER_WARMUP * total_steps), seed=seed,
        device=resolve_device(device))
    if ckpt_path:
        full = state.full_view()
        load_pretrained_into(full.model, ckpt_path)
        state.load_full(full)
    return state


def run_probe(cfg, seed: int, ckpt_path: Optional[str], train_pool, train_labels, val_pool,
              val_labels, epochs: int, steps: int, batch: int, device_pools: bool = False,
              device=None, train_step=None, on_state=None) -> dict:
    """The frozen-encoder probe through the downstream engine's train and
    val loops; each epoch's val mean AUROC, the best, the last train
    losses' mean and the launches of the train steps and the eval batches."""
    from headct_foundation_tpu_torch.engines import downstream_engine

    device = resolve_device(device)
    total = epochs * steps
    state = _probe_state(cfg, seed, total, ckpt_path, device)
    if on_state is not None:
        on_state(state)
    train_step = train_step or downstream_engine.make_train_step(cfg)
    eval_step = downstream_engine.make_eval_step(cfg)
    if device_pools:
        train_loader = DevicePoolLabeledLoader(train_pool, train_labels, batch, steps,
                                               device=device)
        val_loader = DeviceSequentialLabeledLoader(val_pool, val_labels, batch, device=device)
    else:
        train_loader = SyntheticLabeledLoader(train_pool, train_labels, batch, steps)
        val_loader = SequentialLabeledLoader(val_pool, val_labels, batch)
    val_aurocs: List[float] = []
    train_losses: List[float] = []
    train_launches: Dict[str, int] = {}
    eval_launches: Dict[str, int] = {}
    for epoch in range(epochs):
        train_loader.set_epoch(epoch)
        rec = RecordingRun()
        state, stats = downstream_engine.train_one_epoch(cfg, state, train_step, train_loader,
                                                         seed, epoch, epochs, wandb_run=rec)
        _add(train_launches, stats["launches"])
        train_losses.extend(rec.losses)
        vstats = downstream_engine.val_one_epoch(cfg, state, eval_step, val_loader, epoch, epochs)
        _add(eval_launches, vstats["launches"])
        val_aurocs.append(float(vstats["mean_auroc"]))
    return {"val_aurocs": val_aurocs, "best_val_auroc": float(np.max(val_aurocs)),
            "final_train_loss": float(np.mean(train_losses[-10:])),
            "train_steps": total, "eval_batches": epochs * len(val_loader),
            "launches": {"train": train_launches, "eval": eval_launches}}


def extract_feats(cfg, seed: int, ckpt_path: Optional[str], pool, batch: int,
                  device_pool: Optional[torch.Tensor] = None, device=None) -> dict:
    """{'cls': [N, C], 'mean': [N, C]} of a frozen encoder (warm-started from
    ``ckpt_path``, else the random init), bfloat16 compute; with
    ``launches``, the kernels' launches. 'cls' is the notebook's feature,
    'mean' pools the patch tokens (an MAE encoder's CLS has no objective of
    its own). ``device_pool``: ``pool`` already on the device."""
    from headct_foundation_tpu_torch.data.device_preprocess import wire_to_compute
    from headct_foundation_tpu_torch.engines import mae_engine

    device = resolve_device(device)
    state = _probe_state(cfg, seed, 10, ckpt_path, device)
    model = state.model.eval()
    n_reg = int(cfg.VIT.NUM_REGISTER_TOKENS)
    in_chans = int(cfg.VIT.IN_CHANS)
    cls_f, mean_f = [], []
    before = mae_engine.kernel_launches()
    loader = SequentialLabeledLoader(pool, np.zeros(len(pool), np.int32), batch)
    with torch.no_grad():
        for idx, real in loader.indices():
            if device_pool is not None:  # one copy to the device, a gather per batch
                vols = device_pool.index_select(0, torch.from_numpy(idx).to(device))
            else:
                vols = torch.from_numpy(np.asarray(pool[idx])).to(device)
            tokens, _ = model(wire_to_compute(vols, cfg, in_chans, dtype=torch.bfloat16))
            cls_f.append(tokens[:real, 0, :].float().cpu().numpy())
            mean_f.append(tokens[:real, 1 + n_reg:, :].float().mean(dim=1).cpu().numpy())
    launches = {k: v - before[k] for k, v in mae_engine.kernel_launches().items()}
    return {"cls": np.concatenate(cls_f, axis=0), "mean": np.concatenate(mean_f, axis=0),
            "launches": launches, "batches": len(loader)}


def retrieval_scores(feats, labels) -> dict:
    from headct_foundation_tpu_torch.eval.retrieval import retrieval_map_per_class

    per_class = retrieval_map_per_class(feats, {f"class_{k}": labels == k
                                                for k in np.unique(labels)})
    return {"per_class": per_class, "mean_map": float(np.mean(list(per_class.values())))}


def save_png(result: dict, path: str) -> Optional[str]:
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(13, 3.6), dpi=130)
    ax = axes[0]
    losses = result["pretrain"]["losses"]
    ax.plot(np.arange(1, len(losses) + 1), losses, color="#2563eb", lw=1.2)
    ax.set_xlabel("pretrain step", color="#374151")
    ax.set_ylabel("MAE loss", color="#374151")
    ax.set_title("1. MAE pretrain (unlabeled K-class corpus)", fontsize=10)
    ax = axes[1]
    for key, color in (("pretrained", "#2563eb"), ("random", "#9ca3af")):
        a = result["probe"][key]["val_aurocs"]
        ax.plot(np.arange(1, len(a) + 1), a, color=color, lw=1.8, marker="o", ms=3.5,
                label=f"{key} encoder")
    ax.axhline(0.5, color="#ef4444", lw=0.8, ls="--", label="chance")
    ax.set_ylim(0.35, 1.03)
    ax.set_xlabel("probe epoch", color="#374151")
    ax.set_ylabel("val AUROC", color="#374151")
    ax.set_title("2. Frozen-encoder probe (class 0 vs 1)", fontsize=10)
    ax.legend(fontsize=8, frameon=False)
    ax = axes[2]
    names = ["pretrained", "random"]
    vals = [result["retrieval"][k]["mean_map"] for k in names]
    chance = result["retrieval"]["chance_map"]
    bars = ax.bar(names, vals, color=["#2563eb", "#9ca3af"], width=0.55)
    ax.axhline(chance, color="#ef4444", lw=0.8, ls="--", label=f"chance ≈ {chance:.3f}")
    for b, v in zip(bars, vals):
        ax.text(b.get_x() + b.get_width() / 2, v + 0.01, f"{v:.3f}", ha="center", fontsize=9)
    ax.set_ylim(0, 1.05)
    ax.set_ylabel(f"retrieval mAP ({K_CLASSES}-class)", color="#374151")
    ax.set_title("3. Same-class retrieval", fontsize=10)
    ax.legend(fontsize=8, frameon=False)
    for ax in axes:
        ax.grid(True, color="#e5e7eb", lw=0.6)
        for s in ("top", "right"):
            ax.spines[s].set_visible(False)
    fig.suptitle("MAE pretrain → transfer: frozen-probe + retrieval vs random-init control",
                 fontsize=11, y=1.02)
    fig.tight_layout()
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
    return path


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", choices=["tiny", "flagship"], default="tiny")
    ap.add_argument("--classifier", choices=["linear", "attentive"], default="linear")
    ap.add_argument("--pretrain-epochs", type=int, default=None)
    ap.add_argument("--pretrain-steps", type=int, default=None, help="steps per pretrain epoch")
    ap.add_argument("--pretrain-batch", type=int, default=None)
    ap.add_argument("--probe-epochs", type=int, default=None)
    ap.add_argument("--probe-steps", type=int, default=None)
    ap.add_argument("--probe-batch", type=int, default=None)
    ap.add_argument("--pool", type=int, default=None, help="pretrain corpus size")
    ap.add_argument("--device-pool", action="store_true",
                    help="hold the pools on the device (float16)")
    ap.add_argument("--out-prefix", default=None)
    ap.add_argument("--no-assert", action="store_true")
    ap.add_argument("--margin", type=float, default=0.1,
                    help="required pretrained-minus-random margin (AUROC and mAP)")
    ap.add_argument("--min-auroc", type=float, default=0.7,
                    help="required pretrained-probe best val AUROC")
    ap.add_argument("--reuse-ckpt", default=None,
                    help="skip pretraining and probe from this checkpoint")
    ap.add_argument("--probe-noise", type=float, default=None,
                    help="voxel noise of the probe and retrieval pools (default --noise)")
    ap.add_argument("--delta-deg", type=float, default=15.0,
                    help="class orientation separation in degrees (gratings)")
    ap.add_argument("--noise", type=float, default=0.08, help="per-voxel noise sigma")
    ap.add_argument("--probe-train", type=int, default=None,
                    help="probe train set size (few-shot: the total over 2 classes)")
    ap.add_argument("--corpus", choices=["templates", "gratings"], default="templates")
    ap.add_argument("--warp", type=float, default=0.12,
                    help="instance warp amplitude (a fraction of roi; templates)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def main(argv: Optional[List[str]] = None) -> dict:
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    tiny = args.scale == "tiny"
    # (pre_epochs, pre_steps, pre_batch, pr_epochs, pr_steps, pr_batch, pool)
    d = {"tiny": (4, 40, 16, 6, 25, 16, 128), "flagship": (10, 100, 32, 8, 30, 16, 256)}[args.scale]
    pre_epochs = args.pretrain_epochs or d[0]
    pre_steps = args.pretrain_steps or d[1]
    pre_batch = args.pretrain_batch or d[2]
    pr_epochs = args.probe_epochs or d[3]
    pr_steps = args.probe_steps or d[4]
    pr_batch = args.probe_batch or d[5]
    pool_n = args.pool or d[6]

    mae_cfg, probe_cfg = _cfgs(args.scale, args.classifier)
    roi = mae_cfg.MODEL.ROI[0]
    in_chans = mae_cfg.MODEL.IN_CHANS
    seed = 0

    t0 = time.time()
    # one class signature set (class_seed 0), disjoint instance seeds; a
    # few-shot probe train set, where feature quality decides
    print(f"[transfer] building corpora (roi={roi}, delta={args.delta_deg} deg, "
          f"noise={args.noise})", flush=True)
    gen = {"templates": make_template_class_pool, "gratings": make_hard_class_pool}[args.corpus]
    mk_kw = {"noise": args.noise, "delta_deg": args.delta_deg}
    if args.corpus == "templates":
        mk_kw["warp"] = args.warp
    mk = functools.partial(gen, **mk_kw)
    mk_probe = functools.partial(gen, **{**mk_kw, "noise": (
        args.probe_noise if args.probe_noise is not None else args.noise)})
    pre_pool = mk(pool_n, in_chans, roi, k_classes=K_CLASSES, seed=0, class_seed=0)
    n_probe_tr, n_probe_val, n_retr = (32, 64, 96) if tiny else (32, 96, 128)
    n_probe_tr = args.probe_train or n_probe_tr
    probe_tr = mk_probe(n_probe_tr, in_chans, roi, k_classes=2, seed=1, class_seed=0)
    probe_tr_y = (np.arange(n_probe_tr) % 2).astype(np.int32)
    probe_val = mk_probe(n_probe_val, in_chans, roi, k_classes=2, seed=2, class_seed=0)
    probe_val_y = (np.arange(n_probe_val) % 2).astype(np.int32)
    retr_pool = mk_probe(n_retr, in_chans, roi, k_classes=K_CLASSES, seed=3, class_seed=0)
    retr_y = (np.arange(n_retr) % K_CLASSES).astype(np.int32)

    prefix = args.out_prefix or str(STUDY_DIR / "transfer_mae")
    out_dir = os.path.dirname(os.path.abspath(prefix))
    launches: Dict[str, Dict] = {}
    t_stage = time.time()
    if args.reuse_ckpt:
        ckpt, pre_losses = args.reuse_ckpt, [float("nan")]
        print(f"[transfer] reusing checkpoint {ckpt}", flush=True)
    else:
        print(f"[transfer] pretraining MAE: {pre_epochs}x{pre_steps} steps @ batch {pre_batch}",
              flush=True)
        ckpt, pre_losses, launches["pretrain"] = pretrain_mae(
            mae_cfg, seed, pre_pool, pre_epochs, pre_steps, pre_batch, out_dir,
            device_pool=args.device_pool, device=device)
        print(f"[transfer] pretrain loss {pre_losses[0]:.4f} -> "
              f"{np.mean(pre_losses[-10:]):.4f}; ckpt {ckpt}", flush=True)
    stage_s = {"pretrain": round(time.time() - t_stage, 1)}

    retr_dev = (torch.from_numpy(retr_pool).to(device) if args.device_pool else None)
    probe: Dict[str, dict] = {}
    retr: Dict[str, dict] = {}
    for key, ck in (("pretrained", ckpt), ("random", None)):
        print(f"[transfer] probing ({key})", flush=True)
        t_stage = time.time()
        probe[key] = run_probe(probe_cfg, seed, ck, probe_tr, probe_tr_y, probe_val, probe_val_y,
                               pr_epochs, pr_steps, pr_batch, device_pools=args.device_pool,
                               device=device)
        launches[f"probe_{key}"] = probe[key].pop("launches")
        print(f"[transfer]   val AUROCs: {[round(a, 3) for a in probe[key]['val_aurocs']]}",
              flush=True)
        feats = extract_feats(probe_cfg, seed, ck, retr_pool, pr_batch, device_pool=retr_dev,
                              device=device)
        launches[f"extract_{key}"] = {"batches": feats.pop("batches"), **feats.pop("launches")}
        retr[key] = {kind: retrieval_scores(feats[kind], retr_y) for kind in feats}
        retr[key]["mean_map"] = retr[key]["mean"]["mean_map"]
        stage_s[key] = round(time.time() - t_stage, 1)
        print(f"[transfer]   retrieval mAP mean-token {retr[key]['mean']['mean_map']:.4f} / cls "
              f"{retr[key]['cls']['mean_map']:.4f}", flush=True)
    # chance mAP of same-class retrieval over K balanced classes: the
    # positives' share among the candidates
    retr["chance_map"] = float((n_retr / K_CLASSES - 1) / (n_retr - 1))

    result = {
        "scale": args.scale,
        "classifier": probe_cfg.TRAIN.CLASSIFIER,
        "k_classes": K_CLASSES,
        "pretrain": {
            "epochs": pre_epochs, "steps_per_epoch": pre_steps, "batch": pre_batch,
            "pool": pool_n, "start_loss": float(pre_losses[0]),
            "final_loss": float(np.mean(pre_losses[-10:])),
            "losses": [round(v, 5) for v in pre_losses],
        },
        "probe": probe,
        "probe_noise": args.probe_noise if args.probe_noise is not None else args.noise,
        "probe_train_shots": n_probe_tr,
        "retrieval": retr,
        "auroc_margin": round(probe["pretrained"]["best_val_auroc"]
                              - probe["random"]["best_val_auroc"], 4),
        "map_margin": round(retr["pretrained"]["mean_map"] - retr["random"]["mean_map"], 4),
        "wall_s": round(time.time() - t0, 1),
        "stage_s": stage_s,
        "backend": device.type,
        "device": device_info(device),
        "launches": launches,
    }
    result["png"] = save_png(result, prefix + ".png")
    write_json(prefix + ".json", result, indent=1)
    slim = {k: v for k, v in result.items() if k != "pretrain"}
    slim["pretrain_final_loss"] = result["pretrain"]["final_loss"]
    print(json.dumps(slim), flush=True)
    if not args.no_assert:
        assert result["auroc_margin"] > args.margin, (
            f"probe margin {result['auroc_margin']} <= {args.margin}: pretrained "
            f"{probe['pretrained']['best_val_auroc']:.3f} vs random "
            f"{probe['random']['best_val_auroc']:.3f}")
        assert result["map_margin"] > args.margin, (
            f"retrieval margin {result['map_margin']} <= {args.margin}: pretrained "
            f"{retr['pretrained']['mean_map']:.3f} vs random {retr['random']['mean_map']:.3f}")
        assert probe["pretrained"]["best_val_auroc"] > args.min_auroc, (
            probe["pretrained"], args.min_auroc)
        print("transfer assertions PASSED: pretraining produces useful representations",
              flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
