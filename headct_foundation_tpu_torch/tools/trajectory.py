"""Loss trajectories of the three engines' real epoch loops: the port's
counterpart of the JAX repository's ``tools/trajectory.py``.

    python -m headct_foundation_tpu_torch.tools.trajectory --engine mae \\
        --epochs 10 --steps-per-epoch 30 --batch 16 [--device cpu]
    python -m headct_foundation_tpu_torch.tools.trajectory --engine dino \\
        --epochs 10 --steps-per-epoch 25 --batch 8
    python -m headct_foundation_tpu_torch.tools.trajectory --engine downstream \\
        --epochs 10 --steps-per-epoch 25 --batch 8

Each run drives its engine's ``train_one_epoch`` (the CLIs' loop: schedule
indexing, the teacher's EMA and centre, batched loss reads, the
prefetcher) for a few hundred steps of the flagship recipe
(``configs/{mae/mae_HeadCT, dino/dino_HeadCT, downstream/vit_HeadCT_rsna}.yaml``,
random weights from ``SEED``) on synthetic structured volumes made from a
seed, and records every step's loss. The pretraining runs take the mains'
effective-LR rule (``BASE_LR x batch / 256``, ``MIN_LR = BASE_LR x 1e-3``);
the downstream run keeps its ``BASE_LR``. The checks, unless
``--no-assert``, are the JAX tool's (``:538-563``):

* every step's loss finite, at least epochs x steps of them;
* MAE: the mean of the last 15% of the losses below that of the first 15%;
* DINO: the first loss within 1.5 of ln(HEAD_N_PROTOTYPES) and the tail
  below ln K + 0.5;
* downstream: descent, and the last epoch's train AUROC above 0.85.

Artifacts: ``<prefix>.json`` and, where matplotlib imports, ``<prefix>.png``
(else the JSON's ``png`` is null); the prefix defaults to
``build/study/trajectory_<engine>`` in the repository (``--out-prefix``).
The JSON holds the JAX tool's fields, with ``device`` (the card's name and
power limit) and each kernel's launches over the run beside them.

The pools (``make_blob_pool``, ``make_object_pool``, ``make_class_pool``,
``make_labeled_pool``) and the loaders' index draws are the JAX tool's, bit
for bit; ``DevicePoolLoader`` and ``DevicePoolLabeledLoader``
(``--device-pool``, every engine; the JAX tool's DINO only) hold the pool
on the device in float16 and gather each batch there. ``run_mae``, ``run_dino`` and ``run_downstream``
take the step to drive (``train_step``, default the engine's), a hook that
sees the new state first (``on_state``), so a test can hand them another
framework's weights and draws, and the compute ``dtype`` (bfloat16, the
CLIs'). Runs on ``cuda`` unless ``--device cpu`` is given (without a card
it raises).
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from headct_foundation_tpu_torch.bench import ROOT, config_at, device_info
from headct_foundation_tpu_torch.feature_extraction import resolve_device

STUDY_DIR = ROOT / "build" / "study"
FLAGSHIP = {
    "mae": "configs/mae/mae_HeadCT.yaml",
    "dino": "configs/dino/dino_HeadCT.yaml",
    "downstream": "configs/downstream/vit_HeadCT_rsna.yaml",
}


class SyntheticLoader:
    """In-memory loader with the threaded loader's contract: yields
    (volumes, fnames) batches, supports set_epoch / __len__ / close."""

    def __init__(self, pool: np.ndarray, batch: int, steps: int, seed: int = 0):
        self.pool = pool
        self.batch = batch
        self.steps = steps
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.steps

    def close(self) -> None:
        pass

    def indices(self):
        """The batches' pool indices of this epoch (the JAX tool's draws)."""
        rng = np.random.RandomState(self.seed + self.epoch)
        for _ in range(self.steps):
            yield rng.randint(0, len(self.pool), size=self.batch)

    def __iter__(self):
        for idx in self.indices():
            yield self.pool[idx], [f"synthetic_{j}" for j in idx]


def make_blob_pool(n: int, in_chans: int, roi: int, seed: int = 0) -> np.ndarray:
    """Structured volumes: smooth random low-frequency fields in [0, 1],
    channel-correlated like the 3-window HU stack (learnable content, so
    descent means something)."""
    from scipy.ndimage import zoom

    rng = np.random.RandomState(seed)
    pool = np.empty((n, in_chans, roi, roi, roi), np.float16)
    for i in range(n):
        coarse = rng.rand(6, 6, 6).astype(np.float32)
        base = zoom(coarse, roi / 6.0, order=1)[:roi, :roi, :roi]
        base = (base - base.min()) / (base.max() - base.min() + 1e-6)
        chans = [base]
        while len(chans) < in_chans:
            k = len(chans)
            chans.append(np.clip(base * (1.0 + 0.4 * k) - 0.15 * k, 0.0, 1.0))
        pool[i] = np.stack(chans[:in_chans]).astype(np.float16)
    return pool


def make_object_pool(n: int, in_chans: int, roi: int, seed: int = 0) -> np.ndarray:
    """The blob pool plus 3-8 ellipsoidal structures per volume at their own
    positions, sizes and intensities: crop pairs of one volume share a
    constellation, an identity signal DINO can learn."""
    pool = make_blob_pool(n, in_chans, roi, seed=seed)
    rng = np.random.RandomState(seed + 7)
    ax = np.arange(roi, dtype=np.float32)
    for i in range(n):
        vol = pool[i].astype(np.float32)
        for _ in range(rng.randint(3, 9)):
            c = rng.uniform(0.15 * roi, 0.85 * roi, size=3)
            r = rng.uniform(roi / 16, roi / 5, size=3)
            amp = rng.uniform(-0.5, 0.8)
            d2 = (((ax[:, None, None] - c[0]) / r[0]) ** 2
                  + ((ax[None, :, None] - c[1]) / r[1]) ** 2
                  + ((ax[None, None, :] - c[2]) / r[2]) ** 2)
            vol = vol + amp * np.exp(-0.5 * d2)[None]
        pool[i] = np.clip(vol, 0.0, 1.0).astype(np.float16)
    return pool


def make_class_pool(n: int, in_chans: int, roi: int, k_classes: int = 8, seed: int = 0,
                    class_seed: Optional[int] = None) -> np.ndarray:
    """K latent classes with crop-invariant texture signatures: class k owns
    two low-frequency 3D gratings (its orientations and frequencies, from
    ``class_seed``), each sample renders them at random phases over a mild
    smooth background. Pools of one ``class_seed`` and different ``seed``
    share the classes and hold fresh samples."""
    from scipy.ndimage import zoom

    rng = np.random.RandomState(seed)
    ax = np.arange(roi, dtype=np.float32) / roi
    xx, yy, zz = ax[:, None, None], ax[None, :, None], ax[None, None, :]
    if class_seed is None:
        class_seed = seed
    gratings = []
    for k in range(k_classes):
        r1 = np.random.RandomState(class_seed + 100 + k)
        dirs = r1.randn(2, 3).astype(np.float32)
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        freqs = 2.0 + r1.permutation(8)[:2].astype(np.float32) / 2.0  # 2..5.5 cycles
        gratings.append((dirs, freqs))
    pool = np.empty((n, in_chans, roi, roi, roi), np.float16)
    for i in range(n):
        dirs, freqs = gratings[i % k_classes]
        vol = np.full((roi, roi, roi), 0.5, np.float32)
        for g in range(2):
            phase = rng.rand() * 2 * np.pi
            arg = 2 * np.pi * freqs[g] * (dirs[g, 0] * xx + dirs[g, 1] * yy + dirs[g, 2] * zz)
            vol = vol + 0.18 * np.sin(arg + phase)
        coarse = rng.rand(4, 4, 4).astype(np.float32) - 0.5
        vol = vol + 0.12 * zoom(coarse, roi / 4.0, order=1)[:roi, :roi, :roi]
        vol = np.clip(vol, 0.0, 1.0)
        chans = [vol]
        while len(chans) < in_chans:
            c = len(chans)
            chans.append(np.clip(vol * (1.0 + 0.4 * c) - 0.15 * c, 0.0, 1.0))
        pool[i] = np.stack(chans[:in_chans]).astype(np.float16)
    return pool


def make_labeled_pool(n: int, in_chans: int, roi: int, seed: int = 0):
    """(pool, labels): class 0 the blob pool, class 1 the same with a bright
    ellipsoid 'lesion' at a jittered central place, which a fine-tuned
    backbone and classifier must find."""
    pool = make_blob_pool(n, in_chans, roi, seed=seed)
    labels = (np.arange(n) % 2).astype(np.int32)
    rng = np.random.RandomState(seed + 1)
    ax = np.arange(roi, dtype=np.float32)
    for i in np.nonzero(labels)[0]:
        c = roi / 2.0 + rng.uniform(-roi / 6, roi / 6, size=3)
        r = roi / 5.0
        d2 = ((ax[:, None, None] - c[0]) ** 2 + (ax[None, :, None] - c[1]) ** 2
              + (ax[None, None, :] - c[2]) ** 2)
        blob = np.exp(-d2 / (2 * r * r)).astype(np.float16)
        pool[i] = np.clip(pool[i] + 0.6 * blob[None], 0.0, 1.0)
    return pool, labels


class DevicePoolLoader(SyntheticLoader):
    """``SyntheticLoader`` with its pool held on ``device`` in float16: each
    batch is gathered there (``index_select``), so no host-to-device copy
    sits in the step loop."""

    def __init__(self, pool: np.ndarray, batch: int, steps: int, seed: int = 0,
                 device=None):
        super().__init__(pool, batch, steps, seed)
        self.device = resolve_device(device)
        self.pool_dev = torch.from_numpy(np.asarray(pool, np.float16)).to(self.device)

    def __iter__(self):
        for idx in self.indices():
            rows = torch.from_numpy(idx).to(self.device)
            yield self.pool_dev.index_select(0, rows), [f"synthetic_{j}" for j in idx]


class SyntheticLabeledLoader:
    """The downstream loaders' contract: yields (volumes, targets, fnames)."""

    def __init__(self, pool, labels, batch, steps, seed=0):
        self.pool = pool
        self.labels = labels
        self.batch = batch
        self.steps = steps
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.steps

    def close(self) -> None:
        pass

    def indices(self):
        rng = np.random.RandomState(self.seed + self.epoch)
        for _ in range(self.steps):
            yield rng.randint(0, len(self.pool), size=self.batch)

    def __iter__(self):
        for idx in self.indices():
            yield self.pool[idx], self.labels[idx], [f"synthetic_{j}" for j in idx]


class DevicePoolLabeledLoader(SyntheticLabeledLoader):
    """``SyntheticLabeledLoader`` with its volumes held on the device in
    float16, each batch gathered there."""

    def __init__(self, pool, labels, batch, steps, seed=0, device=None):
        super().__init__(pool, labels, batch, steps, seed)
        self.pool_dev = torch.from_numpy(np.asarray(pool, np.float16)).to(resolve_device(device))

    def __iter__(self):
        for idx in self.indices():
            rows = torch.from_numpy(idx).to(self.pool_dev.device)
            yield (self.pool_dev.index_select(0, rows), self.labels[idx],
                   [f"synthetic_{j}" for j in idx])


class RecordingRun:
    """A wandb run's stand-in: records the engines' per-step log calls, and
    the kernels' launches of the epochs ``add_launches`` is given."""

    def __init__(self):
        self.losses: List[float] = []
        self.lrs: List[float] = []
        self.launches: Dict[str, int] = {}

    def log(self, d):
        if "Training Loss" in d:
            self.losses.append(float(d["Training Loss"]))
        if "Training lr" in d:
            self.lrs.append(float(d["Training lr"]))

    def add_launches(self, launches: Dict[str, int]) -> None:
        for k, v in launches.items():
            self.launches[k] = self.launches.get(k, 0) + int(v)


def _flagship(engine: str):
    return config_at(FLAGSHIP[engine])


def apply_lr_rule(cfg, engine: str, batch: int):
    """The pretrain mains' effective-LR rule: ``BASE_LR x batch / 256``
    (running the batch-256 LR at batch 8 collapses DINO to the uniform
    ln K point); the downstream main keeps ``BASE_LR``. ``MIN_LR`` is
    ``BASE_LR x 1e-3`` either way."""
    if engine != "downstream":
        cfg.TRAIN.BASE_LR = cfg.TRAIN.BASE_LR * batch / 256
    cfg.TRAIN.MIN_LR = cfg.TRAIN.BASE_LR * 1e-3
    return cfg


def run_mae(cfg, epochs: int, steps: int, batch: int, accum: int, seed: int, pool,
            device=None, train_step: Optional[Callable] = None,
            on_state: Optional[Callable] = None, dtype: torch.dtype = torch.bfloat16,
            device_pool: bool = False) -> RecordingRun:
    """The MAE epoch loop with augmentation over ``pool``; ``dtype`` is the
    compute dtype (bfloat16, the CLI's), ``device_pool`` holds the pool on
    the device (``DevicePoolLoader``)."""
    from headct_foundation_tpu_torch.engines import mae_engine

    device = resolve_device(device)
    total = epochs * steps
    state, _ = mae_engine.create_train_state(
        cfg, total, int(cfg.TRAIN.PER_WARMUP * total), seed=seed, dtype=dtype, device=device)
    if on_state is not None:
        on_state(state)
    train_step = train_step or mae_engine.make_train_step(augment=True, accum_steps=accum,
                                                          config=cfg)
    loader = (DevicePoolLoader(pool, batch, steps, device=device) if device_pool
              else SyntheticLoader(pool, batch, steps))
    rec = RecordingRun()
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        state, stats = mae_engine.train_one_epoch(cfg, state, train_step, loader, seed, epoch,
                                                  epochs, wandb_run=rec)
        rec.add_launches(stats["launches"])
    return rec


def run_dino(cfg, epochs: int, steps: int, batch: int, seed: int, pool, accum: int = 1,
             device_pool: bool = False, sched_epochs: Optional[int] = None,
             on_epoch: Optional[Callable] = None, device=None,
             train_step: Optional[Callable] = None, on_state: Optional[Callable] = None,
             dtype: torch.dtype = torch.bfloat16) -> RecordingRun:
    """The DINO epoch loop over ``pool``. ``sched_epochs``: every schedule
    (LR warm-up and cosine, the weight decay ramp, the teacher's momentum
    and temperature) is built over that longer horizon and only the first
    ``epochs`` run ("the first N steps of the recipe"), so a short run does
    not squeeze the 0.04 -> 0.4 weight decay ramp into a few hundred steps,
    which pins the loss at the uniform ln K."""
    from headct_foundation_tpu_torch.engines import dino_engine

    device = resolve_device(device)
    if accum > 1:
        cfg.defrost()
        cfg.TRAIN.ACCUM_STEPS = accum  # the step takes micro-batches of B / accum
        cfg.freeze()
    horizon = (sched_epochs or epochs) * steps
    state = dino_engine.create_train_state(cfg, horizon, int(cfg.TRAIN.PER_WARMUP * horizon),
                                           niter_per_ep=steps, seed=seed, dtype=dtype,
                                           device=device)
    if on_state is not None:
        on_state(state)
    train_step = train_step or dino_engine.make_train_step(cfg)
    loader = (DevicePoolLoader(pool, batch, steps, device=device) if device_pool
              else SyntheticLoader(pool, batch, steps))
    rec = RecordingRun()
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        state, stats = dino_engine.train_one_epoch(cfg, state, train_step, loader, seed, epoch,
                                                   sched_epochs or epochs, wandb_run=rec)
        rec.add_launches(stats["launches"])
        if on_epoch is not None:
            on_epoch(epoch, rec)
    return rec


def run_downstream(cfg, epochs: int, steps: int, batch: int, seed: int, pool, labels,
                   device=None, train_step: Optional[Callable] = None,
                   on_state: Optional[Callable] = None, dtype: torch.dtype = torch.bfloat16,
                   device_pool: bool = False) -> RecordingRun:
    """Fine-tune the downstream recipe (random-init backbone, AdamW with the
    classifier at 100 x the LR) on the labeled pool (on the device with
    ``device_pool``); records each step's loss and each epoch's train AUROC
    (``epoch_aurocs``)."""
    from headct_foundation_tpu_torch.engines import downstream_engine

    device = resolve_device(device)
    total = epochs * steps
    state = downstream_engine.create_train_state(
        cfg, total, int(cfg.TRAIN.PER_WARMUP * total), seed=seed, dtype=dtype, device=device)
    if on_state is not None:
        on_state(state)
    train_step = train_step or downstream_engine.make_train_step(cfg, compute_dtype=dtype)
    loader = (DevicePoolLabeledLoader(pool, labels, batch, steps, device=device) if device_pool
              else SyntheticLabeledLoader(pool, labels, batch, steps))
    rec = RecordingRun()
    aurocs = []
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        state, stats = downstream_engine.train_one_epoch(cfg, state, train_step, loader, seed,
                                                         epoch, epochs, wandb_run=rec)
        rec.add_launches(stats["launches"])
        aurocs.append(float(stats.get("mean_auroc", float("nan"))))
    rec.epoch_aurocs = aurocs
    return rec


def save_png(losses, path, title) -> Optional[str]:
    """The loss curve as a PNG at ``path``; None (no file) without matplotlib."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 3.5), dpi=120)
    ax.plot(np.arange(1, len(losses) + 1), losses, color="#2563eb", lw=1.5)
    ax.set_xlabel("optimizer step", color="#374151")
    ax.set_ylabel("training loss", color="#374151")
    ax.set_title(title, color="#111827", fontsize=11)
    ax.grid(True, color="#e5e7eb", lw=0.6)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path


def write_json(path: str, obj: Any, indent: Optional[int] = None) -> None:
    """``obj`` as JSON at ``path``, atomically (a timeout cannot truncate it)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path + ".tmp", "w") as f:
        json.dump(obj, f, indent=indent)
    os.replace(path + ".tmp", path)


def _write_artifacts(args, rec: RecordingRun, cfg, wall: float, device: torch.device,
                     partial: bool = False):
    """The JAX tool's summary (``_write_artifacts``), with the device, its
    type as ``backend``, the launches and the PNG's path, as
    ``<prefix>.json``, and the curve as ``<prefix>.png``; returns (summary,
    losses, head mean, tail mean)."""
    losses = rec.losses
    n = len(losses)
    k = max(1, int(0.15 * n))
    head, tail = float(np.mean(losses[:k])), float(np.mean(losses[-k:]))
    summary = {
        "engine": args.engine,
        "steps": n,
        "batch": args.batch,
        "accum": args.accum,
        "epochs": args.epochs,
        "sched_epochs": getattr(args, "sched_epochs", None),
        "pool_style": getattr(args, "pool_style", None),
        "partial": partial,
        "start_loss": losses[0] if losses else None,
        "head_mean": head,
        "tail_mean": tail,
        "descended": tail < head,
        "min_loss": float(np.min(losses)) if losses else None,
        "wall_s": round(wall, 1),
        "backend": device.type,
        "device": device_info(device),
        "launches": dict(rec.launches),
        "losses": [round(v, 5) for v in losses],
        "lrs": [float(v) for v in rec.lrs[:: max(1, n // 50)]],
    }
    if getattr(rec, "epoch_aurocs", None) is not None:
        summary["epoch_aurocs"] = [round(a, 4) for a in rec.epoch_aurocs]
    if args.engine == "dino" and losses:
        ln_k = float(np.log(cfg.DINO.HEAD_N_PROTOTYPES))
        summary["ln_k"] = ln_k
        summary["frac_steps_below_lnk_minus_1"] = float(np.mean(np.asarray(losses) < ln_k - 1.0))
    prefix = args.out_prefix or str(STUDY_DIR / f"trajectory_{args.engine}")
    os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
    summary["png"] = save_png(
        losses, prefix + ".png",
        f"{args.engine.upper()} training loss — {n} steps, batch {args.batch} "
        f"({summary['device']['name']})")
    write_json(prefix + ".json", summary)
    return summary, losses, head, tail


def check(args, rec: RecordingRun, cfg, head: float, tail: float) -> None:
    """The JAX tool's assertions (``:538-563``)."""
    losses = rec.losses
    n = len(losses)
    assert n >= args.epochs * args.steps_per_epoch, n
    assert all(np.isfinite(losses)), "non-finite loss"
    if args.engine in ("mae", "downstream"):
        assert tail < head, f"no descent: head={head:.4f} tail={tail:.4f}"
    if args.engine == "downstream":
        # the classifier must learn the lesion, not only shrink the loss
        final_auroc = rec.epoch_aurocs[-1]
        assert final_auroc > 0.85, f"final train AUROC {final_auroc:.3f}"
    if args.engine == "dino":
        # at the batch-scaled LR a few hundred steps show the recipe's early
        # shape: a start near ln K, then bounded near it
        expected = float(np.log(cfg.DINO.HEAD_N_PROTOTYPES))
        assert abs(losses[0] - expected) < 1.5, f"start {losses[0]:.3f} vs ln(K)={expected:.3f}"
        assert tail < expected + 0.5, f"diverged above ln(K): tail={tail:.4f}"


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--engine", choices=["mae", "dino", "downstream"], required=True)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--steps-per-epoch", type=int, default=30)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--accum", type=int, default=1,
                    help="gradient-accumulation micro-steps (MAE and DINO)")
    ap.add_argument("--pool", type=int, default=64, help="distinct volumes")
    ap.add_argument("--device-pool", action="store_true",
                    help="hold the volume pool on the device (float16), no host gather "
                    "or copy in the step loop")
    ap.add_argument("--pool-style", choices=["blobs", "objects", "classes"], default="blobs",
                    help="'objects' adds per-volume ellipsoid constellations; 'classes' "
                    "gives K latent classes crop-invariant textures (the DINO positive "
                    "control)")
    ap.add_argument("--classes", type=int, default=8, help="latent classes of --pool-style classes")
    ap.add_argument("--sched-epochs", type=int, default=None,
                    help="DINO: build the schedules over this many epochs and run only "
                    "--epochs of them")
    ap.add_argument("--out-prefix", default=None)
    ap.add_argument("--no-assert", action="store_true")
    ap.add_argument("--opts", nargs="*", default=[],
                    help="config overrides, KEY VALUE pairs (the mains' --opts)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def main(argv: Optional[List[str]] = None) -> dict:
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = _flagship(args.engine)
    if args.opts:
        cfg.merge_from_list(args.opts)
    apply_lr_rule(cfg, args.engine, args.batch)
    roi = cfg.MODEL.ROI[0]
    in_chans = cfg.MODEL.IN_CHANS
    seed = int(cfg.SEED)
    pool_fn = {
        "blobs": make_blob_pool,
        "objects": make_object_pool,
        "classes": functools.partial(make_class_pool, k_classes=args.classes),
    }[args.pool_style]
    t0 = time.time()
    if args.engine == "mae":
        pool = pool_fn(args.pool, in_chans, roi)
        rec = run_mae(cfg, args.epochs, args.steps_per_epoch, args.batch, args.accum, seed, pool,
                      device=device, device_pool=args.device_pool)
    elif args.engine == "dino":
        pool = pool_fn(args.pool, in_chans, roi)

        def flush(epoch, rec):  # a long run leaves a usable artifact at a timeout
            _write_artifacts(args, rec, cfg, time.time() - t0, device, partial=True)

        rec = run_dino(cfg, args.epochs, args.steps_per_epoch, args.batch, seed, pool,
                       accum=args.accum, device_pool=args.device_pool,
                       sched_epochs=args.sched_epochs, on_epoch=flush, device=device)
    else:
        pool, labels = make_labeled_pool(args.pool, in_chans, roi)
        rec = run_downstream(cfg, args.epochs, args.steps_per_epoch, args.batch, seed, pool,
                             labels, device=device, device_pool=args.device_pool)
    summary, losses, head, tail = _write_artifacts(args, rec, cfg, time.time() - t0, device)
    print(json.dumps({k: v for k, v in summary.items() if k != "losses"}), flush=True)
    if not args.no_assert:
        check(args, rec, cfg, head, tail)
        print("trajectory assertions PASSED", flush=True)
    return summary


if __name__ == "__main__":
    main(sys.argv[1:])
