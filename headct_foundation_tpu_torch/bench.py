"""The MAE pretrain step's rate and the feature path's latency on the card:
the port's counterpart of the repository's root ``bench.py``.

    python -m headct_foundation_tpu_torch.bench [--compute-only | --model-only |
        --with-loader | --feature-latency | --feature-throughput] [--device cpu]
        [--set KEY VALUE ...]

The step is the flagship recipe (``configs/mae/mae_HeadCT.yaml``: ViT-B/12
encoder, 8-block decoder, 96^3, patch 12, 3 channels, mask 0.75) at
``BATCH_PER_GPU`` volumes on the hu16 wire (int16 HU, windowed on the card
inside the step), random weights from seed 42. Modes, each printing one
JSON line:

* ``--compute-only``: THE production step object, built by the MAE CLI's
  own ``main_pretrain_mae.make_train_step`` (augmentation and the wire cast
  inside). ``CHAIN_STEPS`` steps are queued back to back with no host sync
  and the last loss is read with ``.item()``; the best of ``MEASURE_RUNS``
  such chains gives the rate. The state carries from step to step, so the
  steps run in order. No CUDA graph.
* ``--model-only``: a hand-rolled loss loop on a bfloat16 batch, no
  augmentation and no wire cast (``model_step``).
* ``--with-loader``: the packed cache (``PackedCacheWriter``) ->
  ``ThreadedLoader`` -> ``DevicePrefetcher`` -> the step, after a warm
  epoch; with the host-only loader rates at 4, 16 and 16 uncapped workers
  (``HEADCT_LOADER_MAX_WORKERS``), the share of the timed window the loop
  waits on its input, and the host-to-device rate
  (``data/pipeline.py measure_h2d_mbps``) before and after.
* ``--feature-latency``: the p50 time of one NIfTI scan to its CLS
  embedding (``FeatureExtractor``, ViT-B/12 float32, the notebook-order
  ``DevicePreprocessor``), split as decode / h2d / device / dispatch_fetch.
* ``--feature-throughput``: ``extract_from_files`` over 16 scans, batch 4.
* The default runs compute-only, model-only, with-loader and the feature
  latency, and prints them in one line. A failing mode fails the run.

Every line names the device it ran on (``device``: the card's name and
power limit, or the CPU) and the kernels' launches over its timed window.
``vs_baseline`` is against the reference's 3.1 volumes/s/GPU (BASELINE.md).
Runs on ``cuda`` unless ``--device cpu`` is given (without a card it
raises).

Across cards (the root ``bench.py``'s ``make_mesh(data=n_chips)``):
``torchrun --nproc_per_node N -m headct_foundation_tpu_torch.bench
--compute-only`` runs one process per card (``parallel/distributed.py``,
NCCL; gloo with ``--device cpu``). Rank 0 first times the step alone, the
other ranks waiting to join; then every rank times the CLI's step at
``BATCH_PER_GPU`` volumes with the gradient average over ``DATA N`` that
the CLI runs. Rank 0 prints one line: ``n_gpus``, ``value`` (the mean of
the ranks' rates, volumes/s/GPU, as the root bench reports a chip's),
``summed`` (their sum), ``per_rank``, ``one_card`` (rank 0's rate alone)
and ``per_card_vs_one`` (``value / one_card``). As one process (or
``torchrun`` of one) the line is the one-process line.
"""

from __future__ import annotations

import argparse
import csv
import json
import math
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from headct_foundation_tpu_torch.config import default_config
from headct_foundation_tpu_torch.engines import mae_engine
from headct_foundation_tpu_torch.feature_extraction import resolve_device

ROOT = Path(__file__).resolve().parent.parent
FLAGSHIP = "configs/mae/mae_HeadCT.yaml"
REFERENCE_VOLS_PER_SEC_PER_GPU = 3.1  # BASELINE.md: the reference's DINO run on A100s
BATCH_PER_GPU = 32
CHAIN_STEPS = 30
MEASURE_RUNS = 3
SEED = 42


def config_at(path: str, overrides: Sequence = ()):
    """The recipe at ``path`` (from the repository root), ``overrides`` (KEY,
    VALUE pairs) merged last."""
    cfg = default_config()
    cfg.merge_from_file(str(ROOT / path))
    cfg.merge_from_list(list(overrides))
    return cfg


def flagship_config(overrides: Sequence = ()):
    """The flagship MAE recipe on the hu16 wire, ``overrides`` merged last."""
    return config_at(FLAGSHIP, ["TRAIN.GRAD_CLIP", 0.0, "DATA.WIRE_FORMAT", "hu16", *overrides])


def wire_batch(cfg, n: int, seed: int = 0) -> np.ndarray:
    """n volumes in the config's wire format: hu16 [n, 1, roi] int16 HU, else
    windowed [n, C, roi] float16 in [0, 1]."""
    rng = np.random.RandomState(seed)
    roi = tuple(int(r) for r in cfg.MODEL.ROI)
    if str(cfg.DATA.WIRE_FORMAT) == "hu16":
        return rng.randint(-1000, 2800, size=(n, 1) + roi).astype(np.int16)
    return rng.rand(n, int(cfg.MODEL.IN_CHANS), *roi).astype(np.float16)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_info(device: torch.device) -> Dict[str, Any]:
    """The card's name and power limit (``nvidia-smi``), or the CPU."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    from headct_foundation_tpu_torch.tools.cli_runs import card_lines

    index = device.index if device.index is not None else torch.cuda.current_device()
    return {"name": torch.cuda.get_device_name(index),
            "power_limit": card_lines()[index].rsplit(",", 1)[-1].strip()}


def per_gpu(device: torch.device, vols_per_s: float) -> Dict[str, Any]:
    """``value``, ``unit`` and ``vs_baseline`` of a rate; the baseline is per
    GPU, so a CPU run has none."""
    cuda = device.type == "cuda"
    return {"value": vols_per_s, "unit": "volumes/s/GPU" if cuda else "volumes/s/CPU",
            "vs_baseline": vols_per_s / REFERENCE_VOLS_PER_SEC_PER_GPU if cuda else None}


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    """The kernels' launches since ``before`` (``mae_engine.kernel_launches()``)."""
    return {k: v - before[k] for k, v in mae_engine.kernel_launches().items()}


def chained(step_once: Callable[[Any], tuple], state: Any, k: int) -> Callable[[], torch.Tensor]:
    """run() queues ``k`` steps ``state, metrics = step_once(state)`` with no
    host sync, the state carried from each to the next, and returns the last
    step's loss as a device scalar."""
    holder = [state]

    def run() -> torch.Tensor:
        for _ in range(k):
            holder[0], metrics = step_once(holder[0])
        return metrics["loss"]

    return run


def best_of(run: Callable[[], torch.Tensor], runs: int, device: torch.device) -> Dict[str, Any]:
    """One warm call of ``run`` (kernels built, allocator settled), then the
    best host time of ``runs`` timed calls, each read to the end with
    ``.item()``; with the last loss, the warm call's and the launches over
    the timed calls. Raises on a loss that is not finite."""
    warm = float(run().item())
    before = mae_engine.kernel_launches()
    best = float("inf")
    for _ in range(runs):
        sync(device)
        t0 = time.perf_counter()
        loss = float(run().item())
        best = min(best, time.perf_counter() - t0)
    launches = launches_since(before)
    if not (math.isfinite(warm) and math.isfinite(loss)):
        raise RuntimeError(f"a loss is not finite: warm {warm}, last {loss}")
    return {"seconds": best, "loss": loss, "warm_loss": warm, "launches": launches}


def step_bench(metric: str, step_once: Callable[[Any], tuple], state: Any, batch: int,
               steps: int, runs: int, device: torch.device, **extra) -> Dict[str, Any]:
    """One engine step's line: ``steps`` chained steps ``step_once(state)``,
    the best of ``runs`` (``best_of``), as volumes/s and ms per step."""
    got = best_of(chained(step_once, state, steps), runs, device)
    per_step = got["seconds"] / steps
    return {"metric": metric, "batch_per_gpu": batch, **extra, **per_gpu(device, batch / per_step),
            "ms_per_step": per_step * 1e3, "final_loss": got["loss"],
            "device": device_info(device), "launches": got["launches"],
            "timed_steps": runs * steps}


def cli_state(cfg, device: torch.device, dtype: torch.dtype = torch.bfloat16):
    """The MAE train state from seed ``SEED`` (bfloat16 compute)."""
    return mae_engine.create_train_state(cfg, 10_000, 100, seed=SEED, dtype=dtype,
                                         device=device)[0]


def compute_only(cfg=None, device=None, batch: int = BATCH_PER_GPU, steps: int = CHAIN_STEPS,
                 runs: int = MEASURE_RUNS, check_chain: bool = False) -> Dict[str, Any]:
    """The production step's rate. With ``check_chain``, the same ``steps``
    steps are first called one by one from the seed state (each loss read
    before the next step), and the warm chain (the first ``steps`` chained
    steps from the seed state) must end on the same loss within 1e-6
    relative."""
    from headct_foundation_tpu_torch import main_pretrain_mae

    cfg = cfg if cfg is not None else flagship_config()
    device = resolve_device(device)
    wire = torch.from_numpy(wire_batch(cfg, batch)).to(device)
    step = main_pretrain_mae.make_train_step(cfg)
    single = None
    if check_chain:
        state = cli_state(cfg, device)
        for _ in range(steps):
            state, metrics = step(state, wire, SEED)
            single = float(metrics["loss"].item())
        del state
    state = cli_state(cfg, device)
    got = best_of(chained(lambda s: step(s, wire, SEED), state, steps), runs, device)
    out = {"metric": "volumes/sec/GPU (MAE 3D pretrain step)",
           **per_gpu(device, batch * steps / got["seconds"]),
           "wire_format": str(cfg.DATA.WIRE_FORMAT), "device": device_info(device),
           "batch_per_gpu": batch, "chained_steps": steps, "runs": runs,
           "ms_per_step": got["seconds"] / steps * 1e3, "final_loss": got["loss"],
           "launches": got["launches"], "timed_steps": runs * steps}
    if check_chain:
        rel = abs(got["warm_loss"] - single) / max(abs(single), 1e-30)
        out["chain_check"] = {"chained_loss": got["warm_loss"], "single_loss": single,
                              "rel": rel}
        if not rel <= 1e-6:
            raise RuntimeError(f"{steps} chained steps end on loss {got['warm_loss']}, the same "
                               f"steps one by one on {single} (relative {rel:.3e} > 1e-6)")
    return out


def model_step(state, batch: torch.Tensor, seed: int,
               noise: Optional[torch.Tensor] = None) -> tuple:
    """One hand-rolled MAE update: the mask noise of update ``state.step``
    (or ``noise``), the loss, its backward and the optimizer update; no
    augmentation, no wire cast."""
    model = state.model
    model.train()
    if noise is None:
        g = mae_engine.step_generator(batch.device, seed, state.step, 0)
        noise = torch.rand((batch.shape[0], int(np.prod(model.grid_size))), generator=g,
                           device=batch.device)
    loss, _, _ = model(batch, noise=noise)
    loss.backward()
    return mae_engine.apply_update(state), {"loss": loss.detach()}


def model_only(cfg=None, device=None, batch: int = BATCH_PER_GPU, steps: int = CHAIN_STEPS,
               runs: int = MEASURE_RUNS) -> Dict[str, Any]:
    """The hand-rolled loss loop's rate on a bfloat16 batch [B, C, roi]."""
    cfg = cfg if cfg is not None else flagship_config()
    device = resolve_device(device)
    roi = tuple(int(r) for r in cfg.MODEL.ROI)
    vols = mae_engine.to_device_batch(np.random.RandomState(0).randn(
        batch, int(cfg.MAE.IN_CHANS), *roi).astype(np.float32), device)
    state = cli_state(cfg, device)
    got = best_of(chained(lambda s: model_step(s, vols, SEED), state, steps), runs, device)
    return {**per_gpu(device, batch * steps / got["seconds"]),
            "ms_per_step": got["seconds"] / steps * 1e3, "final_loss": got["loss"],
            "launches": got["launches"], "timed_steps": runs * steps,
            "note": "hand-rolled loss loop (no augment, no wire cast)"}


def write_packed_cache(cfg, cache_dir: str, n: int, seed: int = 0) -> tuple:
    """``n`` random wire volumes in a packed cache at ``cache_dir`` under the
    keys the loaders look up, and their manifest (written with ``csv``);
    returns (manifest path, wire bytes per volume)."""
    from headct_foundation_tpu_torch.data.datasets import DiskCache, PackedCacheWriter

    wire = str(cfg.DATA.WIRE_FORMAT)
    cache = DiskCache(cache_dir, cfg.MODEL.ROI, int(cfg.MODEL.IN_CHANS), wire=wire)
    rng = np.random.RandomState(seed)
    paths = [f"/synthetic/vol{i:05d}.nii.gz" for i in range(n)]
    dtype = np.int16 if wire == "hu16" else np.float16
    with PackedCacheWriter(cache_dir, cache.wire_shape, dtype=dtype) as w:
        for p in paths:
            if wire == "hu16":
                w.add(cache.key(p), rng.randint(-8000, 20000, size=cache.wire_shape).astype(dtype))
            else:
                w.add(cache.key(p), rng.rand(*cache.wire_shape).astype(dtype))
    manifest = os.path.join(cache_dir, "manifest.csv")
    with open(manifest, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["img_path"])
        writer.writerows([p] for p in paths)
    return manifest, int(np.prod(cache.wire_shape)) * np.dtype(dtype).itemsize


def with_loader(cfg=None, device=None, batch: int = BATCH_PER_GPU, epochs: int = 4,
                warm_epochs: int = 1, steps_per_epoch: int = 8, host_epochs: int = 3,
                workdir: Optional[str] = None) -> Dict[str, Any]:
    """The step fed by the production input path at cache-hit steady state:
    every volume a packed-cache hit. ``epochs`` epochs of ``steps_per_epoch``
    steps, the first ``warm_epochs`` untimed; the host-only loader rate of
    each worker count over ``host_epochs`` epochs after a warm one."""
    from headct_foundation_tpu_torch import main_pretrain_mae
    from headct_foundation_tpu_torch.data.datasets import (
        PretrainDataset,
        ThreadedLoader,
        distributed_indices,
    )
    from headct_foundation_tpu_torch.data.pipeline import DevicePrefetcher, measure_h2d_mbps

    if not 1 <= warm_epochs < epochs:
        raise ValueError(f"need 1 <= warm_epochs < epochs, got {warm_epochs}, {epochs}")
    cfg = cfg if cfg is not None else flagship_config()
    device = resolve_device(device)
    n_files = steps_per_epoch * batch
    tmpd = tempfile.mkdtemp(prefix="headct_bench_cache_", dir=workdir)
    datasets: List[Any] = []
    try:
        manifest, vol_bytes = write_packed_cache(cfg, tmpd, n_files)

        def loader(workers: int) -> ThreadedLoader:
            ds = PretrainDataset(cfg, manifest, cache_dir=tmpd, device=device)
            datasets.append(ds)
            return ThreadedLoader(ds, batch_size=batch, num_workers=workers,
                                  indices_fn=lambda epoch: distributed_indices(n_files, 0, 1,
                                                                               False))

        host_rates: Dict[str, float] = {}
        effective: Dict[str, int] = {}
        for label in ("4", "16", "16_uncapped"):
            prev = os.environ.get("HEADCT_LOADER_MAX_WORKERS")
            if label == "16_uncapped":
                os.environ["HEADCT_LOADER_MAX_WORKERS"] = "16"
            try:
                ld = loader(int(label.split("_")[0]))
            finally:
                if label == "16_uncapped":
                    if prev is None:
                        os.environ.pop("HEADCT_LOADER_MAX_WORKERS", None)
                    else:
                        os.environ["HEADCT_LOADER_MAX_WORKERS"] = prev
            effective[label] = ld.num_workers
            try:
                ld.set_epoch(0)
                for _ in ld:  # warm: the page cache and the pool
                    pass
                t0 = time.perf_counter()
                n = 0
                for ep in range(1, host_epochs + 1):
                    ld.set_epoch(ep)
                    n += sum(1 for _ in ld)
                host_rates[label] = n * batch / (time.perf_counter() - t0)
            finally:
                ld.close()

        h2d_pre = measure_h2d_mbps(device) if device.type == "cuda" else None
        ld = loader(8)
        state = cli_state(cfg, device)
        step = main_pretrain_mae.make_train_step(cfg)
        pending: List[torch.Tensor] = []
        final_loss = float("nan")
        t0 = None
        timed_vols, input_wait, launches = 0, 0.0, None
        try:
            for epoch in range(epochs):
                ld.set_epoch(epoch)
                it = iter(DevicePrefetcher(ld, device, depth=3))
                while True:
                    tw = time.perf_counter()
                    item = next(it, None)
                    if item is None:
                        break
                    if t0 is not None:
                        input_wait += time.perf_counter() - tw
                    if len(pending) >= mae_engine.LOSS_FLUSH:  # batched loss reads
                        final_loss = float(torch.stack(pending)[-1].item())
                        pending = []
                    state, metrics = step(state, mae_engine.to_device_batch(item[0], device), SEED)
                    pending.append(metrics["loss"])
                    if t0 is not None:
                        timed_vols += batch
                if epoch == warm_epochs - 1:
                    if pending:
                        final_loss = float(torch.stack(pending)[-1].item())
                        pending = []
                    sync(device)
                    before = mae_engine.kernel_launches()
                    t0 = time.perf_counter()
            if pending:
                final_loss = float(torch.stack(pending)[-1].item())
            sync(device)
            dt = time.perf_counter() - t0
            launches = launches_since(before)
        finally:
            ld.close()
        if not math.isfinite(final_loss):
            raise RuntimeError(f"the loader-in-the-loop loss is not finite: {final_loss}")
        h2d_post = measure_h2d_mbps(device) if device.type == "cuda" else None
    finally:
        shutil.rmtree(tmpd, ignore_errors=True)

    rate = timed_vols / dt
    out = {**per_gpu(device, rate), "input_wait_frac": input_wait / dt,
           "host_loader_vols_per_s_by_workers": host_rates,
           "host_loader_effective_workers": effective, "packed_cache": True,
           "wire_format": str(cfg.DATA.WIRE_FORMAT), "wire_MB_per_vol": vol_bytes / 1e6,
           "placeholders": sum(ds.placeholders for ds in datasets), "final_loss": final_loss,
           "launches": launches, "timed_steps": (epochs - warm_epochs) * steps_per_epoch,
           "h2d_MB_per_s": None, "h2d_MB_per_s_pre": h2d_pre, "h2d_MB_per_s_post": h2d_post,
           "h2d_bound_vols_per_s": None, "frac_of_h2d_roofline": None, "h2d_probe_swing": None}
    if h2d_pre is not None:
        best = max(h2d_pre, h2d_post)
        bound = best * 1e6 / vol_bytes
        out.update(h2d_MB_per_s=best, h2d_bound_vols_per_s=bound,
                   frac_of_h2d_roofline=rate / bound,
                   h2d_probe_swing=best / max(min(h2d_pre, h2d_post), 1e-9))
    return out


def synth_scans(workdir: str, n: int, shape=(220, 220, 140),
                spacing=(0.5, 0.5, 1.25)) -> List[str]:
    """``n`` head phantoms (air, a skull shell, brain tissue with noise;
    integral HU stored as int16, as real CT) at a realistic CT grid, written
    as ``.nii.gz``."""
    from headct_foundation_tpu_torch.data.nifti import save_nifti

    rng = np.random.RandomState(0)
    grid = np.ogrid[: shape[0], : shape[1], : shape[2]]
    paths = []
    for i in range(n):
        c = np.array(shape) / 2 + rng.uniform(-0.05, 0.05, 3) * np.array(shape)
        r = np.array(shape) * rng.uniform(0.36, 0.44, 3)
        d = sum(((g - ci) / ri) ** 2 for g, ci, ri in zip(grid, c, r))
        vol = np.full(shape, -1000.0, np.float32)
        vol[d < 1.0] = 1000.0
        brain = d < 0.8
        vol[brain] = 35.0 + 8.0 * rng.randn(int(brain.sum()))
        p = os.path.join(workdir, f"s{i}.nii.gz")
        save_nifti(p, np.round(vol), np.diag([*spacing, 1.0]), dtype=np.int16)
        paths.append(p)
    return paths


def feature_latency(device=None, n_scans: int = 12, chain: int = 8, runs: int = 3,
                    workdir: Optional[str] = None, extractor=None) -> Dict[str, Any]:
    """p50 time of one scan from its NIfTI file to its CLS embedding, split by
    stage: ``decode`` (host NIfTI decode and RAS orientation), ``h2d`` (the
    raw volume onto the device, synchronised), ``device`` (the on-device
    preprocessing and the ViT forward, from ``chain`` chained iterations
    with a data dependency and one sync, best of ``runs``), and
    ``dispatch_fetch`` (p50 less the three: launches and the embedding's
    copy back)."""
    from headct_foundation_tpu_torch.feature_extraction import FeatureExtractor

    device = resolve_device(device)
    fe = extractor if extractor is not None else FeatureExtractor(device=device)
    prep = fe.preprocessor
    fe.cls_embedding(torch.zeros((1, 3, fe.img_size, fe.img_size, fe.img_size)))  # warm
    with tempfile.TemporaryDirectory(prefix="headct_bench_scans_", dir=workdir) as tmp:
        paths = synth_scans(tmp, n_scans)
        fe.cls_embedding(prep(paths[0])[None])  # the preprocessing's operators built
        lat, decode, h2d = [], [], []
        for p in paths:
            t0 = time.perf_counter()
            data, affine = prep.decode(p)
            t1 = time.perf_counter()
            vol, zooms = prep.ship(data, affine)
            sync(device)
            t2 = time.perf_counter()
            emb = fe.cls_embedding(prep.transform(vol, zooms)[None])
            t3 = time.perf_counter()
            if not np.isfinite(emb).all():
                raise RuntimeError(f"a CLS embedding of {p} is not finite")
            decode.append(t1 - t0)
            h2d.append(t2 - t1)
            lat.append(t3 - t0)
        vol, zooms = prep.ship(*prep.decode(paths[0]))

    def once(x: torch.Tensor) -> torch.Tensor:
        out, _ = fe(prep.transform(x, zooms)[None])
        return out[:, 0, :]

    def run() -> torch.Tensor:
        emb = None
        for _ in range(chain):  # each input depends on the last embedding
            emb = once(vol if emb is None else vol + emb.mean() * 1e-6)
        return emb

    with torch.inference_mode():
        run()
        best = float("inf")
        for _ in range(runs):
            sync(device)
            t0 = time.perf_counter()
            float(run().sum().item())
            best = min(best, time.perf_counter() - t0)
    device_ms = best / chain * 1e3
    p50, dec, h = (float(np.percentile(x, 50)) * 1e3 for x in (lat, decode, h2d))
    return {"metric": "p50 per-scan feature-extract latency", "value": p50, "unit": "ms",
            "vs_baseline": None, "device": device_info(device), "scans": n_scans,
            "decomposition_ms": {"decode": dec, "h2d": h, "device": device_ms,
                                 "dispatch_fetch": p50 - dec - h - device_ms}}


def feature_throughput(device=None, n: int = 16, batch: int = 4,
                       workdir: Optional[str] = None) -> Dict[str, Any]:
    """Scans a second through ``extract_from_files`` (the host's decode of
    the next scans overlapped with the forward), beside the bound the raw
    scan's host-to-device copy alone would set."""
    from headct_foundation_tpu_torch.feature_extraction import FeatureExtractor

    device = resolve_device(device)
    fe = FeatureExtractor(device=device)
    with tempfile.TemporaryDirectory(prefix="headct_bench_scans_", dir=workdir) as tmp:
        paths = synth_scans(tmp, n)
        fe.extract_from_files(paths[:batch], batch_size=batch)  # warm at the timed batch
        t0 = time.perf_counter()
        feats = fe.extract_from_files(paths, batch_size=batch)
        dt = time.perf_counter() - t0
    if feats.shape[0] != n or not np.isfinite(feats).all():
        raise RuntimeError(f"extract_from_files gave {feats.shape}, finite "
                           f"{bool(np.isfinite(feats).all())}")
    out = {"metric": "feature-extraction throughput (batched)", "value": n / dt,
           "unit": "scans/s", "vs_baseline": None, "device": device_info(device),
           "h2d_MB_per_s": None, "transport_bound_scans_per_s": None,
           "frac_of_transport_bound": None}
    if device.type == "cuda":
        probe = torch.zeros((220, 220, 140), dtype=torch.int16, pin_memory=True)
        best = float("inf")
        for _ in range(3):
            sync(device)
            t0 = time.perf_counter()
            probe.to(device, non_blocking=True)
            sync(device)
            best = min(best, time.perf_counter() - t0)
        nbytes = probe.numel() * probe.element_size()
        bound = 1.0 / best
        out.update(h2d_MB_per_s=nbytes / best / 1e6, transport_bound_scans_per_s=bound,
                   frac_of_transport_bound=n / dt / bound)
    return out


def compute_only_across(cfg=None, device=None, steps: int = CHAIN_STEPS,
                        runs: int = MEASURE_RUNS) -> Optional[Dict[str, Any]]:
    """``compute_only`` on every rank of the ``torchrun`` world, after rank
    0's run alone; rank 0 returns the line (see the module docstring), the
    other ranks None."""
    from headct_foundation_tpu_torch.parallel import distributed

    cfg = cfg if cfg is not None else flagship_config()
    device = resolve_device(device)
    if device.type == "cuda":
        device = torch.device("cuda", distributed.local_rank())
        torch.cuda.set_device(device)
    one = compute_only(cfg, device, steps=steps, runs=runs) \
        if int(os.environ.get("RANK", "0")) == 0 else None
    world = distributed.init_from_env(device.type, config=cfg)
    try:
        line = compute_only(cfg, device, steps=steps, runs=runs)
        rates = [None] * world
        torch.distributed.all_gather_object(rates, line["value"])
    finally:
        distributed.shutdown()
    if one is None:
        return None
    mean = float(np.mean(rates))
    line.update(metric="volumes/sec/GPU (MAE 3D pretrain step, data parallel)",
                **per_gpu(device, mean), n_gpus=world, summed=float(np.sum(rates)),
                per_rank=rates, one_card=one["value"], per_card_vs_one=mean / one["value"])
    return line


def default_line(cfg=None, device=None) -> Dict[str, Any]:
    """The whole record: the production step, the model-only loop, the
    loader in the loop and the feature latency, in one line."""
    result = compute_only(cfg, device)
    result["model_only"] = model_only(cfg, device)
    result["loader_in_loop"] = with_loader(cfg, device)
    fl = feature_latency(device)
    result["feature_p50_ms"] = fl["value"]
    result["feature_p50_decomposition_ms"] = fl["decomposition_ms"]
    return result


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    modes = ap.add_mutually_exclusive_group()
    for flag in ("--compute-only", "--model-only", "--with-loader", "--feature-latency",
                 "--feature-throughput"):
        modes.add_argument(flag, action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--set", nargs="+", default=[], metavar="KEY VALUE",
                    help="config overrides merged last")
    ap.add_argument("--chain-steps", type=int, default=CHAIN_STEPS,
                    help="compute-only: steps a timed chain")
    ap.add_argument("--runs", type=int, default=MEASURE_RUNS,
                    help="compute-only: timed chains, the best kept")
    args = ap.parse_args(argv)
    if len(args.set) % 2:
        raise SystemExit(f"--set needs KEY VALUE pairs, got {args.set}")
    device = resolve_device(args.device)
    cfg = flagship_config(args.set)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        if not args.compute_only:
            raise SystemExit("across cards (torchrun) the bench runs --compute-only only")
        result = compute_only_across(cfg, device, args.chain_steps, args.runs)
        if result is not None:
            print(json.dumps(result), flush=True)
        return result
    if args.feature_latency:
        result = feature_latency(device)
    elif args.feature_throughput:
        result = feature_throughput(device)
    elif args.with_loader:
        result = {"metric": "volumes/sec/GPU (MAE pretrain, loader-in-the-loop)",
                  **with_loader(cfg, device), "device": device_info(device)}
    elif args.compute_only:
        result = compute_only(cfg, device, steps=args.chain_steps, runs=args.runs)
    elif args.model_only:
        result = {**model_only(cfg, device), "device": device_info(device)}
    else:
        result = default_line(cfg, device)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
