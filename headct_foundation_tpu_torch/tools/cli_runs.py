"""Synthetic head scans, label manifests and the CLIs in a subprocess.

Shared by ``chip_smoke.py`` (its slice and CLI phases) and
``tools/check_data_parallel.py``:

* ``synthetic_scan``: a head-CT-like int16 volume in HU, made from a seed;
* ``write_scans``: such volumes written as ``.nii.gz`` at a voxel spacing;
* ``write_label_manifest``: a cq500 label manifest in the dataset's full
  column order (``img_path`` then its 14 labels, the downstream loaders
  read the label by position and group the few-shot draws by name), random
  0/1 labels from a seed with both classes of every column present;
* ``run_cli``: ``python -m headct_foundation_tpu_torch.main_pretrain_mae``
  (or another ``module``, such as ``main_pretrain_dino``; under a launcher
  such as ``torch.distributed.run`` when one is given),
  raising with the end of its log when it fails; returns the log, the
  CLI's ``{"cli": ...}`` result and the wall seconds;
* ``card_lines``: each card's name and power limit, as ``nvidia-smi`` gives
  them, to stand beside every number measured on them.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parent.parent.parent
SCAN_SHAPE = (256, 256, 40)
FINE_SPACING = (0.5, 0.5, 1.0)  # head CT's in-plane resolution, 1 mm slices
CLI_TIMEOUT_S = 600
CQ500_COLUMNS = ("ICH", "IPH", "IVH", "SDH", "EDH", "SAH", "BleedLocation-Left",
                 "BleedLocation-Right", "ChronicBleed", "Fracture", "CalvarialFracture",
                 "OtherFracture", "MassEffect", "MidlineShift")


def synthetic_scan(seed: int) -> np.ndarray:
    """A head-CT-like int16 volume [256, 256, 40] in HU: air, a skull shell,
    brain tissue with noise, placed off-centre so the foreground crop acts."""
    rng = np.random.RandomState(seed)
    c = np.array([128 + rng.randint(-20, 20), 128 + rng.randint(-20, 20), 20])
    r = np.array([90 + rng.randint(0, 20), 105 + rng.randint(0, 20), 24])
    grid = np.ogrid[: SCAN_SHAPE[0], : SCAN_SHAPE[1], : SCAN_SHAPE[2]]
    d = sum(((g - ci) / ri) ** 2 for g, ci, ri in zip(grid, c, r))
    vol = np.full(SCAN_SHAPE, -1000.0, np.float32)
    vol[d < 1.0] = 1000.0                                   # skull
    brain = d < 0.8
    vol[brain] = 35.0 + 8.0 * rng.randn(int(brain.sum()))  # grey/white matter
    return np.round(vol).astype(np.int16)


def write_scans(workdir: Path, seeds: Sequence[int], spacing=FINE_SPACING,
                prefix: str = "scan") -> List[str]:
    """``synthetic_scan(seed)`` for each seed as ``<prefix><seed>.nii.gz``."""
    from headct_foundation_tpu_torch.data.nifti import save_nifti

    paths = []
    for seed in seeds:
        p = Path(workdir) / f"{prefix}{seed}.nii.gz"
        save_nifti(str(p), synthetic_scan(seed), np.diag([*spacing, 1.0]), dtype=np.int16)
        paths.append(str(p))
    return paths


def write_label_manifest(path: Path, paths: Sequence[str], seed: int) -> np.ndarray:
    """``paths`` with random cq500 labels as a manifest at ``path``; returns
    the labels [len(paths), 14]. A path that repeats keeps its first row's
    labels (a scan has one label)."""
    rng = np.random.RandomState(seed)
    first = {}
    for p in paths:
        first.setdefault(p, rng.randint(0, 2, len(CQ500_COLUMNS)))
    labels = np.stack([first[p] for p in paths])
    for c in range(labels.shape[1]):  # both classes in every column
        seen = {}
        for p, v in zip(paths, labels[:, c]):
            seen.setdefault(v, p)
        if len(seen) < 2 and len(first) > 1:
            other = next(p for p in first if p != paths[0])
            first[other][c] = 1 - first[paths[0]][c]
    labels = np.stack([first[p] for p in paths])
    Path(path).write_text("img_path," + ",".join(CQ500_COLUMNS) + "\n" + "".join(
        f"{p}," + ",".join(str(int(x)) for x in row) + "\n" for p, row in zip(paths, labels)))
    return labels


def run_cli(args: Sequence[str], label: str, launcher: Sequence[str] = (),
            module: str = "main_pretrain_mae", cwd: Path = ROOT,
            timeout: float = CLI_TIMEOUT_S, env: Optional[dict] = None
            ) -> Tuple[str, dict, float]:
    """The CLI ``headct_foundation_tpu_torch.<module>`` with ``args`` in a
    subprocess from ``cwd`` (the repository's root), at most ``timeout``
    seconds, with ``env`` added to the environment; ``launcher`` goes
    between the interpreter and ``-m``."""
    cmd = [sys.executable, *launcher, "-m", f"headct_foundation_tpu_torch.{module}", *args]
    env = dict(os.environ, **(env or {}))
    env["PYTHONPATH"] = os.pathsep.join(x for x in (str(ROOT), env.get("PYTHONPATH")) if x)
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    log = r.stdout + r.stderr
    if r.returncode != 0:
        raise RuntimeError(f"{label}: the CLI exited {r.returncode}:\n{log[-4000:]}")
    lines = [line for line in r.stdout.splitlines() if line.startswith('{"cli"')]
    if len(lines) != 1:
        raise RuntimeError(f"{label}: {len(lines)} JSON result lines in the CLI's output")
    return log, json.loads(lines[0])["cli"], wall


def card_lines() -> List[str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]
