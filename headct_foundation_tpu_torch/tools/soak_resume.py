"""A soak run of the port's MAE main with a mid-epoch kill and a resume
(the port's counterpart of the JAX package's ``tools/soak_resume.py:47-262``).

    python -m headct_foundation_tpu_torch.tools.soak_resume [--scans 960] [--epochs 24] \\
        [--batch 32] [--kill-after-epoch 9] [--device cuda] [--data-root DIR] [--out DIR] \\
        [--out-prefix PREFIX]

It builds a synthetic head-CT-like NIfTI corpus with its manifests (once),
runs ``python -m headct_foundation_tpu_torch.main_pretrain_mae`` on it with
the flagship ``configs/mae/mae_HeadCT.yaml`` (the disk cache, the threaded
loader, the pinned prefetch, async epoch checkpoints), SIGKILLs it once
epoch ``--kill-after-epoch`` is checkpointed and the next has logged 5
steps (the log read every 20 s), resumes it from
``latest_`` through ``--model_load_path`` (the full restore: optimizer,
step, epoch), and stitches the two runs' per-step losses (parsed from the
rank-0 log) into ``PREFIX.json`` and, when matplotlib imports, ``PREFIX.png``.
It then holds the run to:

* the resume logged "Resumed from" and restarted at the checkpoint's epoch
  (the reference revisits the saved epoch, MIGRATION.md);
* every loss finite;
* continuity: the resumed run's first losses at the killed run's last
  level, within 35% of the distance from there to the first losses.
"""

from __future__ import annotations

import argparse
import csv
import glob
import json
import os
import re
import signal
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
STEP_RE = re.compile(r"Epoch (\d+)/(\d+) \[(\d+)/([\d?]+)\]\s+Loss: ([0-9.+\-eEnaif]+)")
Row = Tuple[int, int, float]  # (epoch, step in epoch, loss), as logged (from 1)


def build_dataset(root: str, n: int, shape=(140, 140, 100)) -> None:
    """``n`` structured volumes (smooth soft-tissue fields and a bright
    ellipsoid, integral HU stored as int16) and train / val / test manifests
    (val and test: the first 32 scans)."""
    from scipy.ndimage import zoom

    from headct_foundation_tpu_torch.data.nifti import save_nifti

    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(0)
    paths = []
    for i in range(n):
        coarse = rng.rand(5, 5, 4).astype(np.float32)
        vol = zoom(coarse, [s / c for s, c in zip(shape, coarse.shape)],
                   order=1)[:shape[0], :shape[1], :shape[2]] * 160.0 - 80.0
        c = np.array(shape) / 2 + rng.uniform(-15, 15, 3)
        ax = [np.arange(s, dtype=np.float32) for s in shape]
        d2 = (((ax[0][:, None, None] - c[0]) / 18) ** 2
              + ((ax[1][None, :, None] - c[1]) / 18) ** 2
              + ((ax[2][None, None, :] - c[2]) / 14) ** 2)
        vol = vol + 900.0 * np.exp(-0.5 * d2)
        p = os.path.join(root, f"scan_{i:05d}.nii.gz")
        save_nifti(p, np.round(vol).astype(np.int16).astype(np.float32),
                   np.diag([1.1, 1.1, 1.3, 1.0]), dtype=np.int16)
        paths.append(p)
    for split, rows in (("train", paths), ("val", paths[:32]), ("test", paths[:32])):
        with open(os.path.join(root, f"{split}.csv"), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["img_path"])
            w.writerows([p] for p in rows)


def launch(out: str, data_root: str, epochs: int, batch: int, device: str,
           resume: Optional[str] = None) -> subprocess.Popen:
    cmd = [sys.executable, "-m", "headct_foundation_tpu_torch.main_pretrain_mae",
           "--cfg", os.path.join(REPO, "configs/mae/mae_HeadCT.yaml"), "--device", device,
           "--batch_size", str(batch), "--max_epochs", str(epochs), "--num_workers", "8",
           "--opts",
           "MODEL.DIR", os.path.join(out, "model_saved"), "LOG.OUTPUT_DIR", os.path.join(out, "log"),
           "DATA.TRAIN_CSV_PATH", os.path.join(data_root, "train.csv"),
           "DATA.VAL_CSV_PATH", os.path.join(data_root, "val.csv"),
           "DATA.TEST_CSV_PATH", os.path.join(data_root, "test.csv"),
           "DATA.CACHE_DIR", os.path.join(data_root, "cache"), "DATA.WIRE_FORMAT", "hu16",
           "TRAIN.VAL_EVERY", "1000", "TRAIN.ASYNC_CKPT", "True"]
    if resume:
        cmd += ["--model_load_path", resume]
    log = open(os.path.join(out, f"driver_{'resume' if resume else 'first'}.log"), "w")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    return subprocess.Popen(cmd, cwd=REPO, stdout=log, stderr=subprocess.STDOUT, env=env)


def parse_steps(out: str) -> List[Row]:
    """Every logged training step of the rank-0 logs under ``out/log``."""
    rows = []
    for path in sorted(glob.glob(os.path.join(out, "log", "log_rank0_*.txt"))):
        with open(path) as f:
            for line in f:
                m = STEP_RE.search(line)
                if m:
                    rows.append((int(m.group(1)), int(m.group(3)), float(m.group(5))))
    return rows


def stitch(phase1: List[Row], phase2: List[Row], killed_at: Row, resumed: bool,
           **meta: Any) -> Dict[str, Any]:
    """The soak's result: the two loss series, where the kill fell, the
    epoch the resume restarted at and the continuity levels (the mean of
    ``k`` = min(20, both lengths) losses before the kill and after the
    resume, and of the first 3)."""
    k = min(20, len(phase1), len(phase2))
    losses1, losses2 = [r[2] for r in phase1], [r[2] for r in phase2]
    return {**meta, "killed_at": {"epoch": killed_at[0], "step_in_epoch": killed_at[1]},
            "resume_epoch_restarted": phase2[0][0], "steps_phase1": len(phase1),
            "steps_phase2": len(phase2), "resume_step_index": len(phase1),
            "pre_kill_loss": float(np.mean(losses1[-k:])),
            "post_resume_loss": float(np.mean(losses2[:k])),
            "init_loss": float(np.mean(losses1[:3])), "resumed_log_line": resumed,
            "losses_phase1": [round(x, 5) for x in losses1],
            "losses_phase2": [round(x, 5) for x in losses2]}


def failures(result: Dict[str, Any]) -> List[str]:
    """What the soak's assertions find wrong with ``result`` (none: pass)."""
    out = []
    if not result["resumed_log_line"]:
        out.append("the resume did not log 'Resumed from'")
    if not np.all(np.isfinite(result["losses_phase1"] + result["losses_phase2"])):
        out.append("a non-finite loss")
    pre, post, init = result["pre_kill_loss"], result["post_resume_loss"], result["init_loss"]
    if abs(post - pre) >= 0.35 * max(init - pre, 0.05):
        out.append(f"the resume is not continuous: {pre} before the kill, {post} after, "
                   f"{init} at the start")
    return out


def plot(result: Dict[str, Any], path: str) -> bool:
    """The stitched series as a PNG; False when matplotlib is missing."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False
    l1, l2 = result["losses_phase1"], result["losses_phase2"]
    fig, ax = plt.subplots(figsize=(9, 3.6), dpi=130)
    ax.plot(np.arange(1, len(l1) + 1), l1, color="#2563eb", lw=0.9, label="before kill")
    ax.plot(np.arange(len(l1) + 1, len(l1) + len(l2) + 1), l2, color="#059669", lw=0.9,
            label="after resume")
    ax.axvline(len(l1) + 0.5, color="#ef4444", lw=1.2, ls="--",
               label=f"SIGKILL mid-epoch {result['killed_at']['epoch']} -> resume")
    ax.set_xlabel("parsed step")
    ax.set_ylabel("training loss")
    ax.set_title("MAE soak: mid-epoch kill + latest_ resume (PyTorch port)", fontsize=10)
    ax.legend(fontsize=8, frameon=False)
    fig.tight_layout()
    fig.savefig(path, bbox_inches="tight")
    return True


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scans", type=int, default=960)
    ap.add_argument("--epochs", type=int, default=24)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--kill-after-epoch", type=int, default=9,
                    help="SIGKILL once this many epochs are checkpointed and the next is on")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--data-root", default="soak_data")
    ap.add_argument("--out", default="soak_out")
    ap.add_argument("--out-prefix", default="trajectory_mae_soak_torch")
    args = ap.parse_args(argv)

    t0 = time.time()
    if not os.path.exists(os.path.join(args.data_root, "train.csv")):
        print(f"[soak] building a {args.scans}-scan corpus", flush=True)
        build_dataset(args.data_root, args.scans)
    os.makedirs(os.path.join(args.out, "log"), exist_ok=True)
    run = (args.out, args.data_root, args.epochs, args.batch, args.device)

    proc = launch(*run)
    while True:  # phase 1: on until mid-epoch K + 1, then SIGKILL (no clean-up)
        if proc.poll() is not None:
            raise SystemExit(f"phase 1 exited (rc={proc.returncode}) before the kill point; "
                             f"see {args.out}/driver_first.log")
        rows = parse_steps(args.out)
        in_next = [r for r in rows if r[0] == args.kill_after_epoch + 1]
        ckpts = glob.glob(os.path.join(args.out, "model_saved", "latest_*"))
        if ckpts and len(in_next) >= 5:
            killed_at = rows[-1]
            proc.send_signal(signal.SIGKILL)
            proc.wait()
            print(f"[soak] SIGKILLed mid-epoch at {killed_at} after {time.time() - t0:.0f}s",
                  flush=True)
            break
        time.sleep(20)
    phase1 = parse_steps(args.out)

    rc = launch(*run, resume=ckpts[0]).wait()  # phase 2: the full restore from latest_
    if rc != 0:
        raise SystemExit(f"the resume run failed (rc={rc}); see {args.out}/driver_resume.log")
    phase2 = parse_steps(args.out)[len(phase1):]
    with open(os.path.join(args.out, "driver_resume.log")) as f:
        resumed = "Resumed from" in f.read()
    result = stitch(phase1, phase2, killed_at, resumed, scans=args.scans, batch=args.batch,
                    epochs=args.epochs, kill_after_epoch=args.kill_after_epoch,
                    wall_s=round(time.time() - t0, 1))
    with open(args.out_prefix + ".json.tmp", "w") as f:
        json.dump(result, f)
    os.replace(args.out_prefix + ".json.tmp", args.out_prefix + ".json")
    plot(result, args.out_prefix + ".png")
    print(json.dumps({k: v for k, v in result.items() if not k.startswith("losses")}))
    bad = failures(result)
    if bad:
        raise SystemExit("soak failed: " + "; ".join(bad))
    print("soak assertions PASSED")
    return result


if __name__ == "__main__":
    main()
