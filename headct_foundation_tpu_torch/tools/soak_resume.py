"""A soak run of the port's MAE main with a mid-epoch kill and a resume
(the port's counterpart of the JAX package's ``tools/soak_resume.py:47-262``).

    python -m headct_foundation_tpu_torch.tools.soak_resume [--scans 960] [--epochs 24] \\
        [--batch 32] [--kill-after-epoch 9] [--device cuda] [--data-root DIR] [--out DIR] \\
        [--out-prefix PREFIX]

It builds a synthetic head-CT-like NIfTI corpus with its manifests (once,
one process a core), runs ``python -m
headct_foundation_tpu_torch.main_pretrain_mae`` on it with the flagship
``configs/mae/mae_HeadCT.yaml`` (the disk cache, the threaded loader, the
pinned prefetch, async epoch checkpoints), and follows its rank-0 log
every ``POLL_S`` seconds. It SIGKILLs the run in epoch ``--kill-after-epoch``
+ 1 (epochs as the log counts them, from 1) once that epoch has logged at
least ``KILL_MIN_STEPS`` steps and not its last (``kill_decision``; the
trainer logs its losses in groups of ``mae_engine.LOSS_FLUSH`` steps, so an
epoch needs more than that many steps for the log to show it mid-way),
and fails if the log passes that point first. It resumes from the newest
complete ``latest_`` file, never a ``*.tmp`` that the killed writer left
(``complete_checkpoint``), through ``--model_load_path`` (the full
restore: optimizer, step, epoch), and stitches the two runs' per-step
losses into ``PREFIX.json`` and, when matplotlib imports, ``PREFIX.png``.
It then holds the run to (``failures``):

* the resume logged "Resumed from" and its first logged epoch is the one
  the chosen file's payload records, counted from 1 as the log counts (the
  trainer revisits the saved epoch, MIGRATION.md);
* the last step logged before the kill lies in epoch K + 1 and before its
  last step;
* every loss finite;
* continuity: the resumed run's first losses at the killed run's last
  level, within 35% of the distance from there to the first losses.

Its JSON line also gives both runs' launches and placeholders: the
killed run's from its completed epochs' "Epoch N done" log lines, the
resumed run's from its ``{"cli": ...}`` line; each run's seconds and the
seconds from the kill to the resumed run's first logged step (the trainer
logs its first ``LOSS_FLUSH`` steps at once).
"""

from __future__ import annotations

import argparse
import csv
import glob
import json
import os
import pickle
import re
import signal
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
STEP_RE = re.compile(r"Epoch (\d+)/(\d+) \[(\d+)/([\d?]+)\]\s+Loss: ([0-9.+\-eEnaif]+)")
DONE_RE = re.compile(r"Epoch (\d+) done in .*\bsteps (\d+)\s+placeholders (\d+)\s+launches (.*)$")
Row = Tuple[int, int, float]  # (epoch, step in epoch, loss), as logged (from 1)
POLL_S = 0.02        # the log is read this often while the kill is pending
KILL_MIN_STEPS = 5   # steps epoch K + 1 logs before the kill


def _volume(args) -> None:
    """One volume of ``build_dataset`` from its drawn numbers, written at ``path``."""
    from scipy.ndimage import zoom

    from headct_foundation_tpu_torch.data.nifti import save_nifti

    path, coarse, offset, shape = args
    vol = zoom(coarse, [s / c for s, c in zip(shape, coarse.shape)],
               order=1)[:shape[0], :shape[1], :shape[2]] * 160.0 - 80.0
    c = np.array(shape) / 2 + offset
    ax = [np.arange(s, dtype=np.float32) for s in shape]
    d2 = (((ax[0][:, None, None] - c[0]) / 18) ** 2
          + ((ax[1][None, :, None] - c[1]) / 18) ** 2
          + ((ax[2][None, None, :] - c[2]) / 14) ** 2)
    vol = vol + 900.0 * np.exp(-0.5 * d2)
    save_nifti(path, np.round(vol).astype(np.int16).astype(np.float32),
               np.diag([1.1, 1.1, 1.3, 1.0]), dtype=np.int16)


def build_dataset(root: str, n: int, shape=(140, 140, 100)) -> None:
    """``n`` structured volumes (smooth soft-tissue fields and a bright
    ellipsoid, integral HU stored as int16), written by one process a core
    from numbers drawn in order from one seed, and train / val / test
    manifests (val and test: the first 32 scans)."""
    import multiprocessing

    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(0)
    jobs = []
    for i in range(n):
        coarse = rng.rand(5, 5, 4).astype(np.float32)
        jobs.append((os.path.join(root, f"scan_{i:05d}.nii.gz"), coarse,
                     rng.uniform(-15, 15, 3), shape))
    with multiprocessing.get_context("spawn").Pool(min(n, os.cpu_count() or 1)) as pool:
        pool.map(_volume, jobs)
    paths = [j[0] for j in jobs]
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
    log = open(output_log(out, resume is not None), "w")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    return subprocess.Popen(cmd, cwd=REPO, stdout=log, stderr=subprocess.STDOUT, env=env)


def output_log(out: str, resume: bool) -> str:
    """The file a run's standard output and errors go to."""
    return os.path.join(out, f"stdout_{'resume' if resume else 'first'}.log")


def _log_lines(out: str) -> List[str]:
    lines = []
    for path in sorted(glob.glob(os.path.join(out, "log", "log_rank0_*.txt"))):
        with open(path) as f:
            lines += f.readlines()
    return lines


def parse_steps(out: str) -> List[Row]:
    """Every logged training step of the rank-0 logs under ``out/log``."""
    return [(int(m.group(1)), int(m.group(3)), float(m.group(5)))
            for m in map(STEP_RE.search, _log_lines(out)) if m]


def parse_epochs(out: str) -> List[Dict[str, Any]]:
    """Every completed epoch of the rank-0 logs under ``out/log``, from the
    trainer's "Epoch N done" lines: its number (from 1), steps, the train
    loader's placeholders so far and the kernels' launches."""
    epochs = []
    for m in map(DONE_RE.search, _log_lines(out)):
        if m:
            launched = m.group(4).strip()
            epochs.append({"epoch": int(m.group(1)), "steps": int(m.group(2)),
                           "placeholders": int(m.group(3)),
                           "launches": {} if launched == "none" else {
                               k: int(v) for k, v in (x.rsplit(" ", 1)
                                                      for x in launched.split(", "))}})
    return epochs


def kill_decision(rows: List[Row], kill_after_epoch: int, steps_per_epoch: int) -> str:
    """What to do with a run whose log shows ``rows``: "kill" once epoch
    ``kill_after_epoch`` + 1 has logged at least ``KILL_MIN_STEPS`` steps and
    not its last; "missed" once the log shows a later epoch or that epoch's
    last step (the kill would not fall mid-epoch K + 1); else "wait"."""
    target = kill_after_epoch + 1
    if any(e > target or (e == target and s >= steps_per_epoch) for e, s, _ in rows):
        return "missed"
    if sum(e == target for e, _, _ in rows) >= KILL_MIN_STEPS:
        return "kill"
    return "wait"


def complete_checkpoint(paths: List[str]) -> Optional[str]:
    """The complete checkpoint among ``paths`` (a ``latest_*`` glob): the
    writer saves through ``path + ".tmp"`` and an atomic rename, so a
    ``*.tmp`` is one a killed writer left torn and is never chosen. None
    when there is none; more than one raises (two save names)."""
    done = sorted(p for p in paths if not p.endswith(".tmp"))
    if len(done) > 1:
        raise ValueError(f"more than one complete latest_ checkpoint: {done}")
    return done[0] if done else None


def checkpoint_epoch(path: str) -> int:
    """The epoch a checkpoint's payload records (from 0, as the trainer
    saves it; the resume restarts there, logged as this + 1)."""
    with open(path, "rb") as f:
        return int(pickle.load(f)["epoch"])


def stitch(phase1: List[Row], phase2: List[Row], killed_at: Row, resumed: bool, *,
           checkpoint_epoch: int, kill_after_epoch: int, steps_per_epoch: int,
           **meta: Any) -> Dict[str, Any]:
    """The soak's result: the two loss series, where the kill fell, the
    epoch the resume restarted at (as logged) beside the chosen
    checkpoint's (from 0), and the continuity levels (the mean of ``k`` =
    min(20, both lengths) losses before the kill and after the resume, and
    of the first 3)."""
    k = min(20, len(phase1), len(phase2))
    losses1, losses2 = [r[2] for r in phase1], [r[2] for r in phase2]
    return {**meta, "kill_after_epoch": kill_after_epoch, "steps_per_epoch": steps_per_epoch,
            "killed_at": {"epoch": killed_at[0], "step_in_epoch": killed_at[1]},
            "checkpoint_epoch": checkpoint_epoch,
            "resume_epoch_restarted": phase2[0][0] if phase2 else None,
            "steps_phase1": len(phase1),
            "steps_phase2": len(phase2), "resume_step_index": len(phase1),
            "pre_kill_loss": float(np.mean(losses1[-k:])) if k else float("nan"),
            "post_resume_loss": float(np.mean(losses2[:k])) if k else float("nan"),
            "init_loss": float(np.mean(losses1[:3])), "resumed_log_line": resumed,
            "losses_phase1": [round(x, 5) for x in losses1],
            "losses_phase2": [round(x, 5) for x in losses2]}


def failures(result: Dict[str, Any]) -> List[str]:
    """What the soak's assertions find wrong with ``result`` (none: pass)."""
    out = []
    if not result["resumed_log_line"]:
        out.append("the resume did not log 'Resumed from'")
    want = result["checkpoint_epoch"] + 1
    if result["resume_epoch_restarted"] != want:
        out.append(f"the resume restarted at epoch {result['resume_epoch_restarted']}, not at "
                   f"{want}, the chosen checkpoint's (epoch {result['checkpoint_epoch']} from 0)")
    target = result["kill_after_epoch"] + 1
    e, s = result["killed_at"]["epoch"], result["killed_at"]["step_in_epoch"]
    if e != target or not 1 <= s < result["steps_per_epoch"]:
        out.append(f"the kill fell after step {s} of epoch {e}, not mid-epoch {target} (of "
                   f"{result['steps_per_epoch']} steps)")
    if not np.all(np.isfinite(result["losses_phase1"] + result["losses_phase2"])):
        out.append("a non-finite loss")
    pre, post, init = result["pre_kill_loss"], result["post_resume_loss"], result["init_loss"]
    if not abs(post - pre) < 0.35 * max(init - pre, 0.05):
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
    from headct_foundation_tpu_torch.engines.mae_engine import LOSS_FLUSH

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scans", type=int, default=960)
    ap.add_argument("--epochs", type=int, default=24)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--kill-after-epoch", type=int, default=9,
                    help="SIGKILL mid-way through the epoch after this one (from 1)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--data-root", default="soak_data")
    ap.add_argument("--out", default="soak_out")
    ap.add_argument("--out-prefix", default="trajectory_mae_soak_torch")
    args = ap.parse_args(argv)
    out, data_root = os.path.abspath(args.out), os.path.abspath(args.data_root)
    steps_per_epoch, kill_after = -(-args.scans // args.batch), args.kill_after_epoch
    if steps_per_epoch <= LOSS_FLUSH:
        raise SystemExit(f"{steps_per_epoch} steps an epoch: the trainer logs its losses in "
                         f"groups of {LOSS_FLUSH}, so the log never shows an epoch mid-way; "
                         f"give more than {LOSS_FLUSH * args.batch} scans")
    if not 1 <= kill_after < args.epochs:
        raise SystemExit(f"--kill-after-epoch {kill_after} leaves no epoch of {args.epochs} to kill in")
    if glob.glob(os.path.join(out, "log", "log_rank0_*.txt")):
        raise SystemExit(f"{out} holds an earlier run's logs: give a fresh --out")

    t0 = time.time()
    if not os.path.exists(os.path.join(data_root, "train.csv")):
        print(f"[soak] building a {args.scans}-scan corpus", flush=True)
        build_dataset(data_root, args.scans)
    os.makedirs(os.path.join(out, "log"), exist_ok=True)
    run = (out, data_root, args.epochs, args.batch, args.device)
    latest = os.path.join(out, "model_saved", "latest_*")

    t1 = time.time()
    proc = launch(*run)
    seen = None  # what the previous poll saw: (its time, its last row, a complete file)
    while True:  # phase 1: on until mid-epoch K + 1, then SIGKILL (no clean-up)
        if proc.poll() is not None:
            raise SystemExit(f"phase 1 exited (rc={proc.returncode}) before the kill point; "
                             f"see {output_log(out, False)}")
        rows = parse_steps(out)
        decision = kill_decision(rows, kill_after, steps_per_epoch)
        done = complete_checkpoint(glob.glob(latest))
        if decision == "missed":
            proc.kill()
            proc.wait()
            before = ("no earlier poll" if seen is None else
                      f"the poll {time.time() - seen[0]:.3f} s before saw {seen[1]} and "
                      f"{'a' if seen[2] else 'no'} complete latest_ file")
            raise SystemExit(f"the log passed mid-epoch {kill_after + 1} before the kill: "
                             f"{rows[-1]}; {before}")
        if decision == "kill" and done:
            proc.send_signal(signal.SIGKILL)
            t_kill = time.time()
            proc.wait()
            break
        seen = (time.time(), rows[-1] if rows else None, done is not None)
        time.sleep(POLL_S)
    phase1, epochs1 = parse_steps(out), parse_epochs(out)
    killed_at = phase1[-1]
    ckpt = complete_checkpoint(glob.glob(latest))  # the writer is dead: nothing moves now
    ckpt_epoch = checkpoint_epoch(ckpt)
    print(f"[soak] SIGKILLed at {killed_at} (epoch, step, loss) after {t_kill - t1:.1f} s; "
          f"resuming from {os.path.basename(ckpt)} (epoch {ckpt_epoch} from 0)", flush=True)

    t2 = time.time()
    proc = launch(*run, resume=ckpt)  # phase 2: the full restore from latest_
    first_step = None
    while proc.poll() is None:
        if first_step is None and len(parse_steps(out)) > len(phase1):
            first_step = time.time()
        time.sleep(POLL_S)
    t3 = time.time()
    if proc.returncode != 0:
        raise SystemExit(f"the resume run failed (rc={proc.returncode}); "
                         f"see {output_log(out, True)}")
    first_step = first_step or t3
    phase2 = parse_steps(out)[len(phase1):]
    with open(output_log(out, True)) as f:
        text = f.read()
    cli = [line for line in text.splitlines() if line.startswith('{"cli"')]
    result = stitch(phase1, phase2, killed_at, "Resumed from" in text,
                    checkpoint_epoch=ckpt_epoch, kill_after_epoch=kill_after,
                    steps_per_epoch=steps_per_epoch, scans=args.scans, batch=args.batch,
                    epochs=args.epochs, wall_s=round(time.time() - t0, 1),
                    seconds={"phase1": round(t_kill - t1, 2), "phase2": round(t3 - t2, 2),
                             "kill_to_first_resumed_step": round(first_step - t_kill, 2),
                             "resume_launch_to_first_step": round(first_step - t2, 2)},
                    phase1_epochs=epochs1,
                    phase2_cli=json.loads(cli[-1])["cli"] if cli else None)
    with open(args.out_prefix + ".json.tmp", "w") as f:
        json.dump(result, f)
    os.replace(args.out_prefix + ".json.tmp", args.out_prefix + ".json")
    plot(result, args.out_prefix + ".png")
    print(json.dumps({k: v for k, v in result.items()
                      if not k.startswith("losses") and k != "phase2_cli"}))
    bad = failures(result)
    if bad:
        raise SystemExit("soak failed: " + "; ".join(bad))
    print("soak assertions PASSED")
    return result


if __name__ == "__main__":
    main()
