"""Step times of two checkouts of the port, taken in alternation on one card.

    python -m headct_foundation_tpu_torch.tools.compare_step_times \
        --trees <parent checkout> <changed checkout> [--labels parent change] \
        [--workloads mae dino stretch] [--rounds 12] [--steps 5] [--batch N]

For each workload one worker process per checkout (the package imported
from that checkout) builds the shipped configuration's train state from
seed 0 at full width, with random weights, on synthetic hu16 head phantoms,
and warms its step. Both workers then stay resident on the card, and the
driver has them time ``--steps`` synchronised steps each, in turns: round
``r`` runs the first checkout then the second when ``r`` is even, the
reverse when it is odd (ABBA), so that drift of the card's clocks falls on
both alike. Each step is timed on the host clock around
``torch.cuda.synchronize``, as ``chip_smoke.py``'s train phase times it.

Workloads: ``mae`` is ``configs/mae/mae_HeadCT.yaml`` (96^3) at batch 32,
``stretch`` ``configs/mae/mae_HeadCT_192.yaml`` at batch 2, ``dino``
``configs/dino/dino_HeadCT.yaml`` at its configured batch; every parallel
axis 1 and dropout as configured (0).

The driver prints, per workload, each checkout's median step and each
round's ratio of the second checkout's median to the first's, and as its
last line one JSON object with every step time. Needs a CUDA card and the
CUDA toolkit (the kernels are built at first use, into each checkout's
``build/kernels``).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

WORKLOADS = {"mae": ("configs/mae/mae_HeadCT.yaml", 32),
             "stretch": ("configs/mae/mae_HeadCT_192.yaml", 2),
             "dino": ("configs/dino/dino_HeadCT.yaml", None)}


def _phantoms(n: int, size: int, seed: int):
    """n hu16 wire volumes [n, 1, size^3]: a ball of noisy tissue in air
    (their values do not change the step's work)."""
    import numpy as np

    from headct_foundation_tpu_torch.data.transforms import hu16_encode

    rng = np.random.RandomState(seed)
    g = (np.arange(size, dtype=np.float32) - size / 2) / (size / 2)
    d = g[:, None, None] ** 2 + g[None, :, None] ** 2 + g[None, None, :] ** 2
    hu = np.where(d < 0.7, 40.0, -1000.0).astype(np.float32)
    return np.stack([hu16_encode(hu + 8.0 * rng.randn(*hu.shape).astype(np.float32))[None]
                     for _ in range(n)])


def worker(root: str, workload: str, device: str, batch: int) -> None:
    """Build the workload's state from the package in ``root``, then time
    the number of steps read from each line of stdin; 'quit' ends. A batch
    of 0 is the workload's own."""
    sys.path.insert(0, root)
    import torch

    from headct_foundation_tpu_torch.config import default_config

    config, own = WORKLOADS[workload]
    cfg = default_config()
    cfg.merge_from_file(str(Path(root) / config))
    cfg.merge_from_list(["DATA.WIRE_FORMAT", "hu16"])
    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    if workload == "dino":
        from headct_foundation_tpu_torch.engines import dino_engine

        batch = batch or int(cfg.DATA.BATCH_SIZE)
        state = dino_engine.create_train_state(cfg, 1000, 1, 100, seed=0, device=dev)
        step_fn = dino_engine.make_train_step(cfg)
        temp, momentum = float(state.temp_sched[0]), float(cfg.DINO.MOMENTUM_TEACHER)
        size = int(cfg.MODEL.ROI[0])

        def step(state, wire):
            return step_fn(state, wire, 0, momentum, temp, False)
    else:
        from headct_foundation_tpu_torch.engines import mae_engine

        batch = batch or own
        state, _ = mae_engine.create_train_state(cfg, 1000, 2, seed=0, device=dev)
        step_fn = mae_engine.make_train_step(augment=True, config=cfg)
        size = int(cfg.MAE.INPUT_SIZE)

        def step(state, wire):
            return step_fn(state, wire, 0)

    wire = torch.from_numpy(_phantoms(batch, size, 0)).to(dev)
    for _ in range(3):  # warm: kernels built and loaded, allocator settled
        state, _ = step(state, wire)
    sync()
    print(json.dumps({"ready": True, "batch": batch}), flush=True)
    for line in sys.stdin:
        if line.strip() == "quit":
            break
        times = []
        for _ in range(int(line)):
            sync()
            t0 = time.perf_counter()
            state, _ = step(state, wire)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        print(json.dumps(times), flush=True)


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown card"


def compare(trees, labels, workload: str, rounds: int, steps: int, device: str = "cuda",
            batch: int = 0) -> dict:
    procs = [subprocess.Popen([sys.executable, __file__, "--worker", str(Path(t).resolve()),
                               workload, device, str(batch)],
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
                              cwd=str(Path(t).resolve())) for t in trees]
    try:
        for p in procs:
            ready = json.loads(p.stdout.readline() or "null")
            if not ready or not ready.get("ready"):
                raise RuntimeError(f"a {workload} worker did not start (exit {p.poll()})")
        times = {label: [] for label in labels}
        ratios = []
        for r in range(rounds):
            order = (0, 1) if r % 2 == 0 else (1, 0)
            med = {}
            for i in order:
                procs[i].stdin.write(f"{steps}\n")
                procs[i].stdin.flush()
                got = json.loads(procs[i].stdout.readline())
                times[labels[i]].append(got)
                med[i] = statistics.median(got)
            ratios.append(med[1] / med[0])
        for p in procs:
            p.stdin.write("quit\n")
            p.stdin.flush()
    finally:
        for p in procs:
            try:
                p.wait(timeout=120)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    flat = {label: [t for block in blocks for t in block] for label, blocks in times.items()}
    result = {"workload": workload, "config": WORKLOADS[workload][0], "rounds": rounds,
              "steps": steps, "median_ms": {k: statistics.median(v) for k, v in flat.items()},
              "round_ratios": ratios, "median_ratio": statistics.median(ratios),
              "rounds_second_slower": sum(x > 1.0 for x in ratios), "times_ms": times}
    print(f"{workload} ({WORKLOADS[workload][0]}): median step "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in result["median_ms"].items())
          + f" over {rounds} x {steps} steps each; {labels[1]}/{labels[0]} per round "
          + ", ".join(f"{x:.4f}" for x in ratios)
          + f" (median {result['median_ratio']:.4f}; {labels[1]} slower in "
          f"{result['rounds_second_slower']} of {rounds})", flush=True)
    return result


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--worker"]:
        worker(argv[1], argv[2], argv[3], int(argv[4]))
        return 0
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs=2, required=True)
    ap.add_argument("--labels", nargs=2, default=["first", "second"])
    ap.add_argument("--workloads", nargs="+", default=["mae"], choices=sorted(WORKLOADS))
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=0, help="0: each workload's own")
    ap.add_argument("--device", default="cuda", help="cpu: a check of the tool itself")
    args = ap.parse_args(argv)
    card = _card() if args.device == "cuda" else "cpu"
    results = [compare(args.trees, args.labels, w, args.rounds, args.steps, args.device,
                       args.batch) for w in args.workloads]
    print(card, flush=True)
    print(json.dumps({"card": card, "labels": args.labels, "results": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
