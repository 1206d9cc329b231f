"""Data-parallel training through the CLI on the card: N processes against one.

    python -m headct_foundation_tpu_torch.tools.check_data_parallel [--nproc 4] \
        [--config configs/dino/dino_HeadCT.yaml]

Writes 32 synthetic head scans (``tools/cli_runs.py``, 0.5 x 0.5 x 1.0 mm)
and manifests, then runs the pretraining CLI of ``--config``'s ``MODEL.NAME``
(``cli_runs.PRETRAIN_CLIS``: the MAE's on ``configs/mae/mae_HeadCT.yaml`` by
default, or DINO's on ``configs/dino/dino_HeadCT.yaml``, whose first epoch
keeps the last layer frozen) for one epoch of 2 steps twice: under
``torch.distributed.run`` with ``--nproc`` processes at batch 64 / nproc
each (one card a process, NCCL), and as one process at batch 64. The
loader gives rank r the rows r::nproc, and the step draws the global
batch's randomness and takes the rank's rows, so the one-process run reads
its manifests reordered to the ranks' concatenation: both runs then train
on the same global batches with the same noise and augmentations.

Held: the train, val and test losses within ``LOSS_REL`` relative, every
(student) parameter's update within ||du_N - du_1|| / ||du_1|| <= ``UPDATE_REL``
(without the key third of each qkv bias: its gradient is rounding noise
that AdamW scales to +-lr), and no scan served as a placeholder. One
program in two layouts differs only by the order of its sums in bf16, which
AdamW's first steps amplify in small-gradient elements: the limits are the
readings of four cards (PERF.md) with margin. Planted in the CPU's
two-process test (PERF.md), a gradient left unaveraged moved the updates by
0.49 (median tensor) to 0.92, and a loss left unaveraged (rank 0's own) moved
the loss by 6.0e-3 and 2.5e-2 at the two steps. Prints
each run's seconds, the differences and one JSON line; exits 1 when a check
fails.
"""

from __future__ import annotations

import argparse
import importlib
import json
import socket
import sys
import tempfile
from pathlib import Path

import torch

from headct_foundation_tpu_torch.optim.optimizers import without_key_bias
from headct_foundation_tpu_torch.tools.cli_runs import (
    PRETRAIN_CLIS,
    ROOT,
    card_lines,
    run_cli,
    write_scans,
)

CONFIG = "configs/mae/mae_HeadCT.yaml"
BATCH, STEPS, SCANS = 64, 2, 32
LOSS_REL, UPDATE_REL = 1e-4, 5e-2


def interleaved(rows: list, nproc: int, batch: int) -> list:
    """Rows in the order of the ranks' concatenated global batches: batch
    block b of rank r holds rows r::nproc of the block."""
    out = []
    for i in range(0, len(rows), batch):
        block = rows[i:i + batch]
        out += [x for r in range(nproc) for x in block[r::nproc]]
    return out


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def updates(before: dict, path: Path) -> dict:
    """name -> parameter update since ``before``, from a checkpoint."""
    from headct_foundation_tpu_torch.utils import checkpoint, torch_interop

    after = torch_interop.state_dict_from_jax(checkpoint.load_checkpoint(str(path))["params"])
    return {name: without_key_bias(name, p.float() - before[name].float())
            for name, p in after.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--config", default=CONFIG)
    args = ap.parse_args(argv)
    if BATCH % args.nproc:
        raise ValueError(f"batch {BATCH} does not split over {args.nproc} processes")
    if torch.cuda.device_count() < args.nproc:
        raise RuntimeError(f"{args.nproc} processes need {args.nproc} CUDA devices, "
                           f"found {torch.cuda.device_count()}")

    from headct_foundation_tpu_torch.config import default_config

    cfg = default_config()
    cfg.merge_from_file(str(ROOT / args.config))
    module = PRETRAIN_CLIS[str(cfg.MODEL.NAME)]
    cli = importlib.import_module(f"headct_foundation_tpu_torch.{module}")
    init = cli.create_state(cfg, {"total_steps": 10, "num_warmup_steps": 1, "niter_per_ep": 1},
                            "cpu")
    before = {k: v.clone() for k, v in init.model.state_dict().items()}
    del init

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        work = Path(tmp)
        scans = write_scans(work, range(1000, 1000 + SCANS))
        rows = {"train": scans * (BATCH // SCANS * STEPS), "val": scans * 2, "test": scans * 2}
        for split, r in rows.items():
            for name, order in ((f"{split}_n.csv", r),
                                (f"{split}_1.csv", interleaved(r, args.nproc, BATCH))):
                (work / name).write_text("img_path\n" + "".join(f"{x}\n" for x in order))

        results = {}
        for label, nproc in (("n", args.nproc), ("1", 1)):
            opts = ["DATA.BATCH_SIZE", str(BATCH // nproc), "DATA.CACHE_DIR", str(work / "cache"),
                    "MODEL.DIR", str(work / f"model_{label}"),
                    "LOG.OUTPUT_DIR", str(work / f"log_{label}"), "OUTPUT", "",
                    "TRAIN.MAX_EPOCHS", "1", "TRAIN.VAL_EVERY", "1"]
            for split in rows:
                opts += [f"DATA.{split.upper()}_CSV_PATH", str(work / f"{split}_{label}.csv")]
            launcher = (["-m", "torch.distributed.run", "--nproc_per_node", str(nproc),
                         "--master_addr", "localhost", "--master_port", str(free_port())]
                        if nproc > 1 else [])
            _, result, seconds = run_cli(
                ["--cfg", args.config, "--device", "cuda", "--opts", *opts],
                f"{nproc} processes", launcher=launcher, module=module)
            results[label] = result, seconds

        (n_res, n_s), (one, one_s) = results["n"], results["1"]
        check = {}
        for what, a, b in (("train", n_res["epochs"][0]["train"]["loss"],
                            one["epochs"][0]["train"]["loss"]),
                           ("val", n_res["epochs"][0]["val"]["loss"],
                            one["epochs"][0]["val"]["loss"]),
                           ("test", n_res["test"]["loss"], one["test"]["loss"])):
            check[f"{what}_loss_rel"] = abs(a - b) / abs(b)
        save = cfg.MODEL.SAVE_NAME
        du_n = updates(before, work / "model_n" / f"latest_{save}")
        du_1 = updates(before, work / "model_1" / f"latest_{save}")
        rels = {k: float((du_n[k] - du_1[k]).norm() / du_1[k].norm())
                for k in du_1 if du_1[k].norm() > 0}
        worst = max(rels, key=rels.get)
        placeholders = n_res["placeholders"] + one["placeholders"]
        ok = (all(v <= LOSS_REL for v in check.values()) and rels[worst] <= UPDATE_REL
              and n_res["world"] == args.nproc and one["world"] == 1 and placeholders == 0)
    card = "; ".join(card_lines()[:args.nproc])
    def timing(res, seconds):
        e = res["epochs"][0]
        return (f"{seconds:.2f} s, {e['train']['steps']} steps, epoch {e['seconds']:.2f} s, "
                f"iter_time {e['train']['iter_time'] * 1e3:.1f} ms, data_time "
                f"{e['train']['data_time'] * 1e3:.1f} ms")

    print(f"data parallel: {args.nproc} processes at batch {BATCH // args.nproc} "
          f"({timing(n_res, n_s)}) against 1 at batch {BATCH} ({timing(one, one_s)}) "
          f"on {args.config}: losses relative "
          f"{', '.join(f'{k} {v:.3e}' for k, v in check.items())} (limit {LOSS_REL}); "
          f"parameter updates worst {worst} {rels[worst]:.3e} over {len(rels)} tensors "
          f"(limit {UPDATE_REL}); {placeholders} placeholders | {card}", flush=True)
    print(json.dumps({"ok": ok, "nproc": args.nproc, "config": args.config, "device": card,
                      **check,
                      "worst_update_rel": rels[worst], "worst_update": worst,
                      "placeholders": placeholders, "seconds": {"n": n_s, "1": one_s}}),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
