"""Data- and model-parallel training through the CLI on the card: N
processes against one.

    python -m headct_foundation_tpu_torch.tools.check_data_parallel [--nproc 4] \
        [--config configs/dino/dino_HeadCT.yaml] [--fsdp F] [--seq S] [--pipe P] \
        [--tensor T] [--batch B] [--dropout RATE] [--float32 | --float64] \
        [--device cuda|cpu]

``--fsdp``, ``--seq``, ``--pipe`` and ``--tensor`` (every main) lay the N
processes out as ``PARALLEL.DATA x FSDP x SEQ x PIPE x TENSOR`` with DATA =
N / (F x S x P x T): the batch is split over the DATA x F ranks (B / (DATA
x F) rows each; the S x P x T ranks of one slice read the same rows), each
of the F ranks holds its ZeRO-3 shard of the weights, the tokens are split
over ``seq``, the trunks' blocks over ``pipe`` (GPipe for the MAE; the
other mains replicate their step over it) and the heads and MLP columns
over ``tensor``. ``--batch`` (default 64) is the
global batch; ``--dropout`` sets ``MAE.DROPOUT_RATE`` in both runs, whose
masks every rank draws as the global batch's and slices. ``--float32``
runs the MAE or the DINO main computing in float32 in every run (its
worker mode ``--float32-main MODULE`` is ``MODULE.run(argv,
dtype=torch.float32)``): the layouts then differ only by float32
rounding. DINO in float32 runs at ``--batch 32``, half bf16's batch, for
the one-process run's activations on one card. ``--float64`` runs the
downstream main computing in float64 in every run (worker mode
``--float64-main main_downstream``; parameters, BatchNorm statistics,
AdamW moments and the gradient all-reduce in float64, the attention the
plain one: no kernel takes float64), held at ``F64_LOSS_REL`` and
``F64_UPDATE_REL``: where float32 rounding alone separates the layouts,
float64 brings them within those limits. Its one-process run at batch 64
needs about 80 GB of activations: use ``--batch 32``. ``--device cpu``
runs every process on the host's CPU (gloo; each of the N processes gets
1/N of the cores, the one process all of them; no rounding floor, as the
CPU runs the plain attention), and the readings name "CPU, gloo" and the
core count in place of the cards.

Writes 32 synthetic head scans (``tools/cli_runs.py``, 0.5 x 0.5 x 1.0 mm)
and manifests, then runs the CLI of ``--config``'s ``MODEL.NAME`` (``CLIS``:
the MAE's on ``configs/mae/mae_HeadCT.yaml`` by default, DINO's on
``configs/dino/dino_HeadCT.yaml``, whose first epoch keeps the last layer
frozen, or the downstream main on ``configs/downstream/vit_HeadCT_cq500.yaml``)
for one epoch of 2 steps twice: under ``torch.distributed.run`` with
``--nproc`` processes at batch 64 / nproc each (one card a process, NCCL),
and as one process at batch 64. Each ``CLIS`` entry says how its CLI is run:

* the pretraining loaders give rank r the rows r::nproc, and their steps
  draw the global batch's randomness and take the rank's block of rows, so
  the one-process run reads its manifests reordered to the ranks'
  concatenation: both runs then train on the same global batches with the
  same noise and augmentations; the ``latest_`` checkpoints are compared;
* the downstream main runs few-shot (64 draws per class of cq500 label
  manifests: 2 steps of 64), whose sampler splits one permutation
  ``rank::world`` and whose step gives rank r the rows r::world of the
  global batch's augmentations: both runs read the same manifests; the
  ``best_`` checkpoints are compared. Its BatchNorm statistics are the
  global batch's. It computes in float32 (``python -m
  headct_foundation_tpu_torch.tools.check_data_parallel --float32-main
  main_downstream <the main's flags>``):
  in bf16 the head's train-mode BatchNorm over alike random-init CLS
  features turns the per-rank and whole-batch products' different bf16
  roundings into the signal, and N processes and one fail these limits by
  far (four cards did, as two and four gloo processes do on the CPU).

In float32 the downstream main misses these limits on cards (at batch 32
DATA 2 and TENSOR 2 the loss, DATA 4 the update) and on four gloo
processes, by rounding alone: the same runs in float64 read 3e-12 or less
on the losses, nine orders of magnitude lower, as far as float64's unit
roundoff is below float32's (ROADMAP.md C.12). So ``--float64`` is its
hard check and the float32 limits stay as they are.

Held: the train, val and test losses within ``LOSS_REL`` relative, every
(student) parameter's update within ||du_N - du_1|| / ||du_1|| <= ``UPDATE_REL``
(without the key third of each qkv bias and the downstream
``ROUNDING_ONLY`` tensors: their gradient is rounding noise that AdamW
scales to +-lr), and no scan served as a placeholder. One
program in two layouts differs only by the order of its sums in bf16, which
AdamW's first steps amplify in small-gradient elements: the limits are the
readings of four cards (PERF.md) with margin. Planted in the CPU's
two-process test (PERF.md), a gradient left unaveraged moved the updates by
0.49 (median tensor) to 0.92, and a loss left unaveraged (rank 0's own) moved
the loss by 6.0e-3 and 2.5e-2 at the two steps. A third run, one process
with the plain attention (``PARALLEL.PALLAS_MIN_T`` above every sequence),
gives the same differences against the one-process run as the rounding
floor of the configuration: what a change of rounding alone moves (printed
and in the JSON line as ``floor``, not held; DINO has none, its plain
attention does not fit at batch 64). Prints each run's seconds, the
differences and one JSON line; exits 1 when a check fails.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import socket
import sys
import tempfile
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Callable, Tuple

import torch

from headct_foundation_tpu_torch.optim.optimizers import without_key_bias
from headct_foundation_tpu_torch.utils.misc import wide_dtype, widen
from headct_foundation_tpu_torch.tools.cli_runs import (
    ROOT,
    card_lines,
    run_cli,
    write_label_manifest,
    write_scans,
)

CONFIG = "configs/mae/mae_HeadCT.yaml"
BATCH, STEPS, SCANS = 64, 2, 32
LOSS_REL, UPDATE_REL = 1e-4, 5e-2
F64_LOSS_REL, F64_UPDATE_REL = 1e-9, 1e-6  # --float64: what rounding leaves there
CPU_TIMEOUT_S = 5400  # a run of the full-width main on the CPU
PLAIN_MIN_T = 1 << 20  # PARALLEL.PALLAS_MIN_T above every T: the plain attention


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


def flat_params(params: dict) -> dict:
    """name -> tensor of a checkpoint's parameter tree; a downstream tree's
    ``model`` and ``classifier`` under those prefixes."""
    from headct_foundation_tpu_torch.utils import torch_interop

    if set(params) == {"model", "classifier"}:
        return {f"{top}.{k}": v for top in params
                for k, v in torch_interop.state_dict_from_jax(params[top]).items()}
    return torch_interop.state_dict_from_jax(params)


def updates(before: dict, path: Path) -> dict:
    """name -> parameter update since ``before``, from a checkpoint (in
    float32, float64 for a float64 checkpoint)."""
    from headct_foundation_tpu_torch.utils import checkpoint

    after = flat_params(checkpoint.load_checkpoint(str(path))["params"])
    return {name: without_key_bias(name, widen(p) - before[name].to(wide_dtype(p.dtype)))
            for name, p in after.items()}


def differences(run: tuple, reference: tuple) -> tuple:
    """({train, val, test}_loss_rel, {tensor: relative update difference}) of
    ``run`` against ``reference``, each (CLI result, seconds, updates)."""
    from headct_foundation_tpu_torch.engines.downstream_engine import ROUNDING_ONLY

    (a, _, du_a), (b, _, du_b) = run, reference
    losses = {"train": (a["epochs"][0]["train"]["loss"], b["epochs"][0]["train"]["loss"]),
              "val": (a["epochs"][0]["val"]["loss"], b["epochs"][0]["val"]["loss"]),
              "test": (a["test"]["loss"], b["test"]["loss"])}
    rels = {k: float((du_a[k] - du_b[k]).norm() / du_b[k].norm())
            for k in du_b if du_b[k].norm() > 0 and k not in ROUNDING_ONLY}
    return {f"{k}_loss_rel": abs(x - y) / abs(y) for k, (x, y) in losses.items()}, rels


def float_main(module: str, argv, dtype: torch.dtype = torch.float32) -> None:
    """The CLI main ``headct_foundation_tpu_torch.<module>``, computing in
    ``dtype`` (float32, or float64 for the downstream main's reference)."""
    importlib.import_module(f"headct_foundation_tpu_torch.{module}").run(argv, dtype=dtype)


def float32_downstream(argv) -> None:
    """The downstream main, computing in float32."""
    float_main("main_downstream", argv)


def float64_downstream(argv) -> None:
    """The downstream main, computing in float64."""
    float_main("main_downstream", argv, torch.float64)


WORKER_DTYPES = {"--float32-main": torch.float32, "--float64-main": torch.float64}


def venue(device: str, nproc: int) -> str:
    """Where the runs ran: each card's name and power limit, or the CPU."""
    if device == "cpu":
        return f"CPU, gloo, {os.cpu_count()} cores"
    return "; ".join(card_lines()[:nproc])


def pretrain_manifests(path_n: Path, path_1: Path, rows: list, nproc: int, seed: int,
                       batch: int = BATCH) -> None:
    """Image lists: the N-process run's in order, the one-process run's
    reordered to the batch ranks' (``nproc``: DATA x FSDP) concatenated
    global batches."""
    for path, order in ((path_n, rows), (path_1, interleaved(rows, nproc, batch))):
        path.write_text("img_path\n" + "".join(f"{x}\n" for x in order))


def label_manifests(path_n: Path, path_1: Path, rows: list, nproc: int, seed: int,
                    batch: int = BATCH) -> None:
    """The same cq500 label manifest for both runs."""
    for path in (path_n, path_1):
        write_label_manifest(path, rows, seed=seed)


def _config(path: str):
    from headct_foundation_tpu_torch.config import default_config

    cfg = default_config()
    cfg.merge_from_file(str(ROOT / path))
    return cfg


@dataclass(frozen=True)
class Cli:
    """How the tool runs one CLI main."""
    module: str                # headct_foundation_tpu_torch.<module>: create_state
    run: Tuple[str, ...]       # the module the processes run, and its leading arguments
    opts: Tuple[str, ...]      # config options beyond the common ones
    manifests: Callable        # (path_n, path_1, rows, nproc, seed): the split's manifests
    checkpoint: str            # the prefix of the checkpoint whose parameters are compared
    floor: bool = True         # run the rounding floor (one process, plain attention)


CLIS = {  # MODEL.NAME -> its CLI
    "mae": Cli("main_pretrain_mae", ("main_pretrain_mae",), (), pretrain_manifests, "latest_"),
    # no floor: the plain attention's [256,12,517,517] scores do not fit on 80 GB at batch 64
    "dino": Cli("main_pretrain_dino", ("main_pretrain_dino",), (), pretrain_manifests,
                "latest_", floor=False),
    "vit": Cli("main_downstream", ("tools.check_data_parallel", "--float32-main",
                                   "main_downstream"),
               # 2 steps of 64: few-shot, the same global batches on N processes and one
               ("DATA.FEW_SHOTS", str(BATCH * STEPS // 2), "DATA.DATASET", "cq500",
                "TRAIN.LABEL_NAME", "ICH"), label_manifests, "best_"),
}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] and argv[0] in WORKER_DTYPES:
        float_main(argv[1], argv[2:], WORKER_DTYPES[argv[0]])
        return 0
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--config", default=CONFIG)
    ap.add_argument("--fsdp", type=int, default=1)
    ap.add_argument("--seq", type=int, default=1)
    ap.add_argument("--tensor", type=int, default=1)
    ap.add_argument("--pipe", type=int, default=1)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--dropout", type=float, default=0.0)
    ap.add_argument("--float32", action="store_true",
                    help="the MAE or DINO main computing in float32 (every run)")
    ap.add_argument("--float64", action="store_true",
                    help="the downstream main computing in float64 (every run), held at "
                         f"{F64_LOSS_REL} and {F64_UPDATE_REL}")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: gloo processes on the host's cores, split evenly")
    args = ap.parse_args(argv)
    batch = args.batch
    data, rem = divmod(args.nproc, args.fsdp * args.seq * args.pipe * args.tensor)
    slices = data * args.fsdp  # the batch's ranks
    if rem or batch % slices:
        raise ValueError(f"{args.nproc} processes at fsdp {args.fsdp} x seq {args.seq} x "
                         f"pipe {args.pipe} x tensor {args.tensor} do not split batch {batch} "
                         "over data x fsdp")
    if args.device == "cuda" and torch.cuda.device_count() < args.nproc:
        raise RuntimeError(f"{args.nproc} processes need {args.nproc} CUDA devices, "
                           f"found {torch.cuda.device_count()}")

    cfg = _config(args.config)
    cli = CLIS[str(cfg.MODEL.NAME)]
    if str(cfg.MODEL.NAME) == "vit":  # few-shot draws per class: STEPS steps of ``batch``
        cli = replace(cli, opts=("DATA.FEW_SHOTS", str(batch * STEPS // 2)) + cli.opts[2:])
    if args.float32:
        if str(cfg.MODEL.NAME) not in ("mae", "dino"):
            raise ValueError("--float32 runs the MAE or the DINO main (the downstream main "
                             "always computes in float32)")
        cli = replace(cli, run=("tools.check_data_parallel", "--float32-main", cli.module))
    if args.float64:
        if str(cfg.MODEL.NAME) != "vit" or args.float32:
            raise ValueError("--float64 runs the downstream main only, without --float32")
        cli = replace(cli, run=("tools.check_data_parallel", "--float64-main", cli.module))
    # no floor where no kernel runs: float64 and the CPU take the plain attention
    floor = cli.floor and not args.float64 and args.device == "cuda"
    loss_limit, update_limit = ((F64_LOSS_REL, F64_UPDATE_REL) if args.float64
                                else (LOSS_REL, UPDATE_REL))
    dtype = ("float64" if args.float64 else
             "float32" if args.float32 or str(cfg.MODEL.NAME) == "vit" else "bfloat16")
    layout = ("PARALLEL.FSDP", str(args.fsdp), "PARALLEL.SEQ", str(args.seq),
              "PARALLEL.PIPE", str(args.pipe), "PARALLEL.TENSOR", str(args.tensor))
    common = ("MAE.DROPOUT_RATE", str(args.dropout)) if args.dropout else ()
    init = importlib.import_module(f"headct_foundation_tpu_torch.{cli.module}").create_state(
        cfg, {"total_steps": 10, "num_warmup_steps": 1, "niter_per_ep": 1}, "cpu")
    before = flat_params(init.jax_trees(0)["params"])  # as the checkpoints name them
    del init

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        work = Path(tmp)
        scans = write_scans(work, range(1000, 1000 + SCANS))
        reps = max(1, -(-batch * STEPS // SCANS))
        rows = {"train": (scans * reps)[:batch * STEPS], "val": scans * 2, "test": scans * 2}
        for i, (split, r) in enumerate(rows.items()):
            cli.manifests(work / f"{split}_n.csv", work / f"{split}_1.csv", r, slices, i, batch)

        results = {}
        runs = [("n", args.nproc, layout), ("1", 1, ())]
        if floor:
            runs.append(("plain", 1, ("PARALLEL.PALLAS_MIN_T", str(PLAIN_MIN_T))))
        for label, nproc, extra in runs:
            manifests = "n" if nproc > 1 else "1"
            per = batch // (slices if nproc > 1 else 1)
            opts = ["DATA.BATCH_SIZE", str(per), "DATA.CACHE_DIR", str(work / "cache"),
                    "MODEL.DIR", str(work / f"model_{label}"),
                    "LOG.OUTPUT_DIR", str(work / f"log_{label}"), "OUTPUT", "",
                    "TRAIN.MAX_EPOCHS", "1", "TRAIN.VAL_EVERY", "1", *cli.opts, *common,
                    *extra]
            for split in rows:
                opts += [f"DATA.{split.upper()}_CSV_PATH", str(work / f"{split}_{manifests}.csv")]
            launcher = (["-m", "torch.distributed.run", "--nproc_per_node", str(nproc),
                         "--master_addr", "localhost", "--master_port", str(free_port())]
                        if nproc > 1 else [])
            cpu = args.device == "cpu"  # each process its share of the cores
            _, result, seconds = run_cli(
                [*cli.run[1:], "--cfg", str(ROOT / args.config), "--device", args.device,
                 "--opts", *opts],
                f"{label}: {nproc} processes", launcher=launcher, module=cli.run[0],
                cwd=work,  # the downstream tester writes preds_pkl/ there
                **({"timeout": CPU_TIMEOUT_S,
                    "env": {"OMP_NUM_THREADS": str(max(1, (os.cpu_count() or 1) // nproc))}}
                   if cpu else {}))
            save = work / f"model_{label}" / f"{cli.checkpoint}{cfg.MODEL.SAVE_NAME}"
            results[label] = result, seconds, updates(before, save)

        (n_res, n_s, _), (one, one_s, _) = results["n"], results["1"]
        check, rels = differences(results["n"], results["1"])
        worst = max(rels, key=rels.get)
        floor_line = None
        if floor:
            losses, floor_rels = differences(results["plain"], results["1"])
            floor_worst = max(floor_rels, key=floor_rels.get)
            floor_line = {**losses, "worst_update_rel": floor_rels[floor_worst],
                          "worst_update": floor_worst}
        placeholders = sum(r[0]["placeholders"] for r in results.values())
        ok = (all(v <= loss_limit for v in check.values()) and rels[worst] <= update_limit
              and n_res["world"] == args.nproc and one["world"] == 1 and placeholders == 0)
    card = venue(args.device, args.nproc)
    def timing(res, seconds):
        e = res["epochs"][0]
        return (f"{seconds:.2f} s, {e['train']['steps']} steps, epoch {e['seconds']:.2f} s, "
                f"iter_time {e['train']['iter_time'] * 1e3:.1f} ms, data_time "
                f"{e['train']['data_time'] * 1e3:.1f} ms, rank 0's peak memory "
                f"{(res['peak_memory_bytes'] or 0) / 2**30:.2f} GiB")

    print(f"{'data' if data == args.nproc else 'model'} parallel: {args.nproc} processes "
          f"(data {data} x fsdp {args.fsdp} x seq {args.seq} x pipe {args.pipe} x tensor "
          f"{args.tensor}) at batch "
          f"{batch // slices} "
          f"({timing(n_res, n_s)}) against 1 at batch {batch} ({timing(one, one_s)}) "
          f"on {args.config} in {dtype}: losses relative "
          f"{', '.join(f'{k} {v:.3e}' for k, v in check.items())} (limit {loss_limit}); "
          f"parameter updates worst {worst} {rels[worst]:.3e} over {len(rels)} tensors "
          f"(limit {update_limit}); {placeholders} placeholders | {card}", flush=True)
    if floor_line:
        print(f"rounding floor: 1 process with the plain attention against 1 with the kernels: "
              f"losses relative {', '.join(f'{k} {floor_line[k]:.3e}' for k in check)}; "
              f"parameter updates worst {floor_line['worst_update']} "
              f"{floor_line['worst_update_rel']:.3e} (not held) | {card}", flush=True)
    print(json.dumps({"ok": ok, "nproc": args.nproc, "config": args.config, "device": card,
                      "fsdp": args.fsdp, "seq": args.seq, "pipe": args.pipe,
                      "tensor": args.tensor,
                      "batch": batch, "steps": STEPS,
                      "dropout": args.dropout, "float32": args.float32,
                      "dtype": dtype, "limits": {"loss": loss_limit, "update": update_limit},
                      **check,
                      "worst_update_rel": rels[worst], "worst_update": worst,
                      "floor": floor_line,
                      "placeholders": placeholders, "seconds": {"n": n_s, "1": one_s},
                      "peak_memory_bytes": {"n": n_res["peak_memory_bytes"],
                                            "1": one["peak_memory_bytes"]}}),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
