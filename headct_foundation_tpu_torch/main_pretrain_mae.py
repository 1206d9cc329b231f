"""MAE pretraining CLI of the port (the JAX package's ``main_pretrain_mae.py``;
reference surface: main_pretrain_mae.py).

    python -m headct_foundation_tpu_torch.main_pretrain_mae --cfg configs/mae/mae_HeadCT.yaml \\
        [--opts KEY VALUE ...] [--batch_size N] [--max_epochs E] [--model_load_path PATH] \\
        [--device cuda|cpu] ...
    torchrun --nproc_per_node N -m headct_foundation_tpu_torch.main_pretrain_mae --cfg ...

The path: CSV manifests -> disk cache (native decoder) -> threaded loader ->
pinned prefetch -> the MAE train step -> trainer with latest/best
checkpoints -> tester. It runs on ``cuda`` (``cuda:LOCAL_RANK`` under
``torchrun``, one process per card) unless ``--device cpu`` is given. The
ranks lay out as ``PARALLEL.DATA x FSDP x SEQ x PIPE x TENSOR``
(``parallel/mesh.py``): the gradients are averaged over ``data``, each
``fsdp`` rank holds a shard of the weights, each ``seq`` rank a share of the
tokens, each ``pipe`` rank a stage of both trunks (GPipe,
``parallel/pipeline.py``; ``PIPE`` takes ``FSDP``, ``SEQ`` and ``TENSOR``
at 1) and each ``tensor`` rank a share of the heads and MLP columns, and the
ranks of one data slice read the same batches.

* The LR is scaled as the JAX main does (``:109-118``): ``BASE_LR x
  BATCH_SIZE x world / 256`` and ``MIN_LR = BASE_LR x 1e-3``.
* ``DATA.WIRE_FORMAT: auto`` is resolved from a host-to-device probe first.
* ``--model_load_path`` is routed by content (JAX ``:136-163``): a torch
  file is merged into the parameters; a pickle of either package resumes
  the whole train state (parameters, optimizer, step, epoch), and one whose
  full resume fails is merged into the parameters only.
* numpy is seeded per rank; the model and the step's randomness from
  ``SEED`` alone, so every rank starts from the same weights.
* Rank 0 writes ``config.json`` into ``OUTPUT``; ``wandb`` is used when
  ``WANDB.WANDB_ENABLE`` is set and it imports.
* At the end rank 0 prints one JSON line ``{"cli": ...}``: each epoch's
  seconds and stats (losses, ``iter_time``, ``data_time``, the kernels'
  launches in training and validation), the test stats, the number of
  scans served as placeholders over all ranks and, on a card, the peak
  memory allocated.
* The scan decoder is built when the loaders are made: a decoder that
  cannot be built or loaded stops the CLI at start-up.

Orbax checkpoints (``TRAIN.CKPT_FORMAT: orbax`` or a directory path) import
JAX and raise ``OrbaxNotSupportedError`` at start-up.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from functools import partial
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from headct_foundation_tpu_torch.config import get_config
from headct_foundation_tpu_torch.engines import mae_engine
from headct_foundation_tpu_torch.feature_extraction import resolve_device
from headct_foundation_tpu_torch.logger import create_logger
from headct_foundation_tpu_torch.parallel import distributed, mesh
from headct_foundation_tpu_torch.utils.checkpoint import restore_state
from headct_foundation_tpu_torch.utils.torch_interop import (
    classify_checkpoint,
    load_pretrained_into,
    merge_params,
    refuse_orbax,
    state_dict_of_payload,
)


def base_parser(description: str) -> argparse.ArgumentParser:
    """The JAX mains' common flags (``--dist-backend`` and ``--dist-url`` are
    accepted and unused, as ``--local_rank``), and ``--device``."""
    parser = argparse.ArgumentParser(description, add_help=False)
    parser.add_argument("--cfg", type=str, required=True, metavar="FILE",
                        help="path to config file")
    parser.add_argument("--opts", help="Modify config options using the command-line",
                        default=None, nargs="+")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; cuda:LOCAL_RANK under torchrun) or cpu")
    parser.add_argument("--local_rank", type=int, default=0,
                        help="accepted for reference CLI parity; torchrun's LOCAL_RANK is read")
    parser.add_argument("--dist-backend", default="nccl", help="accepted for reference CLI parity")
    parser.add_argument("--dist-url", default="env://", help="accepted for reference CLI parity")
    parser.add_argument("--seed", type=int, help="seed")
    parser.add_argument("--use_amp", action="store_true",
                        help="reference flag; bf16 compute is always on")
    parser.add_argument("--use_wandb", action="store_true")
    parser.add_argument("--wandb_project", type=str, default=None)
    parser.add_argument("--model_name", type=str, help="model name")
    parser.add_argument("--model_load_path", type=str, help="path to trained model")
    parser.add_argument("--optimizer", type=str, help="training optimizer")
    parser.add_argument("--scheduler", type=str, help="learning rate scheduler")
    parser.add_argument("--base_lr", type=float, help="base learning rate")
    parser.add_argument("--min_lr", type=float, help="minimum learning rate")
    parser.add_argument("--weight_decay", type=float, help="weight decay")
    parser.add_argument("--grad_clip", type=float, help="gradient clipping")
    parser.add_argument("--batch_size", type=int, help="batch size")
    parser.add_argument("--num_workers", type=int, help="dataloader workers")
    parser.add_argument("--max_epochs", type=int, help="max epoch")
    parser.add_argument("--train_csv_path", type=str)
    parser.add_argument("--val_csv_path", type=str)
    parser.add_argument("--test_csv_path", type=str)
    return parser


def parse_option(argv: Optional[List[str]] = None,
                 description: str = "MAE 3D pretraining (PyTorch)"):
    """The pretraining mains' flags (``base_parser``)."""
    parser = base_parser(description)
    args, _ = parser.parse_known_args(argv)
    return args, get_config(args)


def resolve_run_device(name: str) -> torch.device:
    """``cuda`` means this process's card (``LOCAL_RANK``)."""
    dev = torch.device(name)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", distributed.local_rank())
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def init_wandb(config):
    if not config.WANDB.WANDB_ENABLE or distributed.rank() != 0:
        return None
    try:
        import wandb
    except ImportError:
        print("wandb not available; continuing without it")
        return None
    return wandb.init(project=config.WANDB.PROJECT, config=config.to_dict())


def resume(state, path: str, logger):
    """Content-routed ``--model_load_path``; returns (state, start_epoch).
    A state split over ``fsdp`` or ``tensor`` loads the full file into its
    ``full_view`` and keeps its shards (any mesh reads any file)."""
    full = state.full_view() if hasattr(state, "full_view") else state
    is_torch, payload = classify_checkpoint(path)
    start_epoch = 0
    if is_torch:
        load_pretrained_into(full.model, path, logger=logger)
    else:
        try:
            full, start_epoch, _ = restore_state(full, payload)
            logger.info(f"Resumed from {path} at epoch {start_epoch}")
        except (ValueError, KeyError, TypeError) as e:
            # an architecture-mismatched or params-only pickle: a strict=False warm
            # start (the reference's load_model; the epoch is not restored)
            logger.info(f"Full resume failed ({e}); merging params only")
            merged, _, _ = merge_params(full.model.state_dict(),
                                        state_dict_of_payload(payload,
                                                              into=full.model.state_dict()))
            full.model.load_state_dict(merged)
    if full is not state:
        state.load_full(full)
    return state, start_epoch


def prepare_run(config, device: torch.device, logger) -> Dict[str, Any]:
    """What both pretraining CLIs do before their engine: refuse orbax,
    resolve ``WIRE_FORMAT: auto``, make the loaders, scale the LR to the
    effective batch (``BASE_LR x BATCH_SIZE x world / 256``, ``MIN_LR =
    BASE_LR x 1e-3``, reference: main_pretrain_mae.py:149-152) and count
    the steps. Returns the load path (or None), the world size, the three
    loaders, ``niter_per_ep``, ``total_steps`` and ``num_warmup_steps``."""
    from headct_foundation_tpu_torch.data.datasets import get_pretrain_dataloaders
    from headct_foundation_tpu_torch.data.pipeline import resolve_wire_format

    refuse_orbax(fmt=str(config.TRAIN.CKPT_FORMAT))
    load_path = config.MODEL.PRETRAINED
    load_path = None if load_path in (None, "", "None") else str(load_path)
    if load_path is not None:
        refuse_orbax(load_path)
    # the seq and tensor ranks of one data slice read the same batches
    rank, world = distributed.data_rank(), distributed.data_world()
    if str(config.DATA.WIRE_FORMAT) == "auto":
        config.defrost()
        config.DATA.WIRE_FORMAT = resolve_wire_format(config, device)
        config.freeze()
        logger.info(f"Resolved DATA.WIRE_FORMAT=auto -> {config.DATA.WIRE_FORMAT}")
    loaders = get_pretrain_dataloaders(config, rank, world, device=device)
    effective_batch_size = int(config.DATA.BATCH_SIZE) * world
    niter_per_ep = len(loaders[0])
    total_steps = niter_per_ep * int(config.TRAIN.MAX_EPOCHS)
    num_warmup_steps = int(config.TRAIN.PER_WARMUP * total_steps)
    config.defrost()
    config.TRAIN.BASE_LR = config.TRAIN.BASE_LR * effective_batch_size / 256
    config.TRAIN.MIN_LR = config.TRAIN.BASE_LR * 1e-3
    config.freeze()
    logger.info(f"Effective LR: {config.TRAIN.BASE_LR}, Effective Batch: {effective_batch_size}, "
                f"Epochs: {config.TRAIN.MAX_EPOCHS}, Warmup/Total steps: "
                f"{num_warmup_steps}/{total_steps}, World: {world}, Device: {device}")
    return {"load_path": load_path, "world": world, "loaders": loaders,
            "niter_per_ep": niter_per_ep, "total_steps": total_steps,
            "num_warmup_steps": num_warmup_steps}


def count_placeholders(loaders, device: torch.device) -> int:
    """Scans served as placeholders over ``loaders`` and every data rank."""
    placeholders = torch.tensor(float(sum(loader.dataset.placeholders for loader in loaders)),
                                device=device)
    distributed.data_mean_([placeholders])
    return round(placeholders.item() * distributed.data_world())


def mesh_sizes() -> Dict[str, int]:
    """The process's mesh for the CLI's JSON line."""
    m = mesh.current()
    return {a: m.size(a) for a in ("data", "fsdp", "seq", "pipe", "tensor")}


def finish_run(run: Dict[str, Any], device: torch.device, start_epoch: int,
               history: List[Dict[str, Any]], best_loss: float,
               test_stats: Dict[str, Any]) -> Dict[str, Any]:
    """Close the loaders and gather the CLI's result: the epochs, the test
    stats, the scans served as placeholders over the three loaders and
    every rank, and on a card the peak memory allocated."""
    train_loader, val_loader, test_loader = run["loaders"]
    for loader in (val_loader, test_loader):
        loader.close()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    return {"device": str(device), "world": distributed.world(), "mesh": mesh_sizes(),
            "start_epoch": start_epoch,
            "epochs": history, "best_val_loss": best_loss, "test": test_stats,
            "placeholders": count_placeholders(run["loaders"], device),
            "peak_memory_bytes": peak}


def create_state(config, run: Dict[str, Any], device, dtype: torch.dtype = torch.bfloat16):
    """The train state the CLI starts from (weights from ``SEED``, compute in
    ``dtype``); ``run`` holds ``prepare_run``'s step counts."""
    return mae_engine.create_train_state(config, run["total_steps"], run["num_warmup_steps"],
                                         seed=int(config.SEED), dtype=dtype, device=device)[0]


def make_train_step(config):
    """The CLI's train step: augmentation on the card and ``TRAIN.ACCUM_STEPS``
    micro-batches (the port's bench times this object)."""
    return mae_engine.make_train_step(augment=True, accum_steps=int(config.TRAIN.ACCUM_STEPS),
                                      config=config)


def main(config, device: torch.device, logger, wandb_run=None,
         dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """The run; ``dtype`` is the compute dtype (bfloat16 as the JAX main;
    float32 for ``tools/check_data_parallel.py --float32``)."""
    run = prepare_run(config, device, logger)
    train_loader, val_loader, test_loader = run["loaders"]
    state = create_state(config, run, device, dtype)
    start_epoch = 0
    if run["load_path"] is not None:
        state, start_epoch = resume(state, run["load_path"], logger)

    train_step = make_train_step(config)
    eval_step = mae_engine.make_eval_step(config)
    history: List[Dict[str, Any]] = []
    state, best_loss = mae_engine.trainer(
        config, state, train_step, eval_step, train_loader, val_loader, int(config.SEED),
        int(config.TRAIN.MAX_EPOCHS), int(config.TRAIN.VAL_EVERY), logger=logger,
        start_epoch=start_epoch, wandb_run=wandb_run, history=history)
    logger.info(f"train completed, best val loss: {best_loss:.4f}")
    test_stats = mae_engine.tester(config, state, eval_step, test_loader, int(config.SEED),
                                   logger=logger, wandb_run=wandb_run)
    logger.info(f"test completed, test loss: {test_stats.get('loss', float('nan')):.4f}")
    return finish_run(run, device, start_epoch, history, best_loss, test_stats)


def run_cli(argv: Optional[List[str]], main_fn, description: str,
            parse=parse_option) -> Dict[str, Any]:
    """Parse (``parse(argv, description)``), start the process group, log,
    write ``config.json`` and run ``main_fn(config, device, logger,
    wandb_run)``; rank 0 prints its result as one JSON line ``{"cli": ...}``."""
    args, config = parse(argv, description)
    device = resolve_run_device(args.device)  # this process's card, before NCCL starts
    distributed.init_from_env(device.type, config=config)
    try:
        rank = distributed.rank()
        np.random.seed(int(config.SEED) + rank)
        os.makedirs(config.LOG.OUTPUT_DIR, exist_ok=True)
        logger = create_logger(config.LOG.OUTPUT_DIR, rank, config.LOG.FILENAME)
        if rank == 0 and config.OUTPUT:
            os.makedirs(config.OUTPUT, exist_ok=True)
            path = os.path.join(config.OUTPUT, "config.json")
            with open(path, "w") as f:
                json.dump(config.to_dict(), f, indent=2)
            logger.info(f"Full config saved to {path}")
        result = main_fn(config, device, logger, init_wandb(config))
        if rank == 0:
            print(json.dumps({"cli": result}), flush=True)
        return result
    finally:
        distributed.shutdown()


def run(argv: Optional[List[str]] = None, dtype: torch.dtype = torch.bfloat16
        ) -> Dict[str, Any]:
    return run_cli(argv, partial(main, dtype=dtype), "MAE 3D pretraining (PyTorch)")


if __name__ == "__main__":
    run(sys.argv[1:])
