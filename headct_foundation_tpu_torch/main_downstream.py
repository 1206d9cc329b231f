"""Downstream fine-tune, linear-probe, LoRA and few-shot CLI of the port (the
JAX package's ``main_downstream.py``; reference surface: main_downstream.py).

    python -m headct_foundation_tpu_torch.main_downstream --cfg configs/downstream/vit_HeadCT_cq500.yaml \\
        --dataset cq500 --label_name ICH [--model_load_path <MAE/DINO checkpoint>] \\
        [--lock] [--lora] [--few_shots K] [--classifier linear|attentive] \\
        [--device cuda|cpu] [--opts KEY VALUE ...] ...
    torchrun --nproc_per_node N -m headct_foundation_tpu_torch.main_downstream --cfg ...

The flags are the JAX main's (``:32-73``) and ``--device``; it runs on
``cuda`` (``cuda:LOCAL_RANK`` under ``torchrun``) unless ``--device cpu`` is
given. The path: label manifests -> disk cache (native decoder) -> threaded
loader (inverse-frequency weighted draws, or ``DATA.FEW_SHOTS`` per class)
-> pinned prefetch of volumes and targets -> the downstream train step
(``engines/downstream_engine.py``) -> best-by-validation-AUROC selection
with a ``best_`` checkpoint -> tester with the predictions pickle.

* ``MIN_LR`` is overwritten with ``BASE_LR x 1e-3``; the BASE_LR is not
  scaled by the batch (JAX ``:100-106``); the total steps are
  ``len(train_loader) x MAX_EPOCHS``.
* ``--model_load_path`` (``MODEL.PRETRAINED``) warm-starts the backbone
  strict=False from an MAE or DINO checkpoint of either package or a
  reference torch file (``utils/torch_interop.load_pretrained_into``):
  an MAE's decoder and mask token, or a DINO backbone's register tokens
  against the downstream ViT's none, are counted as unexpected, not an
  error.
* The test runs with the best epoch's weights and BatchNorm statistics.
* Rank 0 prints one JSON line ``{"cli": ...}``: the epochs, the best
  validation mean AUROC, the test stats, the predictions pickle's path, the
  scans served as placeholders over the three loaders and every rank, the
  warm start's merged / missing / unexpected counts, the peak memory on a
  card.
"""

from __future__ import annotations

import sys
from functools import partial
from typing import Any, Dict, List, Optional

import torch

from headct_foundation_tpu_torch.config import get_config
from headct_foundation_tpu_torch.engines import downstream_engine
from headct_foundation_tpu_torch.main_pretrain_mae import (
    base_parser,
    count_placeholders,
    mesh_sizes,
    run_cli,
)
from headct_foundation_tpu_torch.parallel import distributed
from headct_foundation_tpu_torch.utils.torch_interop import load_pretrained_into, refuse_orbax


def parse_option(argv: Optional[List[str]] = None,
                 description: str = "Downstream classification (PyTorch)"):
    parser = base_parser(description)
    parser.add_argument("--preds_save_name", type=str)
    parser.add_argument("--filename", type=str, default=None)
    parser.add_argument("--classifier", type=str, help="linear or attentive")
    parser.add_argument("--label_name", type=str)
    parser.add_argument("--lock", action="store_true")
    parser.add_argument("--lora", action="store_true")
    parser.add_argument("--dataset", type=str)
    parser.add_argument("--few_shots", type=int)
    args, _ = parser.parse_known_args(argv)
    config = get_config(args)
    if args.lora:
        config.defrost()
        config.TRAIN.LORA = True
        config.freeze()
    return args, config


def make_loaders(config, device: torch.device):
    """(train, val, test) loaders of this rank: few-shot when
    ``DATA.FEW_SHOTS > 0``, else the weighted fine-tune draws."""
    from headct_foundation_tpu_torch.data.datasets import (
        get_fewshots_dataloaders,
        get_finetune_dataloaders,
    )

    make = get_fewshots_dataloaders if int(config.DATA.FEW_SHOTS) > 0 else get_finetune_dataloaders
    # the seq and tensor ranks of one data x fsdp slice read the same batches
    return make(config, distributed.data_rank(), distributed.data_world(), device=device)[:3]


def create_state(config, run: Dict[str, Any], device, dtype: torch.dtype = torch.bfloat16
                 ) -> downstream_engine.DownstreamTrainState:
    """The train state the CLI starts from (weights from ``SEED``, computing
    in ``dtype``); ``run`` holds the step counts."""
    return downstream_engine.create_train_state(config, run["total_steps"],
                                                run["num_warmup_steps"], seed=int(config.SEED),
                                                dtype=dtype, device=device)


def main(config, device: torch.device, logger, wandb_run=None,
         dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """The run; ``dtype`` is the compute dtype (bfloat16 as the JAX main
    computes; float32, and float64 as its reference, for
    ``tools/check_data_parallel.py``)."""
    from headct_foundation_tpu_torch.data.pipeline import resolve_wire_format

    refuse_orbax(fmt=str(config.TRAIN.CKPT_FORMAT))
    load_path = config.MODEL.PRETRAINED
    load_path = None if load_path in (None, "", "None") else str(load_path)
    if load_path is not None:
        refuse_orbax(load_path)
    if str(config.DATA.WIRE_FORMAT) == "auto":
        config.defrost()
        config.DATA.WIRE_FORMAT = resolve_wire_format(config, device)
        config.freeze()
        logger.info(f"Resolved DATA.WIRE_FORMAT=auto -> {config.DATA.WIRE_FORMAT}")
    loaders = make_loaders(config, device)
    train_loader, val_loader, test_loader = loaders
    run = {"total_steps": len(train_loader) * int(config.TRAIN.MAX_EPOCHS)}
    run["num_warmup_steps"] = int(config.TRAIN.PER_WARMUP * run["total_steps"])
    config.defrost()
    config.TRAIN.MIN_LR = config.TRAIN.BASE_LR * 1e-3
    config.freeze()
    logger.info(f"LR: {config.TRAIN.BASE_LR} (classifier x100), LOCK: {config.TRAIN.LOCK}, "
                f"LoRA: {config.TRAIN.LORA}, Classifier: {config.TRAIN.CLASSIFIER}, "
                f"Warmup/Total steps: {run['num_warmup_steps']}/{run['total_steps']}, "
                f"World: {distributed.world()}, Device: {device}")
    state = create_state(config, run, device, dtype)
    warm_start = None
    if load_path is not None:  # into the whole backbone; each rank keeps its shards
        full = state.full_view()
        target = len(full.model.state_dict())
        missing, unexpected = load_pretrained_into(full.model, load_path, logger=logger)
        state.load_full(full)
        warm_start = {"path": load_path, "merged": target - len(missing),
                      "missing": len(missing), "unexpected": len(unexpected)}
        logger.info(f"Warm start: {warm_start['merged']} of {target} backbone tensors merged")
    n_params = sum(p.numel() for m in (state.model, state.classifier) for p in m.parameters())
    logger.info(f"Total params (model+classifier): {n_params / 1e6:.2f}M")

    train_step = downstream_engine.make_train_step(config, compute_dtype=dtype)
    eval_step = downstream_engine.make_eval_step(config, compute_dtype=dtype)
    history: List[Dict[str, Any]] = []
    state, best, best_auroc = downstream_engine.trainer(
        config, state, train_step, eval_step, train_loader, val_loader, int(config.SEED),
        int(config.TRAIN.MAX_EPOCHS), int(config.TRAIN.VAL_EVERY), logger=logger,
        wandb_run=wandb_run, history=history)
    logger.info(f"train completed, best val mean AUROC: {best_auroc:.4f}")
    # test with the best-by-AUROC weights and BatchNorm statistics
    state = downstream_engine.load_snapshot(state, best)
    test_stats = downstream_engine.tester(config, state, eval_step, test_loader, logger=logger,
                                          wandb_run=wandb_run)
    logger.info(f"test completed, loss {test_stats.get('loss', float('nan')):.4f}, "
                f"mean AUROC {test_stats.get('mean_auroc', float('nan')):.4f}")
    for loader in (val_loader, test_loader):
        loader.close()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    return {"device": str(device), "world": distributed.world(), "mesh": mesh_sizes(),
            "epochs": history,
            "best_val_mean_auroc": best_auroc, "test": test_stats,
            "placeholders": count_placeholders(loaders, device), "warm_start": warm_start,
            "peak_memory_bytes": peak}


def run(argv: Optional[List[str]] = None, dtype: torch.dtype = torch.bfloat16
        ) -> Dict[str, Any]:
    return run_cli(argv, partial(main, dtype=dtype), "Downstream classification (PyTorch)",
                   parse=parse_option)


if __name__ == "__main__":
    run(sys.argv[1:])
