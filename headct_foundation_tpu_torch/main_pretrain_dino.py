"""DINO pretraining CLI of the port (the JAX package's ``main_pretrain_dino.py``;
reference surface: main_pretrain_dino.py).

    python -m headct_foundation_tpu_torch.main_pretrain_dino --cfg configs/dino/dino_HeadCT.yaml \\
        [--opts KEY VALUE ...] [--batch_size N] [--max_epochs E] [--model_load_path PATH] \\
        [--device cuda|cpu] ...
    torchrun --nproc_per_node N -m headct_foundation_tpu_torch.main_pretrain_dino --cfg ...

The path: CSV manifests -> disk cache (native decoder) -> threaded loader ->
pinned prefetch -> the DINO train step (multi-crop, teacher, student, loss,
AdamW with the weight-decay schedule, the last-layer freeze, the teacher EMA
and the centre) -> trainer with latest/best checkpoints carrying the
teacher and the centre -> tester. It runs on ``cuda`` (``cuda:LOCAL_RANK``
under ``torchrun``, one process per card) unless ``--device cpu`` is given;
the flags, the LR scaling (``BASE_LR x BATCH_SIZE x world / 256``, ``MIN_LR
= BASE_LR x 1e-3``), the loaders and the ``{"cli": ...}`` JSON line with the
placeholder count are the MAE CLI's (``main_pretrain_mae.py``).

``--model_load_path`` (``MODEL.PRETRAINED``) is routed by content (JAX
``:116-177``): a torch file is merged into the student and, from its
``momentum_model_state_dict``, into the teacher; a pickle of either package
resumes the whole DINO state (``restore_dino_state``: "Resumed (full)" in
the log), and one whose parameters do not fit is merged into the student
and the teacher only, at epoch 0.
"""

from __future__ import annotations

import sys
from functools import partial
from typing import Any, Dict, List, Optional

import torch

from headct_foundation_tpu_torch.engines import dino_engine
from headct_foundation_tpu_torch.main_pretrain_mae import finish_run, prepare_run, run_cli
from headct_foundation_tpu_torch.utils.checkpoint import restore_dino_state
from headct_foundation_tpu_torch.utils.torch_interop import (
    CheckpointDtypeError,
    classify_checkpoint,
    load_pretrained_into,
    merge_params,
    state_dict_from_jax,
    state_dict_of_payload,
)


def resume(state: dino_engine.DINOTrainState, path: str, logger):
    """Content-routed ``--model_load_path``; returns (state, start_epoch). A
    state split over ``fsdp`` or ``tensor`` loads the file into its
    ``full_view`` and keeps its shards (any mesh reads any file)."""
    full = state.full_view()
    full, start_epoch = _resume_full(full, path, logger)
    return state.load_full(full), start_epoch


def _resume_full(state: dino_engine.DINOTrainState, path: str, logger):
    is_torch, payload = classify_checkpoint(path)
    if is_torch:
        load_pretrained_into(state.student, path, logger=logger)
        load_pretrained_into(state.teacher, path, state_key="momentum_model_state_dict",
                             logger=logger)
        return state, 0
    try:
        state, start_epoch, _ = restore_dino_state(state, payload, logger=logger)
    except (ValueError, KeyError, TypeError, CheckpointDtypeError) as e:
        # an architecture-mismatched or params-only pickle: a strict=False warm
        # start of both networks; a different run, so the schedules restart at 0
        logger.info(f"Full resume failed ({e}); merging params only")
        target = state.student.state_dict()
        state.student.load_state_dict(
            merge_params(target, state_dict_of_payload(payload, into=target))[0])
        if "momentum_model_state_dict" in payload:
            target = state.teacher.state_dict()
            state.teacher.load_state_dict(merge_params(
                target, state_dict_from_jax(payload["momentum_model_state_dict"]))[0])
        logger.info(f"Warm-started params from {path} (epoch 0)")
        return state, 0
    logger.info(f"Resumed (full) from {path} at epoch {start_epoch}")
    return state, start_epoch


def create_state(config, run: Dict[str, Any], device, dtype: torch.dtype = torch.bfloat16
                 ) -> dino_engine.DINOTrainState:
    """The train state the CLI starts from (weights from ``SEED``, compute in
    ``dtype``); ``run`` holds ``prepare_run``'s step counts."""
    return dino_engine.create_train_state(config, run["total_steps"], run["num_warmup_steps"],
                                          run["niter_per_ep"], seed=int(config.SEED),
                                          dtype=dtype, device=device)


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

    train_step = dino_engine.make_train_step(config)
    eval_step = dino_engine.make_eval_step(config)
    history: List[Dict[str, Any]] = []
    state, best_loss = dino_engine.trainer(
        config, state, train_step, eval_step, train_loader, val_loader, int(config.SEED),
        int(config.TRAIN.MAX_EPOCHS), int(config.TRAIN.VAL_EVERY), logger=logger,
        start_epoch=start_epoch, wandb_run=wandb_run, history=history)
    logger.info(f"train completed, best val loss: {best_loss:.4f}")
    test_stats = dino_engine.tester(config, state, eval_step, test_loader, int(config.SEED),
                                    logger=logger, wandb_run=wandb_run)
    logger.info(f"test completed, test loss: {test_stats.get('loss', float('nan')):.4f}")
    return finish_run(run, device, start_epoch, history, best_loss, test_stats)


def run(argv: Optional[List[str]] = None, dtype: torch.dtype = torch.bfloat16
        ) -> Dict[str, Any]:
    return run_cli(argv, partial(main, dtype=dtype), "DINO 3D pretraining (PyTorch)")


if __name__ == "__main__":
    run(sys.argv[1:])
