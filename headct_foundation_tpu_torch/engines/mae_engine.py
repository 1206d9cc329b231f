"""MAE pretraining engine: model and optimizer state, train and eval steps,
epoch loops.

Port of the JAX package's ``engines/mae_engine.py:44-163, 226-491``
(reference: engine_pretrain_mae.py:14-147):

* ``create_train_state`` builds the MAE (bfloat16 compute, float32
  parameters), draws its weights from a seeded generator on the CPU (so a
  seed gives the same weights on any device), moves it to the device,
  freezes the sincos position embeddings and builds AdamW and the LR
  schedule.
* ``make_train_step(augment, accum_steps, config)`` returns
  ``step(state, batch, seed, draws=None)``: window the wire batch and cast it
  to bfloat16 (whatever the model's compute dtype, as the JAX step's
  ``wire_to_compute`` does), then per micro-batch augment, mask, forward and
  backward, then one AdamW update with ``lr(step)``. With ``accum_steps > 1``
  the micro-batch gradients are summed in float32 and divided by
  ``accum_steps`` before the update (JAX ``:294-323``).
* Randomness is explicit: micro-batch ``i`` of update ``step`` draws its mask
  noise and then its augmentation decisions from a generator seeded from
  (seed, step, i). ``draws`` lets a caller inject both instead (one dict per
  micro-batch with ``"noise"`` [n, L] and ``"augment"`` decisions).
* ``train_one_epoch`` fetches the losses in groups of ``LOSS_FLUSH`` (one
  device-to-host copy per group) and exits on a non-finite loss, as the JAX
  engine does (``:410-450``).

The trainer loop, checkpoints and the CLI are not ported yet.
"""

from __future__ import annotations

import logging
import math
import sys
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from headct_foundation_tpu_torch.data.augment import apply_mae_augment, draw_mae_augment
from headct_foundation_tpu_torch.data.device_preprocess import wire_to_compute
from headct_foundation_tpu_torch.feature_extraction import resolve_device
from headct_foundation_tpu_torch.models.mae import MaskedAutoencoderViT
from headct_foundation_tpu_torch.ops.attention import set_pallas_min_t
from headct_foundation_tpu_torch.optim.lr_sched import Schedule, get_lr_schedule
from headct_foundation_tpu_torch.optim.optimizers import get_optimizer

LOSS_FLUSH = 8  # steps between batched loss fetches (see train_one_epoch)


@dataclass
class TrainState:
    model: MaskedAutoencoderViT
    optimizer: torch.optim.Optimizer
    lr_schedule: Schedule
    step: int = 0  # optimizer updates taken

    @property
    def device(self) -> torch.device:
        return self.model.cls_token.device


def build_mae_model(config, dtype: torch.dtype = torch.bfloat16) -> MaskedAutoencoderViT:
    """The MAE from config keys (reference: main_pretrain_mae.py:103-126)."""
    m = config.MAE
    return MaskedAutoencoderViT(
        input_size=m.INPUT_SIZE, patch_size=m.PATCH_SIZE, mask_ratio=m.MASK_RATIO,
        in_chans=m.IN_CHANS, dropout_rate=m.DROPOUT_RATE, spatial_dims=m.SPATIAL_DIMS,
        pos_embed=m.POS_EMBED, encoder_depth=m.ENCODER_DEPTH,
        encoder_embed_dim=m.ENCODER_EMBED_DIM, encoder_mlp_dim=m.ENCODER_MLP_DIM,
        encoder_num_heads=m.ENCODER_NUM_HEADS, decoder_depth=m.DECODER_DEPTH,
        decoder_embed_dim=m.DECODER_EMBED_DIM, decoder_mlp_dim=m.DECODER_MLP_DIM,
        decoder_num_heads=m.DECODER_NUM_HEADS, norm_pix_loss=m.NORM_PIX_LOSS,
        loss_dtype=getattr(m, "LOSS_DTYPE", "float32"), use_bias=m.USE_BIAS,
        norm_layer=m.NORM_LAYER, remat=config.PARALLEL.REMAT, dtype=dtype,
    )


def mae_trainable_mask(model: torch.nn.Module, pos_embed: str) -> Dict[str, bool]:
    """Parameter name -> trainable. The sincos position embeddings are fixed
    (reference: requires_grad=False, src/utils/pos_embed.py:82-83)."""
    frozen = ("position_embeddings", "decoder_pos_embed") if pos_embed == "sincos" else ()
    return {name: name.rsplit(".", 1)[-1] not in frozen
            for name, _ in model.named_parameters()}


def create_train_state(
    config, total_steps: int, num_warmup_steps: int, seed: int = 0,
    dtype: torch.dtype = torch.bfloat16, device: Union[None, str, torch.device] = None,
) -> Tuple[TrainState, Schedule]:
    """Model, AdamW and LR schedule on ``device`` (default cuda)."""
    device = resolve_device(device)
    set_pallas_min_t(config.PARALLEL.PALLAS_MIN_T)
    model = build_mae_model(config, dtype=dtype)
    model.init_weights(torch.Generator().manual_seed(seed)).to(device)
    trainable = mae_trainable_mask(model, config.MAE.POS_EMBED)
    for name, p in model.named_parameters():
        p.requires_grad_(trainable[name])
    lr_schedule = get_lr_schedule(config, config.TRAIN.BASE_LR, num_warmup_steps, total_steps,
                                  config.TRAIN.MIN_LR)
    optimizer = get_optimizer(config, model.parameters(),
                              grad_clip=config.TRAIN.GRAD_CLIP or None)
    return TrainState(model, optimizer, lr_schedule), lr_schedule


def step_generator(device: torch.device, *keys: int) -> torch.Generator:
    """A generator on ``device`` seeded from the integer ``keys``."""
    hi, lo = np.random.SeedSequence([int(k) for k in keys]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed((int(hi) << 32) | int(lo))


def make_train_step(augment: bool = False, accum_steps: int = 1, config=None) -> Callable:
    """step(state, batch, seed, draws=None) -> (state, {"loss": device scalar}).

    ``batch`` is a wire batch [B, C or 1, R, R, R]; ``config.DATA.WIRE_FORMAT``
    says how to window it."""
    in_chans = int(config.MAE.IN_CHANS) if config is not None else 0

    def train_step(state: TrainState, batch: torch.Tensor, seed: int,
                   draws: Optional[Sequence[dict]] = None):
        model, device = state.model, state.device
        model.train()
        batch = wire_to_compute(batch.to(device), config, in_chans)
        B = batch.shape[0]
        if B % accum_steps:
            raise ValueError(f"batch {B} does not split into {accum_steps} micro-batches")
        n = B // accum_steps
        loss_sum = torch.zeros((), device=device)
        for i in range(accum_steps):
            mb = batch[i * n:(i + 1) * n]
            if draws is None:
                g = step_generator(device, seed, state.step, i)
                noise = torch.rand((n, int(np.prod(model.grid_size))), generator=g,
                                   device=device)
                decisions = draw_mae_augment(n, g, device) if augment else None
            else:
                noise, decisions = draws[i]["noise"], draws[i].get("augment")
            if augment:
                mb = apply_mae_augment(mb, decisions)
            loss, _, _ = model(mb, noise=noise)
            loss.backward()  # float32 .grad of float32 params: the sum over micro-batches
            loss_sum += loss.detach().float()
        if accum_steps > 1:
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(accum_steps)
        lr = state.lr_schedule(state.step)  # optax's count before the increment
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        return state, {"loss": loss_sum / accum_steps}

    return train_step


def make_eval_step(config=None) -> Callable:
    """step(state, batch, generator=None) -> {"loss": device scalar}; the mask
    noise is drawn from ``generator``."""
    in_chans = int(config.MAE.IN_CHANS) if config is not None else 0

    @torch.no_grad()
    def eval_step(state: TrainState, batch: torch.Tensor,
                  generator: Optional[torch.Generator] = None):
        model = state.model
        model.eval()
        batch = wire_to_compute(batch.to(state.device), config, in_chans)
        loss, _, _ = model(batch, generator=generator)
        return {"loss": loss}

    return eval_step


def to_device_batch(batch, device: torch.device) -> torch.Tensor:
    """hu16 (int16) and hu8 (uint8) wire batches ship as they are (the step
    windows them); float batches ship in bfloat16, the step's input dtype."""
    t = torch.as_tensor(np.asarray(batch)) if not isinstance(batch, torch.Tensor) else batch
    if t.dtype in (torch.int16, torch.uint8):
        return t.to(device)
    return t.to(device=device, dtype=torch.bfloat16)


def drain_pending_losses(pending: List[Tuple[torch.Tensor, int]], logger,
                         log_fn: Callable[[float, int], None]) -> None:
    """Fetch every pending (loss, idx) in one copy, exit on a non-finite loss
    (reference: engine_pretrain_mae.py:76-78), and log each value."""
    if not pending:
        return
    values = torch.stack([loss.float() for loss, _ in pending]).cpu().tolist()
    for loss, (_, idx) in zip(values, pending):
        if not math.isfinite(loss):
            if logger:
                logger.info(f"Loss is {loss}, stopping training")
            sys.exit(1)
        log_fn(loss, idx)
    pending.clear()


def _batches(loader: Iterable):
    for batch in loader:
        yield batch[0] if isinstance(batch, tuple) else batch  # (volumes, fnames)


def train_one_epoch(
    config, state: TrainState, train_step, loader: Iterable, seed: int, epoch: int,
    max_epoch: int, logger: Optional[logging.Logger] = None,
) -> Tuple[TrainState, Dict[str, float]]:
    """One pass over ``loader``; returns the state and the mean loss, mean
    LR and mean seconds per step (host clock, losses fetched in groups)."""
    n_batches = len(loader) if hasattr(loader, "__len__") else None
    losses: List[float] = []
    lrs: List[float] = []
    pending: List[Tuple[torch.Tensor, int]] = []

    def log(loss: float, idx: int) -> None:
        losses.append(loss)
        lrs.append(float(state.lr_schedule((n_batches or 0) * epoch + idx)))
        if logger:
            total = n_batches if n_batches is not None else "?"
            logger.info(f"Epoch {epoch + 1}/{max_epoch} [{idx + 1}/{total}]  Loss: {loss:.4f}")

    t0 = time.perf_counter()
    steps = 0
    for idx, batch in enumerate(_batches(loader)):
        data = to_device_batch(batch, state.device)
        state, metrics = train_step(state, data, seed)
        steps += 1
        pending.append((metrics["loss"], idx))
        if len(pending) >= LOSS_FLUSH:
            drain_pending_losses(pending, logger, log)
    drain_pending_losses(pending, logger, log)
    stats = {"iter_time": (time.perf_counter() - t0) / max(steps, 1)}
    if losses:
        stats.update(loss=float(np.mean(losses)), lr=float(np.mean(lrs)))
    return state, stats


def val_one_epoch(
    config, state: TrainState, eval_step, loader: Iterable, seed: int, epoch: int,
    max_epoch: int, logger: Optional[logging.Logger] = None,
) -> Dict[str, float]:
    """Mean loss over ``loader``; batch ``idx`` masks with a generator seeded
    from (seed, idx)."""
    losses = []
    for idx, batch in enumerate(_batches(loader)):
        data = to_device_batch(batch, state.device)
        metrics = eval_step(state, data, step_generator(state.device, seed, idx))
        loss = float(metrics["loss"])
        losses.append(loss)
        if logger:
            logger.info(f"Val Epoch {epoch + 1}/{max_epoch} [{idx + 1}]  Loss: {loss:.4f}")
    return {"loss": float(np.mean(losses))} if losses else {}
