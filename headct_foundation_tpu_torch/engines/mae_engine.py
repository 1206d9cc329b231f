"""MAE pretraining engine: model and optimizer state, train and eval steps,
epoch loops.

Port of the JAX package's ``engines/mae_engine.py:44-163, 226-491``
(reference: engine_pretrain_mae.py:14-147):

* ``create_train_state`` builds the MAE (bfloat16 compute, float32
  parameters), draws its weights from a seeded generator on the CPU (so a
  seed gives the same weights on any device), moves it to the device,
  freezes the sincos position embeddings and builds the optimizer of
  ``TRAIN.OPTIMIZER`` (SGD, AdamW, Lamb or Lion; Lion through the fused
  kernel B6 with ``TRAIN.LION_FUSED``) and the LR schedule; it keeps
  ``TRAIN.GRAD_CLIP``.
* ``make_train_step(augment, accum_steps, config)`` returns
  ``step(state, batch, seed, draws=None)``: window the wire batch and cast it
  to bfloat16 (whatever the model's compute dtype, as the JAX step's
  ``wire_to_compute`` does), then per micro-batch augment, mask, forward and
  backward, then one optimizer update with ``lr(step)``. With ``accum_steps >
  1`` the micro-batch gradients are summed in float32 and divided by
  ``accum_steps`` (JAX ``:294-323``). A nonzero ``TRAIN.GRAD_CLIP`` then clips
  each trainable gradient to that L2 norm (``clip_by_per_param_norm``), since
  the JAX chain clips the averaged gradients first (``:319-325``, then
  ``tx``).
* Randomness is explicit: micro-batch ``i`` of update ``step`` draws its mask
  noise and then its augmentation decisions from a generator seeded from
  (seed, step, i), and its dropout masks (``MAE.DROPOUT_RATE`` above 0; JAX
  ``:252-272`` splits ``mask_rng, drop_rng``) from one seeded from (seed,
  step, i, 1), so dropout leaves the masks as they are. ``draws`` lets a
  caller inject them instead (one dict per micro-batch with ``"noise"`` [n,
  L], the ``"augment"`` decisions and optionally a ``"dropout"`` generator).
* Under data parallelism (``parallel/distributed.py``) each rank draws the
  noise, augmentation decisions and dropout masks of the global micro-batch
  and takes its own rows, and the gradients (with the loss) are averaged
  across the data ranks once per update, after the accumulation and before
  the clip: world 2 at batch n computes what world 1 computes at batch 2n on
  the concatenated batch. The eval step draws its noise the same way.
* ``fsdp`` (ZeRO-3, ``parallel/fsdp.py``): the batch is split over ``data``
  x ``fsdp`` (``distributed.data_rank``); each rank holds its ``fsdp`` shard
  of every weight the rule table splits, with its gradient and optimizer
  state, and gathers it whole only while its Linear runs. The shards'
  gradients are summed over ``fsdp`` by the gather's backward and averaged
  over ``data``; the others are averaged over ``data`` x ``fsdp``.
* ``seq`` and ``tensor`` (``parallel/mesh.py``, JAX ``ops/attention.py:120-186``
  and its rule table): the ranks of a data slice take the same batch; each
  ``seq`` rank holds ceil(T / s) tokens of each trunk (``models/mae.py``) and
  each ``tensor`` rank the Megatron part of every block
  (``models/attention.py shard_block_``). ``create_train_state`` draws the full
  seed-``seed`` weights and keeps this rank's part, so any mesh starts from
  the one-process weights. Every gradient is summed over ``seq`` (each rank
  differentiated its tokens' share); a split parameter keeps its part's
  gradient, whose clip norm is taken over all its parts. The step is
  ``make_grad_step`` (the gradients) then ``apply_update``. ``full_view`` /
  ``load_full`` give checkpoints the whole tensors at any mesh.
* ``pipe`` (GPipe, ``parallel/pipeline.py``; JAX ``:110-120``, ``:186-223``):
  each rank holds the seed-``seed`` weights of blocks [c L/S, (c+1) L/S) of
  both trunks at ``pipe`` coordinate c (and their optimizer state), and the
  prefix and suffix whole; the ``pipe`` ranks of a data slice take the same
  batch. The loss is ``pipelined_loss``: the model's prefix, the trunks
  through ``pipeline_apply`` in ``PARALLEL.PIPE_MICROBATCH`` microbatches,
  its suffix, with ``accum_steps`` and ``PARALLEL.REMAT`` inside. The
  gradients are averaged over ``data``; those of the prefix and suffix are
  made ``pipe`` coordinate 0's (``pipeline.replicate_``), so they stay
  bit-equal. The clip and Lamb take each block parameter's norm over its
  stacked leaf (every layer of every stage), as JAX's optimizer sees the
  stacked [L] leaf. Checkpoints hold the stacked trunks, params and
  moments, as the JAX package's ``PIPE`` state (``jax_trees``);
  ``MAE.DROPOUT_RATE`` above 0 and a depth that ``PIPE`` does not divide
  raise ValueError (``check_pipe``).
* ``train_one_epoch`` takes its batches through ``data/pipeline.py
  DevicePrefetcher`` (pinned copies on a side stream), fetches the losses in
  groups of ``LOSS_FLUSH`` (one device-to-host copy per group) and exits on a
  non-finite loss, as the JAX engine does (``:410-450``); it reports the mean
  ``iter_time`` and ``data_time`` (the wait on the loader) per step.
* ``trainer`` (JAX ``:494``) runs the epochs, writes ``latest_{SAVE_NAME}``
  every epoch and ``best_{SAVE_NAME}`` on a new best validation loss
  (``utils/checkpoint.py``), validates every ``VAL_EVERY`` epochs, and
  closes the loader and waits for the checkpoint writer at the end. The
  stored epoch is the one that just finished, and a resume restarts at that
  index (the reference's quirk, MIGRATION.md:52-55). ``tester`` (``:565``)
  is one validation pass over the test loader.
* Each epoch's stats carry the kernels' launches in it (``launches``, from
  the wrappers' counters), which the CLI prints; the trainer's "Epoch N
  done" log line gives them too, with the steps and the train loader's
  placeholders so far, for a run that never reaches its JSON line (the
  soak tool's killed run). ``allreduce`` is the calls and bytes that
  ``distributed.all_reduce_sum_`` exchanged in the epoch.
* Spans (``utils/tracing.py``, off unless enabled): ``step`` and
  ``drain`` in ``train_one_epoch`` (step id ``state.step`` at the step's
  entry); ``augment`` (the windowing,
  then each micro-batch's augmentation), ``fwd`` and ``bwd`` per
  micro-batch in the grad step; ``update`` around ``apply_update``, with
  ``optimizer`` around the optimizer's step and ``zero_grad``; the
  ``setup.*`` stages of ``create_train_state``. They add no operation.
"""

from __future__ import annotations

import contextlib
import logging
import math
import sys
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from headct_foundation_tpu_torch.data.augment import apply_mae_augment, draw_mae_augment
from headct_foundation_tpu_torch.data.device_preprocess import wire_to_compute
from headct_foundation_tpu_torch.data.pipeline import DevicePrefetcher
from headct_foundation_tpu_torch.feature_extraction import resolve_device
from headct_foundation_tpu_torch.models.attention import shard_block_
from headct_foundation_tpu_torch.models.mae import MaskedAutoencoderViT
from headct_foundation_tpu_torch.ops.attention import set_pallas_min_t
from headct_foundation_tpu_torch.optim.lr_sched import Schedule, get_lr_schedule
from headct_foundation_tpu_torch.optim.optimizers import clip_by_per_param_norm, get_optimizer
from headct_foundation_tpu_torch.parallel import distributed, fsdp, mesh, pipeline
from headct_foundation_tpu_torch.utils.checkpoint import (
    clone_opt_state,
    clone_state_dict,
    model_trees,
    save_checkpoint,
    wait_for_saves,
)
from headct_foundation_tpu_torch.utils import tracing
from headct_foundation_tpu_torch.utils.misc import profile_trace

LOSS_FLUSH = 8  # steps between batched loss fetches (see train_one_epoch)


@dataclass
class TrainState:
    model: MaskedAutoencoderViT
    optimizer: torch.optim.Optimizer
    lr_schedule: Schedule
    step: int = 0  # optimizer updates taken
    grad_clip: float = 0.0  # per-parameter gradient L2 clip before each update; 0 = off
    config: Any = None  # the config it was built from (the checkpoint layout reads it)

    @property
    def device(self) -> torch.device:
        return self.model.cls_token.device

    @property
    def norm_layer(self) -> str:  # the checkpoint's parameter naming reads it
        return str(self.config.MAE.NORM_LAYER)

    def snapshot(self) -> tuple:
        """Device-side copies of the parameters and the optimizer state."""
        return clone_state_dict(self.model), clone_opt_state(self.optimizer)

    @property
    def pipelined(self) -> bool:
        """True under ``PARALLEL.PIPE`` above 1 (stacked checkpoints)."""
        return int(self.config.PARALLEL.PIPE) > 1

    def jax_trees(self, step: int, snapshot: Optional[tuple] = None) -> Dict[str, Any]:
        """The checkpoint's ``params`` and ``opt_state`` (of ``snapshot``, taken
        at update ``step``, when given), the trunks stacked under ``PIPE``."""
        trees = model_trees(self, step, *(snapshot or (None, None)))
        if self.pipelined:
            trees = {k: pipeline.stack_trunks(v) for k, v in trees.items()}
        return trees

    def full_view(self) -> "TrainState":
        """This state with its parameters and their optimizer moments whole
        (gathered over ``fsdp`` and ``tensor``, and every stage's blocks over
        ``pipe``: every rank must call it), in a model and an optimizer of
        their own; the state itself when those axes are 1. Checkpoints are
        written and read through it, so a file holds the JAX layout at any
        mesh."""
        m = mesh.current()
        if m.size("tensor") == 1 and m.size("fsdp") == 1 and m.size("pipe") == 1:
            return self
        with torch.device("meta"):
            model = build_mae_model(self.config, dtype=self.model.dtype)
        gather = pipeline if m.size("pipe") > 1 else fsdp
        pairs = gather.gather_module(self.model, model, m)
        optimizer = get_optimizer(self.config, model.parameters())
        gather.gather_optimizer_state(self.optimizer, optimizer, pairs, m)
        return TrainState(model, optimizer, self.lr_schedule, self.step, self.grad_clip,
                          self.config)

    def load_full(self, full: "TrainState") -> "TrainState":
        """Take this rank's shards (or stage) of ``full`` (a ``full_view``
        the caller filled, e.g. from a checkpoint): parameters, moments and
        step. A no-op when ``full`` is this state."""
        if full is self:
            return self
        load = pipeline if mesh.current().size("pipe") > 1 else fsdp
        load.load_module(self.model, full.model, self.optimizer, full.optimizer)
        self.step = full.step
        return self


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


def check_pipe(config) -> int:
    """``PARALLEL.PIPE``, after the JAX engine's checks (its ``:110-120``):
    above 1 it takes no dropout and must divide both depths (ValueError)."""
    pipe = int(config.PARALLEL.PIPE)
    if pipe > 1:
        if config.MAE.DROPOUT_RATE > 0:
            raise ValueError("PARALLEL.PIPE > 1 requires MAE.DROPOUT_RATE=0")
        if config.MAE.ENCODER_DEPTH % pipe or config.MAE.DECODER_DEPTH % pipe:
            raise ValueError(f"PIPE={pipe} must divide encoder depth {config.MAE.ENCODER_DEPTH} "
                             f"and decoder depth {config.MAE.DECODER_DEPTH}")
    return pipe


def check_mesh(config) -> mesh.Mesh:
    """The process's mesh, which must have the config's ``FSDP``, ``SEQ``,
    ``PIPE`` and ``TENSOR``."""
    m = mesh.current()
    for axis in ("FSDP", "SEQ", "PIPE", "TENSOR"):
        want = int(getattr(config.PARALLEL, axis))
        if m.size(axis.lower()) != want:
            raise ValueError(
                f"PARALLEL.{axis} = {want} but the process's mesh has {axis.lower()} = "
                f"{m.size(axis.lower())}: start the ranks under torchrun and lay the mesh "
                "out with distributed.init_from_env(device, config=config)")
    return m


def create_train_state(
    config, total_steps: int, num_warmup_steps: int, seed: int = 0,
    dtype: torch.dtype = torch.bfloat16, device: Union[None, str, torch.device] = None,
) -> Tuple[TrainState, Schedule]:
    """Model, optimizer and LR schedule on ``device`` (default cuda).

    The weights are the full seed-``seed`` draw at any mesh; under
    ``PARALLEL.TENSOR`` each rank keeps its Megatron part of every block
    (``models/attention.py shard_block_``), under ``FSDP`` its ``fsdp``
    shard of that (``parallel/fsdp.py shard_module_``), and the optimizer
    state follows the shards. Under ``PIPE`` each rank keeps its stage's
    blocks of both trunks (``pipeline.keep_stage_``), after ``check_pipe``."""
    check_pipe(config)
    m = check_mesh(config)
    t = m.size("tensor")
    device = resolve_device(device)
    set_pallas_min_t(config.PARALLEL.PALLAS_MIN_T)
    with tracing.span("setup.build"):
        model = build_mae_model(config, dtype=dtype)
    with tracing.span("setup.init_weights"):
        model.init_weights(torch.Generator().manual_seed(seed))
    with tracing.span("setup.to_device"):  # this rank's part of the model, on the device
        if t > 1:
            for blk in list(model.blocks) + list(model.decoder_blocks):
                shard_block_(blk, t, m.coord("tensor"), m.group("tensor"))
        pipeline.keep_stage_(model, m.size("pipe"), m.coord("pipe"))
        fsdp.shard_module_(model, m)
        model.to(device)
    trainable = mae_trainable_mask(model, config.MAE.POS_EMBED)
    for name, p in model.named_parameters():
        p.requires_grad_(trainable[name])
    with tracing.span("setup.optimizer"):
        lr_schedule = get_lr_schedule(config, config.TRAIN.BASE_LR, num_warmup_steps,
                                      total_steps, config.TRAIN.MIN_LR)
        optimizer = get_optimizer(config, model.parameters(), split=fsdp.split_groups(model, m),
                                  stacked=pipeline.stacked_groups(model, m))
    return (TrainState(model, optimizer, lr_schedule, grad_clip=float(config.TRAIN.GRAD_CLIP),
                       config=config), lr_schedule)


def step_generator(device: torch.device, *keys: int) -> torch.Generator:
    """A generator on ``device`` seeded from the integer ``keys``."""
    hi, lo = np.random.SeedSequence([int(k) for k in keys]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed((int(hi) << 32) | int(lo))


def _rows(decisions: Dict[str, torch.Tensor], lo: int, hi: int) -> Dict[str, torch.Tensor]:
    """Samples [lo, hi) of ``draw_mae_augment``'s decisions (the batch is
    their last axis)."""
    return {k: v[..., lo:hi] for k, v in decisions.items()}


def pipelined_loss(model: MaskedAutoencoderViT, imgs: torch.Tensor, noise: torch.Tensor,
                   trunk: Callable[[Any, torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """The MAE loss with each trunk run by ``trunk(blocks, x)`` (JAX
    ``_make_pipelined_loss``, ``:186-223``): the model's own prefix and
    suffix around it."""
    x, mask, ids_restore = model.encode_prefix(imgs, noise)
    latent = model.encode_suffix(trunk(model.blocks, x))
    x = trunk(model.decoder_blocks, model.decode_prefix(latent, ids_restore))
    return model.forward_loss(imgs, model.decode_suffix(x), mask)


def pipe_trunk(config) -> Optional[Callable]:
    """``trunk(blocks, x)`` for ``pipelined_loss`` over the process's ``pipe``
    group in ``PARALLEL.PIPE_MICROBATCH`` microbatches; None at ``PIPE`` 1."""
    if config is None or int(config.PARALLEL.PIPE) == 1:
        return None
    group = mesh.current().group("pipe")
    m = int(config.PARALLEL.PIPE_MICROBATCH)
    return lambda blocks, x: pipeline.pipeline_apply(blocks, x, group, m)


def replicated_grads(model: torch.nn.Module) -> List[torch.Tensor]:
    """The gradients of the parameters every ``pipe`` stage holds (all of
    them at ``pipe`` 1)."""
    return [p.grad for n, p in model.named_parameters()
            if p.grad is not None and not n.startswith(pipeline.TRUNKS)]


def make_grad_step(augment: bool = False, accum_steps: int = 1, config=None) -> Callable:
    """grads(state, batch, seed, draws=None) -> the loss (device scalar):
    the forward and backward of every micro-batch, the gradients left in
    ``.grad``, averaged over the micro-batches, summed over ``seq`` and
    averaged over ``data`` (``make_train_step``'s first half). Under
    ``PIPE`` the loss is ``pipelined_loss``."""
    in_chans = int(config.MAE.IN_CHANS) if config is not None else 0
    trunk = pipe_trunk(config)

    def grads(state: TrainState, batch: torch.Tensor, seed: int,
              draws: Optional[Sequence[dict]] = None) -> torch.Tensor:
        model, device = state.model, state.device
        model.train()
        with tracing.span("augment"):
            batch = wire_to_compute(batch.to(device), config, in_chans)
        B = batch.shape[0]
        if B % accum_steps:
            raise ValueError(f"batch {B} does not split into {accum_steps} micro-batches")
        n = B // accum_steps
        world, rank = distributed.data_world(), distributed.data_rank()
        drops = bool(model.patch_embedding.dropout_rate)
        loss_sum = torch.zeros((), device=device)
        for i in range(accum_steps):
            mb = batch[i * n:(i + 1) * n]
            if draws is None:  # the global micro-batch's draws; this rank's rows
                g = step_generator(device, seed, state.step, i)
                noise = torch.rand((world * n, int(np.prod(model.grid_size))), generator=g,
                                   device=device)[rank * n:(rank + 1) * n]
                decisions = (_rows(draw_mae_augment(world * n, g, device), rank * n,
                                   (rank + 1) * n) if augment else None)
                # apart from the masking draw, so dropout leaves the masks as they are
                g_drop = step_generator(device, seed, state.step, i, 1) if drops else None
            else:
                noise, decisions = draws[i]["noise"], draws[i].get("augment")
                g_drop = draws[i].get("dropout")
            if augment:
                with tracing.span("augment"):
                    mb = apply_mae_augment(mb, decisions)
            with tracing.span("fwd"):
                if trunk is not None:
                    loss = pipelined_loss(model, mb, noise, trunk)
                else:
                    with mesh.global_dropout():
                        loss, _, _ = model(mb, noise=noise, dropout_generator=g_drop)
            with tracing.span("bwd"):
                loss.backward()  # float32 .grad of float32 params: the sum over micro-batches
            loss_sum += loss.detach().float()
        gs = [p.grad for p in model.parameters() if p.grad is not None]
        if accum_steps > 1:
            torch._foreach_div_(gs, accum_steps)
        loss = loss_sum / accum_steps
        seq = mesh.current().group("seq")
        if seq is not None:  # each seq rank differentiated its tokens' share
            distributed.all_reduce_sum_(gs, seq)
        # one average across the data x fsdp ranks per update, before the clip
        distributed.data_mean_([loss] + gs, sharded=fsdp_grads(model))
        if trunk is not None:  # the prefix and suffix stay bit-equal over pipe
            pipeline.replicate_(replicated_grads(model))
        return loss

    return grads


def fsdp_grads(*modules: torch.nn.Module) -> List[torch.Tensor]:
    """The gradients of the ``fsdp`` shards of ``modules`` (summed over
    ``fsdp`` by the gather's backward already)."""
    if mesh.current().size("fsdp") == 1:
        return []
    out = []
    for module in modules:
        dims = fsdp.sharded_dims(module)
        out += [p.grad for n, p in module.named_parameters() if n in dims and p.grad is not None]
    return out


def apply_update(state: TrainState) -> TrainState:
    """The update from the gradients in ``.grad`` (``make_train_step``'s
    second half): the per-parameter clip (a split parameter's norm over all
    its shards, a block parameter's under ``PIPE`` over its stacked leaf),
    the LR of this step, the optimizer step."""
    with tracing.span("update"):
        model = state.model
        if state.grad_clip:
            clip_by_per_param_norm(model.parameters(), state.grad_clip,
                                   split=fsdp.split_groups(model),
                                   stacked=pipeline.stacked_groups(model))
        lr = state.lr_schedule(state.step)  # optax's count before the increment
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        with tracing.span("optimizer"):
            state.optimizer.step()
            state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
    return state


def make_train_step(augment: bool = False, accum_steps: int = 1, config=None) -> Callable:
    """step(state, batch, seed, draws=None) -> (state, {"loss": device scalar}).

    ``batch`` is a wire batch [B, C or 1, R, R, R]; ``config.DATA.WIRE_FORMAT``
    says how to window it. Under data parallelism ``batch`` is this rank's
    share of the global batch and the loss is the global mean; the ``seq``
    and ``tensor`` ranks of a data slice take the same batch. ``draws[i]``
    may also hold ``"dropout"``, the micro-batch's dropout generator."""
    grads = make_grad_step(augment, accum_steps, config)

    def train_step(state: TrainState, batch: torch.Tensor, seed: int,
                   draws: Optional[Sequence[dict]] = None):
        loss = grads(state, batch, seed, draws)
        return apply_update(state), {"loss": loss}

    return train_step


def make_eval_step(config=None) -> Callable:
    """step(state, batch, generator=None) -> {"loss": device scalar}; the mask
    noise of the global batch is drawn from ``generator``, this rank's rows
    taken, and the loss averaged across the ranks (``pipelined_loss`` under
    ``PIPE``)."""
    in_chans = int(config.MAE.IN_CHANS) if config is not None else 0
    trunk = pipe_trunk(config)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: torch.Tensor,
                  generator: Optional[torch.Generator] = None):
        model = state.model
        model.eval()
        batch = wire_to_compute(batch.to(state.device), config, in_chans)
        B, world, rank = batch.shape[0], distributed.data_world(), distributed.data_rank()
        noise = None
        if generator is not None:
            noise = torch.rand((world * B, int(np.prod(model.grid_size))), generator=generator,
                               device=state.device)[rank * B:(rank + 1) * B]
        if trunk is not None:
            loss = pipelined_loss(model, batch, noise, trunk)
        else:
            loss, _, _ = model(batch, noise=noise)
        distributed.data_mean_([loss])
        return {"loss": loss}

    return eval_step


def kernel_launches() -> Dict[str, int]:
    """The launch counters of the kernels a MAE step can run."""
    from headct_foundation_tpu_torch.ops import flash_attention as fa
    from headct_foundation_tpu_torch.ops.lion_kernel import lion_update_leaf

    return {"flash_attention_fwd": fa.fused_attention.launches,
            "flash_attention_bwd": fa.fused_attention_bwd.launches,
            "flash_attention_blocked_fwd": fa.blocked_fused_attention.launches,
            "flash_attention_blocked_dkv": fa.blocked_attention_dkv.launches,
            "flash_attention_blocked_dq": fa.blocked_attention_dq.launches,
            "lion_update": lion_update_leaf.launches}


def _launches_since(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before[k] for k, v in kernel_launches().items()}


def allreduce_counts() -> Dict[str, int]:
    """The ``dist.all_reduce`` calls and bytes of ``all_reduce_sum_`` so far."""
    f = distributed.all_reduce_sum_
    return {"calls": f.calls, "bytes": f.bytes}


def allreduce_since(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before[k] for k, v in allreduce_counts().items()}


def to_device_batch(batch, device: torch.device) -> torch.Tensor:
    """A batch already on ``device`` passes through without a copy; hu16
    (int16) and hu8 (uint8) wire batches ship as they are (the step windows
    them); float batches ship in bfloat16, the step's input dtype."""
    t = torch.as_tensor(np.asarray(batch)) if not isinstance(batch, torch.Tensor) else batch
    if t.device == torch.device(device):
        return t
    if t.dtype in (torch.int16, torch.uint8):
        return t.to(device)
    return t.to(device=device, dtype=torch.bfloat16)


def drain_pending_losses(pending: List[Tuple[torch.Tensor, int]], logger,
                         log_fn: Callable[[float, int], None],
                         step: Optional[int] = None) -> None:
    """Fetch every pending (loss, idx) in one copy, exit on a non-finite loss
    (reference: engine_pretrain_mae.py:76-78), and log each value (the
    ``drain`` span, of step id ``step``)."""
    if not pending:
        return
    with tracing.span("drain", step):
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
    max_epoch: int, logger: Optional[logging.Logger] = None, wandb_run=None,
) -> Tuple[TrainState, Dict[str, Any]]:
    """One pass over ``loader``; returns the state and the mean loss, mean
    LR, mean ``iter_time`` and ``data_time`` per step (host clock; losses
    fetched in groups), the step count and the kernels' launches."""
    n_batches = len(loader) if hasattr(loader, "__len__") else None
    losses: List[float] = []
    lrs: List[float] = []
    pending: List[Tuple[torch.Tensor, int]] = []

    def log(loss: float, idx: int) -> None:
        lr = float(state.lr_schedule((n_batches or 0) * epoch + idx))
        losses.append(loss)
        lrs.append(lr)
        if logger:
            total = n_batches if n_batches is not None else "?"
            logger.info(f"Epoch {epoch + 1}/{max_epoch} [{idx + 1}/{total}]  Loss: {loss:.4f}")
        if wandb_run is not None:
            wandb_run.log({"Training Loss": loss, "Training lr": lr})

    before, reduced = kernel_launches(), allreduce_counts()
    data_times: List[float] = []
    iter_times: List[float] = []
    batches = iter(_batches(DevicePrefetcher.wrap(loader, state.device)))
    sid = None  # the step id of the spans: state.step at the step's entry
    end = time.perf_counter()
    for idx, batch in enumerate(batches):
        data_times.append(time.perf_counter() - end)
        sid = state.step
        data = to_device_batch(batch, state.device)
        with tracing.span("step", sid):
            state, metrics = train_step(state, data, seed)
        pending.append((metrics["loss"], idx))
        if len(pending) >= LOSS_FLUSH:
            drain_pending_losses(pending, logger, log, sid)
        iter_times.append(time.perf_counter() - end)
        end = time.perf_counter()
    drain_pending_losses(pending, logger, log, sid)
    stats: Dict[str, Any] = {"iter_time": float(np.mean(iter_times)) if iter_times else 0.0,
                             "data_time": float(np.mean(data_times)) if data_times else 0.0,
                             "steps": len(iter_times), "launches": _launches_since(before),
                             "allreduce": allreduce_since(reduced)}
    if losses:
        stats.update(loss=float(np.mean(losses)), lr=float(np.mean(lrs)))
    return state, stats


def val_one_epoch(
    config, state: TrainState, eval_step, loader: Iterable, seed: int, epoch: int,
    max_epoch: int, logger: Optional[logging.Logger] = None,
) -> Dict[str, Any]:
    """Mean loss over ``loader``; batch ``idx`` masks with a generator seeded
    from (seed, idx). Also the batch count and the kernels' launches."""
    losses = []
    before = kernel_launches()
    for idx, batch in enumerate(_batches(DevicePrefetcher.wrap(loader, state.device))):
        data = to_device_batch(batch, state.device)
        metrics = eval_step(state, data, step_generator(state.device, seed, idx))
        loss = float(metrics["loss"])
        losses.append(loss)
        if logger:
            logger.info(f"Val Epoch {epoch + 1}/{max_epoch} [{idx + 1}]  Loss: {loss:.4f}")
    stats: Dict[str, Any] = {"batches": len(losses), "launches": _launches_since(before)}
    if losses:
        stats["loss"] = float(np.mean(losses))
    return stats


def trainer(
    config, state: TrainState, train_step, eval_step, train_loader, val_loader, seed: int,
    max_epochs: int, val_every: int, logger: Optional[logging.Logger] = None,
    start_epoch: int = 0, wandb_run=None, history: Optional[List[Dict[str, Any]]] = None,
) -> Tuple[TrainState, float]:
    """The epoch loop with latest/best checkpoints (reference:
    engine_pretrain_mae.py:149-265); returns the state and the best
    validation loss. ``history``, when given, gets one dict per epoch: its
    seconds and its train (and val) stats."""
    best_loss = float("inf")
    save_name = config.MODEL.SAVE_NAME
    ckpt = dict(logger=logger, async_save=bool(config.TRAIN.ASYNC_CKPT),
                fmt=str(config.TRAIN.CKPT_FORMAT))
    for epoch in range(start_epoch, max_epochs):
        t0 = time.perf_counter()
        if hasattr(train_loader, "set_epoch"):
            train_loader.set_epoch(epoch)  # keeps the loader's lookahead on the next epoch
        with profile_trace() if epoch == start_epoch else contextlib.nullcontext():
            state, train_stats = train_one_epoch(config, state, train_step, train_loader, seed,
                                                 epoch, max_epochs, logger=logger,
                                                 wandb_run=wandb_run)
        seconds = time.perf_counter() - t0
        if logger:
            launched = ", ".join(f"{k} {v}" for k, v in train_stats["launches"].items() if v)
            logger.info(
                f"Epoch {epoch + 1} done in {seconds:.1f}s  "
                f"train loss {train_stats.get('loss', float('nan')):.4f}  "
                f"iter {train_stats['iter_time']:.3f}s (data {train_stats['data_time']:.3f}s)  "
                f"steps {train_stats['steps']}  placeholders "
                f"{getattr(getattr(train_loader, 'dataset', None), 'placeholders', 0)}  "
                f"launches {launched or 'none'}")
        record: Dict[str, Any] = {"epoch": epoch, "seconds": seconds, "train": train_stats}
        save_checkpoint(state, epoch, best_loss, config.MODEL.DIR, f"latest_{save_name}", **ckpt)
        if (epoch + 1) % val_every == 0 and val_loader is not None:
            val_stats = val_one_epoch(config, state, eval_step, val_loader, seed, epoch,
                                      max_epochs, logger=logger)
            record["val"] = val_stats
            val_loss = val_stats.get("loss", float("inf"))
            if wandb_run is not None:
                wandb_run.log({"Validation Loss": val_loss})
            if val_loss < best_loss:
                best_loss = val_loss
                save_checkpoint(state, epoch, best_loss, config.MODEL.DIR, f"best_{save_name}",
                                **ckpt)
        if history is not None:
            history.append(record)
    if hasattr(train_loader, "close"):
        train_loader.close()  # stops the lookahead past the last epoch
    wait_for_saves()
    return state, best_loss


def tester(config, state: TrainState, eval_step, test_loader, seed: int,
           logger: Optional[logging.Logger] = None, wandb_run=None) -> Dict[str, Any]:
    stats = val_one_epoch(config, state, eval_step, test_loader, seed, epoch=0, max_epoch=1,
                          logger=logger)
    if wandb_run is not None and "loss" in stats:
        wandb_run.log({"Test Loss": stats["loss"]})
    return stats
