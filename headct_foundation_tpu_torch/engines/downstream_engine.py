"""Downstream engine: fine-tune, linear probe, LoRA and few-shot
classification.

Port of the JAX package's ``engines/downstream_engine.py`` (reference:
engine_downstream.py, main_downstream.py:141-210):

* ``create_train_state`` builds the ViT (bfloat16 compute, float32
  parameters; with ``dtype=torch.float64``, the reference mode of
  ``tools/check_data_parallel.py --float64``, float64 compute, parameters,
  BatchNorm statistics and AdamW moments, the attention plain; LoRA
  adapters on q and v with ``TRAIN.LORA``) and the classifier
  (``build_classifier``: ``linear`` on the CLS token, ``attentive`` over
  all tokens) from a seeded generator on the CPU, moves
  them to the device and splits the parameters as the JAX package's
  ``optax.multi_transform`` labels them (``:150-175``): the classifier's
  into the classifier's optimizer at 100 x the LR (``lr_clf``: ``BASE_LR x
  100`` -> ``BASE_LR x 0.1``; ``lr_model``: ``BASE_LR`` -> ``BASE_LR x
  1e-3``), the trainable backbone's into the model's optimizer, and the
  frozen ones (``freeze``: no update and no weight decay) into neither,
  with ``requires_grad`` off: the sincos position embeddings always, the
  whole backbone under ``TRAIN.LOCK``, and under ``TRAIN.LORA`` every
  backbone tensor whose JAX path (``utils/torch_interop.jax_path``, not
  the torch name) contains none of ``lora``, ``bias``, ``embeddings``,
  ``norm`` (``lora_trainable_mask``).
* ``make_train_step`` returns ``step(state, batch, target, seed,
  draws=None)``: the wire batch windowed to bfloat16, the ViT augmentation
  (``mae_augment`` without the blur), the ViT in train mode (dropout live,
  its masks from a generator seeded from (seed, step, 1, rank), the rank
  on ``data`` x ``fsdp``), the
  features (CLS for ``linear``, every token for ``attentive``; under
  ``LOCK`` the backbone runs without gradients, as JAX's ``stop_gradient``
  leaves it, so no backward kernel runs), the classifier with train-mode
  BatchNorm, float32 softmax cross-entropy and its backward. Under data
  parallelism the gradients and the loss are averaged across the ranks and
  the BatchNorm statistics are the global batch's. Then the global-norm clip
  per group (``GRAD_CLIP > 0``, optax's ``clip_by_global_norm``) and one
  update of each optimizer at ``lr_model(step)`` and ``lr_clf(step)``. The
  augmentation decisions are drawn for the global batch from a generator
  seeded from (seed, step), and rank r takes rows r::world, the rows its
  ``rank::world`` sampler gives it; ``draws`` injects them (``"augment"``,
  and ``"dropout"``, a generator).
* ``make_eval_step``: no augmentation, eval mode (BatchNorm on its running
  statistics, no dropout), softmax probabilities.
* ``train_one_epoch`` / ``val_one_epoch`` take (volumes, targets, paths)
  batches through ``DevicePrefetcher`` (targets on the device too), fetch
  losses and probabilities in groups of ``LOSS_FLUSH``, gather predictions
  across the ranks (``gather_rows``) and compute ``multiclass_metrics``. A
  non-finite train loss exits 1; validation and test record it and go on
  (JAX ``:416-447``).
* ``trainer`` selects the best epoch by validation mean AUROC and writes
  ``best_<SAVE_NAME>`` (with the classifier's ``batch_stats``);
  ``tester`` evaluates and writes ``preds_pkl/<PREDS_SAVE_NAME>_preds.pkl``
  (``{fnames, preds: probs[:, 1], targets}``) on rank 0, and the ROC/PR
  plot where matplotlib imports.

On the card a fine-tune or LoRA train step launches depth B1 and depth B2
(12 + 12 at ViT-B), a ``LOCK`` step depth B1 and no B2, an eval batch depth
B1; the attentive head's one-query attention runs plain.

The mesh, as in ``dino_engine``: the batch over ``data`` x ``fsdp`` (rank
r of that product takes rows r::n), the backbone's blocks over ``tensor``
(LoRA's B with the heads of its q or v), the ZeRO-3 shards of the backbone
and the classifier over ``fsdp``, the ViT's tokens over ``seq`` (the CLS
gathered for ``linear``, every token for ``attentive``); each ``seq`` rank
backpropagates 1 / s of the loss, the gradients are summed over ``seq``,
and the classifiers' BatchNorm reduces over ``data`` x ``fsdp``. The
global-norm clip takes every shard's share. The predictions are gathered
over ``data`` x ``fsdp``. ``full_view`` / ``load_full`` give checkpoints
and warm starts the whole tensors.
"""

from __future__ import annotations

import contextlib
import logging
import math
import os
import pickle
import sys
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from headct_foundation_tpu_torch.data.augment import apply_mae_augment, draw_mae_augment
from headct_foundation_tpu_torch.data.device_preprocess import wire_to_compute
from headct_foundation_tpu_torch.data.pipeline import DevicePrefetcher
from headct_foundation_tpu_torch.engines.dino_engine import build_vit_model, shard_model_
from headct_foundation_tpu_torch.engines.mae_engine import (
    LOSS_FLUSH,
    _launches_since,
    allreduce_counts,
    allreduce_since,
    check_mesh,
    fsdp_grads,
    kernel_launches,
    step_generator,
    to_device_batch,
)
from headct_foundation_tpu_torch.feature_extraction import resolve_device
from headct_foundation_tpu_torch.models.classifier import AttentionClassifier, LinearClassifier
from headct_foundation_tpu_torch.models.vit import ViT
from headct_foundation_tpu_torch.ops.attention import set_pallas_min_t
from headct_foundation_tpu_torch.optim.lr_sched import Schedule, get_lr_schedule
from headct_foundation_tpu_torch.optim.optimizers import get_optimizer, norms_over_shards
from headct_foundation_tpu_torch.parallel import distributed, fsdp, mesh, pipeline
from headct_foundation_tpu_torch.utils.checkpoint import (
    clone_opt_state,
    clone_state_dict,
    save_checkpoint,
    wait_for_saves,
)
from headct_foundation_tpu_torch.utils.metrics import multiclass_metrics
from headct_foundation_tpu_torch.utils import tracing
from headct_foundation_tpu_torch.utils.misc import profile_trace, widen
from headct_foundation_tpu_torch.utils.plots import plot_pr_curve, plotting_available
from headct_foundation_tpu_torch.utils.torch_interop import (
    downstream_opt_state_to_jax,
    downstream_params_to_jax,
    jax_path,
)

# the reference LoRA rule (misc.py:349-359): substrings of the JAX path
LORA_TRAINABLE_SUBSTRINGS = ("lora", "bias", "embeddings", "norm")
# Tensors (as "model.<name>" / "classifier.<name>") whose gradient is 0 but
# for rounding, which AdamW scales up to +-lr, so comparisons of two runs'
# gradients or updates leave them out (as they leave out a qkv bias's key
# third): the classifiers' BatchNorm takes out a per-channel shift and scale
# of the backbone's final norm (its weight reaches the loss through eps only);
# softmax is invariant to the attentive head's key bias and bn2 takes out its
# value bias, whose drift bn2's running mean then tracks.
ROUNDING_ONLY = ("model.norm.weight", "model.norm.bias", "classifier.wkv.bias",
                 "classifier.bn2.running_mean")


@dataclass
class DownstreamTrainState:
    model: ViT
    classifier: torch.nn.Module
    model_optimizer: Optional[torch.optim.Optimizer]  # None when no backbone tensor trains
    classifier_optimizer: torch.optim.Optimizer
    lr_model: Schedule
    lr_clf: Schedule
    step: int = 0        # updates taken (every optax count)
    grad_clip: float = 0.0
    config: Any = None

    @property
    def device(self) -> torch.device:
        return self.model.cls_token.device

    @property
    def norm_layer(self) -> str:
        return str(self.config.VIT.NORM_LAYER)

    @property
    def optimizers(self) -> Dict[str, Optional[torch.optim.Optimizer]]:
        """The ``multi_transform`` branches: label -> optimizer."""
        return {"model": self.model_optimizer, "classifier": self.classifier_optimizer}

    def full_view(self) -> "DownstreamTrainState":
        """This state with the backbone, the classifier and both optimizers'
        moments whole (gathered over ``fsdp`` and ``tensor``: every rank must
        call it), in modules of their own; the state itself when both axes
        are 1 (``mae_engine.TrainState.full_view``)."""
        m = mesh.current()
        if m.size("tensor") == 1 and m.size("fsdp") == 1:
            return self
        dtype = self.model.patch_embedding.dtype
        with torch.device("meta"):
            model = build_vit_model(self.config, dtype, lora=bool(self.config.TRAIN.LORA))
            classifier = build_classifier(self.config, dtype)
        opts = []
        for sharded, whole in ((self.model, model), (self.classifier, classifier)):
            pairs = fsdp.gather_module(sharded, whole, m)
            opt = self.optimizers["model" if whole is model else "classifier"]
            full_opt = None
            if opt is not None:
                full_opt = get_optimizer(self.config, [p for p in whole.parameters()
                                                       if p.requires_grad])
                fsdp.gather_optimizer_state(opt, full_opt, pairs, m)
            opts.append(full_opt)
        return DownstreamTrainState(model, classifier, opts[0], opts[1], self.lr_model,
                                    self.lr_clf, self.step, self.grad_clip, self.config)

    def load_full(self, full: "DownstreamTrainState") -> "DownstreamTrainState":
        """Take this rank's shards of ``full`` (a filled ``full_view``)."""
        if full is self:
            return self
        fsdp.load_module(self.model, full.model, self.model_optimizer, full.model_optimizer)
        fsdp.load_module(self.classifier, full.classifier, self.classifier_optimizer,
                         full.classifier_optimizer)
        self.step = full.step
        return self

    def snapshot(self) -> tuple:
        """Device-side copies of both modules and both optimizers' state."""
        return ({"model": clone_state_dict(self.model),
                 "classifier": clone_state_dict(self.classifier)},
                {label: clone_opt_state(opt) for label, opt in self.optimizers.items()})

    def jax_trees(self, step: int, snapshot: Optional[tuple] = None) -> Dict[str, Any]:
        """The checkpoint's ``params``, ``opt_state`` and ``batch_stats`` in the
        JAX downstream layout (of ``snapshot``, taken at update ``step``, when
        given)."""
        params, opt = snapshot or ({"model": self.model.state_dict(),
                                    "classifier": self.classifier.state_dict()}, None)
        tree, stats = downstream_params_to_jax(params["model"], params["classifier"],
                                               self.norm_layer)
        return {"params": tree, "batch_stats": stats,
                "opt_state": downstream_opt_state_to_jax(
                    self.optimizers, self.model, self.classifier, self.config, step,
                    states=opt, norm_layer=self.norm_layer)}


def build_classifier(config, dtype: torch.dtype = torch.bfloat16) -> torch.nn.Module:
    """The classifier of ``TRAIN.CLASSIFIER`` (reference: main_downstream.py:141-154)."""
    kind = config.TRAIN.CLASSIFIER
    if kind == "linear":
        return LinearClassifier(config.VIT.HIDDEN_SIZE, config.DATA.NUM_CLASSES, dtype=dtype)
    if kind == "attentive":
        return AttentionClassifier(config.VIT.HIDDEN_SIZE, config.DATA.NUM_CLASSES,
                                   num_heads=config.VIT.NUM_HEADS, qkv_bias=config.VIT.USE_BIAS,
                                   dtype=dtype)
    raise NotImplementedError(f"Unknown classifier: {kind}")


def lora_trainable_mask(model: torch.nn.Module, norm_layer: str = "layernorm"
                        ) -> Dict[str, bool]:
    """Parameter name -> the reference LoRA rule on its JAX path."""
    return {name: any(s in "/".join(jax_path(name, p.dim(), norm_layer)).lower()
                      for s in LORA_TRAINABLE_SUBSTRINGS)
            for name, p in model.named_parameters()}


def backbone_labels(model: torch.nn.Module, config) -> Dict[str, str]:
    """Backbone parameter name -> ``"model"`` or ``"freeze"`` (JAX ``_label``)."""
    lora = lora_trainable_mask(model, str(config.VIT.NORM_LAYER)) if config.TRAIN.LORA else None

    def label(name: str) -> str:
        if config.TRAIN.LOCK:
            return "freeze"
        if config.VIT.POS_EMBED == "sincos" and "position_embeddings" in name.split("."):
            return "freeze"
        if lora is not None and not lora[name]:
            return "freeze"
        return "model"

    return {name: label(name) for name, _ in model.named_parameters()}


def create_train_state(config, total_steps: int, num_warmup_steps: int, seed: int = 0,
                       dtype: torch.dtype = torch.bfloat16,
                       device: Union[None, str, torch.device] = None) -> DownstreamTrainState:
    """Backbone, classifier, the two optimizers and their schedules on
    ``device`` (default cuda); each rank keeps its part of the full
    seed-``seed`` draw (``dino_engine.shard_model_``). The ``pipe`` ranks
    replicate the step, as JAX's ``pipe`` axis does for an engine that does
    not pipeline (``mesh.py batch_sharding``)."""
    m = check_mesh(config)
    device = resolve_device(device)
    set_pallas_min_t(config.PARALLEL.PALLAS_MIN_T)
    g = torch.Generator().manual_seed(seed)
    model = build_vit_model(config, dtype, lora=bool(config.TRAIN.LORA)).init_weights(g)
    classifier = build_classifier(config, dtype).init_weights(g)
    if dtype == torch.float64:  # the float64 reference: the same draw, cast
        model.double()
        classifier.double()
    shard_model_(model, model.blocks, m).to(device)
    fsdp.shard_module_(classifier, m).to(device)
    labels = backbone_labels(model, config)
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] == "model")
    base = float(config.TRAIN.BASE_LR)
    lr_model = get_lr_schedule(config, base, num_warmup_steps, total_steps, base * 1e-3)
    lr_clf = get_lr_schedule(config, base * 1e2, num_warmup_steps, total_steps, base * 1e-1)
    trainable = [p for p in model.parameters() if p.requires_grad]
    return DownstreamTrainState(
        model, classifier,
        get_optimizer(config, trainable, split=fsdp.split_groups(model, m)) if trainable
        else None,
        get_optimizer(config, classifier.parameters(), split=fsdp.split_groups(classifier, m)),
        lr_model, lr_clf, grad_clip=float(config.TRAIN.GRAD_CLIP), config=config)


@torch.no_grad()
def clip_by_global_norm(params: List[torch.nn.Parameter], clip: float, split=()) -> None:
    """optax's ``clip_by_global_norm``: the gradients of ``params`` scaled by
    clip / ||g|| when their joint L2 norm ||g|| is at least ``clip``; a
    parameter split over an axis of ``split`` ((group, parameters) pairs)
    adds every shard's share."""
    params = [p for p in params if p.grad is not None]
    grads = [p.grad for p in params]
    if not grads:
        return
    norms = torch.stack(torch._foreach_norm(grads))
    if split:
        norms = norms_over_shards(norms.square(), params, split).sqrt()
    norm = torch.linalg.vector_norm(norms)
    coef = torch.where(norm < clip, torch.ones_like(norm), clip / norm)
    torch._foreach_mul_(grads, [coef] * len(grads))


def _features(state: DownstreamTrainState, batch: torch.Tensor, lock: bool,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The CLS features (``linear``) or every token (``attentive``)."""
    with torch.no_grad() if lock else contextlib.nullcontext():
        return state.model(batch, generator,
                           cls_only=state.config.TRAIN.CLASSIFIER == "linear")[0]


def make_grad_step(config, compute_dtype: torch.dtype = torch.bfloat16) -> Callable:
    """grads(state, batch, target, seed, draws=None) -> (loss, logits): the
    augmentation, the forward and the backward, the gradients left in
    ``.grad``, summed over ``seq`` and averaged over ``data`` x ``fsdp``
    (``make_train_step``'s first half)."""
    in_chans = int(config.VIT.IN_CHANS)
    lock = bool(config.TRAIN.LOCK)

    def grads(state: DownstreamTrainState, batch: torch.Tensor, target: torch.Tensor,
              seed: int, draws: Optional[Dict[str, Any]] = None):
        device = state.device
        seq = mesh.current().size("seq")  # each seq rank backpropagates 1 / seq of the loss
        state.model.train()
        state.classifier.train()
        batch = wire_to_compute(batch.to(device), config, in_chans, dtype=compute_dtype)
        n, world, rank = batch.shape[0], distributed.data_world(), distributed.data_rank()
        if draws is None:  # the global batch's decisions; this rank's rows r::world
            g = step_generator(device, seed, state.step)
            decisions = {k: v[..., rank::world]
                         for k, v in draw_mae_augment(world * n, g, device).items()}
            drop_g = step_generator(device, seed, state.step, 1, rank)
        else:
            decisions, drop_g = draws["augment"], draws.get("dropout")
        feats = _features(state, apply_mae_augment(batch, decisions), lock, drop_g)
        logits = state.classifier(feats)
        loss = F.cross_entropy(widen(logits), target.to(device).long())
        (loss / seq if seq > 1 else loss).backward()
        gs = [p.grad for opt in state.optimizers.values() if opt is not None
              for g in opt.param_groups for p in g["params"] if p.grad is not None]
        loss = loss.detach()
        if seq > 1:  # the seq ranks' shares
            distributed.all_reduce_sum_(gs, mesh.current().group("seq"))
        distributed.data_mean_([loss] + gs,  # a no-op on one data x fsdp rank
                               sharded=fsdp_grads(state.model, state.classifier))
        pipeline.replicate_(gs)  # pipe ranks replicate the step: the same update
        return loss, logits.detach()

    return grads


def apply_update(state: DownstreamTrainState) -> DownstreamTrainState:
    """The update from the gradients in ``.grad`` (``make_train_step``'s
    second half): per optimizer the global-norm clip (every shard's share)
    and one step at ``lr_model(step)`` or ``lr_clf(step)``."""
    for label, opt in state.optimizers.items():
        if opt is None:
            continue
        params = [p for g in opt.param_groups for p in g["params"]]
        if state.grad_clip:
            module = state.model if label == "model" else state.classifier
            clip_by_global_norm(params, state.grad_clip, split=fsdp.split_groups(module))
        lr = (state.lr_model if label == "model" else state.lr_clf)(state.step)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        opt.zero_grad(set_to_none=True)
    state.step += 1
    return state


def make_train_step(config, compute_dtype: torch.dtype = torch.bfloat16) -> Callable:
    """step(state, batch, target, seed, draws=None) -> (state, {"loss",
    "probs"}): ``make_grad_step`` then ``apply_update``. ``batch`` is this
    rank's wire batch, windowed to ``compute_dtype`` (bfloat16 on the card;
    float32 for a float32 model, as the JAX step's oracle runs), ``target``
    its integer labels; the loss is the global batch's."""
    grads = make_grad_step(config, compute_dtype)

    def train_step(state: DownstreamTrainState, batch: torch.Tensor, target: torch.Tensor,
                   seed: int, draws: Optional[Dict[str, Any]] = None):
        loss, logits = grads(state, batch, target, seed, draws)
        return apply_update(state), {"loss": loss,
                                     "probs": torch.softmax(widen(logits), dim=-1)}

    return train_step


def make_eval_step(config, compute_dtype: torch.dtype = torch.bfloat16) -> Callable:
    """step(state, batch, target) -> {"loss", "probs"}: eval mode, no
    augmentation; the loss averaged across the ranks."""
    in_chans = int(config.VIT.IN_CHANS)

    @torch.no_grad()
    def eval_step(state: DownstreamTrainState, batch: torch.Tensor, target: torch.Tensor):
        state.model.eval()
        state.classifier.eval()
        batch = wire_to_compute(batch.to(state.device), config, in_chans, dtype=compute_dtype)
        logits = widen(state.classifier(_features(state, batch, True)))
        loss = F.cross_entropy(logits, target.to(state.device).long())
        distributed.data_mean_([loss])
        return {"loss": loss, "probs": torch.softmax(logits, dim=-1)}

    return eval_step


def _gather_objects(obj: Any) -> List[Any]:
    """``obj`` of every rank of the batch (``data`` x ``fsdp``), in rank order."""
    parts: List[Any] = [None] * distributed.data_world()
    group = mesh.current().group("batch") if distributed.laid_out() else None
    dist.all_gather_object(parts, obj, group=group)
    return parts


def gather_rows(arr: np.ndarray) -> np.ndarray:
    """Every batch rank's rows, concatenated in rank order (a no-op on one):
    metrics and the best-AUROC selection see the global prediction set."""
    if distributed.data_world() == 1:
        return arr
    return np.concatenate(_gather_objects(arr), axis=0)


def gather_strings(strings: List[str]) -> List[str]:
    """Every batch rank's strings, in ``gather_rows``' order."""
    if distributed.data_world() == 1:
        return list(strings)
    return [s for part in _gather_objects(list(strings)) for s in part]


def _loader(loader: Iterable, device: torch.device) -> DevicePrefetcher:
    """(volumes, targets, paths) batches, volumes and targets on ``device``."""
    return DevicePrefetcher.wrap(loader, device, device_fields=(0, 1))


def _drain(pending: list, on_row: Callable, logger, abort_on_nonfinite: bool,
           step: Optional[int] = None) -> None:
    """Fetch every pending (loss, probs, targets, idx) in one copy each, exit
    1 on a non-finite train loss (reference: engine_downstream.py:118-120),
    then hand each row to ``on_row`` (the ``drain`` span, of step id
    ``step``)."""
    if not pending:
        return
    with tracing.span("drain", step):
        losses = torch.stack([widen(p[0]) for p in pending]).cpu().tolist()
        probs = [p.cpu().numpy() for p in torch.cat([p[1] for p in pending]).split(
            [p[1].shape[0] for p in pending])]
        targets = [t.cpu().numpy() for t in torch.cat([p[2] for p in pending]).split(
            [p[2].shape[0] for p in pending])]
        for loss, pr, t, (_, _, _, idx) in zip(losses, probs, targets, pending):
            if abort_on_nonfinite and not math.isfinite(loss):
                if logger:
                    logger.info(f"Loss is {loss}, stopping training")
                sys.exit(1)
            on_row(loss, pr, t, idx)
        pending.clear()


def _metrics(config, probs: List[np.ndarray], targets: List[np.ndarray]) -> Dict[str, float]:
    if not probs:
        return {}
    return multiclass_metrics(gather_rows(np.concatenate(targets)),
                              gather_rows(np.concatenate(probs)), int(config.DATA.NUM_CLASSES))


def train_one_epoch(config, state: DownstreamTrainState, train_step, loader: Iterable,
                    seed: int, epoch: int, max_epoch: int,
                    logger: Optional[logging.Logger] = None, wandb_run=None
                    ) -> Tuple[DownstreamTrainState, Dict[str, Any]]:
    """One pass over ``loader``: the state and the mean loss, the metrics of
    the epoch's predictions, ``iter_time`` / ``data_time`` per step (host
    clock), the step count and the kernels' launches."""
    n_batches = len(loader) if hasattr(loader, "__len__") else 0
    losses: List[float] = []
    probs: List[np.ndarray] = []
    targets: List[np.ndarray] = []
    pending: list = []

    def on_row(loss, pr, t, idx):
        losses.append(loss)
        probs.append(pr)
        targets.append(t)
        if logger:
            logger.info(f"Epoch {epoch + 1}/{max_epoch} [{idx + 1}/{n_batches}]  Loss: {loss:.4f}")
        if wandb_run is not None:
            wandb_run.log({"Training Loss": loss})

    before, reduced = kernel_launches(), allreduce_counts()
    data_times: List[float] = []
    iter_times: List[float] = []
    sid = None  # the step id of the spans: state.step at the step's entry
    end = time.perf_counter()
    for idx, (data, target, _) in enumerate(_loader(loader, state.device)):
        data_times.append(time.perf_counter() - end)
        sid = state.step
        target = torch.as_tensor(target).to(state.device)
        with tracing.span("step", sid):
            state, m = train_step(state, to_device_batch(data, state.device), target, seed)
        pending.append((m["loss"], m["probs"], target, idx))
        if len(pending) >= LOSS_FLUSH:
            _drain(pending, on_row, logger, True, sid)
        iter_times.append(time.perf_counter() - end)
        end = time.perf_counter()
    _drain(pending, on_row, logger, True, sid)
    stats: Dict[str, Any] = {"iter_time": float(np.mean(iter_times)) if iter_times else 0.0,
                             "data_time": float(np.mean(data_times)) if data_times else 0.0,
                             "steps": len(iter_times), "launches": _launches_since(before),
                             "allreduce": allreduce_since(reduced)}
    if losses:
        stats["loss"] = float(np.mean(losses))
    stats.update(_metrics(config, probs, targets))
    return state, stats


def val_one_epoch(config, state: DownstreamTrainState, eval_step, loader: Iterable,
                  epoch: int = 0, max_epoch: int = 1, logger: Optional[logging.Logger] = None,
                  save_preds: bool = False) -> Dict[str, Any]:
    """Mean loss and metrics over ``loader``, the batch count and the
    kernels' launches; with ``save_preds`` also ``_preds``, the global
    ``{fnames, preds, targets}``."""
    losses: List[float] = []
    probs: List[np.ndarray] = []
    targets: List[np.ndarray] = []
    fnames: List[str] = []
    pending: list = []

    def on_row(loss, pr, t, idx):
        losses.append(loss)
        probs.append(pr)
        targets.append(t)
        if logger:
            logger.info(f"Val Epoch {epoch + 1}/{max_epoch} [{idx + 1}]  Loss: {loss:.4f}")

    before = kernel_launches()
    for idx, (data, target, names) in enumerate(_loader(loader, state.device)):
        target = torch.as_tensor(target).to(state.device)
        m = eval_step(state, to_device_batch(data, state.device), target)
        fnames.extend(names)
        pending.append((m["loss"], m["probs"], target, idx))
        if len(pending) >= LOSS_FLUSH:
            _drain(pending, on_row, logger, False)
    _drain(pending, on_row, logger, False)
    stats: Dict[str, Any] = {"batches": len(losses), "launches": _launches_since(before)}
    if losses:
        stats["loss"] = float(np.mean(losses))
    stats.update(_metrics(config, probs, targets))
    if save_preds and probs:
        g_probs = gather_rows(np.concatenate(probs))
        stats["_preds"] = {"fnames": gather_strings(fnames),
                           "preds": g_probs[:, 1] if g_probs.shape[1] > 1 else g_probs[:, 0],
                           "targets": gather_rows(np.concatenate(targets))}
    return stats


def snapshot(state: DownstreamTrainState) -> Tuple[Dict[str, torch.Tensor],
                                                   Dict[str, torch.Tensor]]:
    """Copies of the backbone's and the classifier's state_dicts (the
    classifier's with its running statistics), on the device."""
    with torch.no_grad():
        return tuple({k: v.detach().clone() for k, v in m.state_dict().items()}
                     for m in (state.model, state.classifier))


def load_snapshot(state: DownstreamTrainState, snap) -> DownstreamTrainState:
    state.model.load_state_dict(snap[0])
    state.classifier.load_state_dict(snap[1])
    return state


def trainer(config, state: DownstreamTrainState, train_step, eval_step, train_loader,
            val_loader, seed: int, max_epochs: int, val_every: int,
            logger: Optional[logging.Logger] = None, start_epoch: int = 0, wandb_run=None,
            history: Optional[List[Dict[str, Any]]] = None):
    """The epoch loop with best-by-mean-AUROC selection (reference:
    engine_downstream.py:381-412); returns (state, best snapshot, best mean
    AUROC). A new best writes ``best_<SAVE_NAME>`` with the classifier's
    ``batch_stats``. ``history`` gets one dict per epoch."""
    best_auroc = -float("inf")
    best = snapshot(state)
    save_name = config.MODEL.SAVE_NAME
    for epoch in range(start_epoch, max_epochs):
        t0 = time.perf_counter()
        if hasattr(train_loader, "set_epoch"):
            train_loader.set_epoch(epoch)
        with profile_trace() if epoch == start_epoch else contextlib.nullcontext():
            state, stats = train_one_epoch(config, state, train_step, train_loader, seed, epoch,
                                           max_epochs, logger=logger, wandb_run=wandb_run)
        seconds = time.perf_counter() - t0
        if logger:
            logger.info(f"Epoch {epoch + 1} done in {seconds:.1f}s  train loss "
                        f"{stats.get('loss', float('nan')):.4f}  train mean AUROC "
                        f"{stats.get('mean_auroc', float('nan')):.4f}")
        record: Dict[str, Any] = {"epoch": epoch, "seconds": seconds, "train": stats}
        if (epoch + 1) % val_every == 0 and val_loader is not None:
            val = val_one_epoch(config, state, eval_step, val_loader, epoch, max_epochs,
                                logger=logger)
            record["val"] = val
            auroc = val.get("mean_auroc", float("nan"))
            if wandb_run is not None:
                wandb_run.log({"Validation Loss": val.get("loss", float("nan")),
                               "Validation AUROC": auroc})
            if logger:
                logger.info(f"Val mean AUROC: {auroc:.4f}")
            if np.isfinite(auroc) and auroc > best_auroc:
                best_auroc = auroc
                best = snapshot(state)
                save_checkpoint(state, epoch, best_auroc, config.MODEL.DIR, f"best_{save_name}",
                                logger=logger, async_save=bool(config.TRAIN.ASYNC_CKPT),
                                fmt=str(config.TRAIN.CKPT_FORMAT))
        if history is not None:
            history.append(record)
    if hasattr(train_loader, "close"):
        train_loader.close()
    wait_for_saves()
    return state, best, best_auroc


def tester(config, state: DownstreamTrainState, eval_step, test_loader,
           logger: Optional[logging.Logger] = None, wandb_run=None,
           preds_dir: str = "preds_pkl", plots_dir: str = "plots") -> Dict[str, Any]:
    """The test pass, the predictions pickle ``<preds_dir>/<PREDS_SAVE_NAME>_preds.pkl``
    (rank 0) and the ROC/PR plot where matplotlib imports (reference:
    engine_downstream.py:419-491). The stats carry the pickle's path as
    ``preds_path``."""
    stats = val_one_epoch(config, state, eval_step, test_loader, logger=logger, save_preds=True)
    if wandb_run is not None and "loss" in stats:
        wandb_run.log({"Test Loss": stats["loss"]})
    preds = stats.pop("_preds", None)
    if preds is not None and distributed.rank() == 0:
        name = config.PREDS_SAVE_NAME
        os.makedirs(preds_dir, exist_ok=True)
        path = os.path.join(preds_dir, f"{name}_preds.pkl")
        with open(path, "wb") as f:
            pickle.dump(preds, f)
        stats["preds_path"] = path
        if logger:
            logger.info(f"Saved predictions to {path}")
        if len(np.unique(preds["targets"])) > 1:
            if plotting_available():
                plot_pr_curve(preds["targets"], preds["preds"], plots_dir, name)
            elif logger:
                logger.info("matplotlib is not installed: no ROC/PR plot written")
    return stats
