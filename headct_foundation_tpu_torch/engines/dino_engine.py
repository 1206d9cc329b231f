"""DINO pretraining engine: student and teacher, on-device multi-crop, the
DINO loss, the teacher EMA and the centre, epoch loops.

Port of the JAX package's ``engines/dino_engine.py`` (reference:
engine_pretrain_dino.py):

* ``create_train_state`` builds the student (ViT + DINO head, bfloat16
  compute, float32 parameters) from a seeded generator on the CPU, moves it
  to the device and copies it into the teacher; freezes the sincos position
  embeddings and, with ``NORM_LAST_LAYER``, the head's ``last_layer.weight_g``
  (``dino_trainable_mask``); builds the optimizer over the trainable tensors,
  with the head's trainable last-layer tensors in a group of their own, and
  the schedules: the LR, the weight decay and the teacher momentum per
  iteration, the teacher temperature per epoch.
* ``make_train_step`` returns ``step(state, batch, seed, momentum,
  teacher_temp, cancel_last_layer, draws=None)``. Per micro-batch: the wire
  batch windowed and cast to bfloat16 (``wire_to_compute``), the multi-crop
  (decisions drawn from a generator seeded from (seed, step, micro-batch),
  or handed in as ``draws``, one list of crop decisions per micro-batch),
  the teacher on the 2 global crops without gradients, the student on all
  crops, ``dino_loss`` and its backward. Both networks run in ``train()``
  mode, as the reference trains them, so a ``VIT.DROPOUT_RATE`` above 0
  drops out in both backbones, the teacher's masks from a generator seeded
  from (seed, step, micro-batch, 101), the student's from (..., 102)
  (JAX ``:279-302`` folds 101 and 102 into the micro-batch's key); each
  rank takes its rows of the global batch's masks. With the BatchNorm head
  (``DINO.USE_BN``) both networks run in ``train()`` mode, so each head
  normalises with its batch's statistics (the teacher's over its 2 x B
  global crops, the student's over all its crops in one call) and updates
  its own running statistics (JAX ``:243-262``); the statistics carry from
  micro-batch to micro-batch, and eval uses the running ones. With
  ``TRAIN.ACCUM_STEPS`` the gradients sum in float32 and are divided by the
  count. Under data
  parallelism every rank draws the global micro-batch's decisions and takes
  its own rows, and the gradients, the loss and the teacher's mean output
  (the centre's input) are averaged across the ranks in one call.
* The last-layer freeze (JAX ``:361-382``): while ``cancel_last_layer`` is
  set the last layer's gradients are multiplied by 0 and its group's LR is
  0, so neither the Adam step nor the decoupled decay ``p (1 - lr wd)``
  touches it (bit-frozen), its moments take zero gradients and its step
  count goes on rising with optax's. Then the per-parameter clip
  (``TRAIN.GRAD_CLIP``), the step's LR and weight decay (update n reads
  ``wd_sched[min(n, len - 1)]``), the update, the teacher EMA ``t m + s (1 -
  m)`` in float32 over every parameter (the BatchNorm scales and biases
  too; the running statistics are buffers and stay each network's own),
  and the centre's EMA towards the teacher's mean output.
* ``train_one_epoch``: the freeze flag and the temperature are indexed by
  epoch, the momentum by the batch's index within the epoch (the
  reference's quirk, JAX ``:533-535``). ``val_one_epoch`` draws batch ``idx``'s crops from a
  generator seeded from (seed, idx); ``trainer`` writes ``latest_`` every
  epoch and ``best_`` on a new best validation loss, each with the DINO
  extras (``utils/checkpoint.py``); ``tester`` is one validation pass.

The teacher runs the whole-sequence kernels at T = 517 (512 patches, CLS, 4
registers) like the student: a step at ACCUM_STEPS 1 launches 12 B1 for the
teacher, 12 B1 and 12 B2 for the student; an eval batch 24 B1.

The mesh (``parallel/mesh.py``; JAX applies its rule table in
``engines/dino_engine.py:162``): the batch is split over ``data`` x
``fsdp`` (``distributed.data_rank``); under ``tensor`` the student's and
the teacher's blocks keep their Megatron parts (``shard_block_``: B1/B2 on
H / t heads), under ``fsdp`` their ZeRO-3 shards (``parallel/fsdp.py``),
and the teacher's EMA runs on the shards; under ``seq`` every crop's trunk
holds ceil(T / s) tokens (B3/B4/B5 on Q shards against the gathered keys,
``models/vit.py``) and the CLS token is gathered before the head, which
stays whole. Each ``seq`` rank computes the head and the loss on the same
gathered features, so it backpropagates 1 / s of the loss and the
gradients are summed over ``seq``; they are averaged over ``data`` x
``fsdp`` (an ``fsdp`` shard's summed over ``fsdp`` by its gather's
backward), as are the loss, the centre's input and the BatchNorm head's
statistics. ``full_view`` / ``load_full`` give checkpoints whole tensors.
"""

from __future__ import annotations

import contextlib
import copy
import logging
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from headct_foundation_tpu_torch.data.augment import apply_dino_multicrop, draw_dino_multicrop
from headct_foundation_tpu_torch.data.device_preprocess import wire_to_compute
from headct_foundation_tpu_torch.data.pipeline import DevicePrefetcher
from headct_foundation_tpu_torch.engines.mae_engine import (
    LOSS_FLUSH,
    _batches,
    _launches_since,
    allreduce_counts,
    allreduce_since,
    check_mesh,
    drain_pending_losses,
    fsdp_grads,
    kernel_launches,
    step_generator,
    to_device_batch,
)
from headct_foundation_tpu_torch.feature_extraction import resolve_device
from headct_foundation_tpu_torch.losses.dino_loss import (
    dino_loss,
    teacher_temp_schedule,
    update_center,
)
from headct_foundation_tpu_torch.models.attention import shard_block_
from headct_foundation_tpu_torch.models.dino_head import DINOHead
from headct_foundation_tpu_torch.models.multicrop import DINOModel
from headct_foundation_tpu_torch.models.vit import ViT
from headct_foundation_tpu_torch.ops.attention import set_pallas_min_t
from headct_foundation_tpu_torch.optim.lr_sched import Schedule, get_lr_schedule
from headct_foundation_tpu_torch.optim.optimizers import (
    clip_by_per_param_norm,
    get_optimizer,
    scheduled_weight_decay,
    set_step_hyperparameters,
)
from headct_foundation_tpu_torch.optim.schedules import get_momentum_schedule, get_wd_schedule
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
from headct_foundation_tpu_torch.utils.torch_interop import (
    batch_stats_from_state_dict,
    jax_tree_from_state_dict,
)

Draws = Sequence[Sequence[Dict[str, torch.Tensor]]]


@dataclass
class DINOTrainState:
    student: DINOModel
    teacher: DINOModel
    optimizer: torch.optim.Optimizer
    lr_schedule: Schedule
    wd_sched: np.ndarray        # weight decay per update
    momentum_sched: np.ndarray  # teacher momentum per iteration
    temp_sched: np.ndarray      # teacher temperature per epoch
    center: torch.Tensor        # [1, HEAD_N_PROTOTYPES] float32
    step: int = 0               # optimizer updates taken
    grad_clip: float = 0.0
    config: Any = None

    @property
    def model(self) -> DINOModel:  # the checkpoint's "params" and optimizer state
        return self.student

    @property
    def device(self) -> torch.device:
        return self.center.device

    @property
    def norm_layer(self) -> str:
        return str(self.config.VIT.NORM_LAYER)

    def snapshot(self) -> tuple:
        """Device-side copies of the student, its optimizer state, the teacher
        and the centre."""
        with torch.no_grad():
            return (clone_state_dict(self.student), clone_opt_state(self.optimizer),
                    clone_state_dict(self.teacher), self.center.detach().clone())

    def jax_trees(self, step: int, snapshot: Optional[tuple] = None) -> Dict[str, Any]:
        """The checkpoint's ``params``, ``opt_state`` and the JAX DINO trainer's
        extras (of ``snapshot``, taken at update ``step``, when given)."""
        params, opt, teacher, center = snapshot or (None, None, self.teacher.state_dict(),
                                                    self.center)
        student = self.student.state_dict() if params is None else params
        # the heads' BatchNorm running statistics ({} without the BatchNorm head)
        return {**model_trees(self, step, params, opt),
                "momentum_model_state_dict": jax_tree_from_state_dict(teacher, self.norm_layer),
                "center": center.detach().cpu().numpy(), "head_stats": head_stats(student),
                "teacher_head_stats": head_stats(teacher)}

    def last_layer_group(self) -> dict:
        """The optimizer group of the head's trainable last-layer tensors."""
        return self.optimizer.param_groups[1]

    def full_view(self) -> "DINOTrainState":
        """This state with the student, its optimizer moments and the
        teacher whole (gathered over ``fsdp`` and ``tensor``: every rank
        must call it), in modules and an optimizer of their own; the state
        itself when both axes are 1 (``mae_engine.TrainState.full_view``)."""
        m = mesh.current()
        if m.size("tensor") == 1 and m.size("fsdp") == 1:
            return self
        dtype = self.student.backbone.patch_embedding.dtype
        with torch.device("meta"):
            student, teacher = (build_dino_model(self.config, dtype) for _ in range(2))
        pairs = fsdp.gather_module(self.student, student, m)
        fsdp.gather_module(self.teacher, teacher, m)
        optimizer = _optimizer(self.config, student)
        fsdp.gather_optimizer_state(self.optimizer, optimizer, pairs, m)
        return DINOTrainState(student, teacher, optimizer, self.lr_schedule, self.wd_sched,
                              self.momentum_sched, self.temp_sched, self.center, self.step,
                              self.grad_clip, self.config)

    def load_full(self, full: "DINOTrainState") -> "DINOTrainState":
        """Take this rank's shards of ``full`` (a filled ``full_view``): the
        student, its moments, the teacher, the centre and the step."""
        if full is self:
            return self
        fsdp.load_module(self.student, full.student, self.optimizer, full.optimizer)
        fsdp.load_module(self.teacher, full.teacher)
        self.center, self.step = full.center, full.step
        return self


def bn_rounding_only(config) -> Tuple[str, ...]:
    """Tensors of a DINO network whose gradient is 0 but for rounding under
    the BatchNorm head, which AdamW scales up to +-lr, so comparisons of two
    runs leave them out (as they leave out a qkv bias's key third): a
    train-mode BatchNorm takes out a per-channel shift of its input, so the
    bias of each Linear before one and the backbone's final norm bias (a
    shift of every CLS feature) reach the loss through nothing; the running
    means track those biases. Empty without the BatchNorm head."""
    d = config.DINO
    if not d.USE_BN or int(d.HEAD_N_LAYERS) < 2:
        return ()
    return ("backbone.norm.bias",) + tuple(
        f"head.mlp.{3 * i + j}.{leaf}" for i in range(int(d.HEAD_N_LAYERS) - 1)
        for j, leaf in ((0, "bias"), (1, "running_mean")))


def head_stats(sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The head's BatchNorm running statistics in a DINO network's
    state_dict as the JAX ``head_stats`` tree (``{"mlp_bn_0": {"mean",
    "var"}, ...}``; ``{}`` without the BatchNorm head)."""
    return batch_stats_from_state_dict({k[len("head."):]: v for k, v in sd.items()
                                        if k.startswith("head.")})


def build_vit_model(config, dtype: torch.dtype = torch.bfloat16, lora: bool = False) -> ViT:
    """The ViT backbone from config keys (reference: main_pretrain_dino.py:110-145);
    ``lora`` adds the downstream adapters (JAX ``:71-91``)."""
    v = config.VIT
    return ViT(in_chans=v.IN_CHANS, img_size=v.INPUT_SIZE, patch_size=v.PATCH_SIZE,
               hidden_size=v.HIDDEN_SIZE, mlp_dim=v.MLP_DIM, num_layers=v.NUM_LAYERS,
               num_heads=v.NUM_HEADS, pos_embed=v.POS_EMBED, classification=False,
               num_register_tokens=v.NUM_REGISTER_TOKENS, qkv_bias=v.USE_BIAS,
               norm_layer=v.NORM_LAYER, dropout_rate=v.DROPOUT_RATE,
               remat=bool(config.PARALLEL.REMAT), lora=lora, dtype=dtype)


def build_dino_head(config, dtype: torch.dtype = torch.bfloat16) -> DINOHead:
    d = config.DINO
    return DINOHead(in_dim=config.VIT.HIDDEN_SIZE, out_dim=d.HEAD_N_PROTOTYPES, use_bn=d.USE_BN,
                    norm_last_layer=d.NORM_LAST_LAYER, nlayers=d.HEAD_N_LAYERS,
                    hidden_dim=d.HEAD_HIDDEN_DIM, bottleneck_dim=d.BOTTLENECK_DIM, dtype=dtype)


def dino_trainable_mask(model: torch.nn.Module, config) -> Dict[str, bool]:
    """Parameter name -> trainable: False for the sincos position embeddings
    and, with NORM_LAST_LAYER, the last layer's weight-norm gain
    (reference: dino_head.py:27-29)."""
    def trainable(name: str) -> bool:
        parts = name.split(".")
        if config.VIT.POS_EMBED == "sincos" and "position_embeddings" in parts:
            return False
        return not (config.DINO.NORM_LAST_LAYER and "last_layer" in parts
                    and parts[-1] == "weight_g")

    return {name: trainable(name) for name, _ in model.named_parameters()}


def _is_last_layer(name: str) -> bool:
    return "last_layer" in name.split(".")


def build_dino_model(config, dtype: torch.dtype = torch.bfloat16) -> DINOModel:
    """A student or teacher network (uninitialised)."""
    return DINOModel(build_vit_model(config, dtype), build_dino_head(config, dtype))


def _optimizer(config, student: DINOModel, split=()) -> torch.optim.Optimizer:
    """The student's optimizer: the head's last layer in a group of its own."""
    named = list(student.named_parameters())
    return get_optimizer(config, [
        {"params": [p for n, p in named if not _is_last_layer(n)]},
        {"params": [p for n, p in named if _is_last_layer(n)]}], split=split)


def shard_model_(model: torch.nn.Module, blocks, m: mesh.Mesh) -> torch.nn.Module:
    """This rank's part of ``model`` on the mesh: the Megatron split of
    ``blocks`` over ``tensor``, then the ZeRO-3 shards over ``fsdp``."""
    if m.size("tensor") > 1:
        for blk in blocks:
            shard_block_(blk, m.size("tensor"), m.coord("tensor"), m.group("tensor"))
    return fsdp.shard_module_(model, m)


def create_train_state(
    config, total_steps: int, num_warmup_steps: int, niter_per_ep: int, seed: int = 0,
    dtype: torch.dtype = torch.bfloat16, device: Union[None, str, torch.device] = None,
) -> DINOTrainState:
    """Student, teacher, optimizer, schedules and centre on ``device``
    (default cuda). The weights are the full seed-``seed`` draw at any mesh,
    of which each rank keeps its part (``shard_model_``). Raises
    ``pipe`` ranks replicate the step, as JAX's ``pipe`` axis does for an
    engine that does not pipeline (``mesh.py batch_sharding``)."""
    m = check_mesh(config)
    device = resolve_device(device)
    set_pallas_min_t(config.PARALLEL.PALLAS_MIN_T)
    g = torch.Generator().manual_seed(seed)
    with tracing.span("setup.build"):
        backbone = build_vit_model(config, dtype)
    with tracing.span("setup.init_weights"):
        backbone = backbone.init_weights(g)
    with tracing.span("setup.build"):
        head = build_dino_head(config, dtype)
    with tracing.span("setup.init_weights"):
        student = DINOModel(backbone, head.init_weights(g))
    with tracing.span("setup.to_device"):
        student = shard_model_(student, backbone.blocks, m).to(device)
    trainable = dino_trainable_mask(student, config)
    for name, p in student.named_parameters():
        p.requires_grad_(trainable[name])
    with tracing.span("setup.to_device"):
        # the process groups are shared, not copied
        teacher = copy.deepcopy(student, {id(gr): gr for gr in m.groups.values()})
    teacher.requires_grad_(False)
    with tracing.span("setup.optimizer"):
        optimizer = _optimizer(config, student, split=fsdp.split_groups(student, m))
        lr_schedule = get_lr_schedule(config, config.TRAIN.BASE_LR, num_warmup_steps,
                                      total_steps, config.TRAIN.MIN_LR)
    d = config.DINO
    return DINOTrainState(
        student, teacher, optimizer, lr_schedule,
        wd_sched=get_wd_schedule(config, niter_per_ep),
        momentum_sched=get_momentum_schedule(config, niter_per_ep),
        temp_sched=teacher_temp_schedule(d.WARMUP_TEACHER_TEMP, d.TEACHER_TEMP,
                                         d.WARMUP_TEACHER_EPOCHS, config.TRAIN.MAX_EPOCHS),
        center=torch.zeros((1, d.HEAD_N_PROTOTYPES), dtype=torch.float32, device=device),
        grad_clip=float(config.TRAIN.GRAD_CLIP), config=config)


def _rows(decisions: Sequence[Dict[str, torch.Tensor]], lo: int, hi: int) -> list:
    """Samples [lo, hi) of ``draw_dino_multicrop``'s decisions (batch first)."""
    return [{k: v[lo:hi] for k, v in d.items()} for d in decisions]


def crop_args(config) -> dict:
    """``draw_dino_multicrop``'s crop sizes and count from DINO's config keys."""
    d = config.DINO
    return dict(global_crop_size=int(d.GLOBAL_CROP_SIZE[0]),
                local_crop_size=int(d.LOCAL_CROP_SIZE[0]),
                local_crops_number=int(d.LOCAL_CROP_NUM))


def _crops(config, batch: torch.Tensor, generator: Optional[torch.Generator],
           decisions=None) -> List[torch.Tensor]:
    """This rank's crops of ``batch``: the global batch's decisions drawn from
    ``generator`` and this rank's rows taken, unless ``decisions`` are given."""
    n, world, rank = batch.shape[0], distributed.data_world(), distributed.data_rank()
    if decisions is None:
        decisions = _rows(draw_dino_multicrop(world * n, generator, batch.device,
                                              batch.shape[-1], **crop_args(config)),
                          rank * n, (rank + 1) * n)
    return apply_dino_multicrop(batch, decisions, tuple(config.MODEL.ROI))


@torch.no_grad()
def update_teacher(teacher: torch.nn.Module, student: torch.nn.Module, momentum: float) -> None:
    """t = t m + s (1 - m) over every parameter, m and 1 - m in float32 (JAX
    ``:385-392``; the frozen tensors too, as the JAX tree map does). The
    BatchNorm running statistics are buffers, not parameters: each network
    keeps its own, as JAX keeps ``teacher_head_stats`` apart."""
    m = np.float32(momentum)
    t = list(teacher.parameters())
    torch._foreach_mul_(t, float(m))
    torch._foreach_add_(t, list(student.parameters()), alpha=float(np.float32(1.0) - m))


def make_grad_step(config) -> Callable:
    """grads(state, batch, seed, teacher_temp, draws=None) -> (loss, t_mean):
    the crops, the teacher and the student forward and the student's
    backward of every micro-batch, the gradients left in ``.grad``, averaged
    over the micro-batches, summed over ``seq`` and averaged over ``data`` x
    ``fsdp``; the loss and the teacher's mean output are the global
    batch's (``make_train_step``'s first half)."""
    in_chans = int(config.VIT.IN_CHANS)
    ncrops = int(config.DINO.LOCAL_CROP_NUM) + 2
    accum_steps = int(config.TRAIN.ACCUM_STEPS)
    drops = bool(config.VIT.DROPOUT_RATE)

    def grads(state: DINOTrainState, batch: torch.Tensor, seed: int, teacher_temp: float,
              draws: Optional[Draws] = None):
        student, teacher, device = state.student, state.teacher, state.device
        seq = mesh.current().size("seq")  # each seq rank backpropagates 1 / seq of the loss
        student.train()
        teacher.train()  # a BatchNorm head normalises with the batch's statistics
        with tracing.span("augment"):
            batch = wire_to_compute(batch.to(device), config, in_chans)
        if batch.shape[0] % accum_steps:
            raise ValueError(f"batch {batch.shape[0]} does not split into {accum_steps} "
                             "micro-batches")
        n = batch.shape[0] // accum_steps
        loss_sum = torch.zeros((), device=device)
        t_sum = torch.zeros_like(state.center[0])
        for i in range(accum_steps):
            g = None if draws is not None else step_generator(device, seed, state.step, i)
            with tracing.span("augment"):
                crops = _crops(config, batch[i * n:(i + 1) * n], g,
                               None if draws is None else draws[i])
            # the teacher's and the student's backbone dropout, from keys of
            # their own (JAX folds 101 and 102 into the micro-batch's key)
            t_drop, s_drop = ((step_generator(device, seed, state.step, i, k) for k in (101, 102))
                              if drops else (None, None))
            with tracing.span("fwd"):
                with torch.no_grad():
                    t_out = teacher(crops[:2], t_drop)
                loss = dino_loss(student(crops, s_drop), t_out, state.center, teacher_temp,
                                 ncrops)
            with tracing.span("bwd"):
                # float32 .grad: the micro-batches' sum
                (loss / seq if seq > 1 else loss).backward()
            loss_sum += loss.detach()
            t_sum += t_out.float().mean(dim=0)
        gs = [p.grad for p in student.parameters() if p.grad is not None]
        if accum_steps > 1:
            torch._foreach_div_(gs, accum_steps)
        loss, t_mean = loss_sum / accum_steps, t_sum / accum_steps
        if seq > 1:  # the seq ranks' shares
            distributed.all_reduce_sum_(gs, mesh.current().group("seq"))
        # one average across the data x fsdp ranks per update (a no-op on one)
        distributed.data_mean_([loss, t_mean] + gs, sharded=fsdp_grads(student))
        pipeline.replicate_(gs)  # pipe ranks replicate the step: the same update
        return loss, t_mean

    return grads


def apply_update(state: DINOTrainState, momentum: float, cancel_last_layer: bool,
                 t_mean: torch.Tensor) -> DINOTrainState:
    """The update from the gradients in ``.grad`` (``make_train_step``'s
    second half): the last-layer freeze, the per-parameter clip (a split
    tensor's norm over its shards), the step's LR and weight decay, the
    optimizer step, the teacher's EMA and the centre's."""
    with tracing.span("update"):
        student = state.student
        last = state.last_layer_group()
        if cancel_last_layer:
            for p in last["params"]:
                p.grad.mul_(0.0)
        if state.grad_clip:
            clip_by_per_param_norm(student.parameters(), state.grad_clip,
                                   split=fsdp.split_groups(student))
        # optax's count before the increment
        set_step_hyperparameters(state.optimizer, state.lr_schedule(state.step),
                                 scheduled_weight_decay(state.wd_sched, state.step))
        if cancel_last_layer:
            last["lr"] = 0.0
        with tracing.span("optimizer"):
            state.optimizer.step()
            state.optimizer.zero_grad(set_to_none=True)
        update_teacher(state.teacher, student, momentum)
        state.center = update_center(state.center, t_mean[None])
        state.step += 1
    return state


def make_train_step(config) -> Callable:
    """step(state, batch, seed, momentum, teacher_temp, cancel_last_layer,
    draws=None) -> (state, {"loss": device scalar}): ``make_grad_step``
    then ``apply_update``.

    ``batch`` is this rank's wire batch [B, C or 1, R, R, R]; the loss is the
    global batch's."""
    grads = make_grad_step(config)

    def train_step(state: DINOTrainState, batch: torch.Tensor, seed: int, momentum: float,
                   teacher_temp: float, cancel_last_layer: bool, draws: Optional[Draws] = None):
        loss, t_mean = grads(state, batch, seed, teacher_temp, draws)
        return apply_update(state, momentum, cancel_last_layer, t_mean), {"loss": loss}

    return train_step


def make_eval_step(config) -> Callable:
    """step(state, batch, generator=None, teacher_temp=..., draws=None) ->
    {"loss": device scalar}: the train step's crops and loss without an
    update (reference: engine_pretrain_dino.py:128-205), averaged across the
    ranks."""
    in_chans = int(config.VIT.IN_CHANS)
    ncrops = int(config.DINO.LOCAL_CROP_NUM) + 2

    @torch.no_grad()
    def eval_step(state: DINOTrainState, batch: torch.Tensor,
                  generator: Optional[torch.Generator], teacher_temp: float,
                  draws: Optional[Sequence[Dict[str, torch.Tensor]]] = None):
        state.student.eval()
        state.teacher.eval()  # a BatchNorm head uses its running statistics
        batch = wire_to_compute(batch.to(state.device), config, in_chans)
        crops = _crops(config, batch, generator, draws)
        loss = dino_loss(state.student(crops), state.teacher(crops[:2]), state.center,
                         teacher_temp, ncrops)
        distributed.data_mean_([loss])
        return {"loss": loss}

    return eval_step


def _at(sched: np.ndarray, i: int) -> float:
    """sched[min(i, len - 1)]: a schedule past its end keeps its last value."""
    return float(sched[min(i, len(sched) - 1)])


def train_one_epoch(
    config, state: DINOTrainState, train_step, loader: Iterable, seed: int, epoch: int,
    max_epoch: int, logger: Optional[logging.Logger] = None, wandb_run=None,
) -> Tuple[DINOTrainState, Dict[str, Any]]:
    """One pass over ``loader``; returns the state and the mean loss, LR and
    weight decay, the mean ``iter_time`` and ``data_time`` per step (host
    clock), the step count and the kernels' launches."""
    n_batches = len(loader) if hasattr(loader, "__len__") else 0
    cancel = epoch < int(config.DINO.FREEZE_LAST_LAYER)
    temp = _at(state.temp_sched, epoch)
    losses: List[float] = []
    lrs: List[float] = []
    wds: List[float] = []
    pending: List[Tuple[torch.Tensor, int]] = []

    def log(loss: float, idx: int) -> None:
        it = n_batches * epoch + idx
        lr, wd = float(state.lr_schedule(it)), _at(state.wd_sched, it)
        losses.append(loss)
        lrs.append(lr)
        wds.append(wd)
        if logger:
            logger.info(f"Epoch {epoch + 1}/{max_epoch} [{idx + 1}/{n_batches}]  Loss: {loss:.4f}")
        if wandb_run is not None:
            wandb_run.log({"Training Loss": loss, "Training lr": lr, "Training wd": wd})

    before, reduced = kernel_launches(), allreduce_counts()
    data_times: List[float] = []
    iter_times: List[float] = []
    sid = None  # the step id of the spans: state.step at the step's entry
    end = time.perf_counter()
    for idx, batch in enumerate(_batches(DevicePrefetcher.wrap(loader, state.device))):
        data_times.append(time.perf_counter() - end)
        sid = state.step
        # the reference's quirk: the momentum by the index within the epoch,
        # not the global iteration
        momentum = _at(state.momentum_sched, idx)
        with tracing.span("step", sid):
            state, metrics = train_step(state, to_device_batch(batch, state.device), seed,
                                        momentum, temp, cancel)
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
        stats.update(loss=float(np.mean(losses)), lr=float(np.mean(lrs)),
                     wd=float(np.mean(wds)))
    return state, stats


def val_one_epoch(
    config, state: DINOTrainState, eval_step, loader: Iterable, seed: int, epoch: int,
    max_epoch: int, logger: Optional[logging.Logger] = None,
) -> Dict[str, Any]:
    """Mean loss over ``loader`` at the epoch's teacher temperature; also the
    batch count and the kernels' launches."""
    temp = _at(state.temp_sched, epoch)
    losses = []
    before = kernel_launches()
    for idx, batch in enumerate(_batches(DevicePrefetcher.wrap(loader, state.device))):
        metrics = eval_step(state, to_device_batch(batch, state.device),
                            step_generator(state.device, seed, idx), temp)
        loss = float(metrics["loss"])
        losses.append(loss)
        if logger:
            logger.info(f"Val Epoch {epoch + 1}/{max_epoch} [{idx + 1}]  Loss: {loss:.4f}")
    stats: Dict[str, Any] = {"batches": len(losses), "launches": _launches_since(before)}
    if losses:
        stats["loss"] = float(np.mean(losses))
    return stats


def trainer(
    config, state: DINOTrainState, train_step, eval_step, train_loader, val_loader, seed: int,
    max_epochs: int, val_every: int, logger: Optional[logging.Logger] = None,
    start_epoch: int = 0, wandb_run=None, history: Optional[List[Dict[str, Any]]] = None,
) -> Tuple[DINOTrainState, float]:
    """The epoch loop with latest/best checkpoints carrying the teacher, the
    centre and the head stats; returns the state and the best validation
    loss. ``history`` gets one dict per epoch, as ``mae_engine.trainer``'s."""
    best_loss = float("inf")
    save_name = config.MODEL.SAVE_NAME
    ckpt = dict(logger=logger, async_save=bool(config.TRAIN.ASYNC_CKPT),
                fmt=str(config.TRAIN.CKPT_FORMAT))
    for epoch in range(start_epoch, max_epochs):
        t0 = time.perf_counter()
        if hasattr(train_loader, "set_epoch"):
            train_loader.set_epoch(epoch)
        with profile_trace() if epoch == start_epoch else contextlib.nullcontext():
            state, train_stats = train_one_epoch(config, state, train_step, train_loader, seed,
                                                 epoch, max_epochs, logger=logger,
                                                 wandb_run=wandb_run)
        seconds = time.perf_counter() - t0
        if logger:
            logger.info(
                f"Epoch {epoch + 1} done in {seconds:.1f}s  "
                f"train loss {train_stats.get('loss', float('nan')):.4f}  "
                f"iter {train_stats['iter_time']:.3f}s (data {train_stats['data_time']:.3f}s)")
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
        train_loader.close()
    wait_for_saves()
    return state, best_loss


def tester(config, state: DINOTrainState, eval_step, test_loader, seed: int,
           logger: Optional[logging.Logger] = None, wandb_run=None) -> Dict[str, Any]:
    stats = val_one_epoch(config, state, eval_step, test_loader, seed, epoch=0, max_epoch=1,
                          logger=logger)
    if wandb_run is not None and "loss" in stats:
        wandb_run.log({"Test Loss": stats["loss"]})
    return stats
