"""Checkpoints of a train state in the JAX package's pickle format.

Port of the JAX package's ``utils/checkpoint.py`` (reference:
src/utils/misc.py:35-69). A checkpoint is one pickle of
``{"epoch", "best_loss", "step", "params", "opt_state", **extra}``:
``params`` is the JAX parameter tree and ``opt_state`` the optax state of
the same optimizer, both in flax's ``to_state_dict`` form with numpy
leaves (``utils/torch_interop.py`` maps the port's modules and optimizers
to and from them). Either package reads the other's files.

* ``save_checkpoint`` writes through a temporary file and ``os.replace``;
  under data parallelism rank 0 writes and the others return. Under tensor
  parallelism every rank first gathers the MAE state's split parameters
  and moments whole (``TrainState.full_view``), so the file has the JAX
  layout at any mesh; ``TrainState.load_full`` takes a rank's parts back
  from a full state that ``restore_state`` filled. The state
  gives the payload's trees itself: ``state.jax_trees(step, snapshot)``
  (``engines/*_engine.py``) returns them in the JAX layout, of the live
  state or of ``state.snapshot()``. With ``async_save`` the state is
  snapshotted on the device (a ``clone`` on the trainer's stream, since the
  optimizer updates the parameters in place) and one writer thread waits on
  a CUDA event recorded after the clones, copies them to the host on a
  stream of its own and writes; at most one write is in flight.
  ``wait_for_saves`` joins it and re-raises its error.
* The MAE state's trees are ``params`` and ``opt_state`` (``model_trees``);
  a ``PIPE`` state's hold the trunks stacked (``parallel/pipeline.py``), as
  the JAX package's ``PIPE`` state does, and ``restore_state`` reads only
  the layout of the state it fills (JAX ``:330-388``).
  A DINO state adds the JAX DINO trainer's extras (its ``:598-606``):
  ``momentum_model_state_dict`` (the teacher's parameter tree), ``center``,
  ``head_stats`` and ``teacher_head_stats`` (the student's and the teacher's
  head BatchNorm running statistics, ``{"mlp_bn_N": {"mean", "var"}}``;
  ``{}`` without the BatchNorm head). A downstream state's are the JAX
  downstream trainer's (its ``:592-601``): ``params`` is ``{"model", "classifier"}``, ``opt_state``
  the ``multi_transform`` state of its two optimizers
  (``utils/torch_interop.py``), and ``batch_stats`` the classifier's
  BatchNorm running statistics; ``restore_downstream_state`` fills one
  back, bit for bit.
* ``load_checkpoint`` unpickles through the restricted unpickler of
  ``utils/torch_interop.py``; ``restore_state`` fills the port's
  ``TrainState`` (the model, the optimizer state and ``step``) from such a
  payload, whichever package wrote it, and returns (state, epoch,
  best_loss). A payload whose trees do not fit raises ValueError or
  KeyError and leaves the state as it was. ``restore_dino_state`` (JAX
  ``:390-428``) restores the student's parameters the same way (they must
  fit), then each DINO entry that is present and fits, skipping any other
  with a log line, as the JAX package does.

Orbax (``TRAIN.CKPT_FORMAT: orbax`` or a directory) imports JAX and raises
``OrbaxNotSupportedError``.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from headct_foundation_tpu_torch.parallel import distributed, pipeline
from headct_foundation_tpu_torch.utils.torch_interop import (
    CheckpointDtypeError,
    downstream_opt_state_from_jax,
    downstream_state_dicts_from_jax,
    is_stat,
    jax_tree_from_state_dict,
    load_native_pickle,
    opt_state_from_jax,
    opt_state_to_jax,
    refuse_orbax,
    state_dict_from_jax,
    tensor_from_leaf,
)


class _AsyncSaver:
    """One background writer; ``submit`` joins the previous write first, so
    the files keep their order and one snapshot at most is held."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def submit(self, fn) -> None:
        self.wait()

        def run():
            try:
                fn()
            except BaseException as e:  # re-raised by the next wait() or submit()
                self._error = e

        self._thread = threading.Thread(target=run, name="ckpt-writer", daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


_SAVER = _AsyncSaver()


def wait_for_saves() -> None:
    """Join the write in flight, if any (end of training, or before reading
    a file just written)."""
    _SAVER.wait()


def clone_state_dict(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A device-side copy of ``module``'s state_dict."""
    with torch.no_grad():
        return {k: v.detach().clone() for k, v in module.state_dict().items()}


def clone_opt_state(optimizer) -> Dict[Any, Dict[str, torch.Tensor]]:
    """A device-side copy of an optimizer's per-parameter state ({} for None)."""
    if optimizer is None:
        return {}
    with torch.no_grad():
        return {p: {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in st.items()}
                for p, st in optimizer.state.items()}


def model_trees(state, step: int, params: Optional[dict], opt: Optional[dict]
                ) -> Dict[str, Any]:
    """``params`` and ``opt_state`` of a state with one ``model`` and one
    ``optimizer`` in the JAX layout: of the live state, or of the copies
    ``params`` and ``opt`` taken at update ``step``."""
    norm_layer = state.norm_layer
    return {"params": jax_tree_from_state_dict(
                state.model.state_dict() if params is None else params, norm_layer),
            "opt_state": opt_state_to_jax(state.optimizer, state.model, state.config, step,
                                          state=opt, norm_layer=norm_layer)}


def _numpy_extra(v: Any) -> Any:
    if isinstance(v, (int, float, str)):
        return v
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if isinstance(v, dict):
        return {k: _numpy_extra(x) for k, x in v.items()}
    return np.asarray(v)


def save_checkpoint(state, epoch: int, best_loss: float, dir_add: str,
                    filename: str = "model.ckpt", logger=None,
                    extra: Optional[Dict[str, Any]] = None, async_save: bool = False,
                    fmt: str = "pickle") -> str:
    """Write ``dir_add/filename``; returns its path (written by rank 0 only).
    A state with a ``full_view`` (the MAE's) is gathered whole first, on
    every rank."""
    refuse_orbax(fmt=fmt)
    path = os.path.join(dir_add, filename)
    if hasattr(state, "full_view"):
        state = state.full_view()
    if distributed.rank() != 0:
        return path
    os.makedirs(dir_add, exist_ok=True)
    step = int(state.step)
    done = side = snapshot = None
    if async_save:
        snapshot = state.snapshot()
        if state.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(state.device))
            side = torch.cuda.Stream(state.device)  # the writer's copies queue apart from the steps

    def write():
        if done is not None:
            done.synchronize()  # the clones are complete
        with torch.cuda.stream(side) if side is not None else contextlib.nullcontext():
            payload = {"epoch": int(epoch), "best_loss": float(best_loss), "step": step,
                       **state.jax_trees(step, snapshot)}
        payload.update({k: _numpy_extra(v) for k, v in (extra or {}).items()})
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
        if os.path.isdir(path):  # a JAX run's orbax directory of the same name
            shutil.rmtree(path)
        os.replace(tmp, path)
        if logger:
            logger.info(f"Saved checkpoint {path}")

    if async_save:
        _SAVER.submit(write)
    else:
        write()
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    refuse_orbax(path)
    with open(path, "rb") as f:
        return load_native_pickle(f)


def _tensors_of(model: torch.nn.Module, tree: Any, stats: Any = None,
                prefix: str = "") -> Dict[str, torch.Tensor]:
    """A JAX parameter tree (or, given ``stats``, a ``batch_stats`` tree) as
    tensors for ``model``'s state_dict entries of that kind under
    ``prefix``, checked (names, dtypes, shapes) before anything is copied."""
    sd = {k: v for k, v in model.state_dict().items()
          if k.startswith(prefix) and (stats is None) != is_stat(k)}
    source = {prefix + k: v for k, v in (
        state_dict_from_jax(tree) if stats is None
        else state_dict_from_jax({}, batch_stats=stats)).items()}
    if set(source) != set(sd):
        raise KeyError(f"checkpoint parameters do not fit the model: missing "
                       f"{sorted(set(sd) - set(source))[:5]}, unexpected "
                       f"{sorted(set(source) - set(sd))[:5]}")
    return {k: tensor_from_leaf(source[k].numpy(), sd[k], k) for k in sd}


def _copy_into(model: torch.nn.Module, tensors: Dict[str, torch.Tensor]) -> None:
    sd = model.state_dict()
    with torch.no_grad():
        for k, v in tensors.items():
            sd[k].copy_(v)


def _pretrain_trees(state, payload: Dict[str, Any]) -> Tuple[Any, Any]:
    """The payload's ``params`` and ``opt_state`` in the per-block layout.
    A ``PIPE`` state (``state.pipelined``) takes stacked trunks only and any
    other state per-block ones only: the JAX package's ``restore_state``
    raises on the other layout (``from_state_dict``'s key check), and so
    does this (KeyError)."""
    params, opt = payload["params"], payload.get("opt_state")
    stacked = pipeline.has_stacked_trunks(params)
    if stacked != bool(getattr(state, "pipelined", False)):
        raise KeyError(f"checkpoint trunks are {'stacked' if stacked else 'per block'} and the "
                       f"state's are {'per block' if stacked else 'stacked'} (PARALLEL.PIPE): "
                       "the layouts differ")
    if stacked:
        params, opt = pipeline.unstack_trunks(params), pipeline.unstack_trunks(opt)
    return params, opt


def restore_state(state, payload: Dict[str, Any]) -> Tuple[Any, int, float]:
    """Fill ``state`` from a checkpoint payload; returns (state, epoch,
    best_loss). The parameters are copied as they are (bit for bit), the
    optimizer's moments and ``step`` with them. A ``PIPE`` state reads a
    ``PIPE`` checkpoint's stacked trunks (``_pretrain_trees``)."""
    params, opt = _pretrain_trees(state, payload)
    tensors = _tensors_of(state.model, params)
    step = int(payload.get("step", 0))
    if opt is not None:
        opt_state_from_jax(opt, state.optimizer, state.model, state.config,
                           step, norm_layer=state.norm_layer)
    _copy_into(state.model, tensors)
    state.step = step
    return state, int(payload.get("epoch", 0)), float(payload.get("best_loss", float("inf")))


def restore_dino_state(state, payload: Dict[str, Any], logger=None) -> Tuple[Any, int, float]:
    """Full DINO resume: the student's parameters (KeyError, ValueError or
    CheckpointDtypeError if they do not fit, the state untouched), then the
    teacher, the optimizer state, the centre and the head stats, each where
    the payload has it and it fits; the others are skipped and logged.
    Returns (state, epoch, best_loss)."""
    tensors = _tensors_of(state.student, payload["params"])
    step = int(payload.get("step", 0))
    skipped = []

    def restore_teacher(tree):
        _copy_into(state.teacher, _tensors_of(state.teacher, tree))

    def restore_opt(tree):
        opt_state_from_jax(tree, state.optimizer, state.student, state.config, step,
                           norm_layer=state.norm_layer)

    def restore_center(value):
        state.center = tensor_from_leaf(value, state.center, "center")

    def stats_of(model):
        def restore(value):
            _copy_into(model, _tensors_of(model, None, stats=dict(value), prefix="head."))
        return restore

    _copy_into(state.student, tensors)
    for key, restore in (("momentum_model_state_dict", restore_teacher),
                         ("opt_state", restore_opt), ("center", restore_center),
                         ("head_stats", stats_of(state.student)),
                         ("teacher_head_stats", stats_of(state.teacher))):
        if key not in payload:
            skipped.append(key)
            continue
        try:
            restore(payload[key])
        except (ValueError, KeyError, TypeError, CheckpointDtypeError) as e:
            skipped.append(f"{key} ({e})")
    state.step = step
    if skipped and logger:
        logger.warning(f"DINO resume: not restored: {skipped}")
    return state, int(payload.get("epoch", 0)), float(payload.get("best_loss", float("inf")))


def restore_downstream_state(state, payload: Dict[str, Any]) -> Tuple[Any, int, float]:
    """Fill a downstream state from a checkpoint payload of either package:
    the backbone and the classifier (with the ``batch_stats`` when present),
    the optimizers' state when present, ``step``. Returns (state, epoch,
    best value). Trees that do not fit raise KeyError, ValueError or
    CheckpointDtypeError before anything is copied."""
    model_sd, clf_sd = downstream_state_dicts_from_jax(payload["params"],
                                                       payload.get("batch_stats"))
    if "batch_stats" not in payload:  # params only: keep the running statistics
        clf_sd.update({k: v for k, v in state.classifier.state_dict().items()
                       if k.endswith(("running_mean", "running_var"))})
    tensors = []
    for module, source in ((state.model, model_sd), (state.classifier, clf_sd)):
        sd = module.state_dict()
        if set(source) != set(sd):
            raise KeyError(f"checkpoint parameters do not fit the model: missing "
                           f"{sorted(set(sd) - set(source))[:5]}, unexpected "
                           f"{sorted(set(source) - set(sd))[:5]}")
        tensors.append({k: tensor_from_leaf(source[k].numpy(), sd[k], k) for k in sd})
    step = int(payload.get("step", 0))
    if "opt_state" in payload:
        downstream_opt_state_from_jax(payload["opt_state"], state.optimizers, state.model,
                                      state.classifier, state.config, step,
                                      norm_layer=state.norm_layer)
    _copy_into(state.model, tensors[0])
    _copy_into(state.classifier, tensors[1])
    state.step = step
    return state, int(payload.get("epoch", 0)), float(payload.get("best_loss", float("inf")))
