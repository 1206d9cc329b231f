"""Checkpoints of a train state in the JAX package's pickle format.

Port of the JAX package's ``utils/checkpoint.py`` (reference:
src/utils/misc.py:35-69). A checkpoint is one pickle of
``{"epoch", "best_loss", "step", "params", "opt_state", **extra}``:
``params`` is the JAX parameter tree and ``opt_state`` the optax state of
the same optimizer, both in flax's ``to_state_dict`` form with numpy
leaves (``utils/torch_interop.py`` maps the port's modules and optimizers
to and from them). Either package reads the other's files.

* ``save_checkpoint`` writes through a temporary file and ``os.replace``;
  under data parallelism rank 0 writes and the others return. With
  ``async_save`` the state is snapshotted on the device (a ``clone`` on the
  trainer's stream, since the optimizer updates the parameters in place)
  and one writer thread waits on a CUDA event recorded after the clones,
  copies them to the host on a stream of its own and writes; at most one
  write is in flight.
  ``wait_for_saves`` joins it and re-raises its error.
* ``load_checkpoint`` unpickles through the restricted unpickler of
  ``utils/torch_interop.py``; ``restore_state`` fills the port's
  ``TrainState`` (the model, the optimizer state and ``step``) from such a
  payload, whichever package wrote it, and returns (state, epoch,
  best_loss). A payload whose trees do not fit raises ValueError or
  KeyError and leaves the state as it was.

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

from headct_foundation_tpu_torch.parallel import distributed
from headct_foundation_tpu_torch.utils.torch_interop import (
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


def _snapshot(state) -> Tuple[Dict[str, torch.Tensor], Dict[Any, Dict[str, torch.Tensor]]]:
    """Device-side copies of the parameters and the optimizer state."""
    with torch.no_grad():
        params = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
        opt = {p: {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in st.items()}
               for p, st in state.optimizer.state.items()}
    return params, opt


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
    """Write ``dir_add/filename``; returns its path (written by rank 0 only)."""
    refuse_orbax(fmt=fmt)
    path = os.path.join(dir_add, filename)
    if distributed.rank() != 0:
        return path
    os.makedirs(dir_add, exist_ok=True)
    config, step, model, optimizer = state.config, int(state.step), state.model, state.optimizer
    done = side = None
    if async_save:
        params, opt = _snapshot(state)
        if state.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(state.device))
            side = torch.cuda.Stream(state.device)  # the writer's copies queue apart from the steps
    else:
        params, opt = model.state_dict(), None

    def write():
        if done is not None:
            done.synchronize()  # the clones are complete
        with torch.cuda.stream(side) if side is not None else contextlib.nullcontext():
            payload = {
                "epoch": int(epoch),
                "best_loss": float(best_loss),
                "step": step,
                "params": jax_tree_from_state_dict(params, str(config.MAE.NORM_LAYER)),
                "opt_state": opt_state_to_jax(optimizer, model, config, step, state=opt),
            }
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


def restore_state(state, payload: Dict[str, Any]) -> Tuple[Any, int, float]:
    """Fill ``state`` from a checkpoint payload; returns (state, epoch,
    best_loss). The parameters are copied as they are (bit for bit), the
    optimizer's moments and ``step`` with them."""
    model = state.model
    sd = model.state_dict()
    source = state_dict_from_jax(payload["params"])
    if set(source) != set(sd):
        raise KeyError(f"checkpoint parameters do not fit the model: missing "
                       f"{sorted(set(sd) - set(source))[:5]}, unexpected "
                       f"{sorted(set(source) - set(sd))[:5]}")
    tensors = {k: tensor_from_leaf(source[k].numpy(), sd[k], k) for k in sd}
    step = int(payload.get("step", 0))
    if "opt_state" in payload:
        opt_state_from_jax(payload["opt_state"], state.optimizer, model, state.config, step)
    with torch.no_grad():
        for k, v in sd.items():
            v.copy_(tensors[k])
    state.step = step
    return state, int(payload.get("epoch", 0)), float(payload.get("best_loss", float("inf")))
