"""The optimizer zoo and the per-parameter gradient clip.

Port of the JAX package's ``optim/optimizers.py:38-287`` as MAE training
reads it. The JAX chain runs inside the ``"train"`` branch of
``multi_transform``; here that branch is the set of parameters with
``requires_grad``, in one group with no decay exclusions (frozen parameters
get no update). The learning rate is set by the caller before each
``optimizer.step()`` from the update count (``engines/mae_engine.py``), so
the first update uses ``lr(0)``, as optax does.

* ``clip_by_per_param_norm`` (``:38-55``): each trainable gradient scaled in
  place to L2 norm <= clip, the norm in float32. The engine calls it on the
  averaged gradients before ``optimizer.step()``, where the JAX chain puts
  it first.
* AdamW: ``scale_by_adam(b1, b2, eps=1e-8)``, ``+ wd * p``, ``* (-lr)`` is
  ``torch.optim.AdamW`` (``p (1 - lr wd) - lr m_hat / (sqrt(v_hat) + eps)``).
* SGD: ``optax.trace(momentum, nesterov=False)`` then ``* (-lr)``, with no
  weight decay (``:242-247``), is ``torch.optim.SGD(momentum, dampening=0,
  nesterov=False, weight_decay=0)``: both keep t = g + momentum t and take
  p - lr t, with t = g on the first step.
* ``Lamb`` ports ``scale_by_lamb`` (``:95-149``) then ``* (-lr)``.
* ``Lion`` ports ``scale_by_lion_with_wd`` (``:161-208``): with ``fused`` it
  calls the kernel B6 (``ops.lion_kernel.lion_update_leaf``) once per
  tensor, else the JAX package's unfused branch in plain torch ops; either
  way ``p += delta`` (``optax.apply_updates``).
* ``scheduled_weight_decay`` (``:66-82`` and ``get_optimizer(weight_decay=
  <schedule>)``): the decay of update n, read from a per-iteration array at
  min(n, len - 1) in float32 (the DINO engine's ``wd_fn``);
  ``set_step_hyperparameters`` puts one update's learning rate and decay
  into every parameter group before ``optimizer.step()``. The decay
  applies to every tensor the optimizer holds, biases and norms included (the
  JAX mask leaves out only the frozen leaves); SGD takes none, as in JAX.
* "float32" here (the clip's norms, Lamb's moments and products) is
  float64 for float64 parameters (``utils/misc.py wide_dtype``); Lion's
  momentum is float32, as B6 takes it.
* ``get_optimizer`` takes parameters or parameter groups (dicts with
  ``"params"``, such as the DINO engine's last layer in a group of its own).
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from headct_foundation_tpu_torch.ops.lion_kernel import lion_update_leaf, sign_keep_nan
from headct_foundation_tpu_torch.utils.misc import wide_dtype, widen


def norms_over_shards(sq: torch.Tensor, params: list, split) -> torch.Tensor:
    """Per-parameter squared norms ``sq`` [n] (or [k, n]) summed over the
    shards of each split parameter: for each (group, parameters) of
    ``split``, the entries of those parameters all-reduced over the group."""
    for group, members in split:
        ids = {id(p) for p in members}
        mask = torch.tensor([id(p) in ids for p in params], device=sq.device)
        part = torch.where(mask, sq, torch.zeros_like(sq))
        dist.all_reduce(part, group=group)
        sq = torch.where(mask, part, sq)
    return sq


def whole_norms(norms: torch.Tensor, params: list, split: Sequence = (),
                stacked: Tuple = (None, [])) -> torch.Tensor:
    """Per-parameter L2 norms [n] (or [k, n]) of what JAX holds as one leaf:
    a parameter split over ``fsdp`` or ``tensor`` takes its norm over all its
    shards (``split``: (group, parameters) per axis), and a block parameter
    of a ``pipe`` stage the norm of its stacked leaf, over every layer of
    every stage (``stacked``: ``parallel/pipeline.py stacked_groups``)."""
    if split:
        norms = norms_over_shards(norms.square(), params, split).sqrt()
    if stacked[1]:
        from headct_foundation_tpu_torch.parallel.pipeline import stacked_sq_norms

        norms = stacked_sq_norms(norms.square(), params, stacked).sqrt()
    return norms


@torch.no_grad()
def clip_by_per_param_norm(params: Iterable[torch.nn.Parameter], clip: float,
                           eps: float = 1e-6, split: Sequence = (),
                           stacked: Tuple = (None, [])) -> None:
    """Scale each trainable ``.grad`` in place by min(clip / (||g||_2 + eps), 1),
    the norm taken in float32 (the reference clip_gradients: each
    parameter's gradient on its own, not the global norm). A parameter
    split over ``fsdp`` or ``tensor`` takes its norm over all its shards:
    ``split`` holds (group, parameters split over it) per axis
    (``parallel/fsdp.py split_groups``), and the sums of squares are
    all-reduced over each. Under ``pipe`` a block parameter is clipped by
    the norm of its stacked leaf (``stacked``; JAX's clip sees the [L]
    leaf whole), summed over the ``pipe`` group."""
    params = [p for p in params if p.requires_grad and p.grad is not None]
    grads = [p.grad for p in params]
    if not grads:
        return
    norms = whole_norms(torch.stack(torch._foreach_norm([widen(g) for g in grads])), params,
                        split, stacked)
    coefs = torch.clamp(clip / (norms + eps), max=1.0)
    torch._foreach_mul_(grads, list(coefs))  # in float32, rounded to g's dtype


def without_key_bias(name: str, t: torch.Tensor) -> torch.Tensor:
    """``t`` flattened, less the key third when ``name`` is a qkv bias. The
    loss does not depend on a key bias (softmax is invariant to a shift of a
    query row's scores), so its gradient is rounding noise that AdamW scales
    up to +-lr: comparisons of gradients or updates between two programs
    leave it out."""
    t = t.flatten()
    if not name.endswith("qkv.bias"):
        return t
    n = t.numel() // 3
    return torch.cat([t[:n], t[2 * n:]])


class Lamb(torch.optim.Optimizer):
    """Lamb (arXiv 1904.00962) as the JAX package's ``scale_by_lamb`` followed
    by ``scale_by_learning_rate``: no bias correction, the weight norm clipped
    to [0, 10], the trust ratio 1 where either norm is 0. ``exp_avg_quirk``
    takes the reference's first moment ``m = b1 m + (1 - b1) g^2``. The
    trust ratio takes whole-tensor norms: ``split`` (set by the engines from
    ``parallel/fsdp.py split_groups``) lists (group, parameters split over
    it), and each such parameter's two sums of squares are all-reduced over
    its groups, one call per group for all parameters; ``stacked`` (set
    under ``pipe``) takes a block parameter's norms over its stacked leaf."""

    def __init__(self, params, lr: float = 0.0, betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-6, weight_decay: float = 0.0, exp_avg_quirk: bool = False):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                                      exp_avg_quirk=exp_avg_quirk))
        self.split: Sequence = ()
        self.stacked: Tuple = (None, [])

    @torch.no_grad()
    def step(self, closure=None):
        todo = []  # (parameter, group, Adam step)
        for group in self.param_groups:
            b1, b2 = group["betas"]
            eps, wd = group["eps"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["exp_avg"] = torch.zeros_like(p, dtype=wide_dtype(p.dtype))
                    state["exp_avg_sq"] = torch.zeros_like(p, dtype=wide_dtype(p.dtype))
                m, v = state["exp_avg"], state["exp_avg_sq"]
                g = widen(p.grad)
                m.mul_(b1).add_((1 - b1) * (g * g if group["exp_avg_quirk"] else g))
                v.mul_(b2).add_((1 - b2) * g * g)
                todo.append((p, group, m / (v.sqrt() + eps) + wd * widen(p)))
        if not todo:
            return
        params = [p for p, _, _ in todo]
        norms = torch.stack([torch.stack(torch._foreach_norm([widen(p) for p in params])),
                             torch.stack(torch._foreach_norm([a for _, _, a in todo]))])
        norms = whole_norms(norms, params, self.split, self.stacked)
        w_norms, a_norms = norms.unbind(0)
        for (p, group, adam_step), w, a in zip(todo, w_norms, a_norms):
            w_norm = torch.clamp(w, 0.0, 10.0)
            trust = torch.where((w_norm == 0) | (a == 0), 1.0, w_norm / (a + group["eps"]))
            p.add_((trust * adam_step).to(p.dtype) * -group["lr"])


class Lion(torch.optim.Optimizer):
    """Lion with decoupled weight decay, the JAX package's
    ``scale_by_lion_with_wd``: delta = -lr wd p - lr sign(b1 m + (1 - b1) g),
    m = b2 m + (1 - b2) g, p += delta. The momentum (float32) is the state
    ``exp_avg``, the reference torch Lion's name. ``fused`` runs the kernel
    B6 per tensor (its plain version on a CPU tensor), updating ``exp_avg``
    in place."""

    def __init__(self, params, lr: float = 0.0, betas: Tuple[float, float] = (0.9, 0.99),
                 weight_decay: float = 0.0, fused: bool = False):
        super().__init__(params, dict(lr=lr, betas=betas, weight_decay=weight_decay, fused=fused))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["exp_avg"] = torch.zeros_like(p, dtype=torch.float32,
                                                        memory_format=torch.contiguous_format)
                m = state["exp_avg"]
                if group["fused"]:
                    delta, _ = lion_update_leaf(p, p.grad, m, group["lr"],
                                                group["weight_decay"], b1, b2, m_out=m)
                else:
                    delta = _lion_unfused(p, p.grad, m, group["lr"], group["weight_decay"],
                                          b1, b2)
                p.add_(delta)


def _lion_unfused(p, g, m, lr, wd, b1, b2) -> torch.Tensor:
    """The JAX package's unfused Lion leaf (``:195-201``): lr and wd as
    float32 scalars, b1 and b2 as Python floats (weakly typed there, float32
    here once they meet a float32 tensor). Updates m in place; returns delta
    in p's dtype."""
    lr, wd = (torch.tensor(float(x), dtype=torch.float32, device=p.device) for x in (lr, wd))
    p32, g32 = p.float(), g.float()
    update = sign_keep_nan(m * b1 + (1 - b1) * g32)
    delta = -lr * wd * p32 - lr * update
    m.mul_(b2).add_((1 - b2) * g32)
    return delta.to(p.dtype)


def scheduled_weight_decay(wd_sched: np.ndarray, count: int) -> float:
    """The weight decay of update ``count``: ``wd_sched[min(count, len - 1)]``
    rounded to float32, as the JAX DINO engine's ``wd_fn`` reads it
    (``engines/dino_engine.py:183-186``)."""
    return float(np.float32(wd_sched[min(int(count), len(wd_sched) - 1)]))


def set_step_hyperparameters(optimizer: torch.optim.Optimizer, lr: float,
                             weight_decay: float) -> None:
    """Every group's learning rate and (but for SGD, which has none) weight
    decay for the next ``optimizer.step()``."""
    for group in optimizer.param_groups:
        group["lr"] = lr
        if not isinstance(optimizer, torch.optim.SGD):
            group["weight_decay"] = weight_decay


def _trainable(params) -> list:
    """The trainable parameters, or the groups with their trainable ones."""
    params = list(params)
    if params and isinstance(params[0], dict):
        return [{**g, "params": [p for p in g["params"] if p.requires_grad]} for g in params]
    return [p for p in params if p.requires_grad]


def get_optimizer(config, params: Iterable, split: Sequence = (),
                  stacked: Tuple = (None, [])) -> torch.optim.Optimizer:
    """The optimizer of ``config.TRAIN.OPTIMIZER`` (SGD, AdamW, Lamb, Lion)
    over the trainable ``params`` (parameters or parameter groups); the
    learning rate, and a scheduled weight decay, are set before each step.
    ``split`` is Lamb's (group, parameters split over it) list and
    ``stacked`` its ``pipe`` stage's stacked groups. The
    gradient clip is the caller's (``clip_by_per_param_norm``)."""
    t = config.TRAIN
    name = t.OPTIMIZER
    trainable = _trainable(params)
    wd = float(t.WEIGHT_DECAY)
    if name == "SGD":  # the reference's SGD has its weight decay commented out
        return torch.optim.SGD(trainable, lr=0.0, momentum=float(t.MOMENTUM), dampening=0.0,
                               nesterov=False, weight_decay=0.0)
    if name == "AdamW":
        return torch.optim.AdamW(trainable, lr=0.0, betas=(t.BETA1, t.BETA2), eps=1e-8,
                                 weight_decay=wd)
    if name == "Lamb":
        lamb = Lamb(trainable, betas=(t.BETA1, t.BETA2), weight_decay=wd)
        lamb.split, lamb.stacked = list(split), stacked
        return lamb
    if name == "Lion":
        return Lion(trainable, betas=(t.BETA1, t.BETA2), weight_decay=wd,
                    fused=bool(t.LION_FUSED))
    raise NotImplementedError(f"Unknown optimizer: {name}")
