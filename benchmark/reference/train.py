"""Follow a cell's first training steps with the plain reference.

``follow`` starts from the seed's weights (``benchmark/weights.py``), takes
the same wire batches and draws as the measured run, computes each step in
blocks of rows (the loss is a mean over rows, so each block's gradient is
weighted by its share) and returns the readings that ``benchmark/compare.py``
holds the measured run to: each step's loss, each parameter's first
gradient (after the average over ranks) and each parameter's change
after the last step (for DINO also the teacher's, ``teacher.<name>``, and
the centre's), as tensors. ``all_reduce`` averages gradients over ranks in place where a
cell runs on several cards. ``fault`` plants one of the faults the check has
to see: ``"unchanged"`` (no update), ``"half"`` (half of each batch, the
mean taken over it), ``"no_exchange"`` (no average over ranks) and
``"altered"`` (one parameter's gradient doubled where it is made).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from benchmark.reference import common, dino, mae

FAULTS = ("unchanged", "half", "no_exchange", "altered")


def _rows(draw, lo: int, hi: int):
    """Rows [lo, hi) of a step's draws (batch on the last axis of MAE's
    augmentation, first elsewhere)."""
    if isinstance(draw, dict):
        aug = draw["augment"]
        return {"noise": draw["noise"][lo:hi],
                "augment": {k: v[..., lo:hi] for k, v in aug.items()}}
    return [{k: v[lo:hi] for k, v in crop.items()} for crop in draw]


def altered_leaf(names: Sequence[str]) -> str:
    """The parameter the ``altered`` fault doubles: the first MLP weight."""
    return next(n for n in names if n.endswith("mlp.linear1.weight"))


def follow(engine: str, cfg: dict, weights: Dict[str, torch.Tensor],
           batches: Sequence[torch.Tensor], draws: Sequence, start_step: int, epoch: int,
           niter_per_ep: int, rows_per_block: int, precision: str = "float32",
           all_reduce: Optional[Callable[[List[torch.Tensor]], None]] = None,
           fault: Optional[str] = None) -> Dict[str, object]:
    """Readings of ``len(batches)`` reference steps (see the module)."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _follow(engine, cfg, weights, batches, draws, start_step, epoch, niter_per_ep,
                       rows_per_block, precision, all_reduce, fault)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _follow(engine, cfg, weights, batches, draws, start_step, epoch, niter_per_ep,
            rows_per_block, precision, all_reduce, fault):
    model = mae if engine == "mae" else dino
    device = next(iter(weights.values())).device
    names = list(weights)
    P = {n: weights[n].detach().clone().requires_grad_(True) for n in names}
    P.update(model.frozen(cfg, device))
    T = center = sched = None
    if engine == "dino":
        T = {n: weights[n].detach().clone() for n in names}
        T.update(model.frozen(cfg, device))
        center = torch.zeros((1, model.dims(cfg)["prototypes"]), device=device)
        sched = model.schedules(cfg, niter_per_ep)
    betas = (float(cfg["TRAIN"]["BETA1"]), float(cfg["TRAIN"]["BETA2"]))
    opt_state: List[dict] = [{} for _ in names]
    losses: List[float] = []
    first_grads: Dict[str, torch.Tensor] = {}
    for i, (wire, draw) in enumerate(zip(batches, draws)):
        use = wire.shape[0] // 2 if fault == "half" else wire.shape[0]
        loss = torch.zeros((), device=device)
        t_sum = None
        for lo in range(0, use, rows_per_block):
            hi = min(lo + rows_per_block, use)
            share = (hi - lo) / use
            if engine == "mae":
                part = model.loss(P, wire[lo:hi], _rows(draw, lo, hi), cfg, precision)
            else:
                temp = float(sched["temp"][min(epoch, len(sched["temp"]) - 1)])
                part, t_part = model.forward(P, T, wire[lo:hi], _rows(draw, lo, hi), center,
                                             temp, cfg, precision)
                t_sum = t_part if t_sum is None else t_sum + t_part
            (part * share).backward()
            loss += part.detach() * share
        grads = [P[n].grad for n in names]
        extra = [loss] if t_sum is None else [loss, t_sum / (2 * use)]
        if all_reduce is not None and fault != "no_exchange":
            all_reduce(grads + extra)
        if fault == "altered":
            grads[names.index(altered_leaf(names))].mul_(2.0)
        if i == 0:
            first_grads = {n: g.detach().clone() for n, g in zip(names, grads)}
        losses.append(float(extra[0]))
        step = start_step + i
        lr, wd = model.hyper(cfg, step, niter_per_ep)
        if fault != "unchanged":
            common.adamw_([P[n] for n in names], grads, opt_state, i + 1, lr, wd, betas)
            if engine == "dino":
                m = np.float32(sched["momentum"][min(i, len(sched["momentum"]) - 1)])
                with torch.no_grad():
                    for n in names:
                        T[n].mul_(float(m)).add_(P[n], alpha=float(np.float32(1.0) - m))
                center = center * dino.CENTER_MOMENTUM + extra[1][None] * (1 - dino.CENTER_MOMENTUM)
        for n in names:
            P[n].grad = None
    change = {n: P[n].detach() - weights[n] for n in names}
    if engine == "dino":
        change.update({f"teacher.{n}": T[n] - weights[n] for n in names})
        change["center"] = center
    return {"losses": losses, "grads": first_grads, "change": change}
