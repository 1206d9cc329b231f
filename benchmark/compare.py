"""The comparison that decides ``correct``.

Three numbers, each held to its cell's limit (``benchmark/limits/<cell>.json``):

* ``loss_gap``: the largest |loss - reference loss| / |reference loss| over
  the compared steps;
* ``grad_gap``: over parameters, the largest gap between the norm of the
  first update's gradient as the optimizer got it and the reference's
  norm, against the larger of that parameter's reference norm and the
  median parameter's;
* ``update_gap``: the same of each parameter's change over the compared
  steps (for DINO also the teacher's and the centre's).

Elements whose reference gradient is below a thousandth of the median
parameter's root-mean-square gradient (a key's bias under softmax) move
under Adam by round-off alone; ``nought_masks`` leaves them out of both
sides' change, by that rule on the reference's first gradient, never by
name. The gradient norms are taken whole.
"""

from __future__ import annotations

import statistics
from typing import Dict

import torch

NOUGHT = 1e-3  # of the median parameter's root-mean-square gradient


def _owner(leaf: str) -> str:
    return leaf[len("teacher."):] if leaf.startswith("teacher.") else leaf


def nought_masks(ref_grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Per parameter, the elements kept (True): |reference gradient| at
    least ``NOUGHT`` x the median parameter's root-mean-square gradient."""
    rms = [float(g.double().square().mean().sqrt()) for g in ref_grads.values()]
    floor = NOUGHT * statistics.median(rms)
    return {n: g.abs() >= floor for n, g in ref_grads.items()}


def change_norms(change: Dict[str, torch.Tensor], masks: Dict[str, torch.Tensor]
                 ) -> Dict[str, float]:
    """Each change's norm over the kept elements of its parameter (a
    teacher's by its student's; the centre whole)."""
    out = {}
    for k, v in change.items():
        m = masks.get(_owner(k))
        v = v.to(m.device)[m] if m is not None else v
        out[k] = float(v.double().norm())
    return out


def grad_norms(grads: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in grads.items()}


def readings(raw: dict, masks: Dict[str, torch.Tensor]) -> dict:
    """The numbers of a reference run (``reference/train.py follow``):
    losses, first-gradient and change norms (elements left out by
    ``masks``)."""
    return {"losses": raw["losses"], "grad_norms": grad_norms(raw["grads"]),
            "change_norms": change_norms(raw["change"], masks)}


def norm_gap(prog: Dict[str, float], ref: Dict[str, float]) -> float:
    keys = [k for k in ref if ref[k] > 0]
    missing = [k for k in keys if k not in prog]
    if missing:
        raise KeyError(f"the measured run has no reading of {missing[:4]}")
    med = statistics.median(ref[k] for k in keys)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys)


def worst(prog: Dict[str, float], ref: Dict[str, float]) -> str:
    keys = [k for k in ref if ref[k] > 0]
    med = statistics.median(ref[k] for k in keys)
    return max(keys, key=lambda k: abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med))


def gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """The compared numbers of two sets of readings (``ref`` the reference's)."""
    losses = list(zip(prog["losses"], ref["losses"]))
    return {"loss_gap": max(abs(p - r) / max(abs(r), 1e-30) for p, r in losses),
            "grad_gap": norm_gap(prog["grad_norms"], ref["grad_norms"]),
            "update_gap": norm_gap(prog["change_norms"], ref["change_norms"])}


def verdict(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every compared number within its limit (a NaN fails)."""
    return all(values[k] <= limits[k] for k in limits)
