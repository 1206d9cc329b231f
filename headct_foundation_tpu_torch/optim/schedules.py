"""Array-valued cosine schedules for the weight decay and the teacher momentum.

Port of the JAX package's ``optim/schedules.py:14-53`` (reference:
src/utils/misc.py:414-425 ``cosine_scheduler``, src/utils/wd_sched.py:3-23):
a linear warm-up, then a half cosine from the base value to the final one,
one value per global iteration, in numpy float64.
"""

from __future__ import annotations

import numpy as np


def cosine_scheduler(
    base_value: float,
    final_value: float,
    epochs: int,
    niter_per_ep: int,
    warmup_epochs: int = 0,
    start_warmup_value: float = 0.0,
) -> np.ndarray:
    warmup_iters = warmup_epochs * niter_per_ep
    warmup_schedule = np.array([])
    if warmup_epochs > 0:
        warmup_schedule = np.linspace(start_warmup_value, base_value, warmup_iters)
    iters = np.arange(epochs * niter_per_ep - warmup_iters)
    schedule = final_value + 0.5 * (base_value - final_value) * (
        1 + np.cos(np.pi * iters / len(iters)))
    schedule = np.concatenate((warmup_schedule, schedule))
    if len(schedule) != epochs * niter_per_ep:
        raise ValueError(f"schedule of {len(schedule)} values for {epochs} x {niter_per_ep}")
    return schedule


def get_wd_schedule(config, niter_per_ep: int) -> np.ndarray:
    """Weight decay per iteration, TRAIN.WEIGHT_DECAY -> WEIGHT_DECAY_END."""
    return cosine_scheduler(config.TRAIN.WEIGHT_DECAY, config.TRAIN.WEIGHT_DECAY_END,
                            config.TRAIN.MAX_EPOCHS, niter_per_ep)


def get_momentum_schedule(config, niter_per_ep: int) -> np.ndarray:
    """Teacher EMA momentum per iteration, DINO.MOMENTUM_TEACHER -> _END."""
    return cosine_scheduler(config.DINO.MOMENTUM_TEACHER, config.DINO.MOMENTUM_TEACHER_END,
                            config.TRAIN.MAX_EPOCHS, niter_per_ep)
