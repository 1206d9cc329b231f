"""Step-wise learning-rate schedules as plain ``step -> lr`` functions.

Port of the JAX package's ``optim/lr_sched.py:19-90`` (reference:
src/utils/lr_sched.py:18-140): cosine with linear warm-up down to an
``lr_end`` floor, polynomial decay, and constant with warm-up. The step is
the optimizer's update count before the update, as optax evaluates it: the
first update uses ``lr(0)``, which is 0 under a warm-up.
"""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def cosine_schedule_with_warmup(
    base_lr: float, num_warmup_steps: int, num_training_steps: int,
    lr_end: float = 1e-6, num_cycles: float = 0.5,
) -> Schedule:
    if not base_lr > lr_end:
        raise ValueError(f"lr_end ({lr_end}) must be smaller than initial lr ({base_lr})")

    def schedule(step: int) -> float:
        if step < num_warmup_steps:
            return step / max(1.0, num_warmup_steps) * base_lr
        progress = (step - num_warmup_steps) / max(1.0, num_training_steps - num_warmup_steps)
        cosine = lr_end + (base_lr - lr_end) * 0.5 * (
            1.0 + math.cos(math.pi * num_cycles * 2.0 * progress))
        return max(0.0, cosine)

    return schedule


def polynomial_schedule_with_warmup(
    base_lr: float, num_warmup_steps: int, num_training_steps: int,
    lr_end: float = 1e-7, power: float = 1.0,
) -> Schedule:
    if not base_lr > lr_end:
        raise ValueError(f"lr_end ({lr_end}) must be smaller than initial lr ({base_lr})")

    def schedule(step: int) -> float:
        if step < num_warmup_steps:
            return step / max(1.0, num_warmup_steps) * base_lr
        if step > num_training_steps:
            return lr_end
        decay_steps = max(1.0, num_training_steps - num_warmup_steps)
        pct_remaining = 1.0 - (step - num_warmup_steps) / decay_steps
        return (base_lr - lr_end) * pct_remaining ** power + lr_end

    return schedule


def constant_schedule_with_warmup(base_lr: float, num_warmup_steps: int) -> Schedule:
    def schedule(step: int) -> float:
        if step < num_warmup_steps:
            return step / max(1.0, num_warmup_steps) * base_lr
        return base_lr

    return schedule


def get_lr_schedule(config, base_lr: float, num_warmup_steps: int, total_steps: int,
                    min_lr: float) -> Schedule:
    """Resolve TRAIN.SCHEDULER (reference: src/utils/lr_sched.py:127-140)."""
    name = config.TRAIN.SCHEDULER
    if name == "cosine":
        return cosine_schedule_with_warmup(base_lr, num_warmup_steps, total_steps, lr_end=min_lr)
    if name == "poly":
        return polynomial_schedule_with_warmup(
            base_lr, num_warmup_steps, total_steps, lr_end=min_lr, power=2.0)
    if name == "constant":
        return constant_schedule_with_warmup(base_lr, num_warmup_steps)
    raise ValueError(f"Scheduler {name} not supported")
