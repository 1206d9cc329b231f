"""Optimizer factory.

Port of the JAX package's ``optim/optimizers.py:215-287`` for AdamW. The JAX
chain is ``scale_by_adam(b1, b2, eps=1e-8)``, then ``+ wd * p``, then
``* (-lr)``, applied to every trainable leaf (biases and norms included;
frozen leaves get no update). That is ``torch.optim.AdamW`` over every
parameter with ``requires_grad``, in one group with no decay exclusions:
torch's ``p * (1 - lr wd) - lr m_hat / (sqrt(v_hat) + eps)`` is the same
update. The learning rate is set by the caller before each
``optimizer.step()`` from the update count (``engines/mae_engine.py``), so
the first update uses ``lr(0)``, as optax does.

SGD, Lamb and Lion, and the per-parameter gradient clip, are not ported yet
(ROADMAP A.12); they raise.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch


def get_optimizer(
    config, params: Iterable[torch.nn.Parameter], grad_clip: Optional[float] = None,
) -> torch.optim.Optimizer:
    """AdamW over the trainable ``params``, per ``config.TRAIN``."""
    name = config.TRAIN.OPTIMIZER
    if grad_clip:
        raise NotImplementedError(
            f"TRAIN.GRAD_CLIP={grad_clip}: clip_by_per_param_norm is not ported yet "
            "(ROADMAP A.12); set TRAIN.GRAD_CLIP 0")
    if name != "AdamW":
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet (ROADMAP A.12); the port has AdamW")
    trainable = [p for p in params if p.requires_grad]
    return torch.optim.AdamW(trainable, lr=0.0, betas=(config.TRAIN.BETA1, config.TRAIN.BETA2),
                             eps=1e-8, weight_decay=float(config.TRAIN.WEIGHT_DECAY))
