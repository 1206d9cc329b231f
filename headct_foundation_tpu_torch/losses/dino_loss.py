"""DINO loss: a centred and sharpened teacher against the student's crops.

Port of the JAX package's ``losses/dino_loss.py:22-92`` (reference:
src/losses/losses.py:46-102):

* ``teacher_temp_schedule``: the teacher temperature per epoch, a linear
  warm-up then constant;
* ``dino_loss``: in float32, the teacher's softmax((t - center) / temp) over
  its 2 global crops against the student's log-softmax(s / 0.1) over all
  crops, same-view pairs skipped, the mean over the remaining pairs;
* ``update_center``: the centre's EMA (momentum 0.9) towards the batch mean
  of the teacher's output. Under data parallelism the engine averages that
  mean across the ranks first, where the JAX package's sharded mean is
  already global.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch


def teacher_temp_schedule(warmup_teacher_temp: float, teacher_temp: float,
                          warmup_teacher_temp_epochs: int, nepochs: int) -> np.ndarray:
    return np.concatenate([
        np.linspace(warmup_teacher_temp, teacher_temp, warmup_teacher_temp_epochs),
        np.ones(max(nepochs - warmup_teacher_temp_epochs, 0)) * teacher_temp,
    ])


def dino_loss(student_output: torch.Tensor, teacher_output: torch.Tensor,
              center: torch.Tensor, temp: Union[float, torch.Tensor], ncrops: int,
              student_temp: float = 0.1) -> torch.Tensor:
    """student_output [ncrops * B, K], teacher_output [2 * B, K], center
    [1, K], temp the epoch's teacher temperature -> scalar float32 loss."""
    temp = torch.as_tensor(temp, dtype=torch.float32, device=center.device)
    student_chunks = (student_output.float() / student_temp).chunk(ncrops)
    teacher_probs = torch.softmax((teacher_output.float() - center) / temp, dim=-1)
    teacher_chunks = teacher_probs.detach().chunk(2)
    total, n_terms = 0.0, 0
    for iq, q in enumerate(teacher_chunks):
        for v in range(ncrops):
            if v == iq:
                continue  # the same view (reference: losses.py:80-82)
            logp = torch.log_softmax(student_chunks[v], dim=-1)
            total = total + torch.sum(-q * logp, dim=-1).mean()
            n_terms += 1
    return total / n_terms


@torch.no_grad()
def update_center(center: torch.Tensor, teacher_output: torch.Tensor,
                  center_momentum: float = 0.9) -> torch.Tensor:
    """center * m + mean(teacher_output) * (1 - m), in float32."""
    batch_center = teacher_output.detach().float().mean(dim=0, keepdim=True)
    return center * center_momentum + batch_center * (1.0 - center_momentum)
