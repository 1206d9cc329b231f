"""Elementary reconstruction losses, the JAX package's ``losses/basic.py``
(reference: src/losses/losses.py:14-43).

Defined for API parity; the CLI mains do not use them (MAE's loss lives in
the model), as in the reference.
"""

from __future__ import annotations

import torch


def l2_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(x - y)) / y.numel()


def l1_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.abs(x - y)) / y.numel()


def kl_divergence(z_mean: torch.Tensor, z_log_sigma: torch.Tensor) -> torch.Tensor:
    z_log_var = z_log_sigma * 2.0
    return 0.5 * torch.sum(torch.square(z_mean) + torch.exp(z_log_var) - z_log_var - 1.0)
