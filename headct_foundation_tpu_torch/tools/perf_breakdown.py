"""Where the MAE step's milliseconds go: the port's counterpart of the JAX
repository's ``tools/perf_breakdown.py``.

    python -m headct_foundation_tpu_torch.tools.perf_breakdown [--batch 32] [--remat]
        [--full-only] [--attn pallas|xla] [--device cpu]

Times variants of the flagship MAE step (``configs/mae/mae_HeadCT.yaml``,
ViT-B/12, 96^3, patch 12, a random bfloat16 batch, seed-0 weights,
``TRAIN.GRAD_CLIP`` 0, ``PARALLEL.REMAT`` under ``--remat``):

  full             forward + backward + optimizer update (``bench.model_step``)
  fwd_bwd          forward + backward, the gradients folded back at 1e-30
  fwd              the loss alone, fed into the next step's batch at 1e-30
  encoder_fwd_bwd  the mean of ``forward_encoder``'s latent squared, + backward
  optimizer        the optimizer update alone, on constant 1e-8 gradients

Each variant queues ``STEPS`` iterations that depend on each other, with
no host sync, and reads its last value; the best of ``RUNS`` gives the time
per step. ``derived_ms`` are the JAX tool's differences. ``--attn`` sets the
attention backend (``ops/attention.py set_attention_backend``): the JAX
tool's ``pallas`` is the port's ``kernel``, ``xla`` its ``plain``.
Prints one JSON line with the card's name and power limit and each
variant's kernel launches over its timed steps. Runs on ``cuda`` unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from headct_foundation_tpu_torch.bench import (
    best_of,
    device_info,
    flagship_config,
    model_step,
)
from headct_foundation_tpu_torch.engines import mae_engine
from headct_foundation_tpu_torch.feature_extraction import resolve_device
from headct_foundation_tpu_torch.ops.attention import set_attention_backend

STEPS = 10
RUNS = 3
ATTN = {"pallas": "kernel", "xla": "plain"}
VARIANTS = ("full", "fwd_bwd", "fwd", "encoder_fwd_bwd", "optimizer")


def fwd_loss(model, batch: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """The MAE loss of ``batch`` under mask ``noise``."""
    return model(batch, noise=noise)[0]


def encoder_loss(model, batch: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """mean(latent ** 2) in float32 of the encoder's output under ``noise``."""
    latent, _, _ = model.forward_encoder(batch, noise=noise)
    return (latent.float() ** 2).mean()


class Variants:
    """The variants on one train state and batch. ``variant(k)`` returns a
    ``run()`` that queues k iterations and returns the last value as a
    device scalar. ``noise_of(i)`` is iteration i's mask noise (default:
    drawn from a generator seeded from (seed, i, 0), as the train step
    draws update i's)."""

    def __init__(self, state, batch: torch.Tensor, seed: int = 0,
                 noise_of: Optional[Callable[[int], torch.Tensor]] = None):
        self.state, self.batch, self.seed = state, batch, seed
        model = state.model
        model.train()
        n_tok = int(np.prod(model.grid_size))
        self.noise_of = noise_of or (lambda i: torch.rand(
            (batch.shape[0], n_tok), generator=mae_engine.step_generator(batch.device, seed, i, 0),
            device=batch.device))
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.i = 0

    def full(self, k: int) -> Callable[[], torch.Tensor]:
        def run():
            for _ in range(k):
                self.state, m = model_step(self.state, self.batch, self.seed,
                                           self.noise_of(self.state.step))
            return m["loss"]
        return run

    def _fold_back(self, loss_fn, k: int) -> Callable[[], torch.Tensor]:
        """k forwards and backwards of ``loss_fn``; each update's gradients
        are added to the parameters at 1e-30, a dependency that changes no
        value."""
        def run():
            for _ in range(k):
                loss = loss_fn(self.state.model, self.batch, self.noise_of(self.i))
                loss.backward()
                with torch.no_grad():
                    held = [p for p in self.params if p.grad is not None]
                    torch._foreach_add_(held, [p.grad for p in held], alpha=1e-30)
                for p in held:
                    p.grad = None
                self.i += 1
            return loss.detach()
        return run

    def fwd_bwd(self, k: int) -> Callable[[], torch.Tensor]:
        return self._fold_back(fwd_loss, k)

    def encoder_fwd_bwd(self, k: int) -> Callable[[], torch.Tensor]:
        return self._fold_back(encoder_loss, k)

    def fwd(self, k: int) -> Callable[[], torch.Tensor]:
        def run():
            prev = torch.zeros((), device=self.batch.device)
            with torch.no_grad():
                for _ in range(k):
                    prev = fwd_loss(self.state.model,
                                    self.batch + (prev * 1e-30).to(self.batch.dtype),
                                    self.noise_of(self.i))
                    self.i += 1
            return prev
        return run

    def optimizer(self, k: int) -> Callable[[], torch.Tensor]:
        grads = [torch.full_like(p, 1e-8) for p in self.params]

        def run():
            for _ in range(k):
                for p, g in zip(self.params, grads):
                    p.grad = g
                self.state = mae_engine.apply_update(self.state)
            return self.params[0].detach().flatten()[0]
        return run


def run(batch: int = 32, remat: bool = False, full_only: bool = False,
        attn: Optional[str] = None, steps: int = STEPS, runs: int = RUNS, device=None,
        overrides: Sequence = ()) -> Dict[str, Any]:
    device = resolve_device(device)
    prev = set_attention_backend(ATTN[attn]) if attn else None
    try:
        cfg = flagship_config(["PARALLEL.REMAT", bool(remat), *overrides])
        state = mae_engine.create_train_state(cfg, 10_000, 100, seed=0, device=device)[0]
        roi = tuple(int(r) for r in cfg.MODEL.ROI)
        vols = mae_engine.to_device_batch(np.random.RandomState(0).randn(
            batch, int(cfg.MAE.IN_CHANS), *roi).astype(np.float32), device)
        variants = Variants(state, vols)
        got = {}
        for name in VARIANTS[:1] if full_only else VARIANTS:
            got[name] = best_of(getattr(variants, name)(steps), runs, device)
    finally:
        if attn:
            set_attention_backend(prev)
    ms = {k: v["seconds"] / steps * 1e3 for k, v in got.items()}
    out = {"batch_per_gpu": batch, "remat": bool(remat), "attn": attn, "ms_per_step": ms,
           "vols_per_s_per_gpu_full": batch / ms["full"] * 1e3,
           "device": device_info(device), "steps": steps, "runs": runs,
           "launches": {k: v["launches"] for k, v in got.items()},
           "losses": {k: v["loss"] for k, v in got.items() if k != "optimizer"}}
    if not full_only:
        out["derived_ms"] = {"backward": ms["fwd_bwd"] - ms["fwd"],
                             "optimizer_overhead_in_full": ms["full"] - ms["fwd_bwd"],
                             "decoder_share_fwd_bwd": ms["fwd_bwd"] - ms["encoder_fwd_bwd"]}
    return out


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--full-only", action="store_true",
                    help="time only the full train step (batch sweeps)")
    ap.add_argument("--attn", choices=sorted(ATTN), default=None,
                    help="force the attention backend")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    result = run(args.batch, args.remat, args.full_only, args.attn, device=args.device)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
