"""The cells' weights, made from the seed on the device in a few large draws.

``make(spec, seed, device)`` returns every trainable parameter of a
reference ``spec`` (name, shape, init) as float32: one uniform draw for all
xavier-uniform weights (each scaled to its bound sqrt(6 / (fan_in +
fan_out))), one normal draw (std 0.02, clipped at 2 std) for the tokens,
patch kernels, biases and head weights, ones and zeros for the norms. The
frozen position embeddings and weight-norm gains are left out: each side
builds its own. The same seed and device give the same weights, which both
the measured run and the reference take.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List

import numpy as np
import torch

FROZEN = ("sincos", "frozen_ones")


def generator(device, *keys: int) -> torch.Generator:
    """A generator on ``device`` seeded from the whole numbers ``keys``."""
    hi, lo = np.random.SeedSequence([int(k) % (1 << 64) for k in keys]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed((int(hi) << 32) | int(lo))


def trainable(spec: Iterable[tuple]) -> List[tuple]:
    return [s for s in spec if s[2] not in FROZEN]


def make(spec: Iterable[tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    spec = trainable(spec)
    device = torch.device(device)
    gen = generator(device, seed, 0x5EED)
    out: Dict[str, torch.Tensor] = {}
    for kind in ("xavier", "normal"):
        leaves = [s for s in spec if s[2] == kind]
        sizes = [math.prod(s[1]) for s in leaves]
        flat = torch.empty(sum(sizes), device=device)
        if kind == "xavier":
            flat.uniform_(-1.0, 1.0, generator=gen)
        else:
            flat.normal_(0.0, 0.02, generator=gen).clamp_(-0.04, 0.04)
        for (name, shape, _), part in zip(leaves, flat.split(sizes)):
            if kind == "xavier":
                part.mul_(math.sqrt(6.0 / (shape[0] + shape[1])))
            out[name] = part.view(shape)
    for name, shape, kind in spec:
        if kind in ("ones", "zeros"):
            out[name] = (torch.ones if kind == "ones" else torch.zeros)(shape, device=device)
        elif kind not in ("xavier", "normal"):
            raise ValueError(f"unknown init {kind!r} of {name}")
    return {name: out[name] for name, _, _ in spec}
