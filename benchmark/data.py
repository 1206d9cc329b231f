"""The cells' inputs: wire batches and the per-step random decisions.

* ``ring`` makes ``traffic["ring"]`` distinct host batches of hu16 wire
  volumes ([batch, 1, R, R, R] int16, HU x 10 over the wire's clamp
  -800..2000 HU) with numpy from (seed, rank); every row of the ring differs.
* ``draws`` gives update ``step`` its decisions from a generator seeded from
  (seed, step): the global batch's (every rank draws the same) and then
  this rank's rows. MAE: the masking noise [n, L] and the flips along each
  axis (p 0.1), the intensity shift U(-0.1, 0.1) with p 0.5. DINO: per crop
  an integer box (global: side U{112..224} anywhere on the 224^3 canvas the
  volume sits centred in; local: U{64..112} inside the centre 192^3), the
  global crops' flips (p 0.2) and shift (U(-0.2, 0.2), p 0.5), the first's
  blur (sigma U(0.5, 1.0) per axis, p 0.2), the second's contrast (gamma
  U(0.2, 1.0), p 0.2). These are the recipe's transforms
  (src/data/transforms.py of the published code).
* ``TimedRing`` feeds an epoch loop from the ring (see its docstring).
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

import numpy as np
import torch

from benchmark.weights import generator

HU16_LO, HU16_HI = -8000, 20000  # the wire's clamp, -800..2000 HU at 10 per HU
CANVAS, LOCAL_CANVAS = 224, 192


def ring(batch: int, size: int, count: int, seed: int, rank: int) -> List[np.ndarray]:
    rng = np.random.default_rng([int(seed) % (1 << 64), rank, 0xDA7A])
    return [rng.integers(HU16_LO, HU16_HI + 1, size=(batch, 1, size, size, size), dtype=np.int16)
            for _ in range(count)]


def _u(g: torch.Generator, device, shape) -> torch.Tensor:
    return torch.rand(shape, generator=g, device=device)


def _box(g, device, n: int, lo_size: int, hi_size: int, lo: int, hi: int, offset: int):
    size = torch.randint(lo_size, hi_size + 1, (n, 3), generator=g, device=device).float()
    start = lo + torch.floor(_u(g, device, (n, 3)) * ((hi - lo) - size + 1.0))
    return start - offset, size


def mae_draws(g, device, n: int, patches: int) -> dict:
    return {"noise": _u(g, device, (n, patches)),
            "augment": {"flip": _u(g, device, (3, n)) < 0.1,
                        "shift": (_u(g, device, (n,)) * 2.0 - 1.0) * 0.1,
                        "shift_on": _u(g, device, (n,)) < 0.5}}


def dino_draws(g, device, n: int, size: int, global_size: int, local_size: int,
               local_crops: int) -> List[dict]:
    offset = (CANVAS - size) // 2
    crops = []
    for gi in range(2):
        start, box = _box(g, device, n, global_size, CANVAS, 0, CANVAS, offset)
        d = {"start": start, "size": box, "flip": _u(g, device, (n, 3)) < 0.2,
             "shift": -0.2 + _u(g, device, (n,)) * 0.4, "shift_on": _u(g, device, (n,)) < 0.5}
        if gi == 0:
            d.update(sigma=0.5 + _u(g, device, (n, 3)) * 0.5, smooth_on=_u(g, device, (n,)) < 0.2)
        else:
            d.update(gamma=0.2 + _u(g, device, (n,)) * 0.8, contrast_on=_u(g, device, (n,)) < 0.2)
        crops.append(d)
    lo = (CANVAS - LOCAL_CANVAS) // 2
    for _ in range(local_crops):
        start, box = _box(g, device, n, local_size, global_size, lo, lo + LOCAL_CANVAS, offset)
        crops.append({"start": start, "size": box})
    return crops


def draws(engine: str, cfg: dict, seed: int, step: int, batch: int, world: int, rank: int,
          device) -> object:
    """Update ``step``'s decisions for this rank's ``batch`` rows."""
    g = generator(device, seed, step, 0xD4A3)
    n = batch * world
    lo, hi = rank * batch, (rank + 1) * batch
    if engine == "mae":
        m = cfg["MAE"]
        d = mae_draws(g, device, n, (int(m["INPUT_SIZE"]) // int(m["PATCH_SIZE"])) ** 3)
        return {"noise": d["noise"][lo:hi],
                "augment": {k: v[..., lo:hi] for k, v in d["augment"].items()}}
    dn = cfg["DINO"]
    crops = dino_draws(g, device, n, int(cfg["VIT"]["INPUT_SIZE"]),
                       int(dn["GLOBAL_CROP_SIZE"][0]), int(dn["LOCAL_CROP_SIZE"][0]),
                       int(dn["LOCAL_CROP_NUM"]))
    return [{k: v[lo:hi] for k, v in c.items()} for c in crops]


class TimedRing:
    """An epoch's loader over the ring: batch ``first + i`` is
    ``ring[(first + i) % len(ring)]``. It yields ``count`` batches, or with
    ``count`` None until ``seconds`` have passed since ``start()`` and then
    ``extra`` more (the traced stretch); ``timed`` is then the number it
    yielded before the time was up. ``agree(flag)`` makes every rank take
    the same decision (the harness passes a collective over the ranks)."""

    def __init__(self, batches: List[np.ndarray], first: int = 0, count: Optional[int] = None,
                 seconds: float = 0.0, extra: int = 0,
                 agree: Optional[Callable[[bool], bool]] = None):
        self.batches, self.first, self.count = batches, first, count
        self.seconds, self.extra, self.agree = seconds, extra, agree
        self.timed: Optional[int] = None
        self.t0 = time.perf_counter()

    def start(self) -> None:
        self.t0 = time.perf_counter()

    def __iter__(self):
        i = 0
        while True:
            if self.count is not None:
                if i >= self.count:
                    return
            elif self.timed is None:
                up = time.perf_counter() - self.t0 >= self.seconds
                if self.agree is not None:
                    up = self.agree(up)
                if up:
                    self.timed = i
            if self.timed is not None and i >= self.timed + self.extra:
                return
            yield self.batches[(self.first + i) % len(self.batches)]
            i += 1
