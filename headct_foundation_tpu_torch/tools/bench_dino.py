"""The DINO pretrain step's rate on the card: the port's counterpart of the
JAX repository's ``tools/bench_dino.py``.

    python -m headct_foundation_tpu_torch.tools.bench_dino [--batch 16] [--remat]
        [--device cpu]

The whole step of ``dino_engine.make_train_step`` (the DINO CLI's: the
multi-crop, the teacher and student forwards, the DINO loss, the student's
backward, AdamW and the teacher's EMA) on ``configs/dino/dino_HeadCT.yaml``
at ``--batch`` volumes, with ``PARALLEL.REMAT`` under ``--remat``; seed-0
weights, a random batch in the config's wire format, the JAX tool's
momentum 0.996, temperature 0.04 and the last layer frozen. ``STEPS``
steps are queued with no host sync and the last loss read; the best of
``RUNS`` gives volumes/s. Prints one JSON line with the card's name and
power limit and the kernels' launches over the timed steps. Runs on
``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional, Sequence

import torch

from headct_foundation_tpu_torch.bench import config_at, step_bench, wire_batch
from headct_foundation_tpu_torch.engines import dino_engine
from headct_foundation_tpu_torch.feature_extraction import resolve_device

CONFIG = "configs/dino/dino_HeadCT.yaml"
STEPS = 8
RUNS = 3
MOMENTUM, TEACHER_TEMP = 0.996, 0.04  # the JAX tool's constants


def setup(batch: int = 16, remat: bool = False, device=None, overrides: Sequence = (),
          config: str = CONFIG) -> tuple:
    """(cfg, state, step_once, device): the CLI's step on a seed-0 state and
    one random batch, ``step_once(state) -> (state, metrics)``."""
    device = resolve_device(device)
    cfg = config_at(config, ["PARALLEL.REMAT", bool(remat), *overrides])
    state = dino_engine.create_train_state(cfg, 1000, 10, 100, seed=0, device=device)
    step = dino_engine.make_train_step(cfg)
    wire = torch.from_numpy(wire_batch(cfg, batch)).to(device)
    return cfg, state, lambda s: step(s, wire, 0, MOMENTUM, TEACHER_TEMP, True), device


def run(batch: int = 16, remat: bool = False, steps: int = STEPS, runs: int = RUNS,
        device=None, overrides: Sequence = ()) -> Dict[str, Any]:
    _, state, step_once, device = setup(batch, remat, device, overrides)
    return step_bench("volumes/sec/GPU (DINO pretrain step)", step_once, state, batch, steps,
                      runs, device, remat=bool(remat))


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    result = run(args.batch, args.remat, device=args.device)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
