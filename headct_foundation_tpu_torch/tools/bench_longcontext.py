"""The 192^3 / 4096-token MAE step's rate on the card: the port's
counterpart of the JAX repository's ``tools/bench_longcontext.py``.

    python -m headct_foundation_tpu_torch.tools.bench_longcontext [--batch 2] [--device cpu]

``configs/mae/mae_HeadCT_192.yaml`` (192^3, patch 12: the encoder at
T = 1025, the decoder at T = 4097), whose attention runs on the blocked
kernels B3 (forward), B4 (dK, dV) and B5 (dQ) in every block, both ways.
The step is the JAX tool's: the loss of a random bfloat16 batch under seeded
mask noise, its backward and the optimizer update
(``bench.model_step``). ``STEPS`` steps are queued with no host sync and
the last loss read; the best of ``RUNS`` gives volumes/s. Prints one JSON
line with the card's name and power limit and the kernels' launches over
the timed steps. Runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from headct_foundation_tpu_torch.bench import config_at, model_step, step_bench
from headct_foundation_tpu_torch.engines import mae_engine
from headct_foundation_tpu_torch.feature_extraction import resolve_device

CONFIG = "configs/mae/mae_HeadCT_192.yaml"
STEPS = 4
RUNS = 2


def run(batch: int = 2, steps: int = STEPS, runs: int = RUNS, device=None,
        overrides: Sequence = ()) -> Dict[str, Any]:
    device = resolve_device(device)
    cfg = config_at(CONFIG, overrides)
    state = mae_engine.create_train_state(cfg, 100, 0, seed=0, device=device)[0]
    roi = tuple(int(r) for r in cfg.MODEL.ROI)
    vols = mae_engine.to_device_batch(np.random.RandomState(0).randn(
        batch, int(cfg.MAE.IN_CHANS), *roi).astype(np.float32), device)
    return step_bench("volumes/sec/GPU (MAE 192^3 / 4096-token step, blocked attention)",
                      lambda s: model_step(s, vols, 0), state, batch, steps, runs, device)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    result = run(args.batch, device=args.device)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
