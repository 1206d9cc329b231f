"""The downstream fine-tune and probe step's rate on the card: the port's
counterpart of the JAX repository's ``tools/bench_downstream.py``.

    python -m headct_foundation_tpu_torch.tools.bench_downstream [--batch 64] [--lock]
        [--classifier linear|attentive] [--device cpu]

The whole step of ``downstream_engine.make_train_step`` (the downstream
CLI's: ``vit_augment`` on the card, the ViT-B backbone, the classifier, the
float32 cross-entropy and the two AdamW updates) on
``configs/downstream/vit_HeadCT_rsna.yaml`` at ``--batch`` volumes: the
full fine-tune, or under ``--lock`` the linear probe (the backbone without
gradients). Seed-0 weights, a random batch in the config's wire format and
random labels. ``STEPS`` steps are queued with no host sync and the last
loss read; the best of ``RUNS`` gives volumes/s. Prints one JSON line
with the card's name and power limit and the kernels' launches over the
timed steps. Runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from headct_foundation_tpu_torch.bench import config_at, step_bench, wire_batch
from headct_foundation_tpu_torch.engines import downstream_engine
from headct_foundation_tpu_torch.feature_extraction import resolve_device

CONFIG = "configs/downstream/vit_HeadCT_rsna.yaml"
STEPS = 8
RUNS = 3


def run(batch: int = 64, lock: bool = False, classifier: str = "linear", steps: int = STEPS,
        runs: int = RUNS, device=None, overrides: Sequence = ()) -> Dict[str, Any]:
    device = resolve_device(device)
    cfg = config_at(CONFIG, ["TRAIN.LOCK", bool(lock), "TRAIN.CLASSIFIER", classifier,
                             *overrides])
    state = downstream_engine.create_train_state(cfg, 1000, 10, seed=0, device=device)
    step = downstream_engine.make_train_step(cfg)
    wire = torch.from_numpy(wire_batch(cfg, batch)).to(device)
    target = torch.from_numpy(np.random.RandomState(1).randint(
        0, int(cfg.DATA.NUM_CLASSES), size=batch).astype(np.int64)).to(device)
    return step_bench("volumes/sec/GPU (downstream train step)",
                      lambda s: step(s, wire, target, 0), state, batch, steps, runs, device,
                      lock=bool(lock), classifier=classifier)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lock", action="store_true", help="linear-probe mode")
    ap.add_argument("--classifier", default="linear", choices=["linear", "attentive"])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    result = run(args.batch, args.lock, args.classifier, device=args.device)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
