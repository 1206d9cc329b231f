"""Retrieval mAP of a labelled manifest, embedded by a frozen encoder.

Counterpart of the JAX package's ``tools/eval_retrieval.py`` (the
reference's images/mAP_{RSNA,CQ500}_Retrieval.png protocol; BASELINE.md):

    python -m headct_foundation_tpu_torch.tools.eval_retrieval --cfg CFG --csv MANIFEST \
        [--checkpoint CKPT] [--labels ICH IPH ...] [--batch-size 8] [--device cuda|cpu]

The manifest holds ``img_path`` and one 0/1 column per label; every column
but ``img_path`` is evaluated unless ``--labels`` names some. It is read
with the ``csv`` module (``data/datasets.py read_manifest``), not pandas.
The encoder is ``build_extractor_from_config`` of ``CFG`` loaded from
``CKPT`` (a reference ``.pt`` or a pickle of either package). The next-to-last line is ``{"retrieval": ...}``: the scans, the
embedding seconds and the kernel launches counted in this process. The last
line is the JAX tool's ``{"mAP_<label>": ...}``, each rounded to 4 places.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

import numpy as np


def read_labelled_manifest(path: str):
    """(image paths, {column: int labels}) of a manifest, in column order."""
    from headct_foundation_tpu_torch.data.datasets import read_manifest

    rows = read_manifest(path)
    if not rows or "img_path" not in rows[0]:
        raise ValueError(f"{path}: no rows with an img_path column")
    labels = {c: np.asarray([int(float(r[c])) for r in rows]) for c in rows[0]
              if c != "img_path"}
    return [r["img_path"] for r in rows], labels


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description="Retrieval mAP (PyTorch)")
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--csv", required=True, help="manifest with img_path + label columns")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--labels", nargs="+", default=None,
                    help="label columns to evaluate (default: all non-path columns)")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from headct_foundation_tpu_torch.config import default_config
    from headct_foundation_tpu_torch.engines.mae_engine import kernel_launches
    from headct_foundation_tpu_torch.eval.retrieval import retrieval_map_per_class
    from headct_foundation_tpu_torch.feature_extraction import build_extractor_from_config

    cfg = default_config()
    cfg.merge_from_file(args.cfg)
    paths, labels = read_labelled_manifest(args.csv)
    label_cols = args.labels or list(labels)

    extractor = build_extractor_from_config(cfg, checkpoint_path=args.checkpoint,
                                            device=args.device)
    before = kernel_launches()
    t0 = time.perf_counter()
    feats = extractor.extract_from_files(paths, batch_size=args.batch_size)
    seconds = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in kernel_launches().items()}
    print(json.dumps({"retrieval": {"scans": len(paths), "embed_seconds": seconds,
                                    "batch_size": args.batch_size,
                                    "device": str(extractor.device), "launches": launches}}),
          flush=True)
    results = retrieval_map_per_class(feats, {c: labels[c] for c in label_cols})
    out = {f"mAP_{k}": round(v, 4) for k, v in results.items()}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
