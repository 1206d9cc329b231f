"""Feature-extraction walkthrough (reference surface:
notebooks/extract_feature_sample.ipynb): the port's counterpart of the
repository's ``examples/extract_feature_sample.py``.

Builds the ViT-B/12 @ 96^3 encoder, loads pretrained weights (a reference
``.pt`` with its module./backbone./_orig_mod. prefixes, or a pickle of
either package, strict=False), preprocesses NIfTI scans in the notebook's
transform order on the device, and extracts (last_layer_out,
all_layers_out), the CLS features and a ``LinearClassifier``'s
probabilities (its weights from ``--classifier-checkpoint``, a reference
``.pt``, else a seeded init).

    python -m headct_foundation_tpu_torch.examples.extract_feature_sample \\
        scan1.nii.gz [scan2.nii.gz ...] [--checkpoint CKPT] \\
        [--classifier-checkpoint CKPT] [--device cpu]

Needs only torch and numpy. Runs on ``cuda`` unless ``--device cpu`` is
given.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np
import torch


def main(argv: Optional[List[str]] = None) -> np.ndarray:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scans", nargs="+", help="NIfTI files (.nii/.nii.gz)")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--classifier-checkpoint", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from headct_foundation_tpu_torch.feature_extraction import FeatureExtractor
    from headct_foundation_tpu_torch.models.classifier import LinearClassifier
    from headct_foundation_tpu_torch.utils.torch_interop import (
        load_reference_checkpoint,
        merge_params,
    )

    # Cell 2: 96^3, patch 12, 768 wide, 12 layers, 12 heads, 3 channels, sincos.
    extractor = FeatureExtractor(checkpoint_path=args.checkpoint, device=args.device)
    n_params = sum(p.numel() for p in extractor.model.parameters())
    print(f"encoder parameters: {n_params / 1e6:.1f}M")

    # Cells 7-12: preprocess + forward.
    vols = torch.stack([extractor.preprocess(p) for p in args.scans])
    last_layer_out, all_layers_out = extractor(vols)
    print(f"last_layer_out: {tuple(last_layer_out.shape)}")  # [B, 513, 768]
    print(f"all_layers_out: {len(all_layers_out)} x {tuple(all_layers_out[0].shape)}")

    # Cells 16-17: CLS feature -> LinearClassifier probabilities.
    cls_feature = last_layer_out[:, 0, :]
    print(f"CLS features: {tuple(cls_feature.shape)}")
    clf = LinearClassifier(dim=cls_feature.shape[-1], num_classes=2).init_weights(
        torch.Generator().manual_seed(0))
    if args.classifier_checkpoint:
        merged, missing, unexpected = merge_params(
            clf.state_dict(), load_reference_checkpoint(args.classifier_checkpoint))
        clf.load_state_dict(merged)
        print(f"classifier: {len(missing)} missing, {len(unexpected)} unexpected keys")
    clf = clf.to(extractor.device).eval()  # the BatchNorm's running statistics
    with torch.inference_mode():
        probs = torch.softmax(clf(cls_feature).float(), dim=-1).cpu().numpy()
    for path, p in zip(args.scans, probs):
        print(f"{os.path.basename(path)}: P(positive) = {p[1]:.4f}")
    return probs


if __name__ == "__main__":
    main(sys.argv[1:])
