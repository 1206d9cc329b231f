"""Per-layer CLS attention maps over head-CT volume slices: the port's
counterpart of the repository's ``examples/visualize_attention.py``.

The reference ships this surface as notebooks/visualization_sample.ipynb on
top of the ``save_attn`` buffers (reference: src/models/attentionblock.py:
36-66); here the maps come from ``FeatureExtractor.cls_attention_volume``
(the unfused softmax, no kernel launched) and are drawn as heatmap overlays
on the mid axial, coronal and sagittal slices of the preprocessed volume.

    python -m headct_foundation_tpu_torch.examples.visualize_attention \\
        [--scan path.nii.gz] [--checkpoint CKPT] [--layers 3 7 11] [--head N] \\
        [--out attention_maps.png] [--device cpu]

With no ``--scan`` a synthetic head phantom is written, so the example runs
end to end. The PNG is drawn only when matplotlib imports; without it the
maps are computed and the example says that it drew nothing. Runs on
``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import Dict, List, Optional

import numpy as np


def synthetic_head_scan(out_dir: str, size: int = 160) -> str:
    """A crude head phantom NIfTI: an ellipsoidal skull shell of bone HU
    around soft-tissue brain with a bright lesion blob, at 1 mm."""
    from headct_foundation_tpu_torch.data.nifti import save_nifti

    rng = np.random.RandomState(0)
    g = np.linspace(-1, 1, size)
    zz, yy, xx = np.meshgrid(g, g, g, indexing="ij")
    r = np.sqrt(xx ** 2 + yy ** 2 + (zz * 1.3) ** 2)
    vol = np.full((size, size, size), -1000.0, np.float32)  # air
    vol[r < 0.92] = 900.0                                   # skull shell
    vol[r < 0.82] = 35.0                                    # brain parenchyma
    vol[r < 0.82] += rng.randn(*vol[r < 0.82].shape).astype(np.float32) * 4
    lesion = np.sqrt((xx - 0.3) ** 2 + (yy + 0.2) ** 2 + (zz - 0.1) ** 2) < 0.12
    vol[lesion & (r < 0.82)] = 75.0                         # acute blood
    path = os.path.join(out_dir, "phantom.nii.gz")
    save_nifti(path, np.round(vol), np.diag([1.0, 1.0, 1.0, 1.0]))
    return path


def render(vol_c: np.ndarray, attn_by_layer: Dict[int, np.ndarray], layers: List[int],
           out_path: str) -> bool:
    """vol_c: [R, R, R] display channel; attn_by_layer: {layer: [R, R, R]}.
    Writes the PNG; False (nothing written) when matplotlib is missing."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False
    R = vol_c.shape[0]
    mids = {"axial": 2, "coronal": 1, "sagittal": 0}
    fig, axes = plt.subplots(len(mids), len(layers),
                             figsize=(3.2 * len(layers), 3.2 * len(mids)), squeeze=False)
    for col, layer in enumerate(layers):
        att = attn_by_layer[layer]
        att = (att - att.min()) / max(att.max() - att.min(), 1e-12)
        for row, (name, axis) in enumerate(mids.items()):
            sl = [slice(None)] * 3
            sl[axis] = R // 2
            ax = axes[row][col]
            ax.imshow(vol_c[tuple(sl)].T, cmap="gray", origin="lower")
            ax.imshow(att[tuple(sl)].T, cmap="inferno", alpha=0.45, origin="lower")
            ax.set_xticks([])
            ax.set_yticks([])
            if row == 0:
                ax.set_title(f"layer {layer}")
            if col == 0:
                ax.set_ylabel(name)
    fig.suptitle("CLS attention over volume slices")
    fig.tight_layout()
    fig.savefig(out_path, dpi=140)
    plt.close(fig)
    return True


def main(argv: Optional[List[str]] = None, extractor=None) -> Dict[int, np.ndarray]:
    """The maps by layer; ``extractor`` replaces the default ViT-B/12 one."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scan", default=None, help="NIfTI path (default: phantom)")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--layers", type=int, nargs="+", default=[3, 7, 11])
    ap.add_argument("--head", type=int, default=None,
                    help="single attention head (default: mean over heads)")
    ap.add_argument("--out", default="attention_maps.png")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from headct_foundation_tpu_torch.feature_extraction import FeatureExtractor

    with tempfile.TemporaryDirectory(prefix="headct_attn_") as tmp:
        scan = args.scan
        if scan is None:
            scan = synthetic_head_scan(tmp)
            print(f"no --scan given; synthesized phantom at {scan}")
        if extractor is None:
            extractor = FeatureExtractor(checkpoint_path=args.checkpoint, device=args.device)
        vol = extractor.preprocess(scan)  # [C, R, R, R], notebook order
    attn = {layer: extractor.cls_attention_volume(vol[None], layer=layer, head=args.head)[0]
            for layer in args.layers}
    heads = "mean over heads" if args.head is None else f"head {args.head}"
    if render(vol[0].cpu().numpy(), attn, args.layers, args.out):
        print(f"wrote {args.out} (layers {args.layers}, {heads})")
    else:
        print(f"matplotlib is not installed: no {args.out} drawn (layers {args.layers}, {heads})")
    return attn


if __name__ == "__main__":
    main(sys.argv[1:])
