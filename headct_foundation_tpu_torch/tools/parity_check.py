"""Embedding parity of the port against the reference's formulas (the
port's counterpart of the JAX package's ``tools/parity_check.py:41-220``).

    python -m headct_foundation_tpu_torch.tools.parity_check --checkpoint ref.pt \\
        --nifti-dir scans/ [--threshold 0.999] [--device cuda|cpu] \\
        [--ref-embeddings ref.npz] [--report out.json]
    python -m headct_foundation_tpu_torch.tools.parity_check --make-oracle-ckpt out.pt

For every ``*.nii`` / ``*.nii.gz`` under ``--nifti-dir`` it computes

* the port's chain: ``FeatureExtractor`` (the on-card preprocessing, the
  port's ViT, its attention through kernel B1 in float32 on a card, in
  batches of 8, the serving batch), the checkpoint loaded through
  ``load_pretrained_into``;
* the reference chain: ``OracleViT``, a plain PyTorch ViT of the reference's
  formulas (pre-norm blocks, erf GELU, softmax attention written out), with
  the same weights read straight from the ``.pt`` (or, when the file lacks
  some, the port's loaded weights), on the scipy host preprocessing of the
  reference notebook (``data/transforms.py extract_feature_preprocess``); or,
  with ``--ref-embeddings``, embeddings the reference code computed (an npz
  keyed by scan basename);

and reports each scan's CLS cosine and PASS when every one reaches
``--threshold`` (exit code 0, else 1). ``--make-oracle-ckpt`` writes a
randomly initialised reference-format checkpoint, to test the tool end to
end. The model's geometry flags default to the flagship ViT-B/12 at 96^3.
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import sys
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class OracleBlock(nn.Module):
    """A pre-norm ViT block of the reference's formulas."""

    def __init__(self, dim: int, mlp_dim: int, heads: int, qkv_bias: bool = True):
        super().__init__()
        self.att_norm = nn.LayerNorm(dim)
        self.ffn_norm = nn.LayerNorm(dim)
        self.heads = heads
        self.attn = nn.Module()
        self.attn.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.attn.proj = nn.Linear(dim, dim)
        self.mlp = nn.Module()
        self.mlp.linear1 = nn.Linear(dim, mlp_dim)
        self.mlp.linear2 = nn.Linear(mlp_dim, dim)

    def attention(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        h = self.heads
        q, k, v = self.attn.qkv(x).reshape(B, N, 3, h, C // h).permute(2, 0, 3, 1, 4)
        p = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(C // h), dim=-1)
        return self.attn.proj((p @ v).transpose(1, 2).reshape(B, N, C))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attention(self.att_norm(x))
        return x + self.mlp.linear2(F.gelu(self.mlp.linear1(self.ffn_norm(x))))


class OracleViT(nn.Module):
    """The reference ViT's formulas (the JAX tests' oracle, kept here so the
    tool imports neither JAX nor the tests): Conv3d patch embedding plus a
    position embedding, a CLS token, ``layers`` blocks, a final LayerNorm."""

    def __init__(self, in_chans: int = 3, img: int = 96, patch: int = 12, dim: int = 768,
                 mlp: int = 3072, layers: int = 12, heads: int = 12):
        super().__init__()
        self.patch_embedding = nn.Module()
        self.patch_embedding.patch_embeddings = nn.Conv3d(in_chans, dim, patch, stride=patch)
        n = (img // patch) ** 3
        self.patch_embedding.position_embeddings = nn.Parameter(torch.randn(1, n, dim) * 0.02)
        self.cls_token = nn.Parameter(torch.randn(1, 1, dim) * 0.02)
        self.blocks = nn.ModuleList(OracleBlock(dim, mlp, heads) for _ in range(layers))
        self.norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pe = self.patch_embedding
        x = pe.patch_embeddings(x).flatten(2).transpose(-1, -2) + pe.position_embeddings
        x = torch.cat([self.cls_token.expand(x.shape[0], -1, -1), x], dim=1)
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)


def _oracle(args) -> OracleViT:
    return OracleViT(in_chans=args.in_chans, img=args.img_size, patch=args.patch_size,
                     dim=args.hidden_size, mlp=args.mlp_dim, layers=args.num_layers,
                     heads=args.num_heads).eval()


def make_oracle_ckpt(out_path: str, args) -> None:
    """A reference-format checkpoint ``{"state_dict": ...}`` of a randomly
    initialised oracle (seed ``args.seed``)."""
    torch.manual_seed(args.seed)
    torch.save({"state_dict": _oracle(args).state_dict()}, out_path)
    print(f"wrote oracle checkpoint: {out_path}")


def scan_paths(nifti_dir: str) -> List[str]:
    paths = sorted(glob.glob(os.path.join(nifti_dir, "**", "*.nii*"), recursive=True))
    if not paths:
        raise SystemExit(f"no NIfTI files under {nifti_dir}")
    return paths


def reference_embeddings(args, paths: List[str], extractor) -> np.ndarray:
    """The oracle's CLS embeddings of ``paths`` on the CPU in float32."""
    from headct_foundation_tpu_torch.data.transforms import extract_feature_preprocess
    from headct_foundation_tpu_torch.utils.torch_interop import load_reference_checkpoint

    oracle = _oracle(args)
    try:  # the raw .pt straight into the oracle: an import path of its own
        oracle.load_state_dict(load_reference_checkpoint(args.checkpoint), strict=True)
    except (RuntimeError, KeyError, ValueError):
        # the file lacks oracle keys (a pickle, frozen sincos buffers not
        # saved): both sides take the port's loaded weights; the
        # preprocessing and the forward still differ
        print("note: oracle weights routed through the port's importer")
        sd = {k: v.detach().float().cpu() for k, v in extractor.model.state_dict().items()}
        oracle.load_state_dict({k: sd[k] for k in oracle.state_dict()}, strict=True)
    refs = []
    for p in paths:
        vol = extract_feature_preprocess(p, (args.img_size,) * 3, args.in_chans)
        with torch.no_grad():
            refs.append(oracle(torch.from_numpy(vol[None]))[0, 0].numpy())
    return np.stack(refs)


def run(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Parse, compute and print; returns the report (``pass``: every cosine
    at or above the threshold). The erf GELU (``HEADCT_EXACT_GELU=1``, unless
    set) holds for the check and is unset after it."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", help="reference .pt (or a pickle of either package)")
    ap.add_argument("--nifti-dir", help="directory of *.nii / *.nii.gz scans")
    ap.add_argument("--threshold", type=float, default=0.999)
    ap.add_argument("--ref-embeddings",
                    help="npz of reference-computed embeddings keyed by scan basename")
    ap.add_argument("--report", help="write the JSON report here")
    ap.add_argument("--make-oracle-ckpt", metavar="OUT_PT",
                    help="write a synthetic reference-format checkpoint and exit")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--img-size", type=int, default=96)
    ap.add_argument("--patch-size", type=int, default=12)
    ap.add_argument("--in-chans", type=int, default=3)
    ap.add_argument("--hidden-size", type=int, default=768)
    ap.add_argument("--mlp-dim", type=int, default=3072)
    ap.add_argument("--num-layers", type=int, default=12)
    ap.add_argument("--num-heads", type=int, default=12)
    ap.add_argument("--pos-embed", default="sincos", choices=["sincos", "learnable"])
    ap.add_argument("--registers", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.make_oracle_ckpt:
        make_oracle_ckpt(args.make_oracle_ckpt, args)
        return {"oracle_checkpoint": args.make_oracle_ckpt}
    if not args.checkpoint or not args.nifti_dir:
        ap.error("--checkpoint and --nifti-dir are required")
    if args.registers and not args.ref_embeddings:
        raise SystemExit("--registers needs --ref-embeddings (the oracle has no register "
                         "tokens)")
    gelu = os.environ.get("HEADCT_EXACT_GELU")
    os.environ.setdefault("HEADCT_EXACT_GELU", "1")  # the reference's erf GELU, for this run
    try:
        return _check(args)
    finally:
        if gelu is None:
            os.environ.pop("HEADCT_EXACT_GELU", None)


def _check(args) -> Dict[str, Any]:
    from headct_foundation_tpu_torch.feature_extraction import FeatureExtractor

    paths = scan_paths(args.nifti_dir)
    extractor = FeatureExtractor(
        checkpoint_path=args.checkpoint, img_size=args.img_size, patch_size=args.patch_size,
        in_chans=args.in_chans, hidden_size=args.hidden_size, mlp_dim=args.mlp_dim,
        num_layers=args.num_layers, num_heads=args.num_heads, pos_embed=args.pos_embed,
        num_register_tokens=args.registers, qkv_bias=True, device=args.device)
    ours = extractor.extract_from_files(paths, batch_size=8)
    names = [os.path.basename(p) for p in paths]
    if args.ref_embeddings:
        npz = np.load(args.ref_embeddings)
        refs = np.stack([np.asarray(npz[n]).reshape(-1) for n in names])
    else:
        refs = reference_embeddings(args, paths, extractor)
    cosines = {n: float(np.sum(a * b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))
               for n, a, b in zip(names, ours, refs)}
    values = np.array(list(cosines.values()))
    report = {"checkpoint": args.checkpoint, "n_scans": len(paths),
              "threshold": args.threshold, "min_cosine": float(values.min()),
              "mean_cosine": float(values.mean()),
              "pass": bool((values >= args.threshold).all()), "per_scan": cosines}
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=2)
    for name, c in cosines.items():
        print(f"  {name}: cosine={c:.6f}")
    print(f"{'PASS' if report['pass'] else 'FAIL'}: min={values.min():.6f} "
          f"mean={values.mean():.6f} over {len(paths)} scans (threshold {args.threshold})")
    return report


def main(argv: Optional[List[str]] = None) -> None:
    report = run(argv)
    sys.exit(0 if report.get("pass", True) else 1)


if __name__ == "__main__":
    main()
