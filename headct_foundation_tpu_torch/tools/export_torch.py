"""Export a checkpoint of either package to a reference-loadable ``.pt``
(the port's counterpart of the JAX package's ``tools/export_torch.py:40-160``;
reference: src/utils/misc.py:35-52, 72-96).

    python -m headct_foundation_tpu_torch.tools.export_torch CKPT OUT.pt \\
        [--part auto|mae|vit|dino-student|dino-teacher|downstream] [--norm-layer layernorm]

The checkpoint is the pickle format both packages write (read through the
port's restricted unpickler); its parameter trees become the reference's
torch naming (``blocks.<i>.*``, Linear weights [out, in], the Conv3d patch
embedding, BatchNorm running statistics) through
``utils/torch_interop.state_dict_from_jax``, and the file is the
reference's ``{epoch, best_loss, state_dict[, ...]}``. A ``PIPE`` run's
stacked trunks are unstacked first (``parallel/pipeline.py``). By kind
(``detect_part``):

* MAE: the whole model's state dict;
* DINO: the student as ``backbone.*`` / ``head.*`` (its head's BatchNorm
  statistics with it) and the teacher as ``momentum_model_state_dict``
  (``--part dino-teacher`` exports the teacher alone);
* downstream: the backbone to ``OUT.pt`` and the classifier (with its
  ``batch_stats``) to ``OUT_classifier.pt``.

``FeatureExtractor(checkpoint_path=OUT.pt)`` loads the backbone of any of
them. Orbax directories need JAX and are refused.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict, List, Mapping, Optional

import torch

from headct_foundation_tpu_torch.parallel.pipeline import unstack_if_pipelined
from headct_foundation_tpu_torch.utils.checkpoint import load_checkpoint
from headct_foundation_tpu_torch.utils.torch_interop import state_dict_from_jax

PARTS = ("auto", "mae", "vit", "dino-student", "dino-teacher", "downstream")


def detect_part(params: Mapping[str, Any]) -> str:
    keys = {str(k) for k in params}
    if {"backbone", "head"} <= keys:
        return "dino-student"
    if {"model", "classifier"} <= keys:
        return "downstream"
    if any(k.startswith("decoder") for k in keys):
        return "mae"
    return "vit"


def _per_block(params: Mapping[str, Any]) -> Dict[str, Any]:
    """The reference's per-block trunks, at the top and under a DINO
    ``backbone`` or a downstream ``model``."""
    params = unstack_if_pipelined(params)
    for sub in ("backbone", "model"):
        if isinstance(params.get(sub), Mapping):
            params[sub] = unstack_if_pipelined(params[sub])
    return params


def _prefixed(sd: Mapping[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.{k}": v for k, v in sd.items()}


def _dino(tree: Mapping[str, Any], stats: Optional[Mapping[str, Any]]) -> Dict[str, torch.Tensor]:
    sd = _prefixed(state_dict_from_jax(unstack_if_pipelined(tree["backbone"])), "backbone")
    sd.update(_prefixed(state_dict_from_jax(tree["head"], batch_stats=stats or None), "head"))
    return sd


def export(ckpt_path: str, out_path: str, part: str = "auto",
           norm_layer: str = "layernorm") -> List[str]:
    """Write the ``.pt`` file(s); returns their paths. ``norm_layer`` is the
    JAX tool's flag: both norms map ``scale`` to ``weight``."""
    del norm_layer
    payload = load_checkpoint(ckpt_path)
    params = _per_block(payload["params"])
    if part == "auto":
        part = detect_part(params)
    if part not in PARTS:
        raise SystemExit(f"unknown --part {part}")
    meta = {"epoch": payload.get("epoch", 0), "best_loss": payload.get("best_loss", 0.0)}
    written = []
    if part in ("mae", "vit"):
        torch.save({**meta, "state_dict": state_dict_from_jax(params)}, out_path)
        written.append(out_path)
    elif part in ("dino-student", "dino-teacher"):
        student = part == "dino-student"
        src = params if student else payload["momentum_model_state_dict"]
        stats = payload.get("head_stats" if student else "teacher_head_stats")
        out = {**meta, "state_dict": _dino(src, stats)}
        # a student export carries the teacher too, as the reference's DINO
        # checkpoints do (engine_pretrain_dino.py:284-295)
        if student and "momentum_model_state_dict" in payload:
            out["momentum_model_state_dict"] = _dino(payload["momentum_model_state_dict"],
                                                     payload.get("teacher_head_stats"))
        torch.save(out, out_path)
        written.append(out_path)
    else:
        torch.save({**meta, "state_dict": state_dict_from_jax(params["model"])}, out_path)
        written.append(out_path)
        stats = payload.get("batch_stats") or None
        if isinstance(stats, Mapping):
            stats = stats.get("classifier", stats) or None
        root, ext = os.path.splitext(out_path)
        cpath = f"{root}_classifier{ext or '.pt'}"
        torch.save({**meta, "state_dict": state_dict_from_jax(params["classifier"],
                                                              batch_stats=stats)}, cpath)
        written.append(cpath)
    return written


def main(argv: Optional[List[str]] = None) -> List[str]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ckpt", help="checkpoint of either package (pickle format)")
    ap.add_argument("out", help="output .pt path")
    ap.add_argument("--part", default="auto", choices=PARTS)
    ap.add_argument("--norm-layer", default="layernorm", choices=["layernorm", "rmsnorm"])
    args = ap.parse_args(argv)
    written = export(args.ckpt, args.out, args.part, args.norm_layer)
    for path in written:
        print(f"wrote {path}")
    return written


if __name__ == "__main__":
    main()
