"""Weights between the JAX package's parameter trees, reference checkpoints
and the port's modules.

* ``state_dict_from_jax``: a nested dict of numpy arrays in the JAX package's
  naming (``blocks_3/attn/qkv/kernel``) -> a state_dict in the reference torch
  naming (``blocks.3.attn.qkv.weight``), the same keys and values that the
  JAX package's ``utils/torch_interop.py:282 tree_to_torch`` emits: Dense
  kernels [in, out] transpose to Linear weights [out, in], the patch-embed
  matmul kernel [(ph pw pd C), O] folds back into a Conv3d weight
  [O, C, ph, pw, pd], LayerNorm ``scale`` becomes ``weight``.
* ``strip_prefixes``: drop the ``module.``, ``backbone.`` and ``_orig_mod.``
  prefixes that reference checkpoints carry (reference:
  src/utils/misc.py:72-96).
* ``load_reference_checkpoint``: a reference ``.pt`` -> a stripped
  state_dict, loaded the way the feature-extraction notebook does.

Orbax and pickle checkpoints of the JAX package are not read yet.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

PREFIXES = ("module.", "backbone.", "_orig_mod.")


def strip_prefixes(sd: Mapping[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in sd.items():
        for p in PREFIXES:
            k = k.replace(p, "")
        out[k] = v
    return out


def _patch_kernel_to_conv(k: np.ndarray) -> np.ndarray:
    """[(ph pw pd C), O] -> [O, C, ph, pw, pd] for a cubic patch; C is the
    first of 3, 1, 2, 4 that factors the rows, as ``tree_to_torch`` does."""
    pd_c, o = k.shape
    for c in (3, 1, 2, 4):
        p = round((pd_c // c) ** (1 / 3))
        if c * p * p * p == pd_c:
            return k.reshape(p, p, p, c, o).transpose(4, 3, 0, 1, 2)
    raise ValueError(f"cannot infer conv shape from kernel {k.shape}")


def _torch_module_name(name: str) -> str:
    for base in ("blocks", "decoder_blocks"):
        if name.startswith(base + "_") and name[len(base) + 1:].isdigit():
            return f"{base}.{name[len(base) + 1:]}"
    return name


def state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ViT parameter tree (numpy leaves) -> reference-named state_dict."""
    out: Dict[str, np.ndarray] = {}

    def walk(tree: Mapping[str, Any], prefix: str, in_patch_embed: bool) -> None:
        for key, val in tree.items():
            name = str(key)
            if isinstance(val, Mapping):
                sub = _torch_module_name(name)
                walk(val, f"{prefix}.{sub}" if prefix else sub,
                     in_patch_embed or name == "patch_embedding")
                continue
            arr = np.asarray(val)
            if in_patch_embed and name == "kernel":
                out[f"{prefix}.patch_embeddings.weight"] = _patch_kernel_to_conv(arr)
            elif in_patch_embed and name == "bias" and prefix.endswith("patch_embedding"):
                out[f"{prefix}.patch_embeddings.bias"] = arr
            elif name == "kernel":
                out[f"{prefix}.weight"] = arr.T
            elif name == "scale":
                out[f"{prefix}.weight"] = arr
            else:
                out[f"{prefix}.{name}" if prefix else name] = arr

    walk(params, "", False)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}


def load_reference_checkpoint(path: str, key: str = "state_dict") -> Dict[str, torch.Tensor]:
    """A reference ``.pt`` (optionally nesting the weights under ``key``) ->
    a prefix-stripped state_dict on the CPU. Loaded with
    ``weights_only=True``: only tensors and plain containers are unpickled."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    sd = payload[key] if isinstance(payload, dict) and key in payload else payload
    return strip_prefixes({k: v for k, v in sd.items() if isinstance(v, torch.Tensor)})
