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
* ``jax_tree_from_state_dict``: the inverse of ``state_dict_from_jax``, the
  counterpart of JAX ``:74 torch_to_tree``; a port state_dict goes to the
  JAX tree and back bit for bit.
* ``opt_state_to_jax`` / ``opt_state_from_jax``: the optimizer state of the
  port's SGD, AdamW, Lamb and Lion (fused or not) as optax's state tree of
  the JAX package's chain, in flax's ``to_state_dict`` form, and back:
  ``multi_transform({"train", "freeze"})`` over ``chain([clip], ...)`` (JAX
  ``optim/optimizers.py:235-286``). Moments are laid out as their
  parameters (kernels transposed); the frozen sincos embeddings carry the
  ``freeze`` branch's empty state (``{}`` in the trees). torch's AdamW keeps a
  ``step`` per parameter, optax one ``count`` per transform: all of them are
  the update count ``TrainState.step``. The DINO student's
  ``{'backbone', 'head'}`` tree maps the same way (the head's ``mlp_N`` is
  ``head.mlp.{2N}``, ``last_layer/weight_v`` and ``weight_g`` keep their
  names and layout), with its two kinds of frozen leaf (the sincos position
  embeddings and, with ``NORM_LAST_LAYER``, ``last_layer/weight_g``).
* The downstream state (``engines/downstream_engine.py``): its parameter
  tree ``{"model": ViT, "classifier": head}``, the classifier's BatchNorm
  running statistics as ``batch_stats`` ``{"classifier": {"bn": {"mean",
  "var"}}}`` (``running_mean`` / ``running_var`` in torch, the names JAX
  ``tree_to_torch(..., batch_stats=...)`` gives them), the LoRA adapters
  (``lora_q/lora_matrix_A`` ...), and its optimizer state as
  ``multi_transform({"model", "classifier", "freeze"})`` (JAX
  ``downstream_engine.py:150-180``): each branch's chain, nested as
  ``chain(clip_by_global_norm, chain(...))`` when ``GRAD_CLIP > 0``, over the
  whole tree with the other branches' leaves masked (``{}``); ``freeze`` is
  ``set_to_zero``'s empty state (``downstream_params_to_jax``,
  ``downstream_state_dicts_from_jax``, ``downstream_opt_state_to_jax``,
  ``downstream_opt_state_from_jax``).
* ``classify_checkpoint`` (JAX ``:410``) tells a torch file from a pickle
  of the JAX package's format with a restricted unpickler (``:360``) that
  runs nothing: only numpy arrays, dtypes and plain containers load.
* ``merge_params`` (``:210``) and ``load_pretrained_into`` (``:465``):
  strict=False warm starts into a module's state_dict, from a torch file or
  from either package's pickle, routed by content; a position embedding of
  another grid is interpolated to the model's.
* The BatchNorm DINO head (``DINO.USE_BN``): its ``mlp_N`` at ``mlp.{3N}``,
  ``mlp_bn_N`` ``{scale, bias}`` at ``mlp.{3N+1}.weight`` / ``.bias``, and
  its ``batch_stats`` ``{mean, var}`` at ``running_mean`` / ``running_var``
  (``bn_layout_of`` tells the layout from the names).

The pickle format is ``utils/checkpoint.py``'s. Orbax directories need JAX
and raise ``OrbaxNotSupportedError``. A leaf in a ``ml_dtypes`` type
(bfloat16 and the float8 types) raises ``CheckpointDtypeError``: it is
never cast.
"""

from __future__ import annotations

import logging
import os
import pickle
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from headct_foundation_tpu_torch.models.pos_embed import interpolate_pos_embed, nth_root
from headct_foundation_tpu_torch.utils.misc import wide_dtype

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


def _torch_module_name(name: str, bn_layout: bool = False) -> str:
    """A JAX module name as the reference's. The DINO head's ``nn.Sequential``
    holds [Linear, GELU]* without BatchNorm (``mlp_N`` at ``mlp.{2N}``) and
    [Linear, BN, GELU]* with it (``mlp_N`` at ``mlp.{3N}``, ``mlp_bn_N`` at
    ``mlp.{3N+1}``; JAX ``utils/torch_interop.py:154-174,296-333``)."""
    for base in ("blocks", "decoder_blocks"):
        if name.startswith(base + "_") and name[len(base) + 1:].isdigit():
            return f"{base}.{name[len(base) + 1:]}"
    if name.startswith("mlp_bn_") and name[7:].isdigit():
        return f"mlp.{3 * int(name[7:]) + 1}"
    if name.startswith("mlp_") and name[4:].isdigit():
        return f"mlp.{(3 if bn_layout else 2) * int(name[4:])}"
    return name


def _has_bn(tree: Any) -> bool:
    """Whether a JAX tree holds a DINO head BatchNorm (``mlp_bn_N``)."""
    return isinstance(tree, Mapping) and any(
        str(k).startswith("mlp_bn_") or _has_bn(v) for k, v in tree.items())


def bn_layout_of(names) -> bool:
    """Whether reference names are of the BatchNorm head's layout: only it
    puts a module at an odd ``mlp.N`` (JAX decides it by a pre-scan, ``:85``)."""
    for name in names:
        parts = name.split(".")
        if any(a == "mlp" and b.isdigit() and int(b) % 2 for a, b in zip(parts, parts[1:])):
            return True
    return False


BN_STATS = {"mean": "running_mean", "var": "running_var"}  # JAX batch_stats -> torch buffers


def state_dict_from_jax(params: Mapping[str, Any],
                        batch_stats: Optional[Mapping[str, Any]] = None
                        ) -> Dict[str, torch.Tensor]:
    """JAX ViT parameter tree (numpy leaves) -> reference-named state_dict;
    BatchNorm statistics ``{"bn": {"mean", "var"}}`` from ``batch_stats``
    become ``bn.running_mean`` / ``bn.running_var``; a DINO head with
    BatchNorm (``mlp_bn_N``) takes the reference's [Linear, BN, GELU] names."""
    out: Dict[str, np.ndarray] = {}
    bn_layout = _has_bn(params) or _has_bn(batch_stats)

    def walk(tree: Mapping[str, Any], prefix: str, in_patch_embed: bool) -> None:
        for key, val in tree.items():
            name = str(key)
            if isinstance(val, Mapping):
                sub = _torch_module_name(name, bn_layout)
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

    def walk_stats(tree: Mapping[str, Any], prefix: str) -> None:
        for key, val in tree.items():
            module = _torch_module_name(str(key), bn_layout)
            name = f"{prefix}.{module}" if prefix else module
            if isinstance(val, Mapping):
                walk_stats(val, name)
            else:
                out[f"{prefix}.{BN_STATS[str(key)]}"] = np.asarray(val)

    walk_stats(batch_stats or {}, "")
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in out.items()}  # copies


def load_reference_checkpoint(path: str, key: str = "state_dict") -> Dict[str, torch.Tensor]:
    """A reference ``.pt`` (optionally nesting the weights under ``key``) ->
    a prefix-stripped state_dict on the CPU. Loaded with
    ``weights_only=True``: only tensors and plain containers are unpickled."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    sd = payload[key] if isinstance(payload, dict) and key in payload else payload
    return strip_prefixes({k: v for k, v in sd.items() if isinstance(v, torch.Tensor)})


class OrbaxNotSupportedError(NotImplementedError):
    """An orbax checkpoint (a directory, or ``TRAIN.CKPT_FORMAT: orbax``):
    orbax imports JAX, which the port does not."""


class CheckpointDtypeError(RuntimeError):
    """A checkpoint leaf whose dtype the port does not take as it is."""


def refuse_orbax(path: Optional[str] = None, fmt: str = "pickle") -> None:
    if fmt == "orbax" or (path is not None and os.path.isdir(path)):
        raise OrbaxNotSupportedError(
            f"orbax checkpoint {'format' if path is None else path!r}: orbax imports JAX and "
            "the port reads and writes only the pickle format (TRAIN.CKPT_FORMAT: pickle)")
    if fmt != "pickle":
        raise ValueError(f"unknown checkpoint format {fmt!r}")


def _jax_module_path(parts: List[str], bn_layout: bool = False) -> List[str]:
    out, i = [], 0
    while i < len(parts):
        if (parts[i] in ("blocks", "decoder_blocks") and i + 1 < len(parts)
                and parts[i + 1].isdigit()):
            out.append(f"{parts[i]}_{parts[i + 1]}")
            i += 2
        elif parts[i] == "mlp" and i + 1 < len(parts) and parts[i + 1].isdigit():
            idx = int(parts[i + 1])
            if not bn_layout:  # the DINO head's Linears at mlp.{2N}
                out.append(f"mlp_{idx // 2}")
            elif idx % 3 == 2:
                raise KeyError(f"mlp.{idx} is a GELU of the BatchNorm head; it holds nothing")
            else:  # Linears at mlp.{3N}, BatchNorms at mlp.{3N+1}
                out.append(f"mlp_{idx // 3}" if idx % 3 == 0 else f"mlp_bn_{idx // 3}")
            i += 2
        else:
            out.append(parts[i])
            i += 1
    return out


def _jax_leaf(name: str, ndim: int, norm_layer: str,
              bn_layout: bool = False) -> Tuple[List[str], str]:
    """Port state_dict name -> (JAX tree path, layout): "linear" (kernel
    [in, out] of a Linear weight [out, in]), "patch" (the patch-embed matmul
    kernel of a Conv3d weight) or "plain". A BatchNorm's weight is its
    ``scale`` whatever the ViT's norm."""
    parts = name.split(".")
    if len(parts) >= 2 and parts[-2] == "patch_embeddings":
        return _jax_module_path(parts[:-2]) + ["kernel" if parts[-1] == "weight" else "bias"], (
            "patch" if parts[-1] == "weight" else "plain")
    path = _jax_module_path(parts[:-1], bn_layout)
    if parts[-1] == "weight" and ndim == 2:
        return path + ["kernel"], "linear"
    if parts[-1] == "weight" and ndim == 1 and (
            norm_layer != "rmsnorm" or path[-1].startswith("mlp_bn_")):
        return path + ["scale"], "plain"
    return path + [parts[-1]], "plain"


def _to_jax_layout(v: torch.Tensor, layout: str) -> np.ndarray:
    """The JAX layout of ``v``, rearranged where ``v`` lies (on a card the
    transposes run there) and then copied to the host."""
    v = v.detach()
    if layout == "linear":
        v = v.t()
    elif layout == "patch":  # [O, C, ph, pw, pd] -> [(ph pw pd C), O]
        v = v.permute(2, 3, 4, 1, 0).reshape(-1, v.shape[0])
    return v.contiguous().cpu().numpy()


def _from_jax_layout(a: np.ndarray, layout: str, shape: Tuple[int, ...]) -> np.ndarray:
    if layout == "linear":
        a = a.T
    elif layout == "patch":
        o, c, ph, pw, pd = shape
        a = a.reshape(ph, pw, pd, c, o).transpose(4, 3, 0, 1, 2)
    return np.ascontiguousarray(a)


def _nest(tree: Dict, path: List[str], value: Any) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def _get(tree: Mapping, path: List[str], what: str) -> Any:
    for p in path:
        if not isinstance(tree, Mapping) or p not in tree:
            raise KeyError(f"{what}: no {'/'.join(path)} in the checkpoint")
        tree = tree[p]
    return tree


def jax_path(name: str, ndim: int, norm_layer: str = "layernorm") -> List[str]:
    """The JAX tree path of a port parameter name (not of a BatchNorm DINO head)."""
    return _jax_leaf(name, ndim, norm_layer)[0]


def is_stat(name: str) -> bool:
    return name.rsplit(".", 1)[-1] in BN_STATS.values()


def jax_tree_from_state_dict(sd: Mapping[str, torch.Tensor],
                             norm_layer: str = "layernorm") -> Dict[str, Any]:
    """Port (reference-named) state_dict -> the JAX parameter tree, numpy
    leaves: ``blocks.3.attn.qkv.weight`` [out, in] -> ``blocks_3/attn/qkv/kernel``
    [in, out], the Conv3d patch weight -> the matmul kernel, a LayerNorm
    ``weight`` -> ``scale``. BatchNorm running statistics are left out
    (``batch_stats_from_state_dict``)."""
    tree: Dict[str, Any] = {}
    bn_layout = bn_layout_of(sd)
    for name, v in sd.items():
        if is_stat(name):
            continue
        path, layout = _jax_leaf(name, v.dim(), norm_layer, bn_layout)
        _nest(tree, path, _to_jax_layout(v, layout))
    return tree


def batch_stats_from_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The BatchNorm running statistics of a state_dict as the JAX
    ``batch_stats`` tree: ``bn.running_mean`` -> ``bn/mean``."""
    tree: Dict[str, Any] = {}
    inverse = {v: k for k, v in BN_STATS.items()}
    bn_layout = bn_layout_of(sd)
    for name, v in sd.items():
        if is_stat(name):
            parts = name.split(".")
            _nest(tree, _jax_module_path(parts[:-1], bn_layout) + [inverse[parts[-1]]],
                  v.detach().contiguous().cpu().numpy())
    return tree


# optax's chain of each optimizer (JAX optim/optimizers.py:242-279), after
# the clip when TRAIN.GRAD_CLIP is set
_CHAINS = {"SGD": ("trace", "count"), "AdamW": ("adam", "count", "count"),
           "Lamb": ("lamb", "count"), "Lion": ("lion",)}
# optax state field -> the torch optimizer's state key, per transform
_MOMENTS = {"trace": {"trace": "momentum_buffer"},
            "adam": {"mu": "exp_avg", "nu": "exp_avg_sq"},
            "lamb": {"exp_avg": "exp_avg", "exp_avg_sq": "exp_avg_sq"},
            "lion": {"exp_avg": "exp_avg"}}


def _chain(config) -> Tuple[str, ...]:
    name = str(config.TRAIN.OPTIMIZER)
    if name not in _CHAINS:
        raise NotImplementedError(f"Unknown optimizer: {name}")
    return (("clip",) if config.TRAIN.GRAD_CLIP else ()) + _CHAINS[name]


def _held(optimizer: Optional[torch.optim.Optimizer]) -> set:
    if optimizer is None:
        return set()
    return {id(p) for g in optimizer.param_groups for p in g["params"]}


def _trainable(model: torch.nn.Module, optimizer: torch.optim.Optimizer):
    """(name, parameter, trainable) over the model's parameters, checking
    that the optimizer holds exactly the trainable ones."""
    held = _held(optimizer)
    out = [(n, p, id(p) in held) for n, p in model.named_parameters()]
    if sum(t for *_, t in out) != len(held):
        raise ValueError("the optimizer holds parameters that are not the model's")
    return out


def _norm_layer(config, norm_layer: Optional[str]) -> str:
    """The parameter naming's norm: given, else the MAE's."""
    return str(config.MAE.NORM_LAYER) if norm_layer is None else str(norm_layer)


def _multi_transform(branches: Mapping[str, Optional[torch.optim.Optimizer]], leaves,
                     kinds: Tuple[str, ...], clip_outside: bool, count: Any,
                     leaf) -> Dict[str, Any]:
    """An ``optax.multi_transform`` state in flax's state_dict form: a
    ``freeze`` branch with ``set_to_zero``'s empty state, and for each of
    ``branches`` (label -> optimizer) the chain of ``kinds`` over the whole
    tree of ``leaves`` ((JAX path, parameter, layout)), with ``leaf(label,
    optimizer, parameter, torch state key, layout)`` where the branch's
    optimizer holds the parameter and ``{}`` (optax's MaskedNode) elsewhere.
    ``clip_outside`` nests the chain as ``chain(clip_by_global_norm,
    chain(...))``, whose clip keeps an empty state."""
    inner_states: Dict[str, Any] = {"freeze": {"inner_state": {}}}
    for label, opt in branches.items():
        held = _held(opt)
        chain: Dict[str, Any] = {}
        for i, kind in enumerate(kinds):
            # optax.trace and the clips keep no count
            entry: Dict[str, Any] = {} if kind in ("clip", "trace") else {"count": count}
            for field, key in _MOMENTS.get(kind, {}).items():
                tree: Dict[str, Any] = {}
                for path, p, layout in leaves:
                    _nest(tree, path, leaf(label, opt, p, key, layout) if id(p) in held else {})
                entry[field] = tree
            chain[str(i)] = entry
        inner_states[label] = {"inner_state": {"0": {}, "1": chain} if clip_outside else chain}
    return {"inner_states": inner_states}


def _states_to_jax(branches, leaves, kinds, clip_outside: bool, step: int,
                   states: Mapping[str, Mapping]) -> Dict[str, Any]:
    """``_multi_transform`` of the optimizers' states (``states[label]``, a
    snapshot, in place of an optimizer's own); every count is ``step`` and
    moments not allocated yet (before the first update) are zeros, as optax
    initialises them."""
    def leaf(label, opt, p, key, layout):
        v = states.get(label, opt.state).get(p, {}).get(key)
        return _to_jax_layout(torch.zeros_like(p, dtype=wide_dtype(p.dtype)) if v is None else v,
                              layout)

    return _multi_transform(branches, leaves, kinds, clip_outside,
                            np.asarray(step, dtype=np.int32), leaf)


def _pretrain_layout(optimizer: torch.optim.Optimizer, model: torch.nn.Module, config,
                     norm_layer: Optional[str]) -> tuple:
    """The pretraining engines' ``multi_transform({"train", "freeze"})`` over
    ``chain([clip], ...)``: (branches, leaves, kinds, clip_outside)."""
    norm_layer = _norm_layer(config, norm_layer)
    bn_layout = bn_layout_of(n for n, _ in model.named_parameters())
    leaves = []
    for name, p, _ in _trainable(model, optimizer):
        path, layout = _jax_leaf(name, p.dim(), norm_layer, bn_layout)
        leaves.append((path, p, layout))
    return {"train": optimizer}, leaves, _chain(config), False


def opt_state_to_jax(optimizer: torch.optim.Optimizer, model: torch.nn.Module, config,
                     step: int, state: Optional[Mapping] = None,
                     norm_layer: Optional[str] = None) -> Dict[str, Any]:
    """The optimizer's state (or ``state``, a snapshot of it keyed the same)
    as the JAX package's ``opt_state`` (flax state_dict form); every
    ``count`` is ``step``. Moments not allocated yet (before the first
    update) are zeros, as optax initialises them. ``norm_layer`` names the
    model's norms (default the MAE's config key; the DINO engine passes
    ``VIT.NORM_LAYER``)."""
    return _states_to_jax(*_pretrain_layout(optimizer, model, config, norm_layer), step,
                          {} if state is None else {"train": state})


def _check_keys(got: Any, want: Any, where: str) -> None:
    """The key tree of ``got`` equals ``want``'s (flax's from_state_dict is as strict)."""
    if isinstance(want, Mapping):
        if not isinstance(got, Mapping) or set(got) != set(want):
            raise ValueError(f"optimizer state {where or '/'}: keys "
                             f"{sorted(got) if isinstance(got, Mapping) else type(got).__name__}"
                             f", expected {sorted(want)}")
        for k in want:
            _check_keys(got[k], want[k], f"{where}/{k}")


def tensor_from_leaf(a: Any, like: torch.Tensor, what: str,
                     layout: str = "plain") -> torch.Tensor:
    """A checkpoint leaf as a tensor of ``like``'s shape on its device, in
    the port's layout; raises on another dtype or shape."""
    a = np.asarray(a)
    if a.dtype != np.dtype(str(like.dtype).replace("torch.", "")):
        raise CheckpointDtypeError(f"{what} is {a.dtype} in the checkpoint and {like.dtype} in "
                                   "the port; the port does not cast checkpoint leaves")
    a = _from_jax_layout(a, layout, tuple(like.shape))
    if tuple(a.shape) != tuple(like.shape):
        raise ValueError(f"{what} has shape {a.shape} in the checkpoint, {tuple(like.shape)} "
                         "in the port")
    # a copy: an unpickled array may be read-only
    return torch.from_numpy(np.array(a)).to(like.device)


def _states_from_jax(tree: Mapping[str, Any], branches, leaves, kinds, clip_outside: bool,
                     step: int) -> None:
    """Fill each branch's optimizer from a ``_multi_transform`` tree, after
    checking its keys (as flax's ``from_state_dict`` does) and every count."""
    _check_keys(tree, _multi_transform(branches, leaves, kinds, clip_outside, None,
                                       lambda *_: None), "")
    new_states = {}
    for label, opt in branches.items():
        if opt is None:
            continue
        chain = tree["inner_states"][label]["inner_state"]
        chain = chain["1"] if clip_outside else chain
        held = _held(opt)
        mine = [(path, p, layout) for path, p, layout in leaves if id(p) in held]
        state: Dict[torch.Tensor, Dict[str, torch.Tensor]] = {p: {} for _, p, _ in mine}
        for i, kind in enumerate(kinds):
            entry = chain[str(i)]
            if "count" in entry and int(np.asarray(entry["count"])) != step:
                raise ValueError(f"optimizer state {label}/{i}: count "
                                 f"{int(np.asarray(entry['count']))} != step {step}")
            for field, key in _MOMENTS.get(kind, {}).items():
                for path, p, layout in mine:
                    leaf = _get(entry[field], path, f"opt_state {label}/{i}/{field}")
                    state[p][key] = tensor_from_leaf(leaf, p.float(),
                                                     f"{field} of {'/'.join(path)}", layout)
            if kind == "adam":
                for _, p, _ in mine:
                    state[p]["step"] = torch.tensor(float(step), dtype=torch.float32)
        new_states[label] = state
    for label, state in new_states.items():
        opt = branches[label]
        opt.state.clear()
        for p, st in state.items():
            opt.state[p] = st


def opt_state_from_jax(tree: Mapping[str, Any], optimizer: torch.optim.Optimizer,
                       model: torch.nn.Module, config, step: int,
                       norm_layer: Optional[str] = None) -> None:
    """Fill ``optimizer.state`` from a JAX-format ``opt_state``. Raises
    ValueError or KeyError when the tree is not this optimizer's chain (as
    flax's ``from_state_dict`` does), or when a ``count`` differs from
    ``step``; CheckpointDtypeError for a leaf of another dtype."""
    _states_from_jax(tree, *_pretrain_layout(optimizer, model, config, norm_layer), step)


def downstream_params_to_jax(model_sd: Mapping[str, torch.Tensor],
                             classifier_sd: Mapping[str, torch.Tensor],
                             norm_layer: str = "layernorm") -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(params, batch_stats) of the downstream state in the JAX layout:
    ``{"model": ..., "classifier": ...}`` and ``{"classifier": ...}``."""
    return ({"model": jax_tree_from_state_dict(model_sd, norm_layer),
             "classifier": jax_tree_from_state_dict(classifier_sd, norm_layer)},
            {"classifier": batch_stats_from_state_dict(classifier_sd)})


def downstream_state_dicts_from_jax(params: Mapping[str, Any],
                                    batch_stats: Optional[Mapping[str, Any]] = None
                                    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(model state_dict, classifier state_dict with its running statistics)
    of a JAX downstream ``params`` tree and its ``batch_stats``."""
    stats = (batch_stats or {}).get("classifier", {})
    return (state_dict_from_jax(params["model"]),
            state_dict_from_jax(params["classifier"], batch_stats=stats))


def _downstream_leaves(model: torch.nn.Module, classifier: torch.nn.Module, norm_layer: str):
    """(JAX path, parameter, layout) of every leaf of the downstream tree."""
    out = []
    for top, module in (("model", model), ("classifier", classifier)):
        for name, p in module.named_parameters():
            path, layout = _jax_leaf(name, p.dim(), norm_layer)
            out.append(([top] + path, p, layout))
    return out


def _downstream_layout(branches, model, classifier, config, norm_layer: str) -> tuple:
    """The downstream ``multi_transform({"model", "classifier", "freeze"})``
    (JAX ``downstream_engine.py:150-180``): each branch the optimizer's chain,
    inside ``chain(clip_by_global_norm, ...)`` when ``GRAD_CLIP`` is set."""
    name = str(config.TRAIN.OPTIMIZER)
    if name not in _CHAINS:
        raise NotImplementedError(f"Unknown optimizer: {name}")
    return (branches, _downstream_leaves(model, classifier, norm_layer), _CHAINS[name],
            bool(config.TRAIN.GRAD_CLIP))


def downstream_opt_state_to_jax(branches: Mapping[str, Optional[torch.optim.Optimizer]],
                                model: torch.nn.Module, classifier: torch.nn.Module, config,
                                step: int, states: Optional[Mapping[str, Mapping]] = None,
                                norm_layer: str = "layernorm") -> Dict[str, Any]:
    """The downstream optimizers' state (``branches``: ``{"model": optimizer
    or None, "classifier": optimizer}``; ``states``, a snapshot of each
    optimizer's ``state`` keyed the same) as JAX's ``opt_state``; every
    ``count`` is ``step``, moments not allocated yet are zeros."""
    return _states_to_jax(*_downstream_layout(branches, model, classifier, config, norm_layer),
                          step, states or {})


def downstream_opt_state_from_jax(tree: Mapping[str, Any],
                                  branches: Mapping[str, Optional[torch.optim.Optimizer]],
                                  model: torch.nn.Module, classifier: torch.nn.Module, config,
                                  step: int, norm_layer: str = "layernorm") -> None:
    """Fill each optimizer's state from a JAX-format downstream ``opt_state``;
    ValueError or KeyError when the tree is not this state's, or a
    ``count`` differs from ``step``."""
    _states_from_jax(tree, *_downstream_layout(branches, model, classifier, config, norm_layer),
                     step)


class _Restricted(pickle.Unpickler):
    """Loads only what the pickle format holds: nested dicts and lists of
    numpy arrays and Python scalars. Any other global (torch's storage
    rebuilders, arbitrary classes) is refused without being imported; a
    ``ml_dtypes`` leaf raises CheckpointDtypeError."""

    _SAFE = {("numpy", "ndarray"), ("numpy", "dtype"),
             ("numpy.core.multiarray", "_reconstruct"), ("numpy._core.multiarray", "_reconstruct"),
             ("numpy.core.multiarray", "scalar"), ("numpy._core.multiarray", "scalar"),
             ("numpy.core.numeric", "_frombuffer"), ("numpy._core.numeric", "_frombuffer")}

    def find_class(self, module, name):
        if module.split(".")[0] == "ml_dtypes":
            raise CheckpointDtypeError(
                f"checkpoint leaf of dtype ml_dtypes.{name}: the port takes float32 and the "
                "numpy dtypes only, and casts nothing (convert the checkpoint to float32)")
        if (module, name) in self._SAFE or module == "numpy.dtypes":
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"non-native global {module}.{name} in checkpoint")


def load_native_pickle(fileobj) -> Any:
    """Unpickle a checkpoint of the pickle format through the restricted unpickler."""
    return _Restricted(fileobj).load()


def classify_checkpoint(path: str) -> Tuple[bool, Optional[Dict[str, Any]]]:
    """(is_torch, payload or None), by content: a zip (``PK``) or a pickle
    that needs other globals is a torch file; a pickle of nested dicts with
    ``params`` (or ``state_dict``) is the pickle format, returned loaded so
    that it is read once. A truncated or unreadable file is routed to
    torch's loader, whose errors say what is wrong, with a warning."""
    refuse_orbax(path)
    with open(path, "rb") as f:
        head = f.read(4)
    if head[:2] == b"PK":
        return True, None
    log = logging.getLogger(__name__)
    try:
        with open(path, "rb") as f:
            payload = load_native_pickle(f)
    except pickle.UnpicklingError as e:
        log.info("classify_checkpoint: %s routed to the torch loader (%s)", path, e)
        return True, None
    except CheckpointDtypeError:
        raise
    except Exception as e:  # truncated or corrupt: torch's loader reports it
        log.warning("classify_checkpoint: probe of %s failed with %s: %s; treating it as a "
                    "torch checkpoint", path, type(e).__name__, e)
        return True, None
    ours = isinstance(payload, dict) and ("params" in payload
                                          or isinstance(payload.get("state_dict"), dict))
    return (False, payload) if ours else (True, None)


# Position embeddings that a warm start interpolates to the model's grid;
# both hold patch tokens only (CLS and registers are separate parameters).
POS_EMBED_LEAVES = ("position_embeddings", "decoder_pos_embed")


def _is_cube(n: int) -> bool:
    return nth_root(int(n), 3) ** 3 == int(n)


def merge_params(target: Mapping[str, torch.Tensor], source: Mapping[str, Any]
                 ) -> Tuple[Dict[str, torch.Tensor], List[str], List[str]]:
    """strict=False merge of ``source`` into the state_dict ``target``:
    (merged, missing keys, unexpected keys). A leaf is taken where its name
    and shape match and cast to the target's dtype, as torch's
    ``load_state_dict`` copies. A position embedding of another grid (both
    token counts cubes, the same width) is interpolated to the target's
    (JAX ``:186-272``; reference: main_pretrain_mae.py:132); any other shape
    mismatch is reported as unexpected."""
    merged, missing, unexpected = dict(target), [], []
    for name, t in target.items():
        if name not in source:
            missing.append(name)
            continue
        v = torch.as_tensor(np.asarray(source[name])) if not isinstance(
            source[name], torch.Tensor) else source[name]
        if tuple(v.shape) != tuple(t.shape):
            if (name.rsplit(".", 1)[-1] in POS_EMBED_LEAVES and v.dim() == t.dim() == 3
                    and v.shape[0] == t.shape[0] == 1 and v.shape[-1] == t.shape[-1]
                    and _is_cube(v.shape[1]) and _is_cube(t.shape[1])):
                v = interpolate_pos_embed(v.float(), 0, new_num_patches=t.shape[1])
            else:
                unexpected.append(f"{name} (shape {tuple(v.shape)} != {tuple(t.shape)})")
                continue
        merged[name] = v.to(dtype=t.dtype, device=t.device)
    unexpected += [k for k in source if k not in target]
    return merged, missing, unexpected


def state_dict_of_payload(payload: Mapping[str, Any], state_key: str = "state_dict",
                          into: Optional[Mapping[str, Any]] = None) -> Dict[str, Any]:
    """The weights of a pickle-format payload as a reference-named
    state_dict: the JAX tree under ``state_key`` or ``params`` (a DINO
    checkpoint's ``backbone`` when ``into`` has no such key), its trunks
    per block when a ``PIPE`` run stacked them."""
    from headct_foundation_tpu_torch.parallel.pipeline import unstack_if_pipelined

    tree = payload.get(state_key, payload.get("params", payload))
    if isinstance(tree, Mapping) and set(tree) == {"backbone", "head"} and not any(
            k.startswith("backbone.") for k in (into or {})):
        tree = tree["backbone"]
    # a PIPE checkpoint's stacked trunks, per block (JAX :490-495), so that
    # no trunk weight is left out of the merge
    return state_dict_from_jax(unstack_if_pipelined(tree))


def _backbone_prefixed(source: Mapping[str, Any], target: Mapping[str, Any]) -> Dict[str, Any]:
    """A stripped reference state_dict for a ``{backbone, head}`` model (the
    DINO student or teacher): every name outside ``head.`` goes back under
    ``backbone.``, which ``strip_prefixes`` took off."""
    if not any(k.startswith("backbone.") for k in target):
        return dict(source)
    return {k if k.startswith("head.") or k in target else f"backbone.{k}": v
            for k, v in source.items()}


def load_pretrained_into(model: torch.nn.Module, checkpoint_path: str,
                         state_key: str = "state_dict", logger=None) -> Tuple[List[str], List[str]]:
    """strict=False warm start of ``model`` from a reference ``.pt`` or a
    pickle of either package, routed by content (reference load_model,
    src/utils/misc.py:72-96). Returns (missing, unexpected)."""
    target = model.state_dict()
    is_torch, payload = classify_checkpoint(checkpoint_path)
    if is_torch:
        source: Mapping[str, Any] = _backbone_prefixed(
            load_reference_checkpoint(checkpoint_path, key=state_key), target)
    else:
        source = state_dict_of_payload(payload, state_key, into=target)
    merged, missing, unexpected = merge_params(target, source)
    model.load_state_dict(merged)
    if logger:
        logger.info(f"Loaded pretrained weights from {checkpoint_path}: {len(missing)} missing, "
                    f"{len(unexpected)} unexpected keys")
        if missing:
            logger.info(f"missing: {missing[:10]}{'...' if len(missing) > 10 else ''}")
        if unexpected:
            logger.info(f"unexpected: {unexpected[:10]}{'...' if len(unexpected) > 10 else ''}")
    return missing, unexpected
