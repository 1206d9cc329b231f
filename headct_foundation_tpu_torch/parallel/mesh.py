"""The port's device mesh: this process's place on the JAX package's
``("data", "fsdp", "seq", "pipe", "tensor")`` mesh, one ``torch.distributed``
group per axis, and the tensor split of the parameters.

Port of the JAX package's ``parallel/mesh.py`` (its ``:44-156``), with its
axis names and rule table copied, not imported:

* ``make_mesh`` lays the ranks out as JAX lays out devices,
  ``reshape(data, fsdp, seq, pipe, tensor)`` in rank order (the ``tensor``
  coordinate varies fastest), and builds, on every rank, one group for
  each axis above 1 (the ranks that differ only in that
  coordinate), and the ``batch`` group (the ranks that differ only in
  ``data`` and ``fsdp``: JAX's ``batch_sharding`` splits the batch over
  both); ``data = -1`` takes what the world leaves. ``pipe`` above 1 takes
  ``fsdp``, ``seq`` and ``tensor`` at 1 only (JAX ``parallel/pipeline.py:149-153``:
  its stages would need collectives of their own); the ``pipe`` ranks of a
  data slice take the same batch (``parallel/pipeline.py``).
* ``current()`` is the process's mesh (``set_mesh``; a mesh of 1s before
  any), read by the attention dispatch, the dropout masks, the Megatron
  linears and the MAE engine.
* ``token_shard(T)`` marks a trunk whose tokens are split over ``seq``: each
  rank holds ``tokens_per_rank(T, s)`` = ceil(T / s) of the T real tokens
  (the last rank's tail is padding); ``current_tokens()`` reads it.
* ``global_dropout(row_groups)`` makes every dropout mask the one a single
  process would draw for the global batch, of which each rank takes its
  slice (``dropout_slice``): its rows over ``data`` x ``fsdp``, its tokens over
  ``seq``, its columns of a column-parallel output over ``tensor``.
  ``row_groups`` > 1 says the local batch is that many blocks of rows (the
  DINO crops), each block sliced on its own.
* ``param_sharding`` applies the rule table to a parameter's name:
  ``(dim, kind)`` for a parameter split over ``tensor``, None for a
  replicated one; ``fsdp_dim`` gives the dimension a parameter of a given
  (tensor-local) shape is split along over ``fsdp``, or None.
  ``split_param`` / ``join_params`` cut a full tensor into rank ``i``'s part
  and put the parts back, exactly, over ``tensor`` (``kind`` "qkv" is the
  head-aligned split of the fused [3C, C] projection: heads h H/t .. (h+1)
  H/t of q, of k and of v; "even" an even split along ``dim``) or, with
  ``axis="fsdp"``, over ``fsdp`` (an even split along ``fsdp_dim``). The
  ``fsdp`` split is taken of the ``tensor`` part, along another dimension.
  ``shard_param`` / ``all_gather_param`` go from the full tensor to this
  rank's shard and back over both axes.
"""

from __future__ import annotations

import contextlib
import re
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

MESH_AXES = ("data", "fsdp", "seq", "pipe", "tensor")


@dataclass
class Mesh:
    """This process's coordinates and groups on the mesh."""

    sizes: Dict[str, int] = field(default_factory=lambda: {a: 1 for a in MESH_AXES})
    coords: Dict[str, int] = field(default_factory=lambda: {a: 0 for a in MESH_AXES})
    groups: Dict[str, Optional[object]] = field(default_factory=dict)

    def size(self, axis: str) -> int:
        return int(self.sizes[axis])

    def coord(self, axis: str) -> int:
        return int(self.coords[axis])

    def group(self, axis: str):
        """The axis's process group; None when the axis is 1."""
        return self.groups.get(axis)

    @property
    def sharded(self) -> bool:
        """True when ``fsdp``, ``seq`` or ``tensor`` is above 1."""
        return any(self.size(a) > 1 for a in ("fsdp", "seq", "tensor"))

    @property
    def batch_size(self) -> int:
        """The ranks over which the batch is split: ``data`` x ``fsdp``."""
        return self.size("data") * self.size("fsdp")

    @property
    def batch_coord(self) -> int:
        """This rank's slice of the batch (``data`` major, as JAX's
        ``P(("data", "fsdp"))`` lays it out)."""
        return self.coord("data") * self.size("fsdp") + self.coord("fsdp")


_MESH = Mesh()
_CTX = threading.local()


def current() -> Mesh:
    return _MESH


def set_mesh(mesh: Optional[Mesh]) -> Mesh:
    """Make ``mesh`` (None: a mesh of 1s) the process's; returns the previous."""
    global _MESH
    prev, _MESH = _MESH, (mesh or Mesh())
    return prev


def layout(data: int = -1, fsdp: int = 1, tensor: int = 1, seq: int = 1, pipe: int = 1,
           world: int = 1) -> Tuple[int, ...]:
    """The mesh's (data, fsdp, seq, pipe, tensor) over ``world`` ranks
    (``data`` -1: what the world leaves); raises when they do not multiply
    to ``world``, or when ``pipe`` above 1 meets ``fsdp``, ``seq`` or
    ``tensor`` above 1."""
    if int(pipe) > 1:
        for other, n in (("fsdp", fsdp), ("seq", seq), ("tensor", tensor)):
            if int(n) != 1:
                raise ValueError(
                    f"pipeline parallelism is manual over every mesh axis; '{other}'={n} "
                    "would need in-stage collectives (PARALLEL.PIPE takes FSDP, SEQ and "
                    "TENSOR at 1)")
    inner = fsdp * seq * pipe * tensor
    if data == -1 and world % inner == 0:
        data = world // inner
    if data * inner != world:
        raise ValueError(
            f"PARALLEL.DATA x FSDP x SEQ x PIPE x TENSOR = {data} x {fsdp} x {seq} x {pipe} x "
            f"{tensor} but "
            f"the launcher started {world} processes; the port runs one process per rank")
    return (data, fsdp, seq, pipe, tensor)


def make_mesh(data: int = -1, fsdp: int = 1, tensor: int = 1, seq: int = 1, pipe: int = 1
              ) -> Mesh:
    """This rank's place on a (data, fsdp, seq, pipe, tensor) mesh over the
    process group's ranks, with its groups built. Every rank must call it
    (group creation is collective)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    shape = layout(data, fsdp, tensor, seq, pipe, world)
    sizes = dict(zip(MESH_AXES, shape))
    coords = dict(zip(MESH_AXES, (int(c) for c in np.unravel_index(rank, shape))))
    groups = {}
    ranks = np.arange(world).reshape(shape)
    for i, axis in enumerate(MESH_AXES):
        if shape[i] == 1:
            continue
        for members in np.moveaxis(ranks, i, -1).reshape(-1, shape[i]):
            # every rank creates every group, in one order
            g = dist.new_group([int(r) for r in members]) if shape[i] < world else dist.group.WORLD
            if rank in members:
                groups[axis] = g
    if shape[0] * shape[1] > 1:  # data x fsdp: the batch's ranks
        for members in ranks.reshape(shape[0] * shape[1], -1).T:
            g = dist.new_group([int(r) for r in members]) if len(members) < world \
                else dist.group.WORLD
            if rank in members:
                groups["batch"] = g
    return Mesh(sizes, coords, groups)


# ---------------------------------------------------------------------------
# Token sharding over seq, and the dropout masks' global layout.
# ---------------------------------------------------------------------------

def tokens_per_rank(t: int, s: int) -> int:
    return -(-int(t) // int(s))


def current_tokens() -> Optional[int]:
    """The real token count of the trunk being run with its tokens split
    over ``seq`` (``token_shard``), else None."""
    return getattr(_CTX, "tokens", None)


@contextlib.contextmanager
def token_shard(t: int):
    prev = current_tokens()
    _CTX.tokens = int(t)
    try:
        yield
    finally:
        _CTX.tokens = prev


@contextlib.contextmanager
def global_dropout(row_groups: int = 1):
    """Draw every dropout mask as the global batch's and take this rank's
    slice (see the module docstring)."""
    prev = getattr(_CTX, "row_groups", None)
    _CTX.row_groups = int(row_groups)
    try:
        yield
    finally:
        _CTX.row_groups = prev


def dropout_slice(shape: Sequence[int], cols_split: bool = False
                  ) -> Optional[Tuple[Tuple[int, ...], Callable]]:
    """None when a mask of ``shape`` is drawn as it is; else (the global
    shape, a function taking this rank's part of a global mask). The
    global mask keeps padded token positions (they are set to keep)."""
    groups = getattr(_CTX, "row_groups", None)
    mesh = current()
    if groups is None:
        return None
    d, r = mesh.batch_size, mesh.batch_coord
    t_real, s = current_tokens(), mesh.size("seq")
    t, c = mesh.size("tensor"), mesh.coord("tensor")
    split_tokens = t_real is not None and s > 1 and len(shape) == 3
    split_cols = cols_split and t > 1
    if d == 1 and not split_tokens and not split_cols:
        return None
    n = shape[0] // groups
    g = [groups * d * n] + list(shape[1:])
    if split_tokens:
        g[1] = t_real
    if split_cols:
        g[-1] = shape[-1] * t

    def take(mask: torch.Tensor) -> torch.Tensor:
        if d > 1:
            mask = mask.reshape(groups, d * n, *mask.shape[1:])[:, r * n:(r + 1) * n]
            mask = mask.reshape(groups * n, *mask.shape[2:])
        if split_tokens:
            tl = shape[1]
            lo = mesh.coord("seq") * tl
            part = mask[:, lo:lo + tl]
            if part.shape[1] < tl:  # the last rank's padding: kept
                pad = torch.ones((part.shape[0], tl - part.shape[1]) + tuple(part.shape[2:]),
                                 dtype=part.dtype, device=part.device)
                part = torch.cat([part, pad], dim=1)
            mask = part
        if split_cols:
            w = shape[-1]
            mask = mask[..., c * w:(c + 1) * w]
        return mask

    return tuple(g), take


# ---------------------------------------------------------------------------
# The rule table and the tensor and fsdp splits of the parameters.
# ---------------------------------------------------------------------------

# The JAX package's rules (its ``:144-156``) for the ``tensor`` axis, in the
# port's names and torch's [out, in] weight layout: (regex, dim, kind). The
# Megatron pairs are column-parallel qkv and linear1 (split over their
# outputs, biases with them) and row-parallel proj and linear2 (split over
# their inputs; their biases stay whole and are added after the all-reduce).
# The port differs from the JAX table in three ways, all forced by computing
# on the shards rather than letting XLA reshard them: the qkv split is
# head-aligned (GSPMD splits the 2304 columns evenly and reshards to heads);
# the qkv and linear1 biases are split with their columns (JAX keeps
# them whole); LoRA's up-projections of q and v (``lora_matrix_B`` [C, r])
# are split with the heads of their outputs (JAX keeps them whole). JAX's
# other tensor entries (the patch embedding, ``decoder_embed``,
# ``decoder_pred``, the DINO head) are storage layouts that XLA gathers at
# use; the port keeps those parameters whole.
_TENSOR_RULES: Tuple[Tuple[str, int, str], ...] = (
    (r"(.*\.)?attn\.qkv\.(weight|bias)$", 0, "qkv"),
    (r"(.*\.)?attn\.proj\.weight$", 1, "even"),
    (r"(.*\.)?mlp\.linear1\.(weight|bias)$", 0, "even"),
    (r"(.*\.)?mlp\.linear2\.weight$", 1, "even"),
    (r"(.*\.)?attn\.lora_[qv]\.lora_matrix_B$", 0, "even"),
)

# The JAX rules' ``fsdp`` entries, (regex, dim or None), for the 2-D weights
# (JAX's ``kernel`` leaves; every other leaf is replicated): the Megatron
# pairs' other dimension (JAX ``P("fsdp", "tensor")`` on a [in, out] kernel
# is dim 1 of the [out, in] weight), no fsdp on the kernels JAX gives to
# ``tensor`` alone, and JAX's catch-all ``.*kernel$ -> P(None, "fsdp")``
# (the output dimension) for every other weight. JAX's ``_clamp_spec``
# holds: a dimension that ``fsdp`` does not divide stays whole.
_FSDP_RULES: Tuple[Tuple[str, Optional[int]], ...] = (
    (r"(.*\.)?attn\.qkv\.weight$", 1),
    (r"(.*\.)?attn\.proj\.weight$", 0),
    (r"(.*\.)?mlp\.linear1\.weight$", 1),
    (r"(.*\.)?mlp\.linear2\.weight$", 0),
    (r"(.*\.)?patch_embeddings\.weight$", None),
    (r"(.*\.)?decoder_embed\.weight$", None),
    (r"(.*\.)?decoder_pred\.weight$", None),
    (r"(.*\.)?head\.mlp\.\d+\.weight$", None),
    (r"(.*\.)?last_layer\.weight_v$", None),
    (r".*\.weight$", 0),
)


def param_sharding(name: str) -> Optional[Tuple[int, str]]:
    """(dim, kind) of a parameter split over ``tensor``; None when whole."""
    for pattern, dim, kind in _TENSOR_RULES:
        if re.match(pattern, name):
            return dim, kind
    return None


def fsdp_dim(name: str, shape: Sequence[int], f: int) -> Optional[int]:
    """The dimension along which the parameter ``name`` of (tensor-local)
    ``shape`` is split over ``fsdp`` = ``f``; None when it stays whole."""
    if f == 1 or len(shape) != 2:
        return None
    for pattern, dim in _FSDP_RULES:
        if re.match(pattern, name):
            if dim is None or shape[dim] % f or shape[dim] < f:
                return None
            return dim
    return None


def _qkv_index(rows: int, t: int, i: int, device) -> torch.Tensor:
    """Rows of rank i's head-aligned share of a fused [3C, ...] projection."""
    c = rows // 3
    if c % t:
        raise ValueError(f"the qkv projection's {c} outputs per tensor do not split over "
                         f"tensor = {t}")
    w = c // t
    return torch.cat([torch.arange(j * c + i * w, j * c + (i + 1) * w, device=device)
                      for j in range(3)])


def _spec(name: str, axis: str, dim: Optional[int]) -> Optional[Tuple[int, str]]:
    if axis == "tensor":
        return param_sharding(name)
    return None if dim is None else (dim, "even")


def split_param(name: str, full: torch.Tensor, t: int, i: int, axis: str = "tensor",
                dim: Optional[int] = None) -> torch.Tensor:
    """Rank ``i``'s part (a fresh tensor) of the full parameter ``name``
    over ``t`` ranks of ``axis``: "tensor" (the rule table), or "fsdp"
    along ``dim`` (``fsdp_dim``; None: whole)."""
    spec = _spec(name, axis, dim)
    if spec is None or t == 1:
        return full.detach().clone()
    dim, kind = spec
    if full.shape[dim] % (3 * t if kind == "qkv" else t):
        raise ValueError(f"{name} {tuple(full.shape)} does not split over {axis} = {t}")
    if kind == "qkv":
        return full.detach().index_select(dim, _qkv_index(full.shape[dim], t, i, full.device))
    w = full.shape[dim] // t
    return full.detach().narrow(dim, i * w, w).clone()


def join_params(name: str, parts: Sequence[torch.Tensor], axis: str = "tensor",
                dim: Optional[int] = None) -> torch.Tensor:
    """The full parameter from its ranks' parts over ``axis``, in rank
    order (exact); ``split_param``'s inverse."""
    spec = _spec(name, axis, dim)
    if spec is None or len(parts) == 1:
        return parts[0].detach().clone()
    dim, kind = spec
    full = torch.cat(list(parts), dim=dim)
    if kind == "qkv":  # [q0 k0 v0 | q1 k1 v1 | ...] -> [q0 q1 .. | k0 k1 .. | v0 v1 ..]
        t, w = len(parts), parts[0].shape[dim] // 3
        order = torch.cat([torch.arange(i * 3 * w + j * w, i * 3 * w + (j + 1) * w)
                           for j in range(3) for i in range(t)]).to(full.device)
        full = full.index_select(dim, order)
    return full


def shard_param(name: str, full: torch.Tensor, mesh: Optional[Mesh] = None,
                dim: Optional[int] = None) -> torch.Tensor:
    """This rank's shard of the full parameter ``name`` (or of a tensor
    shaped like it): its ``tensor`` part, then that part's ``fsdp`` share
    along ``dim`` (its ``fsdp_dim``; None: not split);
    ``all_gather_param``'s inverse."""
    mesh = mesh or current()
    part = split_param(name, full, mesh.size("tensor"), mesh.coord("tensor"))
    return split_param(name, part, mesh.size("fsdp"), mesh.coord("fsdp"), "fsdp", dim)


def _gather(local: torch.Tensor, n: int, group) -> list:
    parts = [torch.empty_like(local) for _ in range(n)]
    dist.all_gather(parts, local.contiguous(), group=group)
    return parts


def all_gather_param(name: str, local: torch.Tensor, mesh: Optional[Mesh] = None,
                     dim: Optional[int] = None) -> torch.Tensor:
    """The full tensor of a parameter (or of a tensor shaped like it) from
    every rank's shard: over ``fsdp`` along ``dim`` (its ``fsdp_dim``; None:
    not split), then over ``tensor``; collective over both."""
    mesh = mesh or current()
    f, t = mesh.size("fsdp"), mesh.size("tensor")
    if f > 1 and dim is not None:
        local = join_params(name, _gather(local, f, mesh.group("fsdp")), "fsdp", dim)
    if t == 1 or param_sharding(name) is None:
        return local
    return join_params(name, _gather(local, t, mesh.group("tensor")))
