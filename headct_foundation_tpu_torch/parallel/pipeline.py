"""GPipe over the ``pipe`` axis, and the stacked trunk layout of its
checkpoints.

Port of the JAX package's ``parallel/pipeline.py`` (its ``:42-222``):

* ``stack_layer_params`` / ``unstack_layer_params`` / ``unstack_if_pipelined``
  / ``adapt_trunk_layout`` convert between the per-block layout (a JAX tree's
  ``blocks_{i}`` subtrees, a state dict's ``blocks.{i}.*`` names) and the
  stacked one a ``PIPE`` run's checkpoint holds (one ``blocks`` subtree, or
  ``blocks.*`` names, whose leaves carry a leading [L] layer axis), for the
  trunks ``blocks`` and ``decoder_blocks``. ``stack_trunks`` /
  ``unstack_trunks`` apply them to every subtree of a checkpoint tree (the
  parameters and each optimizer moment tree).
* ``pipeline_apply(stage_blocks, x, group, n_microbatches)`` is the fold of
  the L blocks in order. Over a ``pipe`` group of S > 1 ranks each rank holds
  its stage's L/S consecutive blocks (``keep_stage_``) and the fold runs as
  the fill-drain (GPipe) schedule of JAX ``:163-214``: the batch is cut into
  M = ``n_microbatches`` (0: S) microbatches (a tail batch zero-padded to a
  multiple of M, the padding's outputs dropped, JAX ``:168-172``, ``:214``);
  stage 0 takes microbatch m, every stage folds its blocks and sends the
  activation to the next stage (``isend`` / ``recv``); the last stage's
  outputs go to every ``pipe`` rank (a broadcast, JAX's masked ``psum``,
  ``:212-213``). The backward runs the same schedule in reverse: the last
  stage takes the cotangent of its own output (once: every rank's suffix
  gives the same one, and they are not summed), each stage sends its input's
  cotangent back, and stage 0's goes to every ``pipe`` rank, so each rank's
  prefix gradients are one process's. A stage keeps its microbatches'
  graphs from the forward, so nothing is recomputed and each attention
  kernel launches once a block and microbatch in each direction.
  The JAX scan also computes the bubble ticks (stage 0 re-ingesting a
  clamped microbatch, later stages folding zeros) and discards their
  results; the port does not launch them, which changes no result.
  S = 1 (no group) is the plain fold.
* ``emulate_pipeline(stages, x, n_microbatches)`` chains the S stages' block
  lists in one process, microbatch by microbatch, through the same per-stage
  forward and backward (``_stage_forward`` / ``_stage_backward``), for a
  card that holds every stage.
* ``gather_stages`` / ``gather_module`` / ``gather_optimizer_state`` /
  ``load_module`` give a pipelined model (its stage's blocks, numbered from
  0) the whole model's tensors under their global names and take them back.
* ``stacked_groups`` lists a stage's parameters by stacked name (the same
  leaf of each of its blocks): the per-parameter clip and Lamb take each
  stacked name's norm over all L layers, summed over the ``pipe`` group
  (JAX's norm of the stacked leaf).
* ``replicate_`` broadcasts tensors from ``pipe`` coordinate 0 over the
  ``pipe`` group: the gradients of the parameters every stage holds
  (prefix, suffix, and every parameter of the engines that do not pipeline),
  so their updates stay bit-equal across the ``pipe`` ranks.
"""

from __future__ import annotations

import contextlib
import re
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from headct_foundation_tpu_torch.parallel import mesh as mesh_lib

TRUNKS = ("blocks", "decoder_blocks")
_BLOCK = re.compile(r"^(blocks|decoder_blocks)\.(\d+)\.(.+)$")


# ---------------------------------------------------------------------------
# The stacked layout (JAX trees and state dicts).
# ---------------------------------------------------------------------------

def _stack(xs: Sequence[Any]) -> Any:
    if isinstance(xs[0], Mapping):
        return {k: _stack([x[k] for x in xs]) for k in xs[0]}
    if isinstance(xs[0], torch.Tensor):
        return torch.stack(list(xs))
    return np.stack([np.asarray(x) for x in xs])


def _index(x: Any, i: int) -> Any:
    if isinstance(x, Mapping):
        return {k: _index(v, i) for k, v in x.items()}
    return x[i]


def _is_tree(params: Mapping[str, Any]) -> bool:
    """A nested JAX tree (``blocks_{i}`` subtrees), not a flat state dict."""
    return not any("." in str(k) for k in params)


def _flat_depth(sd: Mapping[str, Any], prefix: str) -> int:
    idx = {int(m.group(2)) for k in sd for m in [_BLOCK.match(k)] if m and m.group(1) == prefix}
    return max(idx) + 1 if idx else 0


def stack_layer_params(params: Mapping[str, Any], prefix: str, n_layers: int) -> Dict[str, Any]:
    """``{prefix}_0 .. {prefix}_{n-1}`` (a tree) or ``{prefix}.{i}.*`` (a
    state dict) replaced by one ``{prefix}`` subtree (or ``{prefix}.*``
    names) whose leaves carry a leading [n_layers] axis (JAX ``:42-53``).
    The blocks must be homogeneous."""
    if _is_tree(params):
        subs = [params[f"{prefix}_{i}"] for i in range(n_layers)]
        out = {k: v for k, v in params.items()
               if not re.fullmatch(rf"{re.escape(prefix)}_\d+", str(k))}
        out[prefix] = _stack(subs)
        return out
    out, leaves = {}, {}
    for k, v in params.items():
        m = _BLOCK.match(k)
        if m and m.group(1) == prefix:
            leaves.setdefault(m.group(3), {})[int(m.group(2))] = v
        else:
            out[k] = v
    for leaf, per in leaves.items():
        out[f"{prefix}.{leaf}"] = _stack([per[i] for i in range(n_layers)])
    return out


def unstack_layer_params(params: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    """Inverse of ``stack_layer_params`` (JAX ``:56-64``)."""
    if _is_tree(params):
        stacked = params[prefix]
        first = stacked
        while isinstance(first, Mapping):
            first = next(iter(first.values()))
        out = {k: v for k, v in params.items() if k != prefix}
        for i in range(first.shape[0]):
            out[f"{prefix}_{i}"] = _index(stacked, i)
        return out
    out = {}
    for k, v in params.items():
        if k.startswith(prefix + ".") and not _BLOCK.match(k):
            for i in range(v.shape[0]):
                out[f"{prefix}.{i}.{k[len(prefix) + 1:]}"] = v[i]
        else:
            out[k] = v
    return out


def is_stacked(params: Mapping[str, Any], prefix: str) -> bool:
    """True when ``params`` holds the trunk ``prefix`` stacked."""
    if not isinstance(params, Mapping):
        return False
    if _is_tree(params):
        return prefix in params and f"{prefix}_0" not in params
    return (any(k.startswith(prefix + ".") and not _BLOCK.match(k) for k in params)
            and not any(k.startswith(prefix + ".0.") for k in params))


def _has_blocks(params: Mapping[str, Any], prefix: str) -> bool:
    if _is_tree(params):
        return f"{prefix}_0" in params
    return any(k.startswith(prefix + ".0.") for k in params)


def _depth(params: Mapping[str, Any], prefix: str) -> int:
    if not _is_tree(params):
        return _flat_depth(params, prefix)
    n = 0
    while f"{prefix}_{n}" in params:
        n += 1
    return n


def unstack_if_pipelined(params: Any) -> Any:
    """The per-block layout of a parameter tree or state dict whose trunks
    may be stacked; per-block ones pass through (JAX ``:67-79``)."""
    if not isinstance(params, Mapping):
        return params
    out = dict(params)
    for prefix in TRUNKS:
        if is_stacked(out, prefix):
            out = unstack_layer_params(out, prefix)
    return out


def adapt_trunk_layout(tree: Any, target: Any) -> Any:
    """``tree``'s trunks in ``target``'s layout (stacked or per block), for
    a name-based merge; prefixes absent from either pass (JAX ``:82-102``)."""
    if not (isinstance(tree, Mapping) and isinstance(target, Mapping)):
        return tree
    tree = dict(tree)
    for prefix in TRUNKS:
        if is_stacked(tree, prefix) and not is_stacked(target, prefix):
            tree = unstack_layer_params(tree, prefix)
        elif is_stacked(target, prefix) and _has_blocks(tree, prefix):
            tree = stack_layer_params(tree, prefix, _depth(tree, prefix))
    return tree


def stack_trunks(tree: Any) -> Any:
    """Every subtree of a checkpoint tree (the parameters, each optimizer
    moment tree) with its trunks stacked."""
    if not isinstance(tree, Mapping):
        return tree
    out = {k: stack_trunks(v) for k, v in tree.items()}
    for prefix in TRUNKS:
        if f"{prefix}_0" in out:
            out = stack_layer_params(out, prefix, _depth(out, prefix))
    return out


def unstack_trunks(tree: Any) -> Any:
    """``stack_trunks``' inverse."""
    if not isinstance(tree, Mapping):
        return tree
    out = dict(tree)
    for prefix in TRUNKS:
        if prefix in out and isinstance(out[prefix], Mapping) and f"{prefix}_0" not in out:
            out = unstack_layer_params(out, prefix)
    return {k: unstack_trunks(v) for k, v in out.items()}


def has_stacked_trunks(tree: Any) -> bool:
    """True when a parameter tree holds a trunk stacked."""
    return isinstance(tree, Mapping) and any(
        prefix in tree and f"{prefix}_0" not in tree for prefix in TRUNKS)


# ---------------------------------------------------------------------------
# Stages.
# ---------------------------------------------------------------------------

def stage_range(depth: int, stages: int, stage: int) -> Tuple[int, int]:
    """Blocks [lo, hi) of stage ``stage`` of ``stages`` over ``depth``."""
    if depth % stages:
        raise ValueError(f"PIPE={stages} must divide depth {depth}")
    n = depth // stages
    return stage * n, (stage + 1) * n


def keep_stage_(model: nn.Module, stages: int, stage: int) -> nn.Module:
    """Keep only stage ``stage``'s blocks of each trunk of ``model`` (a
    ModuleList attribute), renumbered from 0."""
    if stages == 1:
        return model
    for prefix in TRUNKS:
        blocks = getattr(model, prefix)
        lo, hi = stage_range(len(blocks), stages, stage)
        setattr(model, prefix, nn.ModuleList(list(blocks)[lo:hi]))
    return model


def global_name(name: str, stages: int, stage: int, local_depth: Mapping[str, int]) -> str:
    """A stage-local parameter name as the whole model names it."""
    m = _BLOCK.match(name)
    if m is None or stages == 1:
        return name
    return f"{m.group(1)}.{stage * local_depth[m.group(1)] + int(m.group(2))}.{m.group(3)}"


def _local_depths(module: nn.Module) -> Dict[str, int]:
    return {p: len(getattr(module, p)) for p in TRUNKS if hasattr(module, p)}


def _pipe(mesh: Optional[mesh_lib.Mesh]) -> Tuple[int, int, Any]:
    mesh = mesh or mesh_lib.current()
    return mesh.size("pipe"), mesh.coord("pipe"), mesh.group("pipe")


def gather_stages(named: Sequence[Tuple[str, torch.Tensor]], local_depth: Mapping[str, int],
                  mesh: Optional[mesh_lib.Mesh] = None) -> Dict[str, torch.Tensor]:
    """Global name -> tensor: each stage's block tensors (the same local
    names on every ``pipe`` rank, in the same order) all-gathered over
    ``pipe``; the others (whole on every rank) as they are. Collective."""
    S, _, group = _pipe(mesh)
    out: Dict[str, torch.Tensor] = {}
    for name, t in named:
        if S == 1 or _BLOCK.match(name) is None:
            out[name] = t
            continue
        parts = [torch.empty_like(t) for _ in range(S)]
        dist.all_gather(parts, t.detach().contiguous(), group=group)
        for c, part in enumerate(parts):
            out[global_name(name, S, c, local_depth)] = part
    return out


def gather_module(module: nn.Module, meta: nn.Module,
                  mesh: Optional[mesh_lib.Mesh] = None) -> List[tuple]:
    """Fill ``meta`` (the whole model built on the meta device) with every
    stage's parameters (``gather_stages``) and ``module``'s buffers; returns
    (parameter, {global name: whole parameter}, in stage order) per
    parameter of ``module``."""
    S, _, _ = _pipe(mesh)
    depth = _local_depths(module)
    named = list(module.named_parameters())
    whole = gather_stages([(n, p.detach()) for n, p in named], depth, mesh)
    pairs = []
    for name, p in named:
        fulls = {}
        for g in dict.fromkeys(global_name(name, S, k, depth) for k in range(S)):
            fulls[g] = nn.Parameter(whole[g], requires_grad=p.requires_grad)
            owner, _, leaf = g.rpartition(".")
            setattr(meta.get_submodule(owner), leaf, fulls[g])
        pairs.append((p, fulls))
    for name, b in module.named_buffers():
        owner, _, leaf = name.rpartition(".")
        meta.get_submodule(owner)._buffers[leaf] = b
    return pairs


def gather_optimizer_state(optimizer: torch.optim.Optimizer, whole: torch.optim.Optimizer,
                           pairs: List[tuple], mesh: Optional[mesh_lib.Mesh] = None) -> None:
    """Put every stage's per-parameter optimizer state into ``whole`` (an
    optimizer over ``gather_module``'s parameters). Collective."""
    S, _, group = _pipe(mesh)
    for p, fulls in pairs:
        if p not in optimizer.state:
            continue
        per: List[Dict[str, Any]] = [{} for _ in fulls]
        for k, v in sorted(optimizer.state[p].items()):
            if isinstance(v, torch.Tensor) and v.shape == p.shape and len(fulls) > 1:
                parts = [torch.empty_like(v) for _ in range(S)]
                dist.all_gather(parts, v.contiguous(), group=group)
            else:
                parts = [v] * len(fulls)
            for st, part in zip(per, parts):
                st[k] = part
        for full, st in zip(fulls.values(), per):
            whole.state[full] = st


def load_module(module: nn.Module, whole: nn.Module, optimizer=None, whole_optimizer=None,
                mesh: Optional[mesh_lib.Mesh] = None) -> None:
    """Take this stage's blocks of ``whole`` (and their optimizer state),
    and every other parameter and buffer: ``gather_module``'s inverse."""
    S, c, _ = _pipe(mesh)
    depth = _local_depths(module)
    fulls = dict(whole.named_parameters())
    buffers = dict(whole.named_buffers())
    with torch.no_grad():
        for name, p in module.named_parameters():
            w = fulls[global_name(name, S, c, depth)]
            p.copy_(w.detach())
            if optimizer is not None:
                optimizer.state.pop(p, None)
                if whole_optimizer is not None and w in whole_optimizer.state:
                    optimizer.state[p] = {
                        k: v.detach().clone().to(p.device) if isinstance(v, torch.Tensor) else v
                        for k, v in whole_optimizer.state[w].items()}
        for name, b in module.named_buffers():
            if buffers[name] is not b:
                b.copy_(buffers[name])


def stacked_groups(module: nn.Module, mesh: Optional[mesh_lib.Mesh] = None,
                   emulated: bool = False) -> Tuple[Any, List[List[nn.Parameter]]]:
    """(``pipe`` group, the stage's parameters grouped by stacked name) at
    ``pipe`` above 1, else (None, []): each group is one JAX stacked leaf's
    share on this stage (the same leaf of each of its blocks). ``emulated``:
    ``module`` holds every stage (``emulate_pipeline``), so the groups are
    the whole stacked leaves, with no group to reduce over."""
    S, _, group = _pipe(mesh)
    if emulated:
        group = None
    elif S == 1:
        return None, []
    by_leaf: Dict[str, List[nn.Parameter]] = {}
    for name, p in module.named_parameters():
        m = _BLOCK.match(name)
        if m is not None and p.requires_grad:
            by_leaf.setdefault(f"{m.group(1)}.{m.group(3)}", []).append(p)
    return group, list(by_leaf.values())


def stacked_sq_norms(sq: torch.Tensor, params: list, stacked: Tuple[Any, list]) -> torch.Tensor:
    """Per-parameter squared norms ``sq`` [n] (or [k, n]) replaced, for the
    members of each stacked group, by the group's sum over its local layers
    and over the ``pipe`` group (one all-reduce for every group)."""
    group, lists = stacked
    if not lists:
        return sq
    pos = {id(p): i for i, p in enumerate(params)}
    idx = [[pos[id(p)] for p in members if id(p) in pos] for members in lists]
    idx = [i for i in idx if i]
    totals = torch.stack([sq[..., i].sum(-1) for i in idx], dim=-1)
    if group is not None:
        dist.all_reduce(totals, group=group)
    sq = sq.clone()
    for j, members in enumerate(idx):
        sq[..., members] = totals[..., j:j + 1]
    return sq


@torch.no_grad()
def replicate_(tensors: Sequence[torch.Tensor], mesh: Optional[mesh_lib.Mesh] = None) -> None:
    """Every tensor made ``pipe`` coordinate 0's, over the ``pipe`` group
    (one broadcast of them flattened together; a no-op at ``pipe`` 1)."""
    S, _, group = _pipe(mesh)
    tensors = [t for t in tensors if t is not None]
    if S == 1 or not tensors:
        return
    src = dist.get_global_rank(group, 0)
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.broadcast(flat, src=src, group=group)
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


# ---------------------------------------------------------------------------
# The schedule.
# ---------------------------------------------------------------------------

def fold(blocks: Sequence[nn.Module], x: torch.Tensor) -> torch.Tensor:
    """The blocks applied in order."""
    for blk in blocks:
        x = blk(x)
    return x


def _params(blocks: Sequence[nn.Module]) -> List[nn.Parameter]:
    return [p for blk in blocks for p in blk.parameters() if p.requires_grad]


def _stage_forward(blocks: Sequence[nn.Module], x: torch.Tensor, grad: bool,
                   needs_input_grad: bool) -> Tuple[torch.Tensor, Optional[tuple]]:
    """One stage on one microbatch: (output, what its backward needs, or
    None without grad)."""
    if not grad:
        with torch.no_grad():
            return fold(blocks, x), None
    inp = x.detach().requires_grad_(needs_input_grad)
    with torch.enable_grad():
        out = fold(blocks, inp)
    return out.detach(), (inp, out)


def _stage_backward(blocks: Sequence[nn.Module], saved: tuple, dy: torch.Tensor,
                    acc: List[Optional[torch.Tensor]]) -> Optional[torch.Tensor]:
    """One stage's backward on one microbatch: its parameters' gradients
    added into ``acc``; returns the input's cotangent (None when the input
    needs none)."""
    inp, out = saved
    params = _params(blocks)
    wrt = ([inp] if inp.requires_grad else []) + params
    grads = torch.autograd.grad(out, wrt, dy, allow_unused=True)
    dx = grads[0] if inp.requires_grad else None
    for i, g in enumerate(grads[len(wrt) - len(params):]):
        if g is not None:
            acc[i] = g if acc[i] is None else acc[i] + g
    return dx


def _microbatches(x: torch.Tensor, m: int) -> Tuple[List[torch.Tensor], int]:
    """``x`` zero-padded to a multiple of ``m`` rows and cut into ``m``."""
    b = x.shape[0]
    b_pad = -(-b // m) * m
    if b_pad != b:
        x = torch.cat([x, x.new_zeros((b_pad - b,) + tuple(x.shape[1:]))])
    return list(x.chunk(m)), b


class _Pipeline(torch.autograd.Function):
    """The distributed schedule (see the module docstring); the parameters
    are inputs so that their gradients come back through autograd."""

    @staticmethod
    def forward(ctx, x, blocks, group, m, *params):
        ys, saved = _schedule_forward(blocks, x, group, m, True, ctx.needs_input_grad[0])
        ctx.blocks, ctx.group, ctx.saved, ctx.m = blocks, group, saved, m
        ctx.shape = x.shape
        return ys

    @staticmethod
    def backward(ctx, gy):
        dx, grads = _schedule_backward(ctx.blocks, ctx.group, ctx.saved, gy, ctx.m,
                                       ctx.needs_input_grad[0], ctx.shape)
        ctx.saved = None
        return (dx, None, None, None, *grads)


def _ranks(group) -> Tuple[int, int, Callable[[int], int]]:
    S, r = dist.get_world_size(group), dist.get_rank(group)
    return S, r, lambda i: dist.get_global_rank(group, i)


def _schedule_forward(blocks, x, group, m, grad, needs_input_grad):
    S, r, glob = _ranks(group)
    mbs, b = _microbatches(x, m)
    ys, saved, sends = [], [], []
    for i in range(m):
        if r == 0:
            inp = mbs[i]
        else:
            inp = torch.empty_like(mbs[i])
            dist.recv(inp, src=glob(r - 1), group=group)
        y, keep = _stage_forward(blocks, inp, grad, needs_input_grad or r > 0)
        saved.append(keep)
        if r < S - 1:
            y = y.contiguous()  # kept alive in ``sends`` until its send completes
            sends.append((dist.isend(y, dst=glob(r + 1), group=group), y))
        else:
            ys.append(y)
    for work, _ in sends:
        work.wait()
    out = torch.cat(ys) if r == S - 1 else x.new_empty((len(mbs) * mbs[0].shape[0],)
                                                        + tuple(x.shape[1:]))
    dist.broadcast(out, src=glob(S - 1), group=group)
    return out[:b], saved


def _schedule_backward(blocks, group, saved, gy, m, needs_input_grad, shape):
    S, r, glob = _ranks(group)
    acc: List[Optional[torch.Tensor]] = [None] * len(_params(blocks))
    gys, b = _microbatches(gy.contiguous(), m)
    dxs: List[Optional[torch.Tensor]] = [None] * m
    sends = []
    for i in reversed(range(m)):
        if r == S - 1:
            dy = gys[i]
        else:
            dy = torch.empty_like(gys[i])
            dist.recv(dy, src=glob(r + 1), group=group)
        dx = _stage_backward(blocks, saved[i], dy, acc)
        saved[i] = None
        if r > 0:
            dx = dx.contiguous()
            sends.append((dist.isend(dx, dst=glob(r - 1), group=group), dx))
        else:
            dxs[i] = dx
    for work, _ in sends:
        work.wait()
    dx = None
    if needs_input_grad:
        dx = torch.cat(dxs) if r == 0 else gy.new_empty((m * gys[0].shape[0],)
                                                        + tuple(shape[1:]))
        dist.broadcast(dx, src=glob(0), group=group)
        dx = dx[:b]
    return dx, acc


def pipeline_apply(stage_blocks: Sequence[nn.Module], x: torch.Tensor, group=None,
                   n_microbatches: int = 0) -> torch.Tensor:
    """The L blocks folded over ``x`` [B, T, D], pipelined over the ``pipe``
    ``group`` (None: one stage, the plain fold); this rank holds
    ``stage_blocks``. Differentiable (see the module docstring)."""
    if group is None or dist.get_world_size(group) == 1:
        return fold(stage_blocks, x)
    m = int(n_microbatches) or dist.get_world_size(group)
    blocks = list(stage_blocks)
    if not torch.is_grad_enabled():
        return _schedule_forward(blocks, x, group, m, False, False)[0]
    return _Pipeline.apply(x, blocks, group, m, *_params(blocks))


class _Emulated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, stages, m, on_stage, *params):
        mbs, b = _microbatches(x, m)
        saved = [[None] * m for _ in stages]
        ys = []
        for i in range(m):
            h = mbs[i]
            for s, blocks in enumerate(stages):
                with on_stage(s):
                    h, saved[s][i] = _stage_forward(blocks, h, True,
                                                    ctx.needs_input_grad[0] or s > 0)
            ys.append(h)
        ctx.stages, ctx.m, ctx.on_stage, ctx.saved = stages, m, on_stage, saved
        return torch.cat(ys)[:b]

    @staticmethod
    def backward(ctx, gy):
        stages, m = ctx.stages, ctx.m
        gys, b = _microbatches(gy.contiguous(), m)
        accs = [[None] * len(_params(blocks)) for blocks in stages]
        dxs = []
        for i in reversed(range(m)):
            d = gys[i]
            for s in reversed(range(len(stages))):
                with ctx.on_stage(s):
                    d = _stage_backward(stages[s], ctx.saved[s][i], d, accs[s])
                ctx.saved[s][i] = None
            dxs.append(d)
        dx = torch.cat(dxs[::-1])[:b] if ctx.needs_input_grad[0] else None
        return (dx, None, None, None, *[g for acc in accs for g in acc])


def emulate_pipeline(stages: Sequence[Sequence[nn.Module]], x: torch.Tensor,
                     n_microbatches: int = 0,
                     on_stage: Optional[Callable[[int], Any]] = None) -> torch.Tensor:
    """``pipeline_apply`` with its S stages (``stages[s]``, each a list of
    blocks) in this process, chained microbatch by microbatch through the
    same per-stage forward and backward. ``on_stage(s)`` gives a context
    entered around each of stage ``s``'s forward and backward calls."""
    stages = [list(s) for s in stages]
    m = int(n_microbatches) or len(stages)
    on_stage = on_stage or (lambda s: contextlib.nullcontext())
    if not torch.is_grad_enabled():
        mbs, b = _microbatches(x, m)
        outs = []
        for h in mbs:
            for s, blocks in enumerate(stages):
                with on_stage(s):
                    h = _stage_forward(blocks, h, False, False)[0]
            outs.append(h)
        return torch.cat(outs)[:b]
    params = [p for blocks in stages for p in _params(blocks)]
    return _Emulated.apply(x, stages, m, on_stage, *params)


def split_stages(blocks: Sequence[nn.Module], stages: int) -> List[List[nn.Module]]:
    """A whole trunk's blocks cut into ``stages`` consecutive stages."""
    blocks = list(blocks)
    return [blocks[slice(*stage_range(len(blocks), stages, s))] for s in range(stages)]
