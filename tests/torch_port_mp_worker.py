"""One rank of the port's model-parallel runs, for
``tests/test_torch_port_model_parallel.py``, ``tests/test_torch_port_fsdp.py``,
``tests/test_torch_port_mesh_dino.py``,
``tests/test_torch_port_mesh_downstream.py`` and
``tests/test_torch_port_pipeline.py`` (not a test module: it imports the
port only).

    WORLD_SIZE=4 RANK=r MASTER_ADDR=localhost MASTER_PORT=p \\
        python -m tests.torch_port_mp_worker IN.pkl OUT_DIR

``IN.pkl`` holds the config overrides (``opts``), the ``cases`` to run and
their inputs; each case starts from the seed-0 weights or the given full
``weights`` (a state dict), takes ``steps`` updates on the wire ``batches``
with the given ``draws`` (or its own), and records the losses, the
gathered first-step gradients and the gathered parameters before and
after. With ``checkpoint`` it saves the state after its steps, with
``resume`` it starts from that checkpoint file, with ``warm_start`` (MAE)
from its parameters through ``load_pretrained_into``. A case's ``engine`` is
"mae" (the default), "dino", "downstream" or "toy" (``pipeline_apply`` on
the toy layers of ``tests/test_pipeline.py``); its ``mesh_opts`` (PARALLEL
keys) lay out a mesh of its own over the launch's ranks, and its
``opts_base`` replaces the launch's ``opts``. A MAE case with
``augment`` False takes its ``draws`` of mask noise alone; under ``pipe``
its tensors are gathered from every stage under their global names. Rank 0 pickles
the results to ``OUT_DIR/results.pkl``. With ``WORLD_SIZE`` unset it is the
one-process run of the same cases (``mesh_opts`` left out).
"""

from __future__ import annotations

import gc
import os
import pickle
import sys
import time
import weakref

import torch

from headct_foundation_tpu_torch.config import default_config
from headct_foundation_tpu_torch.engines import dino_engine, downstream_engine, mae_engine
from headct_foundation_tpu_torch.ops import attention as port_attn
from headct_foundation_tpu_torch.parallel import comm, distributed, fsdp, mesh, pipeline
from headct_foundation_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    restore_dino_state,
    restore_downstream_state,
    restore_state,
    save_checkpoint,
)
from headct_foundation_tpu_torch.utils.torch_interop import load_pretrained_into

DINO_STEPS = dict(total_steps=20, num_warmup_steps=0, niter_per_ep=5)
MOMENTUM, TEMP = 0.99, 0.04


def _stages(model) -> dict:
    """The local depth of each trunk of a pipelined MAE (``pipe`` above 1)."""
    if mesh.current().size("pipe") == 1 or not hasattr(model, "decoder_blocks"):
        return {}
    return {p: len(getattr(model, p)) for p in pipeline.TRUNKS}


def _gathered(model, tensors) -> dict:
    depth = _stages(model)
    if depth:
        return {n: t.detach().clone() for n, t in pipeline.gather_stages(
            [(n, t.detach()) for n, t in tensors], depth).items()}
    dims = fsdp.sharded_dims(model)
    return {n: mesh.all_gather_param(n, t.detach(), dim=dims.get(n)).clone()
            for n, t in tensors}


def moments(model, optimizer) -> dict:
    """The optimizer's per-parameter tensors, gathered whole, by name."""
    depth = _stages(model)
    if depth:
        held = [(n, p) for n, p in model.named_parameters() if p in optimizer.state]
        out: dict = {}
        for k in sorted(optimizer.state[held[0][1]]) if held else ():
            named = [(n, optimizer.state[p][k]) for n, p in held
                     if optimizer.state[p][k].shape == p.shape]
            for n, v in pipeline.gather_stages(named, depth).items():
                out.setdefault(n, {})[k] = v.clone()
        return out
    dims = fsdp.sharded_dims(model)
    return {n: {k: mesh.all_gather_param(n, v, dim=dims.get(n)).clone()
                for k, v in sorted(optimizer.state[p].items()) if v.shape == p.shape}
            for n, p in model.named_parameters() if p in optimizer.state}


def held_bytes(module, optimizers) -> dict:
    """This rank's parameter and optimizer-state bytes."""
    opt = sum(v.numel() * v.element_size() for o in optimizers if o is not None
              for st in o.state.values() for v in st.values()
              if isinstance(v, torch.Tensor) and v.dim())
    return {"params": sum(p.numel() * p.element_size() for p in module.parameters()),
            "optimizer": opt}


def still_alive(refs, settle: float = 20.0) -> int:
    """How many of ``refs`` still point at a tensor once c10d has let go of
    its collectives. A gloo collective's work object holds its output
    tensor until c10d's worker thread drops the work, which it may do after
    ``wait()`` has returned to the caller: now and then a moment later on
    an idle machine, and later still on a loaded one. The calling thread
    waits here, so a tensor freed within ``settle`` seconds was held by no
    code of the port."""
    deadline = time.monotonic() + settle
    while True:
        gc.collect()
        n = sum(r() is not None for r in refs)
        if not n or time.monotonic() > deadline:
            return n
        time.sleep(0.01)


def watch_gathers(module) -> dict:
    """Count the whole weights that the ``fsdp`` hooks gather until the end
    of ``module``'s first forward, and how many of them are still alive
    there (none should be: each is freed once its Linear has run, and
    autograd keeps its shard to gather it again). Empty without fsdp."""
    out: dict = {}
    if not fsdp.sharded_dims(module):
        return out
    seen, gather = [], comm.gather_shards

    def recording(*args, **kwargs):
        full = gather(*args, **kwargs)
        seen.append(weakref.ref(full))
        return full

    def after_forward(mod, args, output):
        if not out:
            comm.gather_shards = gather
            out.update(gathered=len(seen), alive=still_alive(seen))

    comm.gather_shards = recording
    module.register_forward_hook(after_forward)
    return out


def all_ranks(value):
    """``value`` of every rank, in rank order ([value] in one process)."""
    if distributed.world() == 1:
        return [value]
    out = [None] * distributed.world()
    torch.distributed.all_gather_object(out, value)
    return out


def config(opts: list, grid=None):
    """The config of ``opts``, with ``grid`` (a non-cubic MAE.INPUT_SIZE
    and MODEL.ROI, which ``--opts`` cannot give) set after."""
    cfg = default_config()
    cfg.merge_from_list(list(opts))
    if grid is not None:
        cfg.MAE.INPUT_SIZE = cfg.MODEL.ROI = list(grid)
    return cfg


def run_case(case: dict, opts: list, out_dir: str, grid=None) -> dict:
    cfg = config(list(opts) + list(case.get("opts", [])), grid)
    state, _ = mae_engine.create_train_state(cfg, case["total_steps"], case["warmup"], seed=0,
                                             dtype=torch.float32, device="cpu")
    seed_init = _gathered(state.model, state.model.named_parameters())
    if case.get("weights") is not None:
        full = state.full_view()
        full.model.load_state_dict(case["weights"])
        state.load_full(full)
    if case.get("resume") is not None:
        full, _, _ = restore_state(state.full_view(), load_checkpoint(case["resume"]))
        state.load_full(full)
    if case.get("warm_start") is not None:  # the CLI's params-only start
        full = state.full_view()
        load_pretrained_into(full.model, case["warm_start"])
        state.load_full(full)
    grads = mae_engine.make_grad_step(augment=case.get("augment", True), config=cfg)
    watch = watch_gathers(state.model)
    init = _gathered(state.model, state.model.named_parameters())
    init_moments = moments(state.model, state.optimizer)
    losses, first_grads = [], None
    n = len(case["batches"][0]) // distributed.data_world()
    lo, hi = distributed.data_rank() * n, (distributed.data_rank() + 1) * n
    for s, wire in enumerate(case["batches"]):
        draws = None
        if case.get("draws") is not None:
            draws = [{k: _slice(v, slice(lo, hi)) if not isinstance(v, dict) else
                      {kk: torch.as_tensor(vv)[..., lo:hi] for kk, vv in v.items()}
                      for k, v in case["draws"][s].items()}]  # augment: the batch last
        loss = grads(state, torch.from_numpy(wire[lo:hi]), 0, draws)
        losses.append(loss.item())
        if s == 0:
            first_grads = _gathered(state.model, [(n, p.grad) for n, p in
                                                  state.model.named_parameters()
                                                  if p.grad is not None])
        mae_engine.apply_update(state)
    out = {"losses": losses, "grads": first_grads, "init": init, "seed_init": seed_init,
           "params": _gathered(state.model, state.model.named_parameters()),
           "bytes": all_ranks(held_bytes(state.model, [state.optimizer])),
           "moments": moments(state.model, state.optimizer), "init_moments": init_moments,
           "whole_alive": all_ranks(watch)}
    if case.get("checkpoint"):
        out["checkpoint"] = save_checkpoint(state, 0, 1.0, out_dir, f"{case['name']}.pkl")
    return out


def _slice(x, rows):
    """``x``'s rows (a slice or a strided range) of a batch-first draw, or
    of each tensor of a dict or list of them."""
    if isinstance(x, dict):
        return {k: _slice(v, rows) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_slice(v, rows) for v in x]
    return torch.as_tensor(x)[rows]


def _whole_state(state, weights: dict):
    """Load full state dicts (by attribute: "student", "model", ...) into a
    state's ``full_view`` and take this rank's shards back."""
    full = state.full_view()
    for attr, sd in weights.items():
        getattr(full, attr).load_state_dict(sd)
    return state.load_full(full)


def _buffers(module) -> dict:
    return {n: b.detach().clone() for n, b in module.named_buffers()}


def run_dino_case(case: dict, opts: list, out_dir: str, grid=None) -> dict:
    cfg = config(list(opts) + list(case.get("opts", [])))
    state = dino_engine.create_train_state(cfg, **DINO_STEPS, seed=0, dtype=torch.float32,
                                           device="cpu")
    if case.get("weights") is not None:
        _whole_state(state, case["weights"])
    if case.get("resume") is not None:
        full, _, _ = restore_dino_state(state.full_view(), load_checkpoint(case["resume"]))
        state.load_full(full)
    grads = dino_engine.make_grad_step(cfg)
    watch = watch_gathers(state.student)
    init = _gathered(state.student, state.student.named_parameters())
    init_moments = moments(state.student, state.optimizer)
    n = len(case["batches"][0]) // distributed.data_world()
    rows = slice(distributed.data_rank() * n, (distributed.data_rank() + 1) * n)
    losses, first_grads = [], None
    for s, wire in enumerate(case["batches"]):
        draws = None if case.get("draws") is None else _slice(case["draws"][s], rows)
        loss, t_mean = grads(state, torch.from_numpy(wire[rows]), 0, TEMP, draws)
        losses.append(loss.item())
        if s == 0:
            first_grads = _gathered(state.student, [
                (n_, p.grad) for n_, p in state.student.named_parameters() if p.grad is not None])
        dino_engine.apply_update(state, MOMENTUM, False, t_mean)
    out = {"losses": losses, "grads": first_grads, "init": init,
           "params": _gathered(state.student, state.student.named_parameters()),
           "teacher": _gathered(state.teacher, state.teacher.named_parameters()),
           "center": state.center.clone(), "stats": _buffers(state.student),
           "bytes": all_ranks(held_bytes(state.student, [state.optimizer])),
           "moments": moments(state.student, state.optimizer), "init_moments": init_moments,
           "whole_alive": all_ranks(watch)}
    if case.get("checkpoint"):
        out["checkpoint"] = save_checkpoint(state, 0, 1.0, out_dir, f"{case['name']}.pkl")
    return out


def run_downstream_case(case: dict, opts: list, out_dir: str, grid=None) -> dict:
    cfg = config(list(opts) + list(case.get("opts", [])))
    state = downstream_engine.create_train_state(cfg, 20, 1, seed=0, dtype=torch.float32,
                                                 device="cpu")
    if case.get("weights") is not None:
        _whole_state(state, case["weights"])
    if case.get("resume") is not None:
        full, _, _ = restore_downstream_state(state.full_view(),
                                              load_checkpoint(case["resume"]))
        state.load_full(full)
    grads = downstream_engine.make_grad_step(cfg, compute_dtype=torch.float32)
    watch = watch_gathers(state.model)
    named = lambda: [(f"{k}.{n}", p) for k in ("model", "classifier")  # noqa: E731
                     for n, p in getattr(state, k).named_parameters()]

    def gathered(tensors) -> dict:
        out = {}
        for k in ("model", "classifier"):
            part = [(n[len(k) + 1:], t) for n, t in tensors if n.startswith(k + ".")]
            out.update({f"{k}.{n}": t for n, t in _gathered(getattr(state, k), part).items()})
        return out

    init = gathered(named())
    stats0 = {f"classifier.{n}": b for n, b in _buffers(state.classifier).items()}
    rows = slice(distributed.data_rank(), None, distributed.data_world())  # the r::n sampler
    losses, first_grads = [], None
    for s, (wire, target) in enumerate(zip(case["batches"], case["targets"])):
        draws = None
        if case.get("draws") is not None:
            draws = {"augment": {k: torch.as_tensor(v)[..., rows]
                                 for k, v in case["draws"][s]["augment"].items()}}
        loss, _ = grads(state, torch.from_numpy(wire[rows]), torch.from_numpy(target[rows]), 0,
                        draws)
        losses.append(loss.item())
        if s == 0:
            first_grads = gathered([(n, p.grad) for n, p in named() if p.grad is not None])
        downstream_engine.apply_update(state)
    out = {"losses": losses, "grads": first_grads, "init": init, "params": gathered(named()),
           "stats0": stats0,
           "stats": {f"classifier.{n}": b for n, b in _buffers(state.classifier).items()},
           "bytes": all_ranks(held_bytes(
               torch.nn.ModuleList([state.model, state.classifier]),
               [state.model_optimizer, state.classifier_optimizer])),
           "whole_alive": all_ranks(watch)}
    if case.get("checkpoint"):
        out["checkpoint"] = save_checkpoint(state, 0, 1.0, out_dir, f"{case['name']}.pkl")
    return out


class Toy(torch.nn.Module):
    """One toy layer of ``tests/test_pipeline.py``: tanh(x w + b)."""

    def __init__(self, w, b):
        super().__init__()
        self.w = torch.nn.Parameter(torch.as_tensor(w).clone())
        self.b = torch.nn.Parameter(torch.as_tensor(b).clone())

    def forward(self, x):
        return torch.tanh(x @ self.w + self.b)


def run_toy_case(case: dict, opts: list, out_dir: str, grid=None) -> dict:
    """``pipeline_apply`` of the stage's toy layers over this launch's
    ``pipe`` group in ``micro`` microbatches: the output, and the gradients
    of sum(out * w) for ``x`` and every layer (gathered by stage)."""
    m = mesh.current()
    lo, hi = pipeline.stage_range(len(case["ws"]), m.size("pipe"), m.coord("pipe"))
    blocks = [Toy(case["ws"][i], case["bs"][i]) for i in range(lo, hi)]
    x = torch.as_tensor(case["x"]).clone().requires_grad_()
    out = pipeline.pipeline_apply(blocks, x, m.group("pipe"), case["micro"])
    (out * torch.as_tensor(case["w"])).sum().backward()
    with torch.no_grad():
        evaluated = pipeline.pipeline_apply(blocks, torch.as_tensor(case["x"]), m.group("pipe"),
                                            case["micro"])
    named = [(f"blocks.{i}.{k}", getattr(b, k).grad) for i, b in enumerate(blocks)
             for k in ("w", "b")]
    grads = pipeline.gather_stages(named, {"blocks": hi - lo})
    n = len(case["ws"])
    return {"out": out.detach(), "eval": evaluated, "gx": x.grad,
            "gw": torch.stack([grads[f"blocks.{i}.w"] for i in range(n)]),
            "gb": torch.stack([grads[f"blocks.{i}.b"] for i in range(n)])}


ENGINES = {"mae": run_case, "dino": run_dino_case, "downstream": run_downstream_case,
           "toy": run_toy_case}


def mesh_axes(cfg) -> dict:
    p = cfg.PARALLEL
    return dict(data=int(p.DATA), fsdp=int(p.FSDP), seq=int(p.SEQ), pipe=int(p.PIPE),
                tensor=int(p.TENSOR))


def main(in_path: str, out_dir: str) -> None:
    with open(in_path, "rb") as f:
        job = pickle.load(f)
    distributed.init_from_env("cpu", config=config(job["opts"]))
    port_attn.set_attention_backend("kernel")  # the blocked branch, plain versions on the CPU
    try:
        results = {}
        for c in job["cases"]:
            opts = list(c.get("opts_base", job["opts"])) + list(c.get("mesh_opts", []))
            if c.get("mesh_opts"):
                mesh.set_mesh(mesh.make_mesh(**mesh_axes(config(opts))))
            results[c["name"]] = ENGINES[c.get("engine", "mae")](c, opts, out_dir,
                                                                  job.get("grid"))
        if distributed.rank() == 0:
            with open(os.path.join(out_dir, "results.pkl"), "wb") as f:
                pickle.dump(results, f)
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
