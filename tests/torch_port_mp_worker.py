"""One rank of the port's model-parallel MAE run, for
``tests/test_torch_port_model_parallel.py`` (not a test module: it imports
the port only).

    WORLD_SIZE=4 RANK=r MASTER_ADDR=localhost MASTER_PORT=p \\
        python -m tests.torch_port_mp_worker IN.pkl OUT_DIR

``IN.pkl`` holds the config overrides (``opts``), the ``cases`` to run and
their inputs; each case starts from the seed-0 weights or the given full
``weights`` (a state dict), takes ``steps`` updates on the wire ``batches``
with the given ``draws`` (or its own), and records the losses, the
gathered first-step gradients and the gathered parameters before and
after. With ``checkpoint`` it saves the state after its steps. Rank 0
pickles the results to ``OUT_DIR/results.pkl``. With ``WORLD_SIZE`` unset
it is the one-process run of the same cases.
"""

from __future__ import annotations

import os
import pickle
import sys

import torch

from headct_foundation_tpu_torch.config import default_config
from headct_foundation_tpu_torch.engines import mae_engine
from headct_foundation_tpu_torch.ops import attention as port_attn
from headct_foundation_tpu_torch.parallel import distributed, mesh
from headct_foundation_tpu_torch.utils.checkpoint import save_checkpoint


def _gathered(model, tensors) -> dict:
    return {n: mesh.all_gather_param(n, t.detach()).clone() for n, t in tensors}


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
    grads = mae_engine.make_grad_step(augment=True, config=cfg)
    init = _gathered(state.model, state.model.named_parameters())
    losses, first_grads = [], None
    for s, wire in enumerate(case["batches"]):
        draws = None
        if case.get("draws") is not None:
            draws = [{k: torch.as_tensor(v) if not isinstance(v, dict) else
                      {kk: torch.as_tensor(vv) for kk, vv in v.items()}
                      for k, v in case["draws"][s].items()}]
        loss = grads(state, torch.from_numpy(wire), 0, draws)
        losses.append(loss.item())
        if s == 0:
            first_grads = _gathered(state.model, [(n, p.grad) for n, p in
                                                  state.model.named_parameters()
                                                  if p.grad is not None])
        mae_engine.apply_update(state)
    out = {"losses": losses, "grads": first_grads, "init": init, "seed_init": seed_init,
           "params": _gathered(state.model, state.model.named_parameters())}
    if case.get("checkpoint"):
        out["checkpoint"] = save_checkpoint(state, 0, 1.0, out_dir, f"{case['name']}.pkl")
    return out


def main(in_path: str, out_dir: str) -> None:
    with open(in_path, "rb") as f:
        job = pickle.load(f)
    distributed.init_from_env("cpu", config=config(job["opts"]))
    port_attn.set_attention_backend("kernel")  # the blocked branch, plain versions on the CPU
    try:
        results = {c["name"]: run_case(c, job["opts"], out_dir, job.get("grid"))
                   for c in job["cases"]}
        if distributed.rank() == 0:
            with open(os.path.join(out_dir, "results.pkl"), "wb") as f:
                pickle.dump(results, f)
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
