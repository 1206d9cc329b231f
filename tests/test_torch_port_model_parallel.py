"""PyTorch port: the MAE step on the ``seq`` and ``tensor`` axes, on the CPU.

Four gloo processes (``tests/torch_port_mp_worker.py``) run the port's MAE
step at ``PARALLEL.SEQ 2 x TENSOR 2`` with ``PALLAS_MIN_T 16``, so both
trunks take the blocked branch (its plain versions on the CPU): each rank's
Q shard against the keys all-gathered over ``seq`` with ``kv_len``. The
grid is 2 x 5 x 7 patches of 12 (a 24 x 60 x 84 volume) at mask ratio 0.6:
the decoder has T = 71 tokens and the encoder 29, both odd, so both pad to
36 and 15 a rank. They are held against:

* JAX's ``make_train_step`` on ``make_mesh(data=1, seq=2, tensor=2)`` over
  four of the eight CPU devices (``tests/test_seq_parallel.py``'s mesh), from
  JAX's weights and with its mask and augmentation draws, at dropout 0;
* the port's one-process step on the same inputs, at dropout 0 and 0.25
  (the masks drawn by each rank as the global batch's, its slice taken) with
  ``GRAD_CLIP`` 1.0 (the clip's norm of a split parameter is over its shards),
  and with Lamb (its trust ratio's two norms over the shards too).

Limits (float32): the loss within 1e-5 relative; the first step's gradients
and the two AdamW updates (parameters after less before), each tensor
normwise within 1e-4 (``||a - b|| / ||b||``), without a qkv bias's key third,
whose gradient is 0 but for rounding (``optim.optimizers.without_key_bias``).
Measured on the CPU: against JAX's mesh step the gradients at most 3.8e-7
and the updates 4.6e-5 apart, the second loss 2.2e-7 relative; against the
one-process step the gradients 3.2e-7 and the updates 3.0e-5 (the worst
tensors are LayerNorm scales, whose AdamW update divides small gradients
by their own size).
"""

import json
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from headct_foundation_tpu.config import default_config as jax_default_config
from headct_foundation_tpu.engines import mae_engine as jax_mae
from headct_foundation_tpu.parallel.mesh import make_mesh
from headct_foundation_tpu.utils import checkpoint as jax_ckpt
from headct_foundation_tpu_torch.engines import dino_engine, downstream_engine, mae_engine
from headct_foundation_tpu_torch.ops import attention as port_attn
from headct_foundation_tpu_torch.ops.flash_attention import (
    BlockedFusedAttention,
    fused_attention_reference,
)
from headct_foundation_tpu_torch.optim.optimizers import without_key_bias
from headct_foundation_tpu_torch.parallel import distributed, mesh
from headct_foundation_tpu_torch.utils.checkpoint import load_checkpoint, restore_state
from headct_foundation_tpu_torch.utils.torch_interop import state_dict_from_jax
from tests import torch_port_mp_worker as worker
from tests.test_torch_port_dropout import jax_mae_draws, jax_mae_grads, kernel_backends, wires

ROOT = Path(__file__).resolve().parent.parent
GRID = [24, 60, 84]  # 2 x 5 x 7 patches
PATCHES = 70
OPTS = ["MAE.PATCH_SIZE", 12, "MAE.IN_CHANS", 3, "MAE.MASK_RATIO", 0.6,
        "MAE.ENCODER_DEPTH", 2, "MAE.ENCODER_EMBED_DIM", 48, "MAE.ENCODER_MLP_DIM", 96,
        "MAE.ENCODER_NUM_HEADS", 4, "MAE.DECODER_DEPTH", 2, "MAE.DECODER_EMBED_DIM", 48,
        "MAE.DECODER_MLP_DIM", 96, "MAE.DECODER_NUM_HEADS", 4, "MAE.USE_BIAS", True,
        "MAE.POS_EMBED", "sincos", "DATA.WIRE_FORMAT", "hu16", "TRAIN.OPTIMIZER", "AdamW",
        "TRAIN.BASE_LR", 1e-3, "TRAIN.MIN_LR", 1e-6, "TRAIN.WEIGHT_DECAY", 0.05,
        "TRAIN.GRAD_CLIP", 0.0, "TRAIN.SCHEDULER", "cosine", "PARALLEL.PALLAS_MIN_T", 16]
MESH = ["PARALLEL.SEQ", 2, "PARALLEL.TENSOR", 2]
LOSS_REL, NORM_REL = 1e-5, 1e-4
STEPS, BATCH = 2, 4


def _numpy(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _jax_config():
    cfg = jax_default_config()
    cfg.merge_from_list(list(OPTS))
    cfg.MAE.INPUT_SIZE = cfg.MODEL.ROI = list(GRID)
    return cfg


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(job: dict, out: Path, n: int) -> dict:
    """Run ``job`` in ``n`` gloo processes; rank 0's results."""
    (out / "in.pkl").write_bytes(pickle.dumps(job))
    port, procs = _free_port(), []
    for r in range(n):
        env = dict(os.environ, WORLD_SIZE=str(n), RANK=str(r), LOCAL_RANK=str(r),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=str(ROOT))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tests.torch_port_mp_worker", str(out / "in.pkl"), str(out)],
            env=env, cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    logs = [p.communicate(timeout=600)[0].decode(errors="replace") for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    return pickle.loads((out / "results.pkl").read_bytes())


def _one_process(case: dict, out: Path) -> dict:
    prev = port_attn.set_attention_backend("kernel")
    try:
        return worker.run_case(case, OPTS, str(out), GRID)
    finally:
        port_attn.set_attention_backend(prev)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four-process run and the one-process run of two cases, and JAX's
    mesh step from the same weights and draws: ``jax`` (dropout 0, JAX's
    weights and draws, a checkpoint after) and ``dropout`` (0.25, the
    seed-0 weights, the port's own draws, GRAD_CLIP 1.0)."""
    out = tmp_path_factory.mktemp("model_parallel")
    cfg_j = _jax_config()
    rng = jax.random.PRNGKey(0)
    jax_mesh = make_mesh(data=1, seq=2, tensor=2, devices=jax.devices()[:4])
    with kernel_backends():
        state_j, _, _ = jax_mae.create_train_state(cfg_j, jax_mesh, rng, 20, 0,
                                                   dtype=jnp.float32)
        model_j = jax_mae.build_mae_model(cfg_j, dtype=jnp.float32)
        batches = wires(STEPS, BATCH, GRID)
        draws = [{k: (v.numpy() if k == "noise" else {kk: vv.numpy() for kk, vv in v.items()})
                  for k, v in jax_mae_draws(model_j, rng, s, BATCH, PATCHES)[0].items()}
                 for s in range(STEPS)]
        init_j = state_dict_from_jax(_numpy(state_j.params))
        loss_j, grads_j = jax_mae_grads(state_j, cfg_j, jax_mesh, batches[0], rng, 0)
        step_j = jax_mae.make_train_step(jax_mesh, augment=True, config=cfg_j)
        losses_j = []
        for wire in batches:
            state_j, m = step_j(state_j, jax_mae._to_device_batch(wire, jax_mesh), rng)
            losses_j.append(float(m["loss"]))
    cases = [dict(name="jax", total_steps=20, warmup=0, batches=batches, draws=draws,
                  weights=init_j, checkpoint=True),
             dict(name="dropout", total_steps=20, warmup=0, batches=batches,
                  opts=["MAE.DROPOUT_RATE", 0.25, "TRAIN.GRAD_CLIP", 1.0]),
             dict(name="lamb", total_steps=20, warmup=0, batches=batches, draws=draws,
                  opts=["TRAIN.OPTIMIZER", "Lamb", "TRAIN.GRAD_CLIP", 1.0])]
    four = _launch(dict(opts=OPTS + MESH, cases=cases, grid=GRID), out, 4)
    one = {c["name"]: _one_process({**c, "checkpoint": False}, out) for c in cases}
    return dict(four=four, one=one, out=out, losses_j=losses_j, loss_j=loss_j,
                grads_j=grads_j, init_j=init_j,
                params_j=state_dict_from_jax(_numpy(state_j.params)))


def _rel(a: torch.Tensor, b: torch.Tensor, name: str) -> float:
    a, b = without_key_bias(name, a), without_key_bias(name, b)
    return float((a - b).norm() / b.norm()) if b.norm() > 0 else float(a.norm())


def _assert_updates_close(got: dict, want_after: dict, want_before: dict, what: str):
    for name, after in want_after.items():
        rel = _rel(got["params"][name] - got["init"][name], after - want_before[name], name)
        assert rel <= NORM_REL, f"{what}: {name} update {rel:.3e} apart"


def test_four_processes_match_the_jax_mesh_step(runs):
    """SEQ 2 x TENSOR 2 against JAX's step on the seq 2 x tensor 2 mesh: the
    losses, the first step's gradients and the two updates."""
    got = runs["four"]["jax"]
    assert all(torch.equal(got["init"][n], v) for n, v in runs["init_j"].items())
    np.testing.assert_allclose(got["losses"][0], runs["loss_j"], rtol=LOSS_REL)
    np.testing.assert_allclose(got["losses"], runs["losses_j"], rtol=LOSS_REL)
    assert set(got["grads"]) == {n for n in runs["grads_j"]
                                 if not n.endswith(("position_embeddings", "decoder_pos_embed"))}
    for name, g in got["grads"].items():
        rel = _rel(g, runs["grads_j"][name], name)
        assert rel <= NORM_REL, f"{name}: gradient {rel:.3e} apart"
    _assert_updates_close(got, runs["params_j"], runs["init_j"], "JAX mesh")


@pytest.mark.parametrize("case", ["jax", "dropout", "lamb"])
def test_four_processes_match_one_process(runs, case):
    """The four ranks against the port's one-process step on the same
    batches, draws and (for ``dropout``) dropout generators; ``lamb`` takes
    Lamb's trust ratio with each split tensor's norms over its shards."""
    got, want = runs["four"][case], runs["one"][case]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_REL)
    for name, g in want["grads"].items():
        rel = _rel(got["grads"][name], g, name)
        assert rel <= NORM_REL, f"{name}: gradient {rel:.3e} apart"
    _assert_updates_close(got, want["params"], want["init"], case)


def test_model_parallel_starts_from_the_seed_weights(runs):
    """``create_train_state`` at SEQ 2 x TENSOR 2 keeps each rank's part of
    the full seed-0 draw: the parts gathered are the one-process weights."""
    got, want = runs["four"]["dropout"]["seed_init"], runs["one"]["dropout"]["seed_init"]
    assert set(got) == set(want)
    assert all(torch.equal(got[n], want[n]) for n in want)


def test_tensor2_checkpoint_loads_in_one_process_bit_for_bit(runs):
    """The checkpoint the four ranks wrote (rank 0, the parts gathered whole)
    restores into a one-process state bit for bit, parameters and AdamW
    moments, and reads in the JAX package's reader as the JAX state's tree."""
    path = runs["four"]["jax"]["checkpoint"]
    payload = load_checkpoint(path)
    cfg = worker.config(OPTS, GRID)
    state, _ = mae_engine.create_train_state(cfg, 20, 0, seed=1, dtype=torch.float32,
                                             device="cpu")
    state, epoch, _ = restore_state(state, payload)
    assert epoch == 0 and state.step == STEPS
    params = runs["four"]["jax"]["params"]
    assert all(torch.equal(p, params[n]) for n, p in state.model.named_parameters())
    trees = state.jax_trees(state.step)
    flat_a = jax.tree_util.tree_leaves_with_path(trees)
    flat_b = jax.tree_util.tree_leaves_with_path(
        {k: payload[k] for k in ("params", "opt_state")})
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    assert all(np.array_equal(np.asarray(a), np.asarray(b))
               for (_, a), (_, b) in zip(flat_a, flat_b))
    jax_payload = jax_ckpt.load_checkpoint(path)
    state_j, _, _ = jax_mae.create_train_state(_jax_config(), make_mesh(data=1, devices=jax.devices()[:1]),
                                               jax.random.PRNGKey(0), 20, 0, dtype=jnp.float32)
    assert (jax.tree.structure(_numpy(state_j.params))
            == jax.tree.structure(jax_payload["params"]))
    assert all(np.shape(a) == np.shape(b) for a, b in zip(
        jax.tree.leaves(_numpy(state_j.params)), jax.tree.leaves(jax_payload["params"])))


@pytest.mark.parametrize("t,heads", [(2, 12), (4, 12), (2, 16), (4, 16)])
def test_column_and_row_split_round_trip(t, heads):
    """The tensor split of each Megatron parameter and its join are exact,
    and the qkv split is head-aligned: rank i's rows are heads i H/t ..
    (i+1) H/t of q, of k and of v."""
    d = 4
    c = heads * d
    full = {"blocks.0.attn.qkv.weight": torch.randn(3 * c, c),
            "blocks.0.attn.qkv.bias": torch.randn(3 * c),
            "blocks.0.attn.proj.weight": torch.randn(c, c),
            "blocks.0.mlp.linear1.weight": torch.randn(4 * c, c),
            "blocks.0.mlp.linear1.bias": torch.randn(4 * c),
            "blocks.0.mlp.linear2.weight": torch.randn(c, 4 * c),
            "blocks.0.attn.proj.bias": torch.randn(c)}
    for name, w in full.items():
        parts = [mesh.split_param(name, w, t, i) for i in range(t)]
        assert torch.equal(mesh.join_params(name, parts), w), name
    hl = heads // t
    qkv = full["blocks.0.attn.qkv.weight"].reshape(3, heads, d, c)
    for i in range(t):
        part = mesh.split_param("blocks.0.attn.qkv.weight", full["blocks.0.attn.qkv.weight"], t, i)
        assert torch.equal(part.reshape(3, hl, d, c), qkv[:, i * hl:(i + 1) * hl])
    assert mesh.param_sharding("blocks.0.attn.proj.bias") is None
    assert mesh.param_sharding("decoder_pred.weight") is None


@pytest.mark.parametrize("s", [2, 4])
def test_seq_shards_against_gathered_keys_match_whole_attention(s):
    """One process emulating ``s`` seq ranks: each Q shard of an odd T
    against the padded whole K, V with ``kv_len`` (``attend_shard``, the
    blocked branch), the dK and dV partials summed in rank order, against
    the whole attention's output and gradients."""
    g = torch.Generator().manual_seed(s)
    B, T, H, D = 2, 71, 2, 16
    q, k, v, w = (torch.randn(B, T, H, D, generator=g) for _ in range(4))
    tl = mesh.tokens_per_rank(T, s)
    pad = lambda x: torch.cat([x, torch.zeros(B, s * tl - T, H, D)], dim=1)  # noqa: E731
    kp, vp = pad(k).requires_grad_(), pad(v).requires_grad_()
    qp = pad(q)
    prev, prev_t = port_attn.set_attention_backend("kernel"), port_attn.set_pallas_min_t(16)
    try:
        outs, dq = [], []
        for r in range(s):
            qr = qp[:, r * tl:(r + 1) * tl].clone().requires_grad_()
            o = port_attn.attend_shard(qr, kp, vp, T)
            (o * pad(w)[:, r * tl:(r + 1) * tl]).sum().backward()
            outs.append(o.detach())
            dq.append(qr.grad)
    finally:
        port_attn.set_attention_backend(prev)
        port_attn.set_pallas_min_t(prev_t)
    qf, kf, vf = (x.clone().requires_grad_() for x in (q, k, v))
    ref = fused_attention_reference(qf, kf, vf)[0]
    (ref * w).sum().backward()
    torch.testing.assert_close(torch.cat(outs, 1)[:, :T], ref.detach(), rtol=1e-5, atol=2e-6)
    torch.testing.assert_close(torch.cat(dq, 1)[:, :T], qf.grad, rtol=1e-4, atol=2e-5)
    torch.testing.assert_close(kp.grad[:, :T], kf.grad, rtol=1e-4, atol=2e-5)
    torch.testing.assert_close(vp.grad[:, :T], vf.grad, rtol=1e-4, atol=2e-5)
    assert not kp.grad[:, T:].any() and not vp.grad[:, T:].any()
    assert BlockedFusedAttention is port_attn._fa.BlockedFusedAttention


@pytest.mark.parametrize("axis", ["FSDP", "PIPE", "SEQ", "TENSOR"])
def test_unported_axes_still_raise(axis):
    """FSDP, SEQ, PIPE and TENSOR lay out (at a world they divide), and a
    single process with one of them above 1 raises in every engine: it has
    no ranks to split over. The layout refuses PIPE above 1 with another
    model axis above 1 (JAX ``parallel/pipeline.py:149-153``)."""
    cfg = worker.config(OPTS + [f"PARALLEL.{axis}", 2], GRID)
    makes = (lambda: mae_engine.create_train_state(cfg, 10, 0, device="cpu"),
             lambda: dino_engine.create_train_state(cfg, 10, 0, 1, device="cpu"),
             lambda: downstream_engine.create_train_state(cfg, 10, 0, device="cpu"))
    if axis != "PIPE":
        with pytest.raises(ValueError, match="would need in-stage collectives"):
            mesh.layout(world=4, pipe=2, **{axis.lower(): 2})
    assert mesh.layout(world=4, **{axis.lower(): 2}) == tuple(
        2 if a == axis.lower() else (2 if a == "data" else 1) for a in mesh.MESH_AXES)
    for make in makes:
        with pytest.raises(ValueError, match=f"PARALLEL.{axis} = 2 but the process's mesh"):
            make()


def test_cli_under_torchrun_at_seq_and_tensor_resumes_in_one_process(tmp_path):
    """``main_pretrain_mae`` under ``torch.distributed.run`` at SEQ 2 x
    TENSOR 2 (4 gloo processes, dropout 0.1) trains an epoch and writes its
    checkpoints whole; one process resumes from them."""
    from tests.test_torch_port_cli import _cli, _dataset

    cfg = _dataset(tmp_path)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "4",
           "--master_addr", "localhost", "--master_port", str(_free_port()),
           "-m", "headct_foundation_tpu_torch.main_pretrain_mae", "--cfg", cfg,
           "--device", "cpu", "--max_epochs", "1", "--opts", *map(str, MESH),
           "MAE.DROPOUT_RATE", "0.1", "DATA.BATCH_SIZE", "2"]
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-3000:]
    result = json.loads(next(line for line in r.stdout.splitlines()[::-1]
                             if line.startswith('{"cli"')))["cli"]
    assert result["world"] == 4
    assert result["mesh"] == {"data": 1, "fsdp": 1, "seq": 2, "pipe": 1, "tensor": 2}
    assert result["placeholders"] == 0 and np.isfinite(result["epochs"][0]["train"]["loss"])
    latest = str(tmp_path / "model_saved" / "latest_debug.pt")
    log, result = _cli(["--cfg", cfg, "--device", "cpu", "--model_load_path", latest,
                        "--max_epochs", "2", "--opts", "DATA.BATCH_SIZE", "2"])
    assert f"Resumed from {latest} at epoch 0" in log and result["start_epoch"] == 0


def test_the_rule_table_splits_only_the_megatron_pairs():
    """The port's copy of the rule table (JAX ``parallel/mesh.py:144-156``):
    qkv and ``linear1`` split with their biases, ``proj`` and ``linear2``
    over their inputs, their biases and everything else whole."""
    names = ["blocks.0.attn.qkv.weight", "blocks.0.attn.qkv.bias", "blocks.0.attn.proj.weight",
             "blocks.0.attn.proj.bias", "blocks.0.mlp.linear1.bias", "blocks.0.mlp.linear2.weight",
             "blocks.0.att_norm.weight", "patch_embedding.patch_embeddings.weight"]
    split = {n for n in names if mesh.param_sharding(n)}
    assert split == {"blocks.0.attn.qkv.weight", "blocks.0.attn.qkv.bias",
                     "blocks.0.attn.proj.weight", "blocks.0.mlp.linear1.bias",
                     "blocks.0.mlp.linear2.weight"}
