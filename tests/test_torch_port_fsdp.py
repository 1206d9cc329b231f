"""PyTorch port: the MAE step on ``fsdp`` (ZeRO-3), and the optimizers on
shards, on the CPU.

Four gloo processes (``tests/torch_port_mp_worker.py``) run the port's MAE
step of ``tests/test_torch_port_model_parallel.py`` (24 x 60 x 84, patch 12,
width 48, the blocked branch through ``PALLAS_MIN_T 16``) at ``PARALLEL.DATA
2 x FSDP 2``: each rank takes one of the batch's four rows and holds its
``fsdp`` shard of every block weight (``parallel/fsdp.py``). They are held
against:

* JAX's ``make_train_step`` on ``make_mesh(data=2, fsdp=2)`` over four of
  the eight CPU devices (its attention through the XLA reference), from
  JAX's weights and with its draws;
* the port's one-process step on the same inputs (AdamW; Lamb and fused
  Lion with ``GRAD_CLIP`` 1.0, whose norms are each tensor's over its
  shards; Lion runs its kernel's plain version on each rank's shard);
* the byte count: each rank holds exactly 1/2 of every parameter the rule
  table splits over ``fsdp``, and of its AdamW moments, and all of the
  others.

A checkpoint written at FSDP 2 restores in one process bit for bit, and
one written by one process restores at FSDP 2 bit for bit. The limits are
the model-parallel test's (``LOSS_REL``, ``NORM_REL``): the loss within 1e-5
relative, gradients and updates each tensor normwise within 1e-4, without a
qkv bias's key third.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from headct_foundation_tpu.engines import mae_engine as jax_mae
from headct_foundation_tpu.parallel.mesh import make_mesh
from headct_foundation_tpu_torch.engines import mae_engine
from headct_foundation_tpu_torch.parallel import fsdp, mesh
from headct_foundation_tpu_torch.utils.checkpoint import load_checkpoint, restore_state
from headct_foundation_tpu_torch.utils.torch_interop import state_dict_from_jax
from tests import torch_port_mp_worker as worker
from tests.test_torch_port_dropout import jax_mae_draws, jax_mae_grads, wires
from tests.test_torch_port_mesh_dino import jax_plain_attention
from tests.test_torch_port_model_parallel import (
    BATCH,
    GRID,
    LOSS_REL,
    NORM_REL,
    OPTS,
    PATCHES,
    STEPS,
    _assert_updates_close,
    _jax_config,
    _launch,
    _numpy,
    _one_process,
    _rel,
)

FSDP = ["PARALLEL.DATA", 2, "PARALLEL.FSDP", 2]
CLIP = ["TRAIN.GRAD_CLIP", 1.0]
OPT_CASES = {"lamb": ["TRAIN.OPTIMIZER", "Lamb"] + CLIP,
             "lion": ["TRAIN.OPTIMIZER", "Lion", "TRAIN.LION_FUSED", True] + CLIP}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four-process run at DATA 2 x FSDP 2 and the one-process run of
    the ``jax`` case (JAX's weights and draws, a checkpoint after), the
    optimizer cases and a ``resume`` case that starts from a one-process
    checkpoint; JAX's fsdp-mesh step from the same weights and draws."""
    out = tmp_path_factory.mktemp("fsdp")
    cfg_j = _jax_config()
    rng = jax.random.PRNGKey(0)
    jax_mesh = make_mesh(data=2, fsdp=2, devices=jax.devices()[:4])
    with jax_plain_attention():
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
    jax_case = dict(name="jax", total_steps=20, warmup=0, batches=batches, draws=draws,
                    weights=init_j, checkpoint=True)
    one = {"jax": _one_process({**jax_case, "name": "one-process"}, out)}
    cases = [jax_case, dict(name="resume", total_steps=20, warmup=0, batches=batches[:1],
                            draws=draws[:1], resume=one["jax"]["checkpoint"])]
    cases += [dict(name=k, total_steps=20, warmup=0, batches=batches, draws=draws, opts=v)
              for k, v in OPT_CASES.items()]
    four = _launch(dict(opts=OPTS + FSDP, cases=cases, grid=GRID), out, 4)
    for c in cases[2:]:
        one[c["name"]] = _one_process({**c, "checkpoint": False}, out)
    return dict(four=four, one=one, losses_j=losses_j, loss_j=loss_j, grads_j=grads_j,
                init_j=init_j, params_j=state_dict_from_jax(_numpy(state_j.params)))


def test_fsdp_matches_the_jax_mesh_step(runs):
    """DATA 2 x FSDP 2 against JAX's step on the data 2 x fsdp 2 mesh: the
    losses, the first step's gradients and the two updates."""
    got = runs["four"]["jax"]
    assert all(torch.equal(got["init"][n], v) for n, v in runs["init_j"].items())
    np.testing.assert_allclose(got["losses"][0], runs["loss_j"], rtol=LOSS_REL)
    np.testing.assert_allclose(got["losses"], runs["losses_j"], rtol=LOSS_REL)
    for name, g in got["grads"].items():
        rel = _rel(g, runs["grads_j"][name], name)
        assert rel <= NORM_REL, f"{name}: gradient {rel:.3e} apart"
    _assert_updates_close(got, runs["params_j"], runs["init_j"], "JAX fsdp mesh")


@pytest.mark.parametrize("case", ["jax", "lamb", "lion"])
def test_fsdp_matches_one_process(runs, case):
    """The four ranks against the one-process step: AdamW, Lamb (its trust
    ratio's norms over the shards) and fused Lion (B6 on each shard), the
    last two under the per-parameter clip."""
    got, want = runs["four"][case], runs["one"][case]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_REL)
    for name, g in want["grads"].items():
        rel = _rel(got["grads"][name], g, name)
        assert rel <= NORM_REL, f"{name}: gradient {rel:.3e} apart"
    _assert_updates_close(got, want["params"], want["init"], case)


def _expected_bytes(state, f: int) -> dict:
    """One rank's bytes at fsdp ``f``, counted from the one-process model:
    a tensor the rule table splits over fsdp at 1/f, any other whole."""
    dims = {n: mesh.fsdp_dim(n, p.shape, f) for n, p in state.model.named_parameters()}
    params = sum(p.numel() * p.element_size() // (f if dims[n] is not None else 1)
                 for n, p in state.model.named_parameters())
    moments = sum(2 * p.numel() * 4 // (f if dims[n] is not None else 1)
                  for n, p in state.model.named_parameters() if p.requires_grad)
    return {"params": params, "optimizer": moments}


def test_each_rank_holds_its_shards_only(runs):
    """Each rank's parameter and AdamW-moment bytes are the one-process
    bytes less (f - 1) / f of every fsdp-split tensor's, exactly."""
    state, _ = mae_engine.create_train_state(worker.config(OPTS, GRID), 20, 0,
                                             dtype=torch.float32, device="cpu")
    one, want = runs["one"]["jax"]["bytes"][0], _expected_bytes(state, 2)
    split = {n for n, p in state.model.named_parameters()
             if mesh.fsdp_dim(n, p.shape, 2) is not None}
    assert split and all(n.split(".")[-2] in ("qkv", "proj", "linear1", "linear2")
                         for n in split)
    assert runs["four"]["jax"]["bytes"] == [want] * 4
    saved = sum(p.numel() * 4 for n, p in state.model.named_parameters() if n in split) // 2
    assert one["params"] - want["params"] == saved
    assert one["optimizer"] - want["optimizer"] == 2 * saved


def test_whole_weights_live_only_while_their_linear_runs(runs):
    """At the end of the first forward no whole weight that a rank gathered
    is alive: each was freed after its Linear, and autograd saved its shard
    to gather again (``parallel/fsdp.py``), not the whole weight."""
    for case in ("jax", "lamb", "lion"):
        for rank in runs["four"][case]["whole_alive"]:
            assert rank["gathered"] > 0 and rank["alive"] == 0, (case, rank)


def test_the_liveness_count_waits_out_another_threads_hold_only():
    """``still_alive`` waits for a tensor that only another thread holds (as
    c10d's worker holds a finished collective's output), and counts one that
    the calling thread's own code keeps."""
    import threading
    import weakref

    held = [torch.zeros(4)]
    mine = torch.zeros(4)
    refs = [weakref.ref(held[0]), weakref.ref(mine)]
    threading.Timer(0.2, held.clear).start()
    assert worker.still_alive(refs, settle=1.0) == 1
    assert refs[0]() is None and refs[1]() is mine


def test_fsdp_checkpoint_loads_in_one_process_bit_for_bit(runs):
    """The checkpoint written at FSDP 2 (gathered whole) restores into a
    one-process state bit for bit: parameters and AdamW moments."""
    path = runs["four"]["jax"]["checkpoint"]
    state, _ = mae_engine.create_train_state(worker.config(OPTS, GRID), 20, 0, seed=1,
                                             dtype=torch.float32, device="cpu")
    state, _, _ = restore_state(state, load_checkpoint(path))
    assert state.step == STEPS
    params = runs["four"]["jax"]["params"]
    assert all(torch.equal(p, params[n]) for n, p in state.model.named_parameters())
    moments = runs["four"]["jax"]["moments"]
    assert set(moments) == {n for n, p in state.model.named_parameters() if p.requires_grad}
    for n, p in state.model.named_parameters():
        if p.requires_grad:
            st = state.optimizer.state[p]
            assert all(torch.equal(st[k], moments[n][k]) for k in ("exp_avg", "exp_avg_sq"))


def test_one_process_checkpoint_resumes_at_fsdp_bit_for_bit(runs):
    """A one-process checkpoint restored at DATA 2 x FSDP 2 gives every rank
    its shards: gathered, they are the file's tensors bit for bit, and the
    next step matches the one-process step's third loss."""
    got, want = runs["four"]["resume"], runs["one"]["jax"]
    assert all(torch.equal(got["init"][n], want["params"][n]) for n in want["params"])
    for n, m in want["moments"].items():
        assert all(torch.equal(got["init_moments"][n][k], m[k]) for k in m)


def test_fsdp_dims_compose_with_the_tensor_split():
    """At FSDP f and TENSOR t each Megatron weight splits over ``fsdp`` along
    the dimension ``tensor`` leaves whole, and the two splits and joins
    compose to the identity."""
    g = torch.Generator().manual_seed(0)
    c, hidden = 48, 96
    shapes = {"blocks.0.attn.qkv.weight": (3 * c, c), "blocks.0.attn.proj.weight": (c, c),
              "blocks.0.mlp.linear1.weight": (hidden, c),
              "blocks.0.mlp.linear2.weight": (c, hidden)}
    for t in (1, 2, 4):
        for f in (2, 4):
            for name, shape in shapes.items():
                w = torch.randn(shape, generator=g)
                tdim = mesh.param_sharding(name)[0]
                parts = []
                for i in range(t):
                    part = mesh.split_param(name, w, t, i)
                    dim = mesh.fsdp_dim(name, part.shape, f)
                    assert dim == 1 - tdim
                    shards = [mesh.split_param(name, part, f, j, "fsdp", dim) for j in range(f)]
                    assert all(s.shape[dim] * f == part.shape[dim] for s in shards)
                    parts.append(mesh.join_params(name, shards, "fsdp", dim))
                assert torch.equal(mesh.join_params(name, parts), w), (name, t, f)
    assert mesh.fsdp_dim("head.linear.weight", (2, 48), 4) is None  # clamped
    assert mesh.fsdp_dim("head.linear.weight", (2, 48), 2) == 0
    assert fsdp.sharded_dims(torch.nn.Linear(2, 2)) == {}


def _jax_axes(path: str, shape, f: int, t: int) -> dict:
    """axis -> the dimension JAX's rule table (clamped) splits ``path`` of
    JAX layout ``shape`` along, at fsdp ``f`` and tensor ``t``."""
    from types import SimpleNamespace

    from headct_foundation_tpu.parallel import mesh as jax_mesh_lib

    fake = SimpleNamespace(shape={"data": 1, "fsdp": f, "seq": 1, "pipe": 1, "tensor": t})
    spec = jax_mesh_lib._clamp_spec(jax_mesh_lib._spec_for(path, jax_mesh_lib._DEFAULT_RULES),
                                    tuple(shape), fake)
    return {axis: d for d, axis in enumerate(spec) if axis is not None}


def _models():
    """The three shipped models and the tiny test ones, built on the meta
    device: (label, module, norm layer)."""
    from headct_foundation_tpu_torch.config import default_config
    from headct_foundation_tpu_torch.engines import dino_engine, downstream_engine

    out = []
    for label, path, extra in (("mae", "configs/mae/mae_HeadCT.yaml", []),
                               ("dino", "configs/dino/dino_HeadCT.yaml", []),
                               ("dino-bn", "configs/dino/dino_HeadCT.yaml", ["DINO.USE_BN", True]),
                               ("downstream", "configs/downstream/vit_HeadCT_cq500.yaml",
                                ["TRAIN.CLASSIFIER", "attentive", "TRAIN.LORA", True])):
        cfg = default_config()
        cfg.merge_from_file(path)
        cfg.merge_from_list(extra)
        with torch.device("meta"):
            if label == "mae":
                out.append((label, mae_engine.build_mae_model(cfg), cfg.MAE.NORM_LAYER))
            elif label.startswith("dino"):
                out.append((label, dino_engine.build_dino_model(cfg), cfg.VIT.NORM_LAYER))
            else:
                out.append((label, torch.nn.ModuleDict({
                    "model": dino_engine.build_vit_model(cfg, lora=True),
                    "classifier": downstream_engine.build_classifier(cfg)}), cfg.VIT.NORM_LAYER))
    with torch.device("meta"):
        out.append(("mae-tiny", mae_engine.build_mae_model(worker.config(OPTS, GRID)), "layernorm"))
    return out


# the port's tensor split where JAX keeps the tensor whole (mesh.py's rule table notes)
PORT_ONLY_TENSOR = ("qkv.bias", "linear1.bias", "lora_matrix_B")
# JAX's tensor storage layouts that the port keeps whole (gathered at use by XLA)
JAX_ONLY_TENSOR = r"(.*\.)?(patch_embeddings\.weight|decoder_embed\.weight|decoder_pred\.weight|" \
                  r"last_layer\.weight_v|head\.mlp\.\d+\.weight)$"


@pytest.mark.parametrize("f,t", [(2, 1), (4, 1), (2, 2), (4, 2), (8, 4)])
def test_the_rule_table_splits_what_the_jax_table_shards(f, t):
    """At each shipped model's shapes (and the tiny MAE's), fsdp f and tensor
    t: the port splits a tensor over ``fsdp`` exactly where JAX's clamped
    rule table shards it, along the same dimension (an [out, in] weight is
    JAX's [in, out] kernel transposed), whether or not it is split over
    ``tensor`` too; over ``tensor`` the Megatron weights agree, and the
    other differences are the ones ``parallel/mesh.py`` lists."""
    import re

    from headct_foundation_tpu_torch.utils.torch_interop import _jax_leaf, bn_layout_of

    for label, model, norm in _models():
        split = 0
        named = [(n, p) for n, p in model.named_parameters()]
        bn = bn_layout_of({n: p for n, p in model.state_dict().items()}) if "bn" in label else False
        for name, p in named:
            leaf = name.split(".", 1)[1] if label == "downstream" else name
            path, layout = _jax_leaf(leaf, p.dim(), norm, bn)
            jshape = tuple(p.shape)[::-1] if layout == "linear" else (
                (int(np.prod(p.shape[1:])), p.shape[0]) if layout == "patch" else tuple(p.shape))
            axes = _jax_axes("/".join(path), jshape, f, t)
            flip = (lambda d: 1 - d) if layout == "linear" else (lambda d: d)
            local = list(p.shape)
            spec = mesh.param_sharding(leaf) if t > 1 else None
            if spec is not None:
                local[spec[0]] //= t
            dim = mesh.fsdp_dim(leaf, local, f)
            want = flip(axes["fsdp"]) if "fsdp" in axes else None
            assert dim == want, (label, name, dim, axes)
            split += dim is not None
            if t == 1:
                continue
            jt = flip(axes["tensor"]) if "tensor" in axes else None
            pt = spec[0] if spec is not None else None
            if jt != pt:
                assert (name.endswith(PORT_ONLY_TENSOR) if jt is None
                        else pt is None and re.match(JAX_ONLY_TENSOR, name)), (label, name, pt, jt)
        assert split >= 4, label  # at least one block's Megatron weights
