"""PyTorch port: the DINO step on the ``seq``, ``tensor`` and ``fsdp``
axes, on the CPU.

One launch of four gloo processes (``tests/torch_port_mp_worker.py``) runs
each case on a mesh of its own over the four ranks: ``PARALLEL.SEQ 2 x
TENSOR 2`` (every crop's tokens split over ``seq``, B3/B4/B5's plain
versions on each Q shard against the gathered keys with ``kv_len``; the
blocks' heads over ``tensor``) and ``DATA 2 x FSDP 2`` (the batch over four
ranks, the ZeRO-3 shards of every weight the rule table splits). The
configuration is ``tests/test_torch_port_dino_train.py``'s (24^3, patch 12,
width 48, 2 layers, 4 heads, 2 registers, T = 11 and ``PALLAS_MIN_T`` 11),
in float32, from JAX's weights and with the crop decisions JAX's step
draws, held against:

* JAX's DINO step on the same mesh over four of the eight CPU devices (its
  attention through the XLA reference its Pallas kernels are held against;
  ``tests/test_torch_port_dino_train.py`` holds the kernels): the losses,
  the first step's gradients (each tensor normwise, at SEQ 2 x TENSOR 2),
  the two updates of the student, the teacher (held as
  ``tests/test_torch_port_dino_train.py`` holds it: its EMA rounds at the
  teacher's own magnitude, far above its update's) and the centre;
* the port's one-process step on the same inputs.

Limits: the MAE model-parallel test's ``LOSS_REL`` (1e-5) and ``NORM_REL``
(1e-4, a qkv bias without its key third). Checkpoints written at either
mesh restore in one process bit for bit, and one written by one process
restores at ``DATA 2 x FSDP 2`` bit for bit; each rank holds exactly its
``fsdp`` shares.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from headct_foundation_tpu.data.augment import dino_multicrop
from headct_foundation_tpu.data.device_preprocess import wire_to_compute as jax_wire_to_compute
from headct_foundation_tpu.engines import dino_engine as jax_dino
from headct_foundation_tpu.engines.mae_engine import _to_device_batch
from headct_foundation_tpu.losses.dino_loss import dino_loss as jax_dino_loss
from headct_foundation_tpu.models.multicrop import multicrop_forward as jax_multicrop
from headct_foundation_tpu.ops import attention as jax_attn
from headct_foundation_tpu.parallel.mesh import make_mesh
from headct_foundation_tpu_torch.engines import dino_engine
from headct_foundation_tpu_torch.ops import attention as port_attn
from headct_foundation_tpu_torch.parallel import mesh
from headct_foundation_tpu_torch.utils.checkpoint import load_checkpoint, restore_dino_state
from headct_foundation_tpu_torch.utils.torch_interop import state_dict_from_jax
from tests import torch_port_mp_worker as worker
from tests.test_torch_port_dino_train import TINY as DINO_TINY
from tests.test_torch_port_dino_train import _configs as dino_configs
from tests.test_torch_port_dino_train import _jax_draws
from tests.test_torch_port_dino_train import _wires as dino_wires
from tests.test_torch_port_dino_train import assert_tensor_close
from tests.test_torch_port_model_parallel import LOSS_REL, NORM_REL, _launch, _numpy, _rel

ST = ["PARALLEL.SEQ", 2, "PARALLEL.TENSOR", 2]
FSDP = ["PARALLEL.DATA", 2, "PARALLEL.FSDP", 2]
MESHES = {"st": (ST, dict(data=1, seq=2, tensor=2)), "fsdp": (FSDP, dict(data=2, fsdp=2))}
STEPS, DINO_BATCH = 2, 4


@contextlib.contextmanager
def jax_plain_attention():
    """JAX's attention through its XLA reference (the plain version the JAX
    tests hold its Pallas kernels against), its interpreted kernels being
    most of a mesh step's CPU time; the port's on its kernel backend."""
    prev = jax_attn.set_attention_backend("xla"), port_attn.set_attention_backend("kernel")
    try:
        yield
    finally:
        jax_attn.set_attention_backend(prev[0])
        port_attn.set_attention_backend(prev[1])


def _one_process(run, case, opts, out):
    prev = port_attn.set_attention_backend("kernel")
    try:
        return run({**case, "checkpoint": True, "name": f"one-{case['name']}"}, opts, str(out))
    finally:
        port_attn.set_attention_backend(prev)


def _assert_close(got: dict, want: dict, what: str, limit: float = NORM_REL, skip=()):
    for name, w in want.items():
        if name in skip:
            continue
        rel = _rel(got[name], w, name)
        assert rel <= limit, f"{what}: {name} {rel:.3e} apart"


def _deltas(after: dict, before: dict) -> dict:
    return {n: after[n] - before[n] for n in after}




def jax_dino_grads(state_j, cfg_j, jax_mesh, wire, rng):
    """(loss, gradients) of the JAX DINO step's micro-batch 0 at update 0
    (its ``one_micro``, ``engines/dino_engine.py:264-318``), under ``jax_mesh``."""
    d = cfg_j.DINO
    ncrops = int(d.LOCAL_CROP_NUM) + 2

    def loss_fn(params, batch):
        with jax_attn.attention_mesh(jax_mesh):
            batch = jax_wire_to_compute(batch, cfg_j, int(cfg_j.VIT.IN_CHANS))
            crop_rng, _ = jax.random.split(jax.random.fold_in(rng, 0))
            micro_rng = jax.random.fold_in(crop_rng, 0)
            crops = dino_multicrop(micro_rng, batch, final_size=tuple(cfg_j.MODEL.ROI),
                                   global_crop_size=d.GLOBAL_CROP_SIZE[0],
                                   local_crop_size=d.LOCAL_CROP_SIZE[0],
                                   local_crops_number=d.LOCAL_CROP_NUM)

            def net(p, key, xs):
                return jax_multicrop(
                    lambda x: state_j.backbone_apply({"params": p["backbone"]}, x,
                                                     deterministic=False,
                                                     rngs={"dropout": key}),
                    lambda f: state_j.head_apply({"params": p["head"]}, f), xs)

            t_out = jax.lax.stop_gradient(net(state_j.teacher_params,
                                              jax.random.fold_in(micro_rng, 101), crops[:2]))
            s_out = net(params, jax.random.fold_in(micro_rng, 102), crops)
            return jax_dino_loss(s_out, t_out, state_j.center, jnp.asarray(0.04, jnp.float32),
                                 ncrops)

    batch = _to_device_batch(wire, jax_mesh)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(state_j.params, batch)
    return float(loss), state_dict_from_jax(_numpy(grads))


def _jax_dino_run(cfg_j, axes, batches, rng):
    jax_mesh = make_mesh(devices=jax.devices()[:4], **axes)
    state_j = jax_dino.create_train_state(cfg_j, jax_mesh, jax.random.PRNGKey(0), 20, 0, 5,
                                          dtype=jnp.float32)[0]
    init = {"student": state_dict_from_jax(_numpy(state_j.params)),
            "teacher": state_dict_from_jax(_numpy(state_j.teacher_params))}
    # the first step's gradients at SEQ 2 x TENSOR 2; one process holds FSDP 2's
    loss0, grads0 = (jax_dino_grads(state_j, cfg_j, jax_mesh, batches[0], rng)
                     if "seq" in axes else (None, None))
    step_j = jax_dino.make_train_step(cfg_j, jax_mesh)
    losses = []
    for wire in batches:
        state_j, m = step_j(state_j, _to_device_batch(wire, jax_mesh), rng,
                            jnp.asarray(worker.MOMENTUM, jnp.float32),
                            jnp.asarray(worker.TEMP, jnp.float32), jnp.asarray(0.0))
        losses.append(float(m["loss"]))
    return dict(init=init, loss0=loss0, grads=grads0, losses=losses,
                params=state_dict_from_jax(_numpy(state_j.params)),
                teacher=state_dict_from_jax(_numpy(state_j.teacher_params)),
                center=torch.from_numpy(np.asarray(state_j.center)))


@pytest.fixture(scope="module")
def dino_runs(tmp_path_factory):
    """JAX's DINO step on both meshes, the four-process runs of the port on
    both (and a resume at DATA 2 x FSDP 2 from a one-process checkpoint),
    and the port's one-process run, from JAX's weights and draws."""
    out = tmp_path_factory.mktemp("dino_mesh")
    cfg_j, _ = dino_configs()
    rng = jax.random.PRNGKey(1)
    batches = dino_wires(STEPS, DINO_BATCH)
    draws = [_jax_draws(rng, s, 1, DINO_BATCH) for s in range(STEPS)]
    with jax_plain_attention():
        jax_runs = {k: _jax_dino_run(cfg_j, axes, batches, rng) for k, (_, axes) in MESHES.items()}
    case = dict(engine="dino", batches=batches, draws=draws, weights=jax_runs["st"]["init"])
    one = _one_process(worker.run_dino_case, {**case, "name": "dino"}, DINO_TINY, out)
    cases = [{**case, "name": k, "mesh_opts": opts, "checkpoint": True}
             for k, (opts, _) in MESHES.items()]
    cases.append({**case, "name": "resume", "mesh_opts": FSDP, "batches": batches[:1],
                  "draws": draws[:1], "weights": None, "resume": one["checkpoint"]})
    four = _launch(dict(opts=DINO_TINY, cases=cases), out, 4)
    return dict(jax=jax_runs, one=one, four=four)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_dino_mesh_matches_the_jax_mesh_step(dino_runs, mesh_name):
    """The port's four ranks against JAX's DINO step on the same mesh: the
    losses, the first step's gradients (at SEQ 2 x TENSOR 2), the two
    updates of the student and of the teacher, and the centre."""
    got, want = dino_runs["four"][mesh_name], dino_runs["jax"][mesh_name]
    init = want["init"]
    assert all(torch.equal(got["init"][n], v) for n, v in init["student"].items())
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_REL)
    if want["grads"] is not None:
        np.testing.assert_allclose(got["losses"][0], want["loss0"], rtol=LOSS_REL)
        assert set(got["grads"]) <= set(want["grads"])
        _assert_close(got["grads"], {n: want["grads"][n] for n in got["grads"]}, "gradient")
    _assert_close(_deltas(got["params"], got["init"]),
                  _deltas(want["params"], init["student"]), "student update")
    for name, t in want["teacher"].items():  # the EMA rounds at the teacher's magnitude
        assert_tensor_close(name, got["teacher"][name].numpy(), t.numpy(), "teacher")
    _assert_close({"center": got["center"]}, {"center": want["center"]}, "centre")


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_dino_mesh_matches_one_process(dino_runs, mesh_name):
    got, want = dino_runs["four"][mesh_name], dino_runs["one"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_REL)
    _assert_close(got["grads"], want["grads"], "gradient")
    _assert_close(_deltas(got["params"], got["init"]), _deltas(want["params"], want["init"]),
                  "student update")
    _assert_close(_deltas(got["teacher"], want["init"]),
                  _deltas(want["teacher"], want["init"]), "teacher update")
    _assert_close({"center": got["center"]}, {"center": want["center"]}, "centre")


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_dino_mesh_checkpoint_restores_in_one_process_bit_for_bit(dino_runs, mesh_name):
    """The checkpoint each mesh wrote (gathered whole) restores into a
    one-process DINO state bit for bit: student, teacher, centre, AdamW
    moments and step."""
    got = dino_runs["four"][mesh_name]
    state = dino_engine.create_train_state(worker.config(DINO_TINY), **worker.DINO_STEPS,
                                           seed=5, dtype=torch.float32, device="cpu")
    state, _, _ = restore_dino_state(state, load_checkpoint(got["checkpoint"]))
    assert state.step == STEPS
    assert all(torch.equal(p, got["params"][n]) for n, p in state.student.named_parameters())
    assert all(torch.equal(p, got["teacher"][n]) for n, p in state.teacher.named_parameters())
    assert torch.equal(state.center, got["center"])
    want = worker.moments(state.student, state.optimizer)
    assert want.keys() == got["moments"].keys()
    assert all(torch.equal(got["moments"][n][k], v) for n, m in want.items() for k, v in m.items())


def test_dino_one_process_checkpoint_resumes_at_fsdp_bit_for_bit(dino_runs):
    got, want = dino_runs["four"]["resume"], dino_runs["one"]
    assert all(torch.equal(got["init"][n], want["params"][n]) for n in want["params"])
    assert all(torch.equal(got["init_moments"][n][k], v)
               for n, m in want["moments"].items() for k, v in m.items())


def test_dino_fsdp_ranks_hold_their_shards_only(dino_runs):
    """At DATA 2 x FSDP 2 each rank's student and AdamW-moment bytes are the
    one-process bytes less half of every fsdp-split tensor's, exactly."""
    one, got = dino_runs["one"]["bytes"][0], dino_runs["four"]["fsdp"]["bytes"]
    state = dino_engine.create_train_state(worker.config(DINO_TINY), **worker.DINO_STEPS,
                                           device="cpu", dtype=torch.float32)
    split = [(n, p) for n, p in state.student.named_parameters()
             if mesh.fsdp_dim(n, p.shape, 2) is not None]
    assert {n.split(".")[-2] for n, _ in split} == {"qkv", "proj", "linear1", "linear2"}
    saved = sum(p.numel() * 4 for _, p in split) // 2
    moments = sum(p.numel() * 4 for _, p in split if p.requires_grad)  # two moments, halved
    assert got == [{"params": one["params"] - saved,
                    "optimizer": one["optimizer"] - moments}] * 4




def test_dino_fsdp_whole_weights_live_only_while_their_linear_runs(dino_runs):
    """At DATA 2 x FSDP 2 no whole weight that a rank gathered (teacher or
    student) is alive at the end of the student's first forward."""
    for rank in dino_runs["four"]["fsdp"]["whole_alive"]:
        assert rank["gathered"] > 0 and rank["alive"] == 0, rank
