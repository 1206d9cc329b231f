"""PyTorch port: the downstream step on the ``seq``, ``tensor`` and
``fsdp`` axes, on the CPU.

One launch of four gloo processes (``tests/torch_port_mp_worker.py``) runs
each case on a mesh of its own, ``PARALLEL.SEQ 2 x TENSOR 2`` and ``DATA 2
x FSDP 2``, as ``tests/test_torch_port_mesh_dino.py`` does, for the
attentive head fine-tuned (every token gathered over ``seq`` for it) and
the linear head under LoRA (the CLS gathered; LoRA's B split with the
heads' q and v columns). The configuration is
``tests/test_torch_port_downstream_train.py``'s (T = 9, ``PALLAS_MIN_T`` 9,
batch 8), in float32, from JAX's weights and with the augmentation JAX's
step draws, held against JAX's step on the same mesh (its attention
through the XLA reference, as in ``tests/test_torch_port_mesh_dino.py``)
and against the port's one process: the losses within ``LOSS_REL``
(1e-5), the first step's gradients within ``NORM_REL`` (1e-4; JAX's at
SEQ 2 x TENSOR 2), the three updates (with the classifier's BatchNorm
statistics) within ``NORM_REL`` of one process and within that test's
``UPDATE_REL`` (2e-3) of JAX's: AdamW's moments amplify the frameworks'
summation orders there. The tensors whose gradient is 0
but for rounding (``downstream_engine.ROUNDING_ONLY``) are left out, as
there. The cases take that test's 3 steps: after 2, LoRA's A has taken one
update, from a gradient of the order of its rounding (B is 0 until the
first update), and is 1.9e-2 from JAX's on one device as on both meshes
(measured on the CPU; 7.8e-4 after 3). Checkpoints written at either mesh
restore in one process bit for bit, and one written by one process
restores at ``DATA 2 x FSDP 2`` bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from headct_foundation_tpu.data.augment import vit_augment
from headct_foundation_tpu.data.device_preprocess import wire_to_compute as jax_wire_to_compute
from headct_foundation_tpu.engines import downstream_engine as jax_ds
from headct_foundation_tpu.engines.mae_engine import _to_device_batch
from headct_foundation_tpu.ops import attention as jax_attn
from headct_foundation_tpu.parallel.mesh import make_mesh
from headct_foundation_tpu_torch.engines import downstream_engine
from headct_foundation_tpu_torch.utils.checkpoint import load_checkpoint, restore_downstream_state
from headct_foundation_tpu_torch.utils.torch_interop import downstream_state_dicts_from_jax
from tests import torch_port_mp_worker as worker
from tests.test_torch_port_downstream_train import MODES, TARGETS, UPDATE_REL
from tests.test_torch_port_downstream_train import TINY as DS_TINY
from tests.test_torch_port_downstream_train import _configs as ds_configs
from tests.test_torch_port_downstream_train import _wires as ds_wires
from tests.test_torch_port_mae import jax_augment_decisions
from tests.test_torch_port_mesh_dino import (
    FSDP,
    MESHES,
    _assert_close,
    _deltas,
    _one_process,
    jax_plain_attention,
)
from tests.test_torch_port_model_parallel import LOSS_REL, _launch, _numpy

DS_STEPS = 3  # tests/test_torch_port_downstream_train.py's, at which UPDATE_REL was measured
DS_CASES = {"attentive": ("attentive", "fine-tune"), "lora": ("linear", "lora")}



def jax_downstream_grads(state_j, cfg_j, jax_mesh, wire, target, rng):
    """(loss, gradients) of the JAX downstream step at update 0 (its
    ``loss_fn``, ``engines/downstream_engine.py:228-258``), under ``jax_mesh``."""
    kind, lock = cfg_j.TRAIN.CLASSIFIER, bool(cfg_j.TRAIN.LOCK)

    def loss_fn(params, batch, tgt):
        with jax_attn.attention_mesh(jax_mesh):
            step_rng = jax.random.fold_in(rng, 0)
            batch = jax_wire_to_compute(batch, cfg_j, int(cfg_j.VIT.IN_CHANS),
                                        dtype=jnp.float32)
            batch = vit_augment(step_rng, batch)
            feats = jax_ds._features(state_j, params, batch, kind,
                                     dropout_rng=jax.random.fold_in(step_rng, 1))
            if lock:
                feats = jax.lax.stop_gradient(feats)
            logits, _ = state_j.classifier_apply(
                {"params": params["classifier"],
                 "batch_stats": state_j.batch_stats["classifier"]},
                feats, use_running_average=False, mutable=["batch_stats"])
            return optax.softmax_cross_entropy_with_integer_labels(
                logits.astype(jnp.float32), tgt).mean()

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        state_j.params, _to_device_batch(wire, jax_mesh),
        jax_ds._to_device(target, jax_mesh, np.int32))
    return float(loss), _ds_flat(*downstream_state_dicts_from_jax(_numpy(grads),
                                                                  _numpy(state_j.batch_stats)))


def _ds_flat(model_sd, clf_sd) -> dict:
    return {**{f"model.{k}": v for k, v in model_sd.items()},
            **{f"classifier.{k}": v for k, v in clf_sd.items()}}


def _jax_ds_run(cfg_j, axes, batches, rng):
    jax_mesh = make_mesh(devices=jax.devices()[:4], **axes)
    state_j = jax_ds.create_train_state(cfg_j, jax_mesh, jax.random.PRNGKey(0), 20, 1,
                                        dtype=jnp.float32)[0]
    model_sd, clf_sd = downstream_state_dicts_from_jax(_numpy(state_j.params),
                                                       _numpy(state_j.batch_stats))
    init = _ds_flat(model_sd, clf_sd)
    # the first step's gradients at SEQ 2 x TENSOR 2; one process holds FSDP 2's
    loss0, grads0 = (jax_downstream_grads(state_j, cfg_j, jax_mesh, batches[0], TARGETS[0], rng)
                     if "seq" in axes else (None, None))
    step_j = jax_ds.make_train_step(cfg_j, jax_mesh, compute_dtype=jnp.float32)
    losses = []
    for wire, tgt in zip(batches, TARGETS):
        state_j, m = step_j(state_j, _to_device_batch(wire, jax_mesh),
                            jax_ds._to_device(tgt, jax_mesh, np.int32), rng)
        losses.append(float(m["loss"]))
    after = _ds_flat(*downstream_state_dicts_from_jax(_numpy(state_j.params),
                                                      _numpy(state_j.batch_stats)))
    return dict(weights={"model": model_sd, "classifier": clf_sd}, init=init, loss0=loss0,
                grads=grads0, losses=losses, after=after)


@pytest.fixture(scope="module")
def ds_runs(tmp_path_factory):
    """For the attentive fine-tune and the linear LoRA cases: JAX's
    downstream step on both meshes, the port's four-process runs on both
    (and a resume at DATA 2 x FSDP 2 from a one-process checkpoint), and its
    one-process run."""
    out = tmp_path_factory.mktemp("downstream_mesh")
    rng = jax.random.PRNGKey(1)
    batches = ds_wires(DS_STEPS)
    targets = TARGETS[:DS_STEPS]
    draws = [{"augment": {k: v.numpy() for k, v in jax_augment_decisions(
        jax.random.fold_in(rng, s), len(batches[0])).items()}} for s in range(DS_STEPS)]
    jax_runs, one, cases = {}, {}, []
    for name, (kind, mode) in DS_CASES.items():
        cfg_j, _ = ds_configs(kind, mode)
        with jax_plain_attention():
            jax_runs[name] = {k: _jax_ds_run(cfg_j, axes, batches, rng)
                              for k, (_, axes) in MESHES.items()}
        opts = ["TRAIN.CLASSIFIER", kind] + MODES[mode]
        case = dict(engine="downstream", batches=batches, targets=targets, draws=draws,
                    weights=jax_runs[name]["st"]["weights"], opts=opts)
        one[name] = _one_process(worker.run_downstream_case, {**case, "name": name}, DS_TINY,
                                 out)
        cases += [{**case, "name": f"{name}-{k}", "mesh_opts": mesh_opts, "checkpoint": True}
                  for k, (mesh_opts, _) in MESHES.items()]
        cases.append({**case, "name": f"{name}-resume", "mesh_opts": FSDP, "weights": None,
                      "batches": batches[:1], "targets": targets[:1], "draws": draws[:1],
                      "resume": one[name]["checkpoint"]})
    four = _launch(dict(opts=DS_TINY, cases=cases), out, 4)
    return dict(jax=jax_runs, one=one, four=four)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name", list(DS_CASES))
def test_downstream_mesh_matches_the_jax_mesh_step(ds_runs, name, mesh_name):
    """The four ranks against JAX's downstream step on the same mesh: the
    losses, the first step's gradients (at SEQ 2 x TENSOR 2) and the three
    updates (the classifier's BatchNorm statistics with them)."""
    got, want = ds_runs["four"][f"{name}-{mesh_name}"], ds_runs["jax"][name][mesh_name]
    skip = downstream_engine.ROUNDING_ONLY
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_REL)
    if want["grads"] is not None:
        np.testing.assert_allclose(got["losses"][0], want["loss0"], rtol=LOSS_REL)
        assert set(got["grads"]) <= set(want["grads"])
        _assert_close(got["grads"], {n: want["grads"][n] for n in got["grads"]}, "gradient",
                      skip=skip)
    after = {**got["params"], **got["stats"]}
    _assert_close(_deltas(after, {n: want["init"][n] for n in after}),
                  _deltas({n: want["after"][n] for n in after}, want["init"]), "update",
                  UPDATE_REL, skip=skip)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name", list(DS_CASES))
def test_downstream_mesh_matches_one_process(ds_runs, name, mesh_name):
    got, want = ds_runs["four"][f"{name}-{mesh_name}"], ds_runs["one"][name]
    skip = downstream_engine.ROUNDING_ONLY
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_REL)
    _assert_close(got["grads"], want["grads"], "gradient", skip=skip)
    _assert_close(_deltas({**got["params"], **got["stats"]}, {**got["init"], **got["stats0"]}),
                  _deltas({**want["params"], **want["stats"]},
                          {**want["init"], **want["stats0"]}), "update", skip=skip)


@pytest.mark.parametrize("name", list(DS_CASES))
def test_downstream_mesh_checkpoints_cross_bit_for_bit(ds_runs, name):
    """Each mesh's checkpoint restores in one process bit for bit
    (backbone, classifier and its statistics), and a one-process
    checkpoint restored at DATA 2 x FSDP 2 gives every rank its shards of
    it bit for bit."""
    kind, mode = DS_CASES[name]
    _, cfg = ds_configs(kind, mode)
    for mesh_name in MESHES:
        got = ds_runs["four"][f"{name}-{mesh_name}"]
        state = downstream_engine.create_train_state(cfg, 20, 1, seed=5, dtype=torch.float32,
                                                     device="cpu")
        state, _, _ = restore_downstream_state(state, load_checkpoint(got["checkpoint"]))
        assert state.step == DS_STEPS
        flat = _ds_flat(state.model.state_dict(), state.classifier.state_dict())
        want = {**got["params"], **got["stats"]}
        assert flat.keys() == want.keys()
        assert all(torch.equal(flat[n], want[n]) for n in want), mesh_name
    resumed, one = ds_runs["four"][f"{name}-resume"], ds_runs["one"][name]
    assert all(torch.equal(resumed["init"][n], one["params"][n]) for n in one["params"])


@pytest.mark.parametrize("name", list(DS_CASES))
def test_downstream_fsdp_whole_weights_live_only_while_their_linear_runs(ds_runs, name):
    """At DATA 2 x FSDP 2 no whole weight that a rank gathered is alive at
    the end of the backbone's first forward."""
    for rank in ds_runs["four"][f"{name}-fsdp"]["whole_alive"]:
        assert rank["gathered"] > 0 and rank["alive"] == 0, rank
