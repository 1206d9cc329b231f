"""PyTorch port: checkpoints in the JAX package's pickle format.

* A port save -> load round trip is bit-exact (parameters, optimizer
  state, step, epoch, best loss), written synchronously and on the writer
  thread, for SGD, AdamW, Lamb and Lion fused and unfused.
* The payload's key tree, shapes and dtypes are those of the JAX package's
  ``save_checkpoint`` for the same configuration and optimizer, with and
  without the gradient clip (the JAX payload from ``get_optimizer`` ->
  ``tx.init`` -> flax's ``to_state_dict``, as its ``save_checkpoint`` writes).
* A JAX checkpoint resumes in the port: JAX trains 2 steps and saves, the
  port loads and takes step 3, which matches JAX's step 3 within
  ``tests/test_torch_port_train.py``'s float32 limits (loss rtol 1e-3,
  parameters rtol 1e-3 / atol 1e-5). A port checkpoint restores in JAX's
  ``restore_state`` with the port's values bit for bit, and a JAX one in
  the port's.
* A 3-step port trajectory interrupted after step 2 (save, load into a fresh
  state, step 3) equals the uninterrupted one bit for bit.
* ``classify_checkpoint`` routes a torch file, a pickle named ``.pt`` and a
  truncated file as JAX's does; an orbax directory or format and a bfloat16
  leaf raise named errors.

Tiny sizes (24^3, patch 12, width 48), float32, on the CPU.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from headct_foundation_tpu.engines import mae_engine as jax_engine
from headct_foundation_tpu.optim import lr_sched as jax_lr_sched
from headct_foundation_tpu.optim import optimizers as jax_optimizers
from headct_foundation_tpu.parallel.mesh import make_mesh
from headct_foundation_tpu.utils import checkpoint as jax_ckpt
from headct_foundation_tpu.utils import torch_interop as jax_interop
from headct_foundation_tpu_torch.engines import mae_engine
from headct_foundation_tpu_torch.utils import checkpoint as ckpt
from headct_foundation_tpu_torch.utils import torch_interop as interop
from tests.test_torch_port_train import (  # noqa: F401  (backends is a fixture)
    TOTAL_STEPS,
    WARMUP,
    _configs,
    _jax_draws,
    _wire_batches,
    backends,
)

OPTIMIZERS = [
    pytest.param({"OPTIMIZER": "SGD"}, id="SGD"),
    pytest.param({"OPTIMIZER": "AdamW"}, id="AdamW"),
    pytest.param({"OPTIMIZER": "Lamb"}, id="Lamb"),
    pytest.param({"OPTIMIZER": "Lion"}, id="Lion-unfused"),
    pytest.param({"OPTIMIZER": "Lion", "LION_FUSED": True}, id="Lion-fused"),
]


def _cfgs(train: dict):
    cfg_j, cfg_p = _configs()
    for cfg in (cfg_j, cfg_p):
        for key, value in train.items():
            setattr(cfg.TRAIN, key, value)
    return cfg_j, cfg_p


def _port_state(cfg, seed: int = 0):
    state, _ = mae_engine.create_train_state(cfg, TOTAL_STEPS, WARMUP, seed=seed,
                                             dtype=torch.float32, device="cpu")
    return state


def _train(state, cfg, wires):
    step = mae_engine.make_train_step(augment=True, config=cfg)
    for wire in wires:
        state, _ = step(state, torch.from_numpy(wire), seed=0)
    return state


def _opt_tensors(state) -> dict:
    """name -> {state key: tensor} of the optimizer state."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    return {names[id(p)]: {k: v.clone() for k, v in st.items()}
            for p, st in state.optimizer.state.items()}


def _assert_states_equal(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = _opt_tensors(a), _opt_tensors(b)
    assert oa.keys() == ob.keys()
    for n in oa:
        assert oa[n].keys() == ob[n].keys(), n
        for k in oa[n]:
            assert torch.equal(oa[n][k], ob[n][k]), (n, k)
    assert a.step == b.step


@pytest.mark.parametrize("async_save", [False, True], ids=["sync", "async"])
@pytest.mark.parametrize("train", OPTIMIZERS)
def test_round_trip_is_bit_exact(tmp_path, train, async_save):
    _, cfg = _cfgs(train)
    state = _train(_port_state(cfg), cfg, _wire_batches(2, 2))
    path = ckpt.save_checkpoint(state, 4, 0.25, str(tmp_path), "latest_x.pt",
                                async_save=async_save)
    ckpt.wait_for_saves()
    fresh = _port_state(cfg, seed=1)
    fresh, epoch, best = ckpt.restore_state(fresh, ckpt.load_checkpoint(path))
    assert (epoch, best) == (4, 0.25)
    _assert_states_equal(fresh, state)
    if train["OPTIMIZER"] == "AdamW":  # one step count: TrainState's, optax's and torch's
        for st in fresh.optimizer.state.values():
            assert float(st["step"]) == fresh.step == 2


def _signature(tree):
    if isinstance(tree, dict):
        return {k: _signature(v) for k, v in tree.items()}
    if isinstance(tree, (int, float, str)):
        return type(tree).__name__
    a = np.asarray(tree)
    return (a.shape, a.dtype.name)


@pytest.fixture(scope="module")
def jax_params():
    """The JAX MAE's initial parameters (numpy) and trainable mask."""
    cfg_j, _ = _configs()
    mesh = make_mesh(data=1, devices=jax.devices()[:1])
    state_j, _, _ = jax_engine.create_train_state(cfg_j, mesh, jax.random.PRNGKey(0),
                                                  TOTAL_STEPS, WARMUP, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jax.device_get(state_j.params))
    return params, jax_engine.mae_trainable_mask(params, cfg_j.MAE.POS_EMBED)


@pytest.mark.parametrize("clip", [1.0, 0.0], ids=["clip", "noclip"])
@pytest.mark.parametrize("train", OPTIMIZERS)
def test_payload_layout_equals_jax(tmp_path, jax_params, train, clip):
    """The JAX payload is what its save_checkpoint writes for a fresh state:
    get_optimizer -> tx.init -> flax's to_state_dict."""
    cfg_j, cfg_p = _cfgs({**train, "GRAD_CLIP": clip})
    params, mask = jax_params
    schedule = jax_lr_sched.get_lr_schedule(cfg_j, cfg_j.TRAIN.BASE_LR, WARMUP, TOTAL_STEPS,
                                            cfg_j.TRAIN.MIN_LR)
    tx = jax_optimizers.get_optimizer(cfg_j, schedule, grad_clip=clip or None,
                                      trainable_mask=mask)
    want = _signature({"epoch": 0, "best_loss": 1.0, "step": 0,
                       "params": serialization.to_state_dict(params),
                       "opt_state": serialization.to_state_dict(jax.device_get(tx.init(params)))})
    path = ckpt.save_checkpoint(_port_state(cfg_p), 0, 1.0, str(tmp_path), "port.ckpt")
    got = _signature(ckpt.load_checkpoint(path))
    assert got == want


def test_jax_checkpoint_resumes_in_port(tmp_path, backends):
    """JAX: 2 steps, save_checkpoint; the port loads it and takes step 3 with
    JAX's draws; JAX takes its step 3; both agree within the float32 limits."""
    cfg_j, cfg_p = _configs()
    mesh = make_mesh(data=1, devices=jax.devices()[:1])
    rng = jax.random.PRNGKey(0)
    state_j, _, _ = jax_engine.create_train_state(cfg_j, mesh, rng, TOTAL_STEPS, WARMUP,
                                                  dtype=jnp.float32)
    step_j = jax_engine.make_train_step(mesh, augment=True, config=cfg_j)
    jax_model = jax_engine.build_mae_model(cfg_j, dtype=jnp.float32)
    wires = _wire_batches(3, 4)
    for wire in wires[:2]:
        state_j, _ = step_j(state_j, jax_engine._to_device_batch(wire, mesh), rng)
    jax_ckpt.save_checkpoint(state_j, 1, 0.5, str(tmp_path), "jax.ckpt")

    state = _port_state(cfg_p, seed=3)
    state, epoch, best = ckpt.restore_state(state, ckpt.load_checkpoint(str(tmp_path / "jax.ckpt")))
    assert (epoch, best, state.step) == (1, 0.5, 2)
    want = interop.state_dict_from_jax(jax.tree.map(np.asarray, jax.device_get(state_j.params)))
    for k, v in state.model.state_dict().items():  # the load itself is bit-exact
        assert torch.equal(v, want[k]), k

    draws = _jax_draws(jax_model, rng, 2, 1, 4)
    state_j, m_j = step_j(state_j, jax_engine._to_device_batch(wires[2], mesh), rng)
    step = mae_engine.make_train_step(augment=True, config=cfg_p)
    state, m = step(state, torch.from_numpy(wires[2]), seed=0, draws=draws)
    np.testing.assert_allclose(m["loss"].item(), float(m_j["loss"]), rtol=1e-3)
    want = interop.state_dict_from_jax(jax.tree.map(np.asarray, jax.device_get(state_j.params)))
    for name, p in state.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=1e-3, atol=1e-5,
                                   err_msg=name)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def test_checkpoints_restore_across_packages(tmp_path):
    """A port file restores in JAX's restore_state, and a JAX file in the
    port's, each with the writer's values bit for bit."""
    cfg_j, cfg_p = _configs()
    mesh = make_mesh(data=1, devices=jax.devices()[:1])
    state_j, _, _ = jax_engine.create_train_state(cfg_j, mesh, jax.random.PRNGKey(0),
                                                  TOTAL_STEPS, WARMUP, dtype=jnp.float32)
    state = _train(_port_state(cfg_p), cfg_p, _wire_batches(3, 2))
    path = ckpt.save_checkpoint(state, 2, 0.75, str(tmp_path), "port.ckpt")
    restored, epoch, best = jax_ckpt.restore_state(state_j, jax_ckpt.load_checkpoint(path))
    assert (epoch, best, int(restored.step)) == (2, 0.75, 3)
    written = ckpt.load_checkpoint(path)
    for what in ("params", "opt_state"):
        got = _flat(serialization.to_state_dict(jax.device_get(getattr(restored, what))))
        want = _flat(written[what])
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k

    # the other way: JAX's own file (after a save of the restored state) into the port
    jax_ckpt.save_checkpoint(restored, 2, 0.75, str(tmp_path), "jax.ckpt")
    back = _port_state(cfg_p, seed=5)
    back, epoch, best = ckpt.restore_state(back, ckpt.load_checkpoint(str(tmp_path / "jax.ckpt")))
    assert (epoch, best) == (2, 0.75)
    _assert_states_equal(back, state)


@pytest.mark.parametrize("train", OPTIMIZERS)
def test_interrupted_trajectory_is_bit_exact(tmp_path, train):
    _, cfg = _cfgs(train)
    wires = _wire_batches(3, 2)
    straight = _train(_port_state(cfg), cfg, wires)
    first = _train(_port_state(cfg), cfg, wires[:2])
    path = ckpt.save_checkpoint(first, 0, 1.0, str(tmp_path), "mid.ckpt", async_save=True)
    ckpt.wait_for_saves()
    resumed, _, _ = ckpt.restore_state(_port_state(cfg, seed=9), ckpt.load_checkpoint(path))
    resumed = _train(resumed, cfg, wires[2:])
    _assert_states_equal(resumed, straight)


def test_state_dict_maps_to_the_jax_tree_and_back():
    """jax_tree_from_state_dict is the inverse of state_dict_from_jax, bit for
    bit, and gives the JAX package's torch_to_tree of the same state_dict."""
    _, cfg = _configs()
    sd = _port_state(cfg).model.state_dict()
    tree = interop.jax_tree_from_state_dict(sd)
    back = interop.state_dict_from_jax(tree)
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)
    want = _flat(jax_interop.torch_to_tree({k: v.numpy() for k, v in sd.items()})["params"])
    got = _flat(tree)
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)


def test_classify_checkpoint_routes_as_jax(tmp_path):
    _, cfg = _configs()
    state = _port_state(cfg)
    torch_pt = tmp_path / "ref.pt"
    torch.save({"state_dict": state.model.state_dict()}, torch_pt)
    native_pt = ckpt.save_checkpoint(state, 0, 1.0, str(tmp_path), "native.pt")
    trunc = tmp_path / "trunc.pt"
    trunc.write_bytes(open(native_pt, "rb").read()[:1000])
    for path, is_torch in ((str(torch_pt), True), (native_pt, False), (str(trunc), True)):
        got, payload = interop.classify_checkpoint(path)
        want, _ = jax_interop.classify_checkpoint(path)
        assert got == want == is_torch, path
        assert (payload is None) == is_torch

    # the torch file routes to a params-only merge that equals JAX's
    model = mae_engine.build_mae_model(cfg, dtype=torch.float32)
    missing, unexpected = interop.load_pretrained_into(model, str(torch_pt))
    assert not missing and not unexpected
    merged = jax_interop.load_pretrained_into(
        interop.jax_tree_from_state_dict(_port_state(cfg, seed=2).model.state_dict()),
        str(torch_pt))
    want = interop.state_dict_from_jax(merged)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_orbax_and_bf16_leaves_raise(tmp_path):
    _, cfg = _configs()
    state = _port_state(cfg)
    orbax_dir = tmp_path / "ckpt_orbax"
    orbax_dir.mkdir()
    with pytest.raises(interop.OrbaxNotSupportedError, match="orbax"):
        ckpt.load_checkpoint(str(orbax_dir))
    with pytest.raises(interop.OrbaxNotSupportedError, match="orbax"):
        interop.classify_checkpoint(str(orbax_dir))
    with pytest.raises(interop.OrbaxNotSupportedError, match="orbax"):
        ckpt.save_checkpoint(state, 0, 1.0, str(tmp_path), "x", fmt="orbax")

    payload = ckpt.load_checkpoint(ckpt.save_checkpoint(state, 0, 1.0, str(tmp_path), "f32.ckpt"))
    payload["params"]["cls_token"] = payload["params"]["cls_token"].astype(jnp.bfloat16)
    with open(tmp_path / "bf16.ckpt", "wb") as f:
        pickle.dump(payload, f)
    with pytest.raises(interop.CheckpointDtypeError, match="bfloat16"):
        ckpt.load_checkpoint(str(tmp_path / "bf16.ckpt"))
    with pytest.raises(interop.CheckpointDtypeError, match="bfloat16"):
        interop.classify_checkpoint(str(tmp_path / "bf16.ckpt"))
    payload["params"]["cls_token"] = payload["params"]["cls_token"].astype(np.float16)
    with pytest.raises(interop.CheckpointDtypeError, match="float16"):
        ckpt.restore_state(state, payload)
    assert os.path.exists(tmp_path / "f32.ckpt")
