"""PyTorch port: the DINO train and eval steps, the DINO state across
frameworks, checkpoints, the CLI and data parallelism, against the JAX
package on the CPU.

The tiny configuration is the JAX DINO tests' (``tests/test_dino_engine.py:18-44``:
24^3, patch 12, width 48, 2 layers, 4 heads, 2 registers, 128 prototypes,
hidden 64, bottleneck 16, GRAD_CLIP 1.0) with hu16 wire batches and
``PALLAS_MIN_T`` 11, so both sides take their whole-sequence attention at
T = 11 (8 patches, CLS, 2 registers): the interpreted Pallas kernels in JAX,
``FusedAttention`` (its plain versions on the CPU) in the port. Both start
from the JAX init carried across with ``state_dict_from_jax`` and the port
is handed the crop decisions that the JAX step draws from its keys. Limits:

* float32 trajectory (3 steps): the loss within 1e-4 relative at every
  step; the student, the teacher and the centre per tensor within the MAE
  trajectory test's limits (rtol 1e-3, atol 1e-5; a qkv bias without its
  key third, whose gradient is 0 but for rounding; ``ADAM_NOISE_SHARE`` of a
  tensor's elements may be up to one LR apart); with the last layer
  frozen, ``weight_v`` bit-equal to its start on both sides;
* bfloat16 trajectory (3 steps): no farther from the float32 reference
  than JAX's own bf16 run (loss, all updates, worst tensor; 1.5 times), and
  against JAX's bf16 run the loss within 2e-2 relative, all the student's
  updates together normwise within 0.05 and each tensor's within 0.35
  (``BF16_*``: the MAE's loss 1e-3 does not hold, see there);
* the eval loss within 1e-5 relative (float32);
* the DINO tree and its AdamW state across, both ways: bit-exact.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from headct_foundation_tpu.config import default_config as jax_default_config
from headct_foundation_tpu.engines import dino_engine as jax_engine
from headct_foundation_tpu.engines.mae_engine import _to_device_batch
from headct_foundation_tpu.ops import attention as jax_attn
from headct_foundation_tpu.parallel.mesh import make_mesh
from headct_foundation_tpu.utils import checkpoint as jax_ckpt
from headct_foundation_tpu.utils.torch_interop import tree_to_torch
from headct_foundation_tpu_torch.config import default_config
from headct_foundation_tpu_torch.data.transforms import hu16_encode
from headct_foundation_tpu_torch.engines import dino_engine
from headct_foundation_tpu_torch.ops import attention as port_attn
from headct_foundation_tpu_torch.optim.optimizers import without_key_bias
from headct_foundation_tpu_torch.utils import checkpoint as ckpt
from headct_foundation_tpu_torch.utils.torch_interop import (
    jax_tree_from_state_dict,
    opt_state_from_jax,
    opt_state_to_jax,
    state_dict_from_jax,
)
from tests.test_torch_port_dino import jax_multicrop_decisions

TINY = ["MODEL.ROI", [24, 24, 24], "MODEL.IN_CHANS", 3, "VIT.INPUT_SIZE", 24,
        "VIT.PATCH_SIZE", 12, "VIT.IN_CHANS", 3, "VIT.HIDDEN_SIZE", 48, "VIT.MLP_DIM", 96,
        "VIT.NUM_LAYERS", 2, "VIT.NUM_HEADS", 4, "VIT.NUM_REGISTER_TOKENS", 2,
        "VIT.USE_BIAS", True, "VIT.POS_EMBED", "sincos", "DINO.HEAD_N_PROTOTYPES", 128,
        "DINO.HEAD_HIDDEN_DIM", 64, "DINO.BOTTLENECK_DIM", 16, "DINO.LOCAL_CROP_NUM", 2,
        "DINO.USE_BN", False, "DINO.WARMUP_TEACHER_EPOCHS", 2, "TRAIN.MAX_EPOCHS", 4,
        "TRAIN.GRAD_CLIP", 1.0, "TRAIN.BASE_LR", 1e-3, "TRAIN.MIN_LR", 1e-6,
        "TRAIN.OPTIMIZER", "AdamW", "TRAIN.WEIGHT_DECAY", 0.04, "TRAIN.WEIGHT_DECAY_END", 0.4,
        "DATA.WIRE_FORMAT", "hu16", "PARALLEL.PALLAS_MIN_T", 11]
TOTAL_STEPS, WARMUP, NITER = 20, 0, 5
F32_LOSS_REL, EVAL_LOSS_REL = 1e-4, 1e-5
MOMENTUM, TEMP = 0.99, 0.04


@contextlib.contextmanager
def _kernel_backends():
    """JAX on its Pallas kernels, the port on its kernel backend; the
    crossover comes from the configs' PALLAS_MIN_T."""
    prev = (jax_attn.set_attention_backend("pallas"), jax_attn.set_pallas_min_t(None),
            port_attn.set_attention_backend("kernel"), port_attn.set_pallas_min_t(None))
    try:
        yield
    finally:
        jax_attn.set_attention_backend(prev[0])
        jax_attn.set_pallas_min_t(prev[1])
        port_attn.set_attention_backend(prev[2])
        port_attn.set_pallas_min_t(prev[3])


@pytest.fixture
def backends():
    with _kernel_backends():
        yield


def _configs(*extra):
    cfg_j, cfg_p = jax_default_config(), default_config()
    cfg_j.merge_from_list(TINY + list(extra))
    cfg_p.merge_from_list(TINY + list(extra))
    return cfg_j, cfg_p


def _wires(k: int, batch: int, seed: int = 11) -> list:
    rng = np.random.RandomState(seed)
    return [hu16_encode(rng.uniform(-1000, 1500, (batch, 1, 24, 24, 24))) for _ in range(k)]


def _numpy(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


F32 = (jnp.float32, torch.float32)
BF16 = (jnp.bfloat16, torch.bfloat16)


@pytest.fixture(scope="module")
def jax_start():
    """``get(extra, dtype)``: (JAX config, port config, mesh, JAX's initial
    state, JAX's jitted step) of that case, built once: JAX's init and its
    step's compile are most of a trajectory's time. The step donates its
    state, so every use takes a copy (``_states``)."""
    built = {}

    def get(extra=(), dtype=F32):
        key = (tuple(extra), dtype)
        if key not in built:
            cfg_j, cfg_p = _configs(*extra)
            mesh = make_mesh(data=1, devices=jax.devices()[:1])
            state_j = jax_engine.create_train_state(cfg_j, mesh, jax.random.PRNGKey(0),
                                                    TOTAL_STEPS, WARMUP, NITER,
                                                    dtype=dtype[0])[0]
            built[key] = (cfg_j, cfg_p, mesh, state_j, jax_engine.make_train_step(cfg_j, mesh))
        return built[key]

    return get


def _states(start, dtype):
    """A copy of the JAX initial state and a port state with its weights."""
    cfg_j, cfg_p, mesh, state_j, _ = start
    state_j = jax.tree.map(lambda x: jnp.array(x, copy=True), state_j)
    state = dino_engine.create_train_state(cfg_p, TOTAL_STEPS, WARMUP, NITER, seed=0,
                                           dtype=dtype[1], device="cpu")
    state.student.load_state_dict(state_dict_from_jax(_numpy(state_j.params)))
    state.teacher.load_state_dict(state_dict_from_jax(_numpy(state_j.teacher_params)))
    return state_j, state


def _jax_draws(rng, step: int, accum: int, n: int) -> list:
    """The crop decisions of the JAX step's micro-batches (``:246-258``)."""
    crop_rng, _ = jax.random.split(jax.random.fold_in(rng, step))
    return [jax_multicrop_decisions(jax.random.fold_in(crop_rng, i), n, 24, 112, 64, 2)
            for i in range(accum)]


def _params(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _trajectory(start, dtype, steps: int, cancel: bool, batch: int = 4):
    """``steps`` updates on both sides; returns (JAX state, port state, JAX
    losses, port losses, the port's initial student)."""
    cfg_j, cfg_p, mesh, _, step_j = start
    state_j, state = _states(start, dtype)
    accum = int(cfg_p.TRAIN.ACCUM_STEPS)
    step = dino_engine.make_train_step(cfg_p)
    init = _params(state.student)
    rng = jax.random.PRNGKey(1)
    losses_j, losses = [], []
    for s, wire in enumerate(_wires(steps, batch)):
        state_j, m_j = step_j(state_j, _to_device_batch(wire, mesh), rng,
                              jnp.asarray(MOMENTUM, jnp.float32), jnp.asarray(TEMP, jnp.float32),
                              jnp.asarray(1.0 if cancel else 0.0))
        state, m = step(state, torch.from_numpy(wire), 0, MOMENTUM, TEMP, cancel,
                        draws=_jax_draws(rng, s, accum, batch // accum))
        losses_j.append(float(m_j["loss"]))
        losses.append(m["loss"].item())
    assert state.step == steps == int(state_j.step)
    return state_j, state, losses_j, losses, init


def _without_key_bias(name: str, v) -> np.ndarray:
    return without_key_bias(name, torch.from_numpy(np.asarray(v))).numpy()


# AdamW's first update is g / (|g| + 1e-8): an element whose gradient is of
# the order of 1e-8 (terms of 1e-4 that cancel) moves with the last bits of
# its sum. Measured in the ACCUM_STEPS 2 case: 5 of the 248832 patch-kernel
# elements (2.0e-5) are up to 1.5e-4 apart, gradients 0.4e-8 to 2e-8. This
# share of a tensor's elements may leave the limits, by at most one LR.
ADAM_NOISE_SHARE = 1e-4


def assert_tensor_close(name: str, got, want, what: str = "") -> None:
    """rtol 1e-3, atol 1e-5 (the MAE trajectory test's limits), but for a
    qkv bias's key third and ``ADAM_NOISE_SHARE`` of the elements."""
    got, exp = _without_key_bias(name, got), _without_key_bias(name, want)
    off = ~np.isclose(got, exp, rtol=1e-3, atol=1e-5)
    assert off.sum() <= ADAM_NOISE_SHARE * off.size, (what, name, int(off.sum()))
    assert not off.any() or np.abs(got - exp)[off].max() <= 1e-3, (what, name)


def _assert_trees_close(model, tree, what):
    want = state_dict_from_jax(_numpy(tree))
    for name, p in model.state_dict().items():
        assert_tensor_close(name, p.numpy(), want[name].numpy(), what)


@pytest.fixture(scope="module")
def runs(jax_start):
    """``get(extra, cancel, dtype)``: the 3-step trajectory of that case
    (configs, then ``_trajectory``'s results), run once for every test that
    reads it."""
    done = {}

    def get(extra=(), cancel=False, dtype=F32):
        key = (tuple(extra), cancel, dtype)
        if key not in done:
            with _kernel_backends():
                start = jax_start(extra, dtype)
                done[key] = start[:2] + _trajectory(start, dtype, 3, cancel)
        return done[key]

    return get


@pytest.mark.parametrize("extra,cancel", [
    pytest.param([], False, id="3-steps"),
    pytest.param([], True, id="frozen-last-layer"),
    pytest.param(["TRAIN.ACCUM_STEPS", 2], False, id="accum-2"),
])
def test_f32_train_trajectory_matches_jax(runs, extra, cancel):
    _, _, state_j, state, losses_j, losses, init = runs(extra, cancel)
    np.testing.assert_allclose(losses, losses_j, rtol=F32_LOSS_REL)
    _assert_trees_close(state.student, state_j.params, "student")
    _assert_trees_close(state.teacher, state_j.teacher_params, "teacher")
    np.testing.assert_allclose(state.center.numpy(), np.asarray(state_j.center), rtol=1e-3,
                               atol=1e-5)
    after = _params(state.student)
    v = "head.last_layer.weight_v"
    v_j = np.asarray(state_j.params["head"]["last_layer"]["weight_v"])
    if cancel:  # bit-frozen on both sides; its step count went on with optax's
        assert torch.equal(after[v], init[v]) and np.array_equal(v_j, init[v].numpy())
        p_v = state.student.head.last_layer.weight_v
        assert int(state.optimizer.state[p_v]["step"]) == 3
    else:
        assert not torch.equal(after[v], init[v])
    frozen = {"backbone.patch_embedding.position_embeddings", "head.last_layer.weight_g"}
    assert {k for k in init if torch.equal(after[k], init[k])} == (
        frozen | ({v} if cancel else set()))


# The bfloat16 trajectory (3 steps) does not meet the MAE's limits (loss
# 1e-3, each tensor's update 0.05), and the JAX package's own bf16 run does
# not meet them against its float32 run either: the teacher's temperature
# 0.04 and the student's 0.1 scale the logits' bf16 roundings up by 25 and
# 10, and the frameworks round at different points (XLA rounds a Dense's
# product before its bias add and each step of the tanh GELU; torch rounds
# each once). Measured on the CPU, the loss at steps 0 (before any update),
# 1 and 2 relative to the float32 JAX run: JAX bf16 5.6e-3, 3.6e-3, 7.2e-3;
# the port's bf16 3.7e-3, 1.4e-3, 4.4e-3; the two bf16 runs 9.3e-3, 4.9e-3,
# 2.9e-3 apart. All of the student's updates together, normwise against the
# float32 run's: JAX bf16 0.041 off it, the port's 0.036, the two 0.039
# apart; the worst tensor 0.178, 0.180 and 0.173 (biases of 48 elements).
# So the port's bf16 run is held two ways:
# * against the float32 reference, no farther from it than JAX's own bf16
#   run is, times BF16_NO_WORSE_THAN_JAX: the loss at its worst step, all
#   updates together and the worst tensor;
# * against JAX's bf16 run: the loss within BF16_DINO_LOSS_REL (about twice
#   the 9.3e-3), all updates together within 0.05 (the MAE's limit), each
#   tensor within BF16_DINO_TENSOR_REL (about twice the 0.173).
BF16_NO_WORSE_THAN_JAX = 1.5
BF16_DINO_LOSS_REL, BF16_DINO_UPDATE_REL, BF16_DINO_TENSOR_REL = 2e-2, 5e-2, 0.35


def _update_distance(a: dict, b: dict, ref: dict, init: dict) -> tuple:
    """||du_a - du_b|| / ||du_ref|| over all tensors together, and the worst
    (ratio, name) of a tensor; du = parameters minus ``init``, without a qkv
    bias's key third."""
    num = den = 0.0
    worst = (0.0, "")
    for name, p0 in init.items():
        du = {k: without_key_bias(name, t[name].float() - p0.float())
              for k, t in (("a", a), ("b", b), ("ref", ref))}
        if du["ref"].norm() > 0:
            off = (du["a"] - du["b"]).norm()
            worst = max(worst, ((off / du["ref"].norm()).item(), name))
            num, den = num + (off ** 2).item(), den + (du["ref"].norm() ** 2).item()
    return (num / den) ** 0.5, worst


def test_bf16_train_trajectory_matches_jax(runs):
    _, _, j16, p16, losses_j16, losses16, init = runs(dtype=BF16)
    _, _, j32, _, losses_j32, _, init32 = runs()
    assert all(torch.equal(init[k], init32[k]) for k in init)
    w = {"j16": state_dict_from_jax(_numpy(j16.params)), "p16": p16.student.state_dict(),
         "j32": state_dict_from_jax(_numpy(j32.params))}
    assert all(p.dtype == torch.float32 for p in w["p16"].values())  # compute in bf16 only

    # no farther from the float32 reference than JAX's own bf16 run
    loss_off = lambda ls: max(abs(a / b - 1) for a, b in zip(ls, losses_j32))
    assert loss_off(losses16) <= BF16_NO_WORSE_THAN_JAX * loss_off(losses_j16), (
        losses16, losses_j16, losses_j32)
    port, port_worst = _update_distance(w["p16"], w["j32"], w["j32"], init)
    jax_, jax_worst = _update_distance(w["j16"], w["j32"], w["j32"], init)
    assert port <= BF16_NO_WORSE_THAN_JAX * jax_, (port, jax_)
    assert port_worst[0] <= BF16_NO_WORSE_THAN_JAX * jax_worst[0], (port_worst, jax_worst)

    # against JAX's bf16 run
    np.testing.assert_allclose(losses16, losses_j16, rtol=BF16_DINO_LOSS_REL)
    apart, worst = _update_distance(w["p16"], w["j16"], w["j16"], init)
    assert apart <= BF16_DINO_UPDATE_REL, apart
    assert worst[0] <= BF16_DINO_TENSOR_REL, worst


def test_eval_loss_matches_jax(backends, jax_start):
    cfg_j, cfg_p, mesh, *_ = jax_start()
    state_j, state = _states(jax_start(), F32)
    wire = _wires(1, 4, seed=12)[0]
    rng = jax.random.PRNGKey(5)
    want = float(jax_engine.make_eval_step(cfg_j, mesh)(
        state_j, _to_device_batch(wire, mesh), rng, jnp.asarray(TEMP, jnp.float32))["loss"])
    got = dino_engine.make_eval_step(cfg_p)(
        state, torch.from_numpy(wire), None, TEMP,
        draws=jax_multicrop_decisions(rng, 4, 24, 112, 64, 2))["loss"].item()
    np.testing.assert_allclose(got, want, rtol=EVAL_LOSS_REL)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", np.asarray(v)


def _assert_trees_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys(), sorted(set(got) ^ set(want))[:5]
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_dino_tree_and_optimizer_state_cross_both_ways(runs):
    """After the JAX trajectory's 3 steps (the Adam moments non-zero), a
    fresh port state takes the student, the teacher and the AdamW state bit
    for bit and gives them back bit for bit; the keys equal ``tree_to_torch``'s."""
    from flax import serialization

    _, cfg_p, state_j, *_ = runs()
    state = dino_engine.create_train_state(cfg_p, TOTAL_STEPS, WARMUP, NITER, seed=3,
                                           dtype=torch.float32, device="cpu")
    params, opt = _numpy(state_j.params), serialization.to_state_dict(_numpy(state_j.opt_state))
    sd = state_dict_from_jax(params)
    assert set(sd) == set(tree_to_torch(params)) == set(state.student.state_dict())
    for name, v in tree_to_torch(params).items():
        assert np.array_equal(sd[name].numpy(), v), name
    state.student.load_state_dict(sd)
    opt_state_from_jax(opt, state.optimizer, state.student, cfg_p, 3, norm_layer="layernorm")
    _assert_trees_equal(jax_tree_from_state_dict(state.student.state_dict()), params)
    _assert_trees_equal(opt_state_to_jax(state.optimizer, state.student, cfg_p, 3,
                                         norm_layer="layernorm"), opt)
    masked = opt["inner_states"]["train"]["inner_state"]["1"]["mu"]
    assert masked["head"]["last_layer"]["weight_g"] == {}
    assert masked["backbone"]["patch_embedding"]["position_embeddings"] == {}


def test_checkpoints_cross_between_the_port_and_jax(runs, tmp_path):
    """A file the port writes restores in JAX ``restore_dino_state`` to the
    same trees, and a JAX file restores in the port bit for bit."""
    from headct_foundation_tpu.engines.dino_engine import _ckpt_view

    _, cfg_p, state_j, state, *_ = runs()
    ckpt.save_checkpoint(state, 1, 0.5, str(tmp_path), "port.ckpt")
    payload = jax_ckpt.load_checkpoint(str(tmp_path / "port.ckpt"))
    assert {"momentum_model_state_dict", "center", "head_stats", "teacher_head_stats"} <= set(
        payload)
    restored, epoch, best = jax_ckpt.restore_dino_state(state_j, payload)
    assert (epoch, best, int(restored.step)) == (1, 0.5, 3)
    _assert_trees_equal(_numpy(restored.params),
                        jax_tree_from_state_dict(state.student.state_dict()))
    _assert_trees_equal(_numpy(restored.teacher_params),
                        jax_tree_from_state_dict(state.teacher.state_dict()))
    assert np.array_equal(np.asarray(restored.center), state.center.numpy())

    # the other way: JAX writes, the port restores into a fresh state
    jax_ckpt.save_checkpoint(_ckpt_view(state_j), 1, 0.25, str(tmp_path), "jax.ckpt",
                             extra={"momentum_model_state_dict": state_j.teacher_params,
                                    "center": state_j.center, "head_stats": {},
                                    "teacher_head_stats": {}}, fmt="pickle")
    jax_ckpt.wait_for_saves()
    payload = ckpt.load_checkpoint(str(tmp_path / "jax.ckpt"))
    fresh = dino_engine.create_train_state(cfg_p, TOTAL_STEPS, WARMUP, NITER, seed=3,
                                           dtype=torch.float32, device="cpu")
    fresh, epoch, best = ckpt.restore_dino_state(fresh, payload)
    assert (epoch, best, fresh.step) == (1, 0.25, 3)
    _assert_trees_equal(jax_tree_from_state_dict(fresh.student.state_dict()), payload["params"])
    _assert_trees_equal(jax_tree_from_state_dict(fresh.teacher.state_dict()),
                        payload["momentum_model_state_dict"])
    _assert_trees_equal(opt_state_to_jax(fresh.optimizer, fresh.student, cfg_p, 3,
                                         norm_layer="layernorm"), payload["opt_state"])
    assert np.array_equal(fresh.center.numpy(), payload["center"])


def test_restore_dino_state_skips_what_is_missing_or_does_not_fit(tmp_path, caplog):
    cfg = default_config()
    cfg.merge_from_list(TINY)
    state = dino_engine.create_train_state(cfg, 10, 0, 5, seed=0, dtype=torch.float32,
                                           device="cpu")
    path = ckpt.save_checkpoint(state, 0, 1.0, str(tmp_path), "a.ckpt")
    payload = ckpt.load_checkpoint(path)
    del payload["center"]
    payload["head_stats"] = {"mlp_bn_0": {"mean": np.zeros(64, np.float32)}}
    other = dino_engine.create_train_state(cfg, 10, 0, 5, seed=1, dtype=torch.float32,
                                           device="cpu")
    center = other.center.clone()
    import logging

    logger = logging.getLogger("dino-restore")
    with caplog.at_level(logging.WARNING, logger="dino-restore"):
        other, _, _ = ckpt.restore_dino_state(other, payload, logger=logger)
    assert "center" in caplog.text and "head_stats (" in caplog.text
    assert torch.equal(other.center, center)
    for k, v in state.teacher.state_dict().items():
        assert torch.equal(other.teacher.state_dict()[k], v), k
    payload["params"]["head"]["mlp_0"]["kernel"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError):
        ckpt.restore_dino_state(other, payload)
