"""PyTorch port: the MAE train step, held against the JAX package's
``make_train_step(augment=True)`` on a one-device CPU mesh.

Both start from the same weights (the JAX init, carried over with
``state_dict_from_jax``) and take the same hu16 wire batches. The port is
handed the mask noise and augmentation decisions that the JAX step draws
from its keys (``engines/mae_engine.py:252-259, 288``: the step key folds
in the update count, the micro-batch key the micro-batch index, the mask
key is its first split, handed to flax as the "mask" stream, and the
augmentation key its fold with 7). Compute
is float32 on both sides (the wire batch is still cast to bfloat16 first,
as the JAX step does), and bfloat16 on both in the bf16 trajectory; the decoder (T=9) runs the Pallas kernels in JAX and
``FusedAttention`` in the port, the encoder (T=3) plain attention.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from headct_foundation_tpu.config import default_config as jax_default_config
from headct_foundation_tpu.engines import mae_engine as jax_engine
from headct_foundation_tpu.ops import attention as jax_attn
from headct_foundation_tpu.optim import lr_sched as jax_lr_sched
from headct_foundation_tpu.parallel.mesh import make_mesh
from headct_foundation_tpu_torch.config import default_config
from headct_foundation_tpu_torch.data.transforms import hu16_encode
from headct_foundation_tpu_torch.engines import mae_engine
from headct_foundation_tpu_torch.ops import attention as port_attn
from headct_foundation_tpu_torch.optim import lr_sched
from headct_foundation_tpu_torch.optim.optimizers import without_key_bias
from headct_foundation_tpu_torch.utils.torch_interop import state_dict_from_jax
from tests.test_torch_port_mae import jax_augment_decisions

TINY = ["MAE.INPUT_SIZE", 24, "MAE.PATCH_SIZE", 12, "MAE.IN_CHANS", 3,
        "MAE.ENCODER_DEPTH", 2, "MAE.ENCODER_EMBED_DIM", 48, "MAE.ENCODER_MLP_DIM", 96,
        "MAE.ENCODER_NUM_HEADS", 4, "MAE.DECODER_DEPTH", 2, "MAE.DECODER_EMBED_DIM", 48,
        "MAE.DECODER_MLP_DIM", 96, "MAE.DECODER_NUM_HEADS", 4, "MAE.USE_BIAS", True,
        "MAE.POS_EMBED", "sincos", "MODEL.ROI", [24, 24, 24], "DATA.WIRE_FORMAT", "hu16",
        "TRAIN.OPTIMIZER", "AdamW", "TRAIN.BASE_LR", 1e-3, "TRAIN.MIN_LR", 1e-6,
        "TRAIN.WEIGHT_DECAY", 0.05, "TRAIN.GRAD_CLIP", 0.0, "TRAIN.SCHEDULER", "cosine",
        "PARALLEL.PALLAS_MIN_T", 9]
TOTAL_STEPS, WARMUP = 20, 2
L = 8  # tokens at 24^3, patch 12


@pytest.fixture
def backends():
    prev = (jax_attn.set_attention_backend("pallas"), jax_attn.set_pallas_min_t(None),
            port_attn.set_attention_backend("kernel"), port_attn.set_pallas_min_t(None))
    yield
    jax_attn.set_attention_backend(prev[0])
    jax_attn.set_pallas_min_t(prev[1])
    port_attn.set_attention_backend(prev[2])
    port_attn.set_pallas_min_t(prev[3])


def _configs():
    cfg_j, cfg_p = jax_default_config(), default_config()
    cfg_j.merge_from_list(list(TINY))
    cfg_p.merge_from_list(list(TINY))
    return cfg_j, cfg_p


def _wire_batches(k: int, batch: int) -> list:
    rng = np.random.RandomState(11)
    return [hu16_encode(rng.uniform(-1000, 1500, (batch, 1, 24, 24, 24))) for _ in range(k)]


def _jax_draws(model, rng, step: int, accum: int, n: int) -> list:
    """What the JAX step draws for update ``step``, one dict per micro-batch.
    The model's ``__call__`` masks with ``self.make_rng("mask")``, a key flax
    derives from the step's mask key; the same call at the root scope gives it."""
    step_rng = jax.random.fold_in(rng, step)
    draws = []
    for i in range(accum):
        micro_rng = jax.random.fold_in(step_rng, i)
        mask_rng, _ = jax.random.split(micro_rng)
        key = model.apply({}, rngs={"mask": mask_rng}, method=lambda m: m.make_rng("mask"))
        draws.append({
            "noise": torch.tensor(np.asarray(jax.random.uniform(key, (n, L)))),
            "augment": jax_augment_decisions(jax.random.fold_in(micro_rng, 7), n),
        })
    return draws


def _port_params(state) -> dict:
    return {k: v.detach().clone() for k, v in state.model.state_dict().items()}


# (TRAIN overrides, accum_steps, steps); the first two cases keep their ids.
# Lion "fused" runs the interpreted Pallas kernel in JAX and the fused path's
# plain version in the port.
_TRAJECTORIES = [
    pytest.param({}, 1, 5, id="1-5"),
    pytest.param({}, 2, 3, id="2-3"),
    pytest.param({"OPTIMIZER": "SGD"}, 1, 3, id="SGD"),
    pytest.param({"OPTIMIZER": "Lamb"}, 1, 3, id="Lamb"),
    pytest.param({"OPTIMIZER": "Lion"}, 1, 3, id="Lion-unfused"),
    pytest.param({"OPTIMIZER": "Lion", "LION_FUSED": True}, 1, 3, id="Lion-fused"),
    pytest.param({"GRAD_CLIP": 1.0}, 1, 3, id="AdamW-clip"),
]
# sign() makes Lion discontinuous: a momentum near 0 can flip between the two
# frameworks' roundings (a step of 2 lr), so this share of Lion's parameter
# elements may differ (as tests/test_resume_and_wiring.py allows between the
# JAX package's fused and unfused Lion).
LION_FLIP_SHARE = 1e-3


@pytest.mark.parametrize("train,accum,k_steps", _TRAJECTORIES)
def test_train_trajectory_matches_jax(backends, train, accum, k_steps):
    cfg_j, cfg_p = _configs()
    for cfg in (cfg_j, cfg_p):
        for key, value in train.items():
            setattr(cfg.TRAIN, key, value)
    mesh = make_mesh(data=1, devices=jax.devices()[:1])
    rng = jax.random.PRNGKey(0)
    state_j, _, _ = jax_engine.create_train_state(cfg_j, mesh, rng, TOTAL_STEPS, WARMUP,
                                                  dtype=jnp.float32)
    step_j = jax_engine.make_train_step(mesh, augment=True, accum_steps=accum, config=cfg_j)
    jax_model = jax_engine.build_mae_model(cfg_j, dtype=jnp.float32)

    state, _ = mae_engine.create_train_state(cfg_p, TOTAL_STEPS, WARMUP, seed=0,
                                             dtype=torch.float32, device="cpu")
    state.model.load_state_dict(
        state_dict_from_jax(jax.tree.map(np.asarray, jax.device_get(state_j.params))))
    step = mae_engine.make_train_step(augment=True, accum_steps=accum, config=cfg_p)
    init = _port_params(state)

    batch = 4
    for s, wire in enumerate(_wire_batches(k_steps, batch)):
        draws = _jax_draws(jax_model, rng, s, accum, batch // accum)
        state_j, m_j = step_j(state_j, jax_engine._to_device_batch(wire, mesh), rng)
        state, m = step(state, torch.from_numpy(wire), seed=0, draws=draws)
        np.testing.assert_allclose(m["loss"].item(), float(m_j["loss"]), rtol=1e-3,
                                   err_msg=f"loss at step {s}")
        if s == 0:
            # optax evaluates the schedule at the count before the update:
            # the first update runs at lr(0) = 0 under the warm-up, so the
            # parameters have not moved (nor have the JAX ones)
            after = _port_params(state)
            assert all(torch.equal(after[k], init[k]) for k in init)
    assert state.step == k_steps == int(state_j.step)

    want = state_dict_from_jax(jax.tree.map(np.asarray, jax.device_get(state_j.params)))
    moved = differ = total = 0
    for name, p in state.model.state_dict().items():
        if cfg_p.TRAIN.OPTIMIZER == "Lion":
            close = np.isclose(p.numpy(), want[name].numpy(), rtol=1e-3, atol=1e-5)
            differ, total = differ + int((~close).sum()), total + close.size
        else:
            np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=1e-3, atol=1e-5,
                                       err_msg=name)
        moved += not torch.equal(p, init[name])
    assert differ <= LION_FLIP_SHARE * total, (differ, total)
    assert moved == len(init) - 2  # all but the two frozen sincos embeddings


# The bfloat16 trajectory, 3 steps: both sides compute in bf16 and round at
# different places (the port's plain attention rounds the unnormalised P, the
# JAX one the normalised softmax; the kernels' products sum in another order),
# so the losses and every tensor's update (its parameters after the steps
# minus before) are held normwise. Measured on the CPU: loss within 1.4e-4
# relative, each update within ||du - du_jax|| / ||du_jax|| <= 0.027.
BF16_LOSS_REL, BF16_UPDATE_REL = 1e-3, 5e-2


def test_bf16_train_trajectory_matches_jax(backends):
    """3 steps of the port's train step against JAX make_train_step(augment=True)
    with bfloat16 compute on both sides, from the same weights and batches."""
    cfg_j, cfg_p = _configs()
    mesh = make_mesh(data=1, devices=jax.devices()[:1])
    rng = jax.random.PRNGKey(0)
    state_j, _, _ = jax_engine.create_train_state(cfg_j, mesh, rng, TOTAL_STEPS, WARMUP,
                                                  dtype=jnp.bfloat16)
    step_j = jax_engine.make_train_step(mesh, augment=True, config=cfg_j)
    jax_model = jax_engine.build_mae_model(cfg_j, dtype=jnp.bfloat16)
    state, _ = mae_engine.create_train_state(cfg_p, TOTAL_STEPS, WARMUP, seed=0,
                                             dtype=torch.bfloat16, device="cpu")
    state.model.load_state_dict(
        state_dict_from_jax(jax.tree.map(np.asarray, jax.device_get(state_j.params))))
    step = mae_engine.make_train_step(augment=True, config=cfg_p)
    init = _port_params(state)

    batch = 4
    for s, wire in enumerate(_wire_batches(3, batch)):
        draws = _jax_draws(jax_model, rng, s, 1, batch)
        state_j, m_j = step_j(state_j, jax_engine._to_device_batch(wire, mesh), rng)
        state, m = step(state, torch.from_numpy(wire), seed=0, draws=draws)
        rel = abs(m["loss"].item() - float(m_j["loss"])) / abs(float(m_j["loss"]))
        assert rel <= BF16_LOSS_REL, f"loss at step {s}: relative difference {rel:.3e}"
    assert state.step == 3 == int(state_j.step)

    want = state_dict_from_jax(jax.tree.map(np.asarray, jax.device_get(state_j.params)))
    moved = 0
    for name, p in state.model.state_dict().items():
        assert p.dtype == torch.float32, name  # parameters stay float32; compute is bf16
        # without a qkv bias's key third: its gradient is rounding noise
        du = without_key_bias(name, p.float() - init[name].float())
        du_j = without_key_bias(name, want[name].float() - init[name].float())
        if du_j.norm() == 0:
            assert du.norm() == 0, name
            continue
        moved += 1
        rel = ((du - du_j).norm() / du_j.norm()).item()
        assert rel <= BF16_UPDATE_REL, f"{name}: ||du - du_jax|| / ||du_jax|| = {rel:.3e}"
    assert moved == len(init) - 2  # all but the two frozen sincos embeddings


def test_lr_schedules_match_jax():
    for name in ("cosine", "poly", "constant"):
        cfg_j, cfg_p = _configs()
        cfg_j.TRAIN.SCHEDULER = cfg_p.TRAIN.SCHEDULER = name
        f_j = jax_lr_sched.get_lr_schedule(cfg_j, 1e-3, 3, 10, 1e-6)
        f_p = lr_sched.get_lr_schedule(cfg_p, 1e-3, 3, 10, 1e-6)
        got = [f_p(s) for s in range(13)]
        want = [float(f_j(s)) for s in range(13)]
        # JAX evaluates in float32, the port in float64
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12, err_msg=name)
        assert got[0] == 0.0


def test_optimizer_and_engine_guards():
    """The configurations the port once refused (a gradient clip; SGD, Lamb,
    Lion fused and unfused) build and take a step that moves the weights; an
    unknown optimizer still raises, as in the JAX package."""
    _, cfg = _configs()
    wire = torch.from_numpy(_wire_batches(1, 2)[0])
    for name, fused, clip in (("AdamW", False, 1.0), ("SGD", False, 1.0), ("Lamb", False, 1.0),
                              ("Lion", False, 0.0), ("Lion", True, 1.0)):
        cfg.TRAIN.OPTIMIZER, cfg.TRAIN.LION_FUSED, cfg.TRAIN.GRAD_CLIP = name, fused, clip
        state, _ = mae_engine.create_train_state(cfg, 10, 0, device="cpu")
        assert type(state.optimizer).__name__ == name and state.grad_clip == clip
        before = _port_params(state)
        state, m = mae_engine.make_train_step(config=cfg)(state, wire, seed=0)
        assert state.step == 1 and bool(torch.isfinite(m["loss"])), name
        assert not all(torch.equal(before[k], v) for k, v in _port_params(state).items()), name
    cfg.TRAIN.OPTIMIZER = "Adafactor"
    with pytest.raises(NotImplementedError, match="Adafactor"):
        mae_engine.create_train_state(cfg, 10, 2, device="cpu")


@pytest.mark.parametrize("axis", ["FSDP", "TENSOR", "SEQ", "PIPE"])
def test_unported_parallel_axes_raise(axis):
    """FSDP, SEQ, PIPE and TENSOR, which every engine takes, raise in a
    single process for want of the ranks to split over
    (tests/test_torch_port_{model_parallel,fsdp,pipeline}.py run them).
    PIPE raises first where the JAX MAE engine does (its
    ``create_train_state``, ``engines/mae_engine.py:110-120``): MAE dropout
    and a depth that PIPE does not divide are ValueErrors naming "DROPOUT"
    and "divide"."""
    from headct_foundation_tpu_torch.engines import dino_engine, downstream_engine

    _, cfg = _configs()
    setattr(cfg.PARALLEL, axis, 2)
    makes = (lambda: mae_engine.create_train_state(cfg, 10, 0, device="cpu"),
             lambda: dino_engine.create_train_state(cfg, 10, 0, 1, device="cpu"),
             lambda: downstream_engine.create_train_state(cfg, 10, 0, device="cpu"))
    for make in makes:
        with pytest.raises(ValueError, match=f"PARALLEL.{axis} = 2 but the process's mesh"):
            make()
    if axis == "PIPE":
        for key, value, words in (("DROPOUT_RATE", 0.1, "DROPOUT"),
                                  ("DECODER_DEPTH", 3, "divide")):
            bad = cfg.clone()
            setattr(bad.MAE, key, value)
            with pytest.raises(ValueError, match=words):
                mae_engine.create_train_state(bad, 10, 0, device="cpu")


@pytest.mark.parametrize("name", ["mae_HeadCT.yaml", "mae_HeadCT_192.yaml"])
def test_shipped_configs_pass_the_parallel_guard(name):
    """The shipped MAE configs, their PARALLEL section as shipped and the
    model cut to the tiny widths, build a train state."""
    cfg = default_config()
    cfg.merge_from_file(str(Path(__file__).resolve().parents[1] / "configs" / "mae" / name))
    assert [getattr(cfg.PARALLEL, a) for a in ("FSDP", "TENSOR", "SEQ", "PIPE")] == [1] * 4
    cfg.merge_from_list([x for i in range(0, len(TINY), 2) if TINY[i].startswith("MAE.")
                         for x in TINY[i:i + 2]] + ["MODEL.ROI", [24, 24, 24]])
    state, _ = mae_engine.create_train_state(cfg, 10, 0, device="cpu")
    assert state.step == 0 and sum(p.numel() for p in state.model.parameters()) > 0


def test_train_one_epoch_and_eval_on_cpu():
    """The epoch loops on generator-drawn randomness: finite losses, one
    update per batch, losses fetched in groups, the same result from the
    same seed, and a non-finite loss ends the process."""
    _, cfg = _configs()
    batches = _wire_batches(3, 2)
    runs = []
    for _ in range(2):
        state, _ = mae_engine.create_train_state(cfg, TOTAL_STEPS, WARMUP, seed=3, device="cpu")
        step = mae_engine.make_train_step(augment=True, config=cfg)
        state, stats = mae_engine.train_one_epoch(cfg, state, step, batches, 5, 0, 1)
        val = mae_engine.val_one_epoch(cfg, state, mae_engine.make_eval_step(cfg),
                                       [(batches[0], ["a", "b"])], 5, 0, 1)
        assert state.step == 3 and np.isfinite(stats["loss"]) and np.isfinite(val["loss"])
        runs.append((stats["loss"], val["loss"]))
    assert runs[0] == runs[1]

    def nan_step(state, data, seed):
        return state, {"loss": torch.tensor(float("nan"))}

    with pytest.raises(SystemExit):
        mae_engine.train_one_epoch(cfg, state, nan_step, batches, 5, 0, 1)
