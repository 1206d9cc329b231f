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
as the JAX step does); the decoder (T=9) runs the Pallas kernels in JAX and
``FusedAttention`` in the port, the encoder (T=3) plain attention.
"""

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


@pytest.mark.parametrize("accum,k_steps", [(1, 5), (2, 3)])
def test_train_trajectory_matches_jax(backends, accum, k_steps):
    cfg_j, cfg_p = _configs()
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
    moved = 0
    for name, p in state.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=1e-3, atol=1e-5,
                                   err_msg=name)
        moved += not torch.equal(p, init[name])
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
    _, cfg = _configs()
    cfg.TRAIN.GRAD_CLIP = 1.0
    with pytest.raises(NotImplementedError, match="A.12"):
        mae_engine.create_train_state(cfg, 10, 2, device="cpu")
    cfg.TRAIN.GRAD_CLIP = 0.0
    cfg.TRAIN.OPTIMIZER = "Lion"
    with pytest.raises(NotImplementedError, match="A.12"):
        mae_engine.create_train_state(cfg, 10, 2, device="cpu")


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
