"""PyTorch port: the loss-trajectory runs, the bf16 extractor and the bench
across processes, against the JAX package on the CPU.

* ``tools/trajectory.py``'s ``run_mae``, ``run_dino`` and
  ``run_downstream`` at ``tests/test_trajectory.py``'s tiny configurations
  (24^3, patch 12, width 48, 2 layers; DINO on 32^3 fields with 24^3 and
  16^3 crops, 256 prototypes; downstream on the labeled pool) for 2 epochs
  of 2 steps, against the JAX tool's own ``run_*`` on a one-device mesh:
  both start from the JAX init (``state_dict_from_jax``), the port is
  handed the draws the JAX step takes from its keys (the mask noise and
  augmentation, the crops), through the ``train_step`` and ``on_state``
  hooks. Both compute in float32 (the JAX engines' ``create_train_state``
  and the downstream ``make_train_step`` given ``jnp.float32`` through a
  patched default; the port's ``dtype``), so each loss is held within the
  limit that engine's float32 step test holds
  (``tests/test_torch_port_train.py`` 1e-3 for the MAE,
  ``test_torch_port_dino_train.py`` ``F32_LOSS_REL`` 1e-4,
  ``test_torch_port_downstream_train.py`` ``LOSS_REL`` 1e-5). The
  downstream head's train-mode BatchNorm over the CLS features of 8
  similar blob volumes amplifies float32 roundings, and the classifier's
  100 x LR takes them into the next loss: past the first loss the
  downstream run is held as ``tests/test_torch_port_dino_bn.py`` holds the
  BatchNorm head, within ``max(LOSS_REL, ULP_FACTOR x`` the distance JAX's
  own run moves when its initial weights move one float32 ulp). (In
  bfloat16 the same amplification takes the downstream loss past the bf16
  step test's 2e-2 from the first step.) One JAX run per engine per module
  (``jax_runs``).
* ``trajectory.main`` end to end with ``--device cpu --no-assert`` at the
  tiny width into ``tmp_path``: the JSON holds the JAX tool's fields plus
  ``device``, ``launches`` and ``png``.
* ``FeatureExtractor(dtype=torch.bfloat16)`` against the JAX extractor's
  ``dtype=jnp.bfloat16`` on the same weights: the tokens normwise within
  1e-2 (the bf16 limit of the kernels' checks); float32 stays the default.
* ``bench.py --compute-only`` under ``torch.distributed.run`` on two gloo
  processes at the tiny width: rank 0's line has ``n_gpus`` 2, the mean,
  summed and one-process rates and their ratio.
"""

import functools
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tools.trajectory as jax_traj
from headct_foundation_tpu.config import default_config as jax_default_config
from headct_foundation_tpu.engines import dino_engine as jax_dino
from headct_foundation_tpu.engines import downstream_engine as jax_ds
from headct_foundation_tpu.engines import mae_engine as jax_mae
from headct_foundation_tpu.feature_extraction import FeatureExtractor as JaxExtractor
from headct_foundation_tpu.parallel.mesh import make_mesh
from headct_foundation_tpu_torch.config import default_config
from headct_foundation_tpu_torch.engines import dino_engine, downstream_engine, mae_engine
from headct_foundation_tpu_torch.feature_extraction import FeatureExtractor
from headct_foundation_tpu_torch.tools import trajectory
from headct_foundation_tpu_torch.utils.torch_interop import (
    downstream_state_dicts_from_jax,
    state_dict_from_jax,
)
from tests.test_torch_port_dino import jax_multicrop_decisions
from tests.test_torch_port_dino_bn import ULP_FACTOR
from tests.test_torch_port_dino_train import F32_LOSS_REL as DINO_LOSS_REL
from tests.test_torch_port_downstream_train import LOSS_REL as DOWNSTREAM_LOSS_REL
from tests.test_torch_port_mae import jax_augment_decisions
from tests.test_torch_port_train import _jax_draws as jax_mae_draws

ROOT = Path(__file__).resolve().parent.parent
EPOCHS, STEPS, BATCH = 2, 2, 8
BASE = ["MODEL.ROI", [24, 24, 24], "MODEL.IN_CHANS", 1, "TRAIN.GRAD_CLIP", 1.0]
VIT = ["VIT.INPUT_SIZE", 24, "VIT.PATCH_SIZE", 12, "VIT.IN_CHANS", 1, "VIT.HIDDEN_SIZE", 48,
       "VIT.MLP_DIM", 96, "VIT.NUM_LAYERS", 2, "VIT.NUM_HEADS", 4, "VIT.USE_BIAS", True]
# tests/test_trajectory.py's three configurations
MAE = BASE + ["MAE.INPUT_SIZE", 24, "MAE.PATCH_SIZE", 12, "MAE.IN_CHANS", 1,
              "MAE.ENCODER_DEPTH", 2, "MAE.ENCODER_EMBED_DIM", 48, "MAE.ENCODER_MLP_DIM", 96,
              "MAE.ENCODER_NUM_HEADS", 4, "MAE.DECODER_DEPTH", 1, "MAE.DECODER_EMBED_DIM", 48,
              "MAE.DECODER_MLP_DIM", 96, "MAE.DECODER_NUM_HEADS", 4, "MAE.USE_BIAS", True,
              "TRAIN.BASE_LR", 1e-3, "TRAIN.MIN_LR", 1e-6]
DINO = BASE + VIT + ["VIT.NUM_REGISTER_TOKENS", 2, "DINO.HEAD_N_PROTOTYPES", 256,
                     "DINO.HEAD_HIDDEN_DIM", 64, "DINO.BOTTLENECK_DIM", 16,
                     "DINO.LOCAL_CROP_NUM", 2, "DINO.GLOBAL_CROP_SIZE", [24, 24, 24],
                     "DINO.LOCAL_CROP_SIZE", [16, 16, 16], "DINO.USE_BN", False,
                     "DINO.WARMUP_TEACHER_EPOCHS", 3, "DINO.FREEZE_LAST_LAYER", 1,
                     "TRAIN.MAX_EPOCHS", EPOCHS, "TRAIN.BASE_LR", 5e-4, "TRAIN.MIN_LR", 5e-7]
DOWNSTREAM = BASE + VIT + ["DATA.NUM_CLASSES", 2, "TRAIN.CLASSIFIER", "linear",
                           "TRAIN.BASE_LR", 1e-4, "TRAIN.MIN_LR", 1e-7]
FIELD = 32  # DINO's pool volumes; its crops sample inside them
MAE_LOSS_REL = 1e-3  # tests/test_torch_port_train.py's float32 trajectory
F32 = torch.float32


def _configs(opts):
    cfg_j, cfg_p = jax_default_config(), default_config()
    cfg_j.merge_from_list(list(opts))
    cfg_p.merge_from_list(list(opts))
    return cfg_j, cfg_p


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _mesh():
    return make_mesh(data=1, devices=jax.devices()[:1])


def _warmup(cfg, total):
    return int(cfg.TRAIN.PER_WARMUP * total)


def _run_mae():
    cfg_j, cfg_p = _configs(MAE)
    mesh, rng, total = _mesh(), jax.random.PRNGKey(0), EPOCHS * STEPS
    pool = jax_traj.make_blob_pool(16, 1, 24)
    rec_j = jax_traj.run_mae(cfg_j, mesh, EPOCHS, STEPS, BATCH, 1, rng, pool)
    init = jax_mae.create_train_state(cfg_j, mesh, rng, total, _warmup(cfg_j, total))[0].params
    model_j = jax_mae.build_mae_model(cfg_j, dtype=jnp.float32)
    step = mae_engine.make_train_step(augment=True, config=cfg_p)

    def train_step(state, batch, seed):
        return step(state, batch, seed, draws=jax_mae_draws(model_j, rng, state.step, 1, BATCH))

    rec = trajectory.run_mae(
        cfg_p, EPOCHS, STEPS, BATCH, 1, 0, pool, device="cpu", train_step=train_step,
        on_state=lambda s: s.model.load_state_dict(state_dict_from_jax(_np(init))), dtype=F32)
    return rec_j, rec


def _dino_draws(rng, step: int, n: int) -> list:
    """The crop decisions of the JAX DINO step ``step`` (one micro-batch)."""
    crop_rng, _ = jax.random.split(jax.random.fold_in(rng, step))
    return [jax_multicrop_decisions(jax.random.fold_in(crop_rng, 0), n, FIELD, 24, 16, 2)]


def _run_dino():
    cfg_j, cfg_p = _configs(DINO)
    mesh, rng, total = _mesh(), jax.random.PRNGKey(1), EPOCHS * STEPS
    pool = jax_traj.make_blob_pool(16, 1, FIELD)
    rec_j = jax_traj.run_dino(cfg_j, mesh, EPOCHS, STEPS, BATCH, rng, pool)
    state_j = jax_dino.create_train_state(cfg_j, mesh, rng, total, _warmup(cfg_j, total),
                                          niter_per_ep=STEPS)[0]
    step = dino_engine.make_train_step(cfg_p)

    def train_step(state, batch, seed, momentum, temp, cancel):
        return step(state, batch, seed, momentum, temp, cancel,
                    draws=_dino_draws(rng, state.step, BATCH))

    def on_state(state):
        state.student.load_state_dict(state_dict_from_jax(_np(state_j.params)))
        state.teacher.load_state_dict(state_dict_from_jax(_np(state_j.teacher_params)))

    rec = trajectory.run_dino(cfg_p, EPOCHS, STEPS, BATCH, 1, pool, device="cpu",
                              train_step=train_step, on_state=on_state, dtype=F32)
    return rec_j, rec


def _run_downstream():
    cfg_j, cfg_p = _configs(DOWNSTREAM)
    mesh, rng, total = _mesh(), jax.random.PRNGKey(2), EPOCHS * STEPS
    pool, labels = jax_traj.make_labeled_pool(16, 1, 24)
    rec_j = jax_traj.run_downstream(cfg_j, mesh, EPOCHS, STEPS, BATCH, rng, pool, labels)
    state_j = jax_ds.create_train_state(cfg_j, mesh, rng, total_steps=total,
                                        num_warmup_steps=_warmup(cfg_j, total))[0]
    step = downstream_engine.make_train_step(cfg_p, compute_dtype=F32)

    def train_step(state, batch, target, seed):
        draws = {"augment": jax_augment_decisions(jax.random.fold_in(rng, state.step), BATCH)}
        return step(state, batch, target, seed, draws=draws)

    def on_state(state):
        model_sd, clf_sd = downstream_state_dicts_from_jax(_np(state_j.params),
                                                           _np(state_j.batch_stats))
        state.model.load_state_dict(model_sd)
        state.classifier.load_state_dict(clf_sd)

    rec = trajectory.run_downstream(cfg_p, EPOCHS, STEPS, BATCH, 2, pool, labels, device="cpu",
                                    train_step=train_step, on_state=on_state, dtype=F32)
    # JAX's own run from its initial weights one float32 ulp up
    create = jax_ds.create_train_state

    def one_ulp_up(*args, **kwargs):
        state, *rest = create(*args, **kwargs)
        up = jax.tree.map(lambda p: jnp.asarray(np.nextafter(np.asarray(p), np.float32(np.inf))),
                          state.params)
        return (state.replace(params=up), *rest)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_ds, "create_train_state", one_ulp_up)
        rec_u = jax_traj.run_downstream(cfg_j, mesh, EPOCHS, STEPS, BATCH, rng, pool, labels)
    rec.ulp_losses = rec_u.losses
    return rec_j, rec


def _float32(fn, **kw):
    return functools.partial(fn, **kw)


@pytest.fixture(scope="module")
def jax_runs():
    """engine -> (the JAX tool's recording, the port's), each run once, the
    JAX engines' default compute dtype float32 while they run."""
    done = {}
    runners = {"mae": _run_mae, "dino": _run_dino, "downstream": _run_downstream}

    def get(engine):
        if engine not in done:
            with pytest.MonkeyPatch.context() as mp:
                for mod in (jax_mae, jax_dino, jax_ds):
                    mp.setattr(mod, "create_train_state",
                               _float32(mod.create_train_state, dtype=jnp.float32))
                mp.setattr(jax_ds, "make_train_step",
                           _float32(jax_ds.make_train_step, compute_dtype=jnp.float32))
                done[engine] = runners[engine]()
        return done[engine]

    return get


@pytest.mark.parametrize("engine,limit", [
    ("mae", MAE_LOSS_REL), ("dino", DINO_LOSS_REL), ("downstream", DOWNSTREAM_LOSS_REL)])
def test_run_trajectory_matches_the_jax_tool(jax_runs, engine, limit):
    rec_j, rec = jax_runs(engine)
    assert len(rec.losses) == len(rec_j.losses) == EPOCHS * STEPS
    assert np.isfinite(rec.losses).all()
    if engine != "downstream":
        np.testing.assert_allclose(rec.losses, rec_j.losses, rtol=limit, err_msg=engine)
    else:  # the first loss as the step test holds it, then JAX's one-ulp distance
        np.testing.assert_allclose(rec.losses[0], rec_j.losses[0], rtol=limit)
        off = [abs(a / b - 1) for a, b in zip(rec.losses, rec_j.losses)]
        off_u = [abs(a / b - 1) for a, b in zip(rec.ulp_losses, rec_j.losses)]
        assert all(o <= max(limit, ULP_FACTOR * u) for o, u in zip(off, off_u)), (off, off_u)
    assert rec.lrs == pytest.approx(rec_j.lrs, rel=1e-6, abs=1e-12)
    assert rec.launches["flash_attention_fwd"] == 0  # the CPU runs the plain versions


def test_downstream_run_records_each_epochs_auroc(jax_runs):
    rec_j, rec = jax_runs("downstream")
    assert len(rec.epoch_aurocs) == len(rec_j.epoch_aurocs) == EPOCHS
    assert all(0.0 <= a <= 1.0 for a in rec.epoch_aurocs)


TINY_MAIN = ["MODEL.ROI", "[24,24,24]", "MAE.INPUT_SIZE", "24", "MAE.PATCH_SIZE", "12",
             "MAE.ENCODER_DEPTH", "1", "MAE.ENCODER_EMBED_DIM", "48", "MAE.ENCODER_MLP_DIM", "96",
             "MAE.ENCODER_NUM_HEADS", "4", "MAE.DECODER_DEPTH", "1",
             "MAE.DECODER_EMBED_DIM", "48", "MAE.DECODER_MLP_DIM", "96",
             "MAE.DECODER_NUM_HEADS", "4"]


def test_main_writes_the_jax_tools_fields(tmp_path):
    prefix = str(tmp_path / "trajectory_mae")
    argv = ["--engine", "mae", "--epochs", "2", "--steps-per-epoch", "2", "--batch", "2",
            "--pool", "4", "--device", "cpu", "--no-assert", "--out-prefix", prefix,
            "--opts", *TINY_MAIN]
    summary = trajectory.main(argv)
    with open(prefix + ".json") as f:
        saved = json.load(f)
    assert saved == json.loads(json.dumps(summary))
    args = trajectory.parser().parse_args(argv)
    rec = jax_traj.RecordingRun()
    rec.losses, rec.lrs = list(saved["losses"]), [1e-4] * len(saved["losses"])
    jax_fields, *_ = jax_traj._write_artifacts(args, rec, None, 1.0, str(tmp_path))
    assert set(saved) == set(jax_fields) | {"device", "launches", "png"}
    assert saved["device"] == {"name": "cpu", "power_limit": None}
    assert saved["steps"] == 4 and np.isfinite(saved["losses"]).all()
    assert saved["png"] in (None, prefix + ".png")


def test_main_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trajectory.main(["--engine", "mae"])


EXTRACTOR = dict(img_size=24, patch_size=12, in_chans=3, hidden_size=48, mlp_dim=96,
                 num_layers=2, num_heads=4, pos_embed="sincos", qkv_bias=True)


def test_bf16_extractor_matches_jax_bf16_on_the_same_weights():
    ext_j = JaxExtractor(**EXTRACTOR, dtype=jnp.bfloat16)
    ext = FeatureExtractor(**EXTRACTOR, dtype=torch.bfloat16, device="cpu")
    ext.model.load_state_dict(state_dict_from_jax(_np(ext_j.params)))
    x = np.random.RandomState(3).rand(2, 3, 24, 24, 24).astype(np.float32)
    out_j, layers_j = ext_j(x)
    out, layers = ext(x)
    assert out.dtype == torch.bfloat16 and len(layers) == len(layers_j) == 2
    want = np.asarray(out_j, np.float32)
    got = out.float().numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-2
    cls = ext.cls_embedding(x)
    assert cls.dtype == np.float32
    np.testing.assert_array_equal(cls, got[:, 0, :])
    assert FeatureExtractor(**EXTRACTOR, device="cpu")(x)[0].dtype == torch.float32


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_bench_across_two_gloo_processes():
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
           "--master_addr", "localhost", "--master_port", str(_free_port()), "-m",
           "headct_foundation_tpu_torch.bench", "--compute-only", "--device", "cpu",
           "--chain-steps", "2", "--runs", "1", "--set", *TINY_MAIN]
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [json.loads(line) for line in r.stdout.splitlines() if line.startswith("{")]
    assert len(lines) == 1  # rank 0 alone prints
    line = lines[0]
    assert line["n_gpus"] == 2 and len(line["per_rank"]) == 2
    assert line["value"] == pytest.approx(np.mean(line["per_rank"]))
    assert line["summed"] == pytest.approx(sum(line["per_rank"]))
    assert line["per_card_vs_one"] == pytest.approx(line["value"] / line["one_card"])
    assert line["batch_per_gpu"] == 32 and np.isfinite(line["final_loss"])
    assert line["device"] == {"name": "cpu", "power_limit": None}
