"""PyTorch port: the DINO pretraining CLI and DINO data parallelism, on the CPU.

* ``python -m headct_foundation_tpu_torch.main_pretrain_dino --device cpu``
  in a subprocess trains the JAX DINO tests' tiny configuration on synthetic
  scans, writes ``latest_`` and ``best_`` with the DINO extras
  (``momentum_model_state_dict``, ``center``, ``head_stats``,
  ``teacher_head_stats``) and no placeholder, and a second run (in this
  process) resumes from ``latest_`` ("Resumed (full)", at the saved epoch).
* ``--model_load_path`` is routed by content: a torch file is merged into
  the student and the teacher (its ``momentum_model_state_dict``), a pickle
  whose parameters do not fit warm-starts both at epoch 0; a reference torch
  file's backbone, which the JAX main leaves unmerged (ROADMAP C.7), is
  merged.
* The scaled LR, the step counts and the LR, weight-decay and momentum
  schedules equal the JAX main's for the same config (the LR schedule at
  rtol 1e-5: JAX evaluates it in float32; the others exactly).
* Two gloo processes at batch 2 give the losses, the student, the teacher
  and the centre of one process at batch 4 after 2 float32 steps, within
  ``tests/test_torch_port_cli.py``'s limits (loss rtol 1e-3; tensors rtol
  1e-3, atol 1e-5, but for a qkv bias's key third and AdamW's first-step
  noise, as ``tests/test_torch_port_dino_train.py`` allows them).
"""

import json
import logging
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import main_pretrain_dino as jax_main
from headct_foundation_tpu.optim import lr_sched as jax_lr_sched
from headct_foundation_tpu.utils.torch_interop import load_pretrained_into as jax_load
from headct_foundation_tpu.utils.torch_interop import tree_to_torch
from headct_foundation_tpu_torch import main_pretrain_dino
from headct_foundation_tpu_torch.config import default_config
from headct_foundation_tpu_torch.data.nifti import save_nifti
from headct_foundation_tpu_torch.engines import dino_engine
from headct_foundation_tpu_torch.optim import lr_sched
from headct_foundation_tpu_torch.utils import checkpoint as ckpt
from headct_foundation_tpu_torch.utils.torch_interop import (
    jax_tree_from_state_dict,
    load_pretrained_into,
    state_dict_from_jax,
)
from tests.test_torch_port_cli import _free_port
from tests.test_torch_port_dino_train import TINY, _wires, assert_tensor_close

ROOT = Path(__file__).resolve().parent.parent
TINY_YAML = """
MODEL:
  DIR: {out}/model_saved
  SAVE_NAME: dino_tiny.ckpt
  ROI: [24, 24, 24]
  IN_CHANS: 3
DATA:
  BATCH_SIZE: 3
  NUM_WORKERS: 2
  CACHE_DIR: {out}/cache
  TRAIN_CSV_PATH: {out}/train.csv
  VAL_CSV_PATH: {out}/val.csv
  TEST_CSV_PATH: {out}/test.csv
LOG:
  OUTPUT_DIR: {out}/log
OUTPUT: {out}/out
TRAIN:
  MAX_EPOCHS: 2
  VAL_EVERY: 1
  BASE_LR: 1.0e-3
  MIN_LR: 1.0e-6
  GRAD_CLIP: 1.0
  WEIGHT_DECAY: 0.04
  WEIGHT_DECAY_END: 0.4
VIT:
  INPUT_SIZE: 24
  PATCH_SIZE: 12
  IN_CHANS: 3
  HIDDEN_SIZE: 48
  MLP_DIM: 96
  NUM_LAYERS: 2
  NUM_HEADS: 4
  NUM_REGISTER_TOKENS: 2
  USE_BIAS: True
  POS_EMBED: sincos
DINO:
  HEAD_N_PROTOTYPES: 128
  HEAD_HIDDEN_DIM: 64
  BOTTLENECK_DIM: 16
  USE_BN: False
  FREEZE_LAST_LAYER: 1
  WARMUP_TEACHER_EPOCHS: 2
"""
EXTRAS = {"momentum_model_state_dict", "center", "head_stats", "teacher_head_stats"}


def _dataset(tmp_path, n=6) -> str:
    rng = np.random.RandomState(0)
    paths = []
    for i in range(n):
        vol = (rng.rand(30, 32, 28) * 3000 - 1000).astype(np.float32)
        p = str(tmp_path / f"scan_{i}.nii.gz")
        save_nifti(p, vol, np.diag([2.0, 2.0, 2.0, 1.0]))
        paths.append(p)
    for split in ("train", "val", "test"):
        (tmp_path / f"{split}.csv").write_text("img_path\n" + "\n".join(paths) + "\n")
    cfg = tmp_path / "dino_tiny.yaml"
    cfg.write_text(TINY_YAML.format(out=tmp_path))
    return str(cfg)


def _cli(args):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-m", "headct_foundation_tpu_torch.main_pretrain_dino",
                        *args], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout[-3000:]}\nSTDERR:\n{r.stderr[-3000:]}"
    result = json.loads(next(line for line in r.stdout.splitlines()[::-1]
                             if line.startswith('{"cli"')))["cli"]
    return r.stdout + r.stderr, result


def test_dino_cli_trains_checkpoints_and_resumes(tmp_path):
    cfg = _dataset(tmp_path)
    _, result = _cli(["--cfg", cfg, "--device", "cpu"])
    saved = sorted(os.listdir(tmp_path / "model_saved"))
    assert saved == ["best_dino_tiny.ckpt", "latest_dino_tiny.ckpt"], saved
    assert [e["epoch"] for e in result["epochs"]] == [0, 1]
    for e in result["epochs"]:
        assert e["train"]["steps"] == 2 and np.isfinite(e["train"]["loss"])
        assert np.isfinite(e["val"]["loss"]) and e["train"]["wd"] > 0
    assert np.isfinite(result["test"]["loss"]) and result["test"]["batches"] == 2
    assert result["placeholders"] == 0
    latest = str(tmp_path / "model_saved" / "latest_dino_tiny.ckpt")
    payload = ckpt.load_checkpoint(latest)
    assert EXTRAS <= set(payload) and payload["epoch"] == 1 and payload["step"] == 4
    assert payload["center"].shape == (1, 128) and np.isfinite(payload["center"]).all()
    assert set(payload["momentum_model_state_dict"]) == {"backbone", "head"}

    # the resume in this process (a second interpreter's start-up is most of a run)
    result = main_pretrain_dino.run(["--cfg", cfg, "--device", "cpu", "--model_load_path",
                                     latest, "--max_epochs", "3"])
    log = "".join(p.read_text() for p in (tmp_path / "log").glob("log_rank0_*.txt"))
    assert f"Resumed (full) from {latest} at epoch 1" in log
    assert result["start_epoch"] == 1 and [e["epoch"] for e in result["epochs"]] == [1, 2]
    assert ckpt.load_checkpoint(latest)["step"] == 8  # 4 restored + 2 epochs of 2


def test_dino_cli_routes_checkpoints_by_content(tmp_path, monkeypatch):
    cfg = _dataset(tmp_path, n=3)
    args = ["--cfg", cfg, "--device", "cpu", "--max_epochs", "1"]
    main_pretrain_dino.run(args)
    payload = ckpt.load_checkpoint(str(tmp_path / "model_saved" / "latest_dino_tiny.ckpt"))
    student = state_dict_from_jax(payload["params"])
    teacher = state_dict_from_jax(payload["momentum_model_state_dict"])
    # a reference torch file: module. and backbone. prefixes on the student's names
    torch_pt = tmp_path / "ref.pt"
    torch.save({"state_dict": {f"module.{k}": v for k, v in student.items()},
                "momentum_model_state_dict": dict(teacher)}, torch_pt)
    seen = {}
    real_resume = main_pretrain_dino.resume

    def spy(state, path, logger):
        state, epoch = real_resume(state, path, logger)
        seen["student"] = {k: v.clone() for k, v in state.student.state_dict().items()}
        seen["teacher"] = {k: v.clone() for k, v in state.teacher.state_dict().items()}
        return state, epoch

    monkeypatch.setattr(main_pretrain_dino, "resume", spy)
    assert main_pretrain_dino.run(args + ["--model_load_path", str(torch_pt)])["start_epoch"] == 0
    for name, want in student.items():
        assert torch.equal(seen["student"][name], want), name
    for name, want in teacher.items():
        assert torch.equal(seen["teacher"][name], want), name
    # a pickle whose parameters do not fit: both networks warm-started at epoch 0
    del payload["params"]["head"]["mlp_1"]
    bad = tmp_path / "other.ckpt"
    with open(bad, "wb") as f:
        pickle.dump(payload, f)
    assert main_pretrain_dino.run(args + ["--model_load_path", str(bad)])["start_epoch"] == 0
    assert torch.equal(seen["teacher"]["head.mlp.2.weight"], teacher["head.mlp.2.weight"])
    assert torch.equal(seen["student"]["head.mlp.0.weight"], student["head.mlp.0.weight"])
    text = "".join(p.read_text() for p in (tmp_path / "log").glob("log_rank0_*.txt"))
    assert "Full resume failed" in text and "Warm-started params from" in text


def test_jax_warm_start_leaves_a_torch_files_backbone_unmerged(tmp_path):
    """ROADMAP C.7, a fault of the JAX reference: a reference torch file's
    names lose their ``backbone.`` prefix to ``strip_prefixes``, so the JAX
    main's merge into the ``{backbone, head}`` tree finds the whole backbone
    missing (its leaves unexpected at the top) and merges the head only. The
    port's ``load_pretrained_into`` puts them back under ``backbone.``
    (``test_dino_cli_routes_checkpoints_by_content``)."""
    cfg = default_config()
    cfg.merge_from_list(TINY)
    state = dino_engine.create_train_state(cfg, 10, 0, 5, seed=0, dtype=torch.float32,
                                           device="cpu")
    tree = jax_tree_from_state_dict(state.student.state_dict())
    path = tmp_path / "ref.pt"
    torch.save({"state_dict": {f"module.{k}": torch.from_numpy(np.array(v))
                               for k, v in tree_to_torch(tree).items()}}, path)
    messages = []

    class Log:
        def info(self, msg):
            messages.append(msg)

    jax_load(tree, str(path), logger=Log())
    assert "1 missing, 6 unexpected keys" in messages[0] and messages[1] == "missing: ['backbone']"
    other = dino_engine.create_train_state(cfg, 10, 0, 5, seed=1, dtype=torch.float32,
                                           device="cpu")
    missing, unexpected = load_pretrained_into(other.student, str(path))
    assert not missing and not unexpected
    for k, v in state.student.state_dict().items():
        assert torch.equal(other.student.state_dict()[k], v), k


class _Stop(Exception):
    pass


def test_scaled_lr_and_schedules_equal_the_jax_main(tmp_path, monkeypatch):
    cfg_path = _dataset(tmp_path, n=5)
    args = ["--cfg", cfg_path, "--batch_size", "2", "--max_epochs", "7"]
    seen = {}

    def capture(name):
        def fake(config, *rest, **kw):
            ints = [a for a in rest if isinstance(a, int)][:3]
            seen[name] = (float(config.TRAIN.BASE_LR), float(config.TRAIN.MIN_LR), *ints)
            raise _Stop
        return fake

    monkeypatch.setattr(jax_main.dino_engine, "create_train_state", capture("jax"))
    monkeypatch.setattr(main_pretrain_dino.dino_engine, "create_train_state", capture("port"))
    monkeypatch.setattr(sys, "argv", ["main_pretrain_dino.py", *args])
    _, jax_cfg = jax_main.parse_option()
    logger = logging.getLogger("dino-cli-test")
    with pytest.raises(_Stop):
        jax_main.main(jax_cfg, None, logger)
    from headct_foundation_tpu_torch.main_pretrain_mae import parse_option

    _, cfg = parse_option(args + ["--device", "cpu"])
    with pytest.raises(_Stop):
        main_pretrain_dino.main(cfg, torch.device("cpu"), logger)
    assert seen["port"] == pytest.approx(seen["jax"], rel=1e-12)
    base, low, total, warmup, niter = seen["port"]
    assert (total, warmup, niter) == (3 * 7, int(0.05 * 21), 3)
    assert base == pytest.approx(1e-3 * 2 / 256)
    f_p = lr_sched.get_lr_schedule(cfg, base, warmup, total, low)
    f_j = jax_lr_sched.get_lr_schedule(jax_cfg, base, warmup, total, low)
    np.testing.assert_allclose([f_p(s) for s in range(total + 2)],
                               [float(f_j(s)) for s in range(total + 2)], rtol=1e-5, atol=1e-12)
    from headct_foundation_tpu.optim import schedules as jax_schedules
    from headct_foundation_tpu_torch.optim import schedules

    for fn in ("get_wd_schedule", "get_momentum_schedule"):
        np.testing.assert_array_equal(getattr(schedules, fn)(cfg, niter),
                                      getattr(jax_schedules, fn)(jax_cfg, niter))


_DP_WORKER = r'''
import json, sys
import numpy as np, torch
from headct_foundation_tpu_torch.config import default_config
from headct_foundation_tpu_torch.engines import dino_engine
from headct_foundation_tpu_torch.parallel import distributed

tiny, data, out = json.loads(sys.argv[1]), sys.argv[2], sys.argv[3]
distributed.init_from_env("cpu", 2)
rank, world = distributed.rank(), distributed.world()
cfg = default_config()
cfg.merge_from_list(tiny)
state = dino_engine.create_train_state(cfg, 20, 0, 5, seed=0, dtype=torch.float32, device="cpu")
step = dino_engine.make_train_step(cfg)
losses = []
for i, wire in enumerate(np.load(data)):
    n = wire.shape[0] // world
    state, m = step(state, torch.from_numpy(wire[rank * n:(rank + 1) * n]), 0, 0.99, 0.04, i == 0)
    losses.append(m["loss"].item())
np.savez(out, losses=np.asarray(losses), center=state.center.numpy(),
         **{"s." + k: v.numpy() for k, v in state.student.state_dict().items()},
         **{"t." + k: v.numpy() for k, v in state.teacher.state_dict().items()})
distributed.shutdown()
'''


def test_two_gloo_processes_equal_one_at_twice_the_batch(tmp_path):
    """The DINO step in 2 gloo processes at batch 2 against 1 process at 4:
    step 1 with the last layer frozen, step 2 without."""
    wires = np.stack(_wires(2, 4))
    np.save(tmp_path / "wires.npy", wires)
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=str(ROOT), RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE="2", MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _DP_WORKER, json.dumps(TINY), str(tmp_path / "wires.npy"),
             str(tmp_path / f"rank{rank}.npz")], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=180)[0] for p in procs]  # a hung rendezvous fails here
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(o[-2000:] for o in outs)

    cfg = default_config()
    cfg.merge_from_list(list(TINY))
    state = dino_engine.create_train_state(cfg, 20, 0, 5, seed=0, dtype=torch.float32,
                                           device="cpu")
    step = dino_engine.make_train_step(cfg)
    losses = []
    for i, wire in enumerate(wires):
        state, m = step(state, torch.from_numpy(wire), 0, 0.99, 0.04, i == 0)
        losses.append(m["loss"].item())
    want = {"center": state.center.numpy(),
            **{"s." + k: v.numpy() for k, v in state.student.state_dict().items()},
            **{"t." + k: v.numpy() for k, v in state.teacher.state_dict().items()}}
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    for got in ranks:
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-3)
        for name, value in want.items():
            assert_tensor_close(name, got[name], value)
    for name in ranks[0].files:  # the ranks hold one model
        assert np.array_equal(ranks[0][name], ranks[1][name]), name
