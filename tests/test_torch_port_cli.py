"""PyTorch port: the MAE pretraining CLI and data-parallel training, on the CPU.

* ``python -m headct_foundation_tpu_torch.main_pretrain_mae --device cpu``
  in a subprocess trains on a tiny synthetic dataset (the
  ``tests/test_cli_e2e.py`` pattern), writes ``latest_`` and ``best_``, and a
  second run resumes from ``latest_`` ("Resumed from", at the saved epoch).
  ``--model_load_path`` is routed by content: a torch file is merged into
  the parameters, a pickle that does not fit the train state falls back to
  a params-only merge, and orbax raises at start-up. ``HEADCT_PROFILE_DIR``
  writes a trace of the first epoch, with the spans as user annotations.
* The scaled LR, the step counts and the schedule equal the JAX main's for
  the same config (schedule rtol 1e-5: JAX evaluates in float32).
* Two gloo processes at batch 2 give the losses and parameters of one
  process at batch 4 on the concatenated batch after 2 float32 steps,
  within ``tests/test_torch_port_train.py``'s float32 limits (loss rtol
  1e-3; parameters rtol 1e-3, atol 1e-5).
"""

import json
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import main_pretrain_mae as jax_main
from headct_foundation_tpu.optim import lr_sched as jax_lr_sched
from headct_foundation_tpu_torch import main_pretrain_mae
from headct_foundation_tpu_torch.data.nifti import save_nifti
from headct_foundation_tpu_torch.engines import mae_engine
from headct_foundation_tpu_torch.optim import lr_sched
from headct_foundation_tpu_torch.utils import checkpoint as ckpt
from headct_foundation_tpu_torch.utils import tracing
from headct_foundation_tpu_torch.utils.torch_interop import OrbaxNotSupportedError
from tests.test_torch_port_train import TINY, _wire_batches

ROOT = Path(__file__).resolve().parent.parent
TINY_YAML = """
MODEL:
  DIR: {out}/model_saved
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
MAE:
  INPUT_SIZE: 24
  PATCH_SIZE: 12
  IN_CHANS: 3
  ENCODER_DEPTH: 2
  ENCODER_EMBED_DIM: 48
  ENCODER_MLP_DIM: 96
  ENCODER_NUM_HEADS: 4
  DECODER_DEPTH: 1
  DECODER_EMBED_DIM: 36
  DECODER_MLP_DIM: 72
  DECODER_NUM_HEADS: 4
  USE_BIAS: True
"""


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
    cfg = tmp_path / "mae_tiny.yaml"
    cfg.write_text(TINY_YAML.format(out=tmp_path))
    return str(cfg)


def _cli(args, cwd=ROOT):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-m", "headct_foundation_tpu_torch.main_pretrain_mae",
                        *args], cwd=cwd, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout[-3000:]}\nSTDERR:\n{r.stderr[-3000:]}"
    result = json.loads(next(line for line in r.stdout.splitlines()[::-1]
                             if line.startswith('{"cli"')))["cli"]
    return r.stdout + r.stderr, result


def test_cli_trains_checkpoints_and_resumes(tmp_path):
    cfg = _dataset(tmp_path)
    _, result = _cli(["--cfg", cfg, "--device", "cpu"])
    saved = sorted(os.listdir(tmp_path / "model_saved"))
    assert saved == ["best_debug.pt", "latest_debug.pt"], saved  # the default SAVE_NAME
    assert [e["epoch"] for e in result["epochs"]] == [0, 1]
    for e in result["epochs"]:
        assert e["train"]["steps"] == 2 and np.isfinite(e["train"]["loss"])
        assert np.isfinite(e["val"]["loss"]) and e["train"]["data_time"] >= 0
    assert np.isfinite(result["test"]["loss"]) and result["test"]["batches"] == 2
    assert result["placeholders"] == 0
    assert json.loads((tmp_path / "out" / "config.json").read_text())["SEED"] == 42

    # resume from latest_ (a pickle named .pt: routed by content, not extension)
    latest = str(tmp_path / "model_saved" / "latest_debug.pt")
    assert ckpt.load_checkpoint(latest)["epoch"] == 1
    log, result = _cli(["--cfg", cfg, "--device", "cpu", "--model_load_path", latest,
                        "--max_epochs", "3"])
    assert f"Resumed from {latest} at epoch 1" in log
    assert result["start_epoch"] == 1 and [e["epoch"] for e in result["epochs"]] == [1, 2]
    assert ckpt.load_checkpoint(latest)["step"] == 8  # 4 restored + 2 epochs of 2


def test_cli_routes_checkpoints_by_content(tmp_path, monkeypatch):
    cfg = _dataset(tmp_path, n=3)
    args = ["--cfg", cfg, "--device", "cpu", "--max_epochs", "1"]
    main_pretrain_mae.run(args)
    model = mae_engine.build_mae_model(main_pretrain_mae.parse_option(args)[1])
    torch_pt = tmp_path / "ref.pt"
    torch.save({"state_dict": {f"module.{k}": v for k, v in model.state_dict().items()}},
               torch_pt)
    out = main_pretrain_mae.run(args + ["--model_load_path", str(torch_pt)])
    assert out["start_epoch"] == 0
    # a pickle of another optimizer does not fit the train state: params only
    latest = str(tmp_path / "model_saved" / "latest_debug.pt")
    payload = ckpt.load_checkpoint(latest)
    del payload["opt_state"]["inner_states"]["train"]["inner_state"]["1"]["nu"]
    bad = tmp_path / "other_opt.ckpt"
    with open(bad, "wb") as f:
        pickle.dump(payload, f)
    out = main_pretrain_mae.run(args + ["--model_load_path", str(bad)])
    assert out["start_epoch"] == 0
    logged = (tmp_path / "log").glob("log_rank0_*.txt")
    text = "".join(p.read_text() for p in logged)
    assert "Loaded pretrained weights from" in text and "0 missing, 0 unexpected" in text
    assert "Full resume failed" in text and "merging params only" in text
    # HEADCT_PROFILE_DIR: a torch.profiler trace of the first epoch
    monkeypatch.setenv("HEADCT_PROFILE_DIR", str(tmp_path / "trace"))
    main_pretrain_mae.run(args)
    monkeypatch.delenv("HEADCT_PROFILE_DIR")
    assert [p.name for p in (tmp_path / "trace").iterdir()] == [f"trace_{os.getpid()}.json"]
    # ... holding the spans as user annotations; spans are off again after it
    with open(tmp_path / "trace" / f"trace_{os.getpid()}.json") as f:
        events = json.load(f)["traceEvents"]
    annotated = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"step", "augment", "fwd", "bwd", "update", "optimizer", "drain"} <= annotated
    assert not tracing.enabled() and tracing.take() == []
    with pytest.raises(OrbaxNotSupportedError):
        main_pretrain_mae.run(args + ["--opts", "TRAIN.CKPT_FORMAT", "orbax"])
    with pytest.raises(OrbaxNotSupportedError):
        main_pretrain_mae.run(args + ["--model_load_path", str(tmp_path)])


class _Stop(Exception):
    pass


def test_scaled_lr_and_schedule_equal_the_jax_main(tmp_path, monkeypatch):
    cfg_path = _dataset(tmp_path, n=5)
    args = ["--cfg", cfg_path, "--batch_size", "2", "--max_epochs", "7"]
    seen = {}

    def capture(name):
        def fake(config, *rest, **kw):
            ints = [a for a in rest if isinstance(a, int)][-2:]
            seen[name] = (float(config.TRAIN.BASE_LR), float(config.TRAIN.MIN_LR), *ints)
            raise _Stop
        return fake

    monkeypatch.setattr(jax_main.mae_engine, "create_train_state", capture("jax"))
    monkeypatch.setattr(main_pretrain_mae.mae_engine, "create_train_state", capture("port"))
    monkeypatch.setattr(sys, "argv", ["main_pretrain_mae.py", *args])
    _, jax_cfg = jax_main.parse_option()
    with pytest.raises(_Stop):
        jax_main.main(jax_cfg, None, main_pretrain_mae.create_logger(str(tmp_path / "jl"), 0, "j"))
    _, cfg = main_pretrain_mae.parse_option(args + ["--device", "cpu"])
    with pytest.raises(_Stop):
        main_pretrain_mae.main(cfg, torch.device("cpu"),
                               main_pretrain_mae.create_logger(str(tmp_path / "pl"), 0, "p"))
    assert seen["port"] == pytest.approx(seen["jax"], rel=1e-12)
    base, low, total, warmup = seen["port"]
    assert (total, warmup) == (3 * 7, int(0.05 * 21)) and base == pytest.approx(1e-3 * 2 / 256)
    f_p = lr_sched.get_lr_schedule(cfg, base, warmup, total, low)
    f_j = jax_lr_sched.get_lr_schedule(jax_cfg, base, warmup, total, low)
    np.testing.assert_allclose([f_p(s) for s in range(total + 2)],
                               [float(f_j(s)) for s in range(total + 2)], rtol=1e-5, atol=1e-12)


_DP_WORKER = r'''
import json, sys
import numpy as np, torch
from headct_foundation_tpu_torch.config import default_config
from headct_foundation_tpu_torch.engines import mae_engine
from headct_foundation_tpu_torch.parallel import distributed

tiny, data, out = json.loads(sys.argv[1]), sys.argv[2], sys.argv[3]
distributed.init_from_env("cpu", 2)
rank, world = distributed.rank(), distributed.world()
cfg = default_config()
cfg.merge_from_list(tiny)
state, _ = mae_engine.create_train_state(cfg, 20, 0, seed=0, dtype=torch.float32, device="cpu")
step = mae_engine.make_train_step(augment=True, config=cfg)
losses = []
for wire in np.load(data):
    n = wire.shape[0] // world
    state, m = step(state, torch.from_numpy(wire[rank * n:(rank + 1) * n]), seed=0)
    losses.append(m["loss"].item())
np.savez(out, losses=np.asarray(losses),
         **{k: v.numpy() for k, v in state.model.state_dict().items()})
distributed.shutdown()
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_equal_one_at_twice_the_batch(tmp_path):
    from headct_foundation_tpu_torch.config import default_config

    wires = np.stack(_wire_batches(2, 4))
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
    state, _ = mae_engine.create_train_state(cfg, 20, 0, seed=0, dtype=torch.float32, device="cpu")
    step = mae_engine.make_train_step(augment=True, config=cfg)
    losses = []
    for wire in wires:
        state, m = step(state, torch.from_numpy(wire), seed=0)
        losses.append(m["loss"].item())
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    for got in ranks:
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-3)
        for name, want in state.model.state_dict().items():
            np.testing.assert_allclose(got[name], want.numpy(), rtol=1e-3, atol=1e-5,
                                       err_msg=name)
    for name in ranks[0].files:  # the ranks hold one model
        assert np.array_equal(ranks[0][name], ranks[1][name]), name
