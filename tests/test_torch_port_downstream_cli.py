"""PyTorch port: the downstream CLI and data-parallel fine-tuning, on the CPU.

* ``python -m headct_foundation_tpu_torch.main_downstream --device cpu`` on
  tiny synthetic scans with cq500 label manifests (the full column order,
  ``img_path`` then the 14 labels), in three modes: a fine-tune
  warm-started from a port MAE checkpoint of the same encoder, in a
  subprocess; ``--lock --few_shots 2`` and ``--lora --classifier
  attentive``, in this process (a second interpreter's start-up is most
  of a run). Each
  writes ``best_`` and the predictions pickle, whose fnames are the test
  manifest's, whose targets are its labels and whose probabilities lie in
  [0, 1]; the JSON line counts 0 placeholders and the warm start's merged,
  missing and unexpected tensors. A non-finite train loss exits 1.
* Two gloo processes at batch 2 against one at batch 4 through the main
  (few-shot, so both read the same global batches: one permutation split
  ``rank::world``; in float32, through the data-parallel tool's
  ``float32_downstream``: in bf16 the head's BatchNorm over alike CLS
  features turns the two layouts' roundings into the signal):
  the train, val and test losses within 1e-5 relative, which a BatchNorm
  on each rank's own half-batch (planted: no all-reduce) fails. The same
  pair in float64 (``float64_downstream``, the tool's ``--float64``):
  within 1e-12 relative, and within 1e-5 of the float32 run.
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

from headct_foundation_tpu_torch import main_downstream
from headct_foundation_tpu_torch.data.datasets import CLASS_MAPPINGS
from headct_foundation_tpu_torch.data.nifti import save_nifti

ROOT = Path(__file__).resolve().parent.parent
TINY_YAML = """
MODEL:
  NAME: vit
  DIR: {out}/model_saved
  SAVE_NAME: vit_tiny.ckpt
  ROI: [24, 24, 24]
  IN_CHANS: 3
DATA:
  BATCH_SIZE: {batch}
  NUM_WORKERS: 2
  CACHE_DIR: {out}/cache
  TRAIN_CSV_PATH: {out}/train.csv
  VAL_CSV_PATH: {out}/val.csv
  TEST_CSV_PATH: {out}/test.csv
  DATASET: cq500
  NUM_CLASSES: 2
LOG:
  OUTPUT_DIR: {out}/log
OUTPUT: {out}/out
TRAIN:
  MAX_EPOCHS: 2
  VAL_EVERY: 1
  BASE_LR: 1.5e-4
  LABEL_NAME: ICH
  PER_WARMUP: 0.1
  ASYNC_CKPT: True
VIT:
  INPUT_SIZE: 24
  PATCH_SIZE: 12
  IN_CHANS: 3
  POS_EMBED: sincos
  HIDDEN_SIZE: 48
  NUM_LAYERS: 2
  MLP_DIM: 96
  NUM_HEADS: 4
  NUM_REGISTER_TOKENS: 0
  USE_BIAS: True
"""
NAMES = sorted(CLASS_MAPPINGS["cq500"], key=CLASS_MAPPINGS["cq500"].get)


def _dataset(tmp_path, n_scans=6, rows=None, batch=100) -> tuple:
    """Scans of different HU ranges (on scans of one range the CLS features
    nearly coincide and the BatchNorm over a few of them amplifies float32
    roundings) and cq500 manifests; returns (yaml path, {split: (paths,
    ICH labels)})."""
    rng = np.random.RandomState(0)
    scans = []
    for i in range(n_scans):
        lo, span = rng.uniform(-1000, 200), rng.uniform(300, 2500)
        vol = (lo + rng.rand(30, 32, 28) * span).astype(np.float32)
        p = str(tmp_path / f"scan_{i}.nii.gz")
        save_nifti(p, vol, np.diag([2.0, 2.0, 2.0, 1.0]))
        scans.append(p)
    rows = rows or {"train": 12, "val": 6, "test": 6}
    out = {}
    for split, n in rows.items():
        paths = [scans[i % n_scans] for i in range(n)]
        labels = (rng.rand(n, len(NAMES)) < 0.4).astype(int)
        labels[:2, 0] = [0, 1]  # both classes of ICH in every split
        # a path names one scan: its label is the row's, the last row winning
        last = {p: r for p, r in zip(paths, labels)}
        labels = np.array([last[p] for p in paths])
        (tmp_path / f"{split}.csv").write_text(
            "img_path," + ",".join(NAMES) + "\n"
            + "".join(f"{p}," + ",".join(map(str, r)) + "\n" for p, r in zip(paths, labels)))
        out[split] = (paths, labels[:, 0])
    cfg = tmp_path / "vit_tiny.yaml"
    cfg.write_text(TINY_YAML.format(out=tmp_path, batch=batch))
    return str(cfg), out


def _cli(args, cwd=ROOT):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-m", "headct_foundation_tpu_torch.main_downstream",
                        *args], cwd=cwd, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout[-3000:]}\nSTDERR:\n{r.stderr[-3000:]}"
    result = json.loads(next(line for line in r.stdout.splitlines()[::-1]
                             if line.startswith('{"cli"')))["cli"]
    return r.stdout + r.stderr, result


def _mae_checkpoint(tmp_path) -> str:
    """A port MAE checkpoint whose encoder is the tiny ViT."""
    import torch

    from headct_foundation_tpu_torch.config import default_config
    from headct_foundation_tpu_torch.engines import mae_engine
    from headct_foundation_tpu_torch.utils import checkpoint

    cfg = default_config()
    cfg.merge_from_list(["MAE.INPUT_SIZE", 24, "MAE.PATCH_SIZE", 12, "MAE.IN_CHANS", 3,
                         "MAE.ENCODER_DEPTH", 2, "MAE.ENCODER_EMBED_DIM", 48,
                         "MAE.ENCODER_MLP_DIM", 96, "MAE.ENCODER_NUM_HEADS", 4,
                         "MAE.DECODER_DEPTH", 1, "MAE.DECODER_EMBED_DIM", 36,
                         "MAE.DECODER_MLP_DIM", 72, "MAE.DECODER_NUM_HEADS", 4,
                         "MAE.USE_BIAS", True, "MODEL.ROI", [24, 24, 24]])
    state, _ = mae_engine.create_train_state(cfg, 10, 0, seed=9, dtype=torch.float32,
                                             device="cpu")
    return checkpoint.save_checkpoint(state, 3, 0.5, str(tmp_path / "mae"), "latest_mae.ckpt")


def _held_preds(tmp_path, name, test) -> dict:
    with open(tmp_path / "preds_pkl" / f"{name}_preds.pkl", "rb") as f:
        preds = pickle.load(f)
    paths, labels = test
    assert preds["fnames"] == paths
    np.testing.assert_array_equal(preds["targets"], labels)
    p = np.asarray(preds["preds"])
    assert p.shape == (len(paths),) and ((p >= 0) & (p <= 1)).all()
    return preds


@pytest.mark.parametrize("mode,args", [  # one epoch of 500 weighted draws, two of few-shot
    ("fine-tune", ["--max_epochs", "1"]),
    ("lock-few-shot", ["--lock", "--few_shots", "2"]),
    ("lora-attentive", ["--lora", "--classifier", "attentive", "--max_epochs", "1"]),
])
def test_downstream_cli_runs_each_mode(tmp_path, monkeypatch, mode, args):
    cfg, splits = _dataset(tmp_path)
    argv = ["--cfg", cfg, "--device", "cpu", "--preds_save_name", mode, *args]
    if mode == "fine-tune":
        log, result = _cli(argv + ["--model_load_path", _mae_checkpoint(tmp_path)], cwd=tmp_path)
    else:
        monkeypatch.chdir(tmp_path)  # the tester writes preds_pkl/ into the working directory
        result = main_downstream.run(argv)
        log = "".join(p.read_text() for p in (tmp_path / "log").glob("log_rank0_*.txt"))
    assert result["placeholders"] == 0 and result["world"] == 1
    steps = [e["train"]["steps"] for e in result["epochs"]]
    assert steps == ([1, 1] if "few" in mode else [5])  # 2 x 2 shots; 500 draws of 100
    for e in result["epochs"]:
        assert np.isfinite(e["train"]["loss"]) and np.isfinite(e["val"]["loss"])
        assert 0.0 <= e["val"]["mean_auroc"] <= 1.0
    assert np.isfinite(result["best_val_mean_auroc"]) and np.isfinite(result["test"]["loss"])
    assert os.listdir(tmp_path / "model_saved") == ["best_vit_tiny.ckpt"]
    _held_preds(tmp_path, mode, splits["test"])
    if mode == "fine-tune":  # the encoder merged; the decoder and mask token unexpected
        ws = result["warm_start"]
        assert ws["merged"] == 30 and ws["missing"] == 0 and ws["unexpected"] > 0, ws
        assert "Warm start: 30 of 30 backbone tensors merged" in log
    else:
        assert result["warm_start"] is None
    if "lora" in mode:
        assert "LoRA: True" in log and "Classifier: attentive" in log


def test_downstream_cli_exits_1_on_a_non_finite_train_loss(tmp_path, monkeypatch):
    cfg, _ = _dataset(tmp_path)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as stop:  # 2 epochs of one step: the second is not finite
        main_downstream.run(["--cfg", cfg, "--device", "cpu", "--base_lr", "1e30",
                             "--few_shots", "2"])
    assert stop.value.code == 1
    log = "".join(p.read_text() for p in (tmp_path / "log").glob("log_rank0_*.txt"))
    assert "stopping training" in log


_DP_WORKER = r'''
import sys

from headct_foundation_tpu_torch.models import layers
from headct_foundation_tpu_torch.tools.check_data_parallel import (
    float32_downstream,
    float64_downstream,
)

if sys.argv[1] == "planted":  # each rank's BatchNorm on its own half-batch, as with no
    class _Alone:              # process group: its own sums over its own count
        @staticmethod
        def is_initialized():
            return False

    layers.dist = _Alone
# float32, so one process and two sum the same numbers; float64, the reference
(float64_downstream if sys.argv[1] == "float64" else float32_downstream)(sys.argv[2:])
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dp_start(tmp_path, cfg, tag: str, world: int, batch: int, mode: str = "synced") -> list:
    """Start the ``world`` processes of one run; ``_dp_result`` reads it."""
    out = tmp_path / tag
    out.mkdir(parents=True, exist_ok=True)
    args = ["--cfg", cfg, "--device", "cpu", "--few_shots", "4", "--batch_size", str(batch),
            "--opts", "MODEL.DIR", str(out / "model"), "LOG.OUTPUT_DIR", str(out / "log"),
            "OUTPUT", "", "TRAIN.ASYNC_CKPT", "False"]
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
        if world > 1:
            env.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                       MASTER_ADDR="localhost", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _DP_WORKER, mode, *args],
            cwd=out, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _dp_result(procs: list, world: int) -> dict:
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]  # a hung rendezvous fails here
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(o[-2000:] for o in outs)
    result = json.loads(next(line for line in outs[0].splitlines()[::-1]
                             if line.startswith('{"cli"')))["cli"]
    assert result["world"] == world and result["placeholders"] == 0
    return result


def _losses(result) -> np.ndarray:
    return np.array([x for e in result["epochs"] for x in (e["train"]["loss"], e["val"]["loss"])]
                    + [result["test"]["loss"]])


def test_two_gloo_processes_equal_one_at_twice_the_batch(tmp_path):
    cfg, _ = _dataset(tmp_path, rows={"train": 12, "val": 8, "test": 8})
    runs = [_dp_start(tmp_path, cfg, "one", 1, 4), _dp_start(tmp_path, cfg, "two", 2, 2),
            _dp_start(tmp_path, cfg, "planted", 2, 2, mode="planted"),
            _dp_start(tmp_path, cfg, "one64", 1, 4, mode="float64"),
            _dp_start(tmp_path, cfg, "two64", 2, 2, mode="float64")]
    one, two, planted, one64, two64 = (_dp_result(p, w) for p, w in zip(runs, (1, 2, 2, 1, 2)))
    assert [e["train"]["steps"] for e in one["epochs"]] == [2, 2]  # 2 x 4 shots at batch 4
    np.testing.assert_allclose(_losses(two), _losses(one), rtol=1e-5)
    assert not np.allclose(_losses(planted), _losses(one), rtol=1e-5, atol=0), (
        _losses(planted), _losses(one))
    # float64: the layouts' roundings all but gone, and the same run as float32's
    np.testing.assert_allclose(_losses(two64), _losses(one64), rtol=1e-12, atol=0)
    np.testing.assert_allclose(_losses(one64), _losses(one), rtol=1e-5)
    assert not np.array_equal(_losses(one64), _losses(one))
