"""PyTorch port: the three CLI mains under ``torchrun`` on the mesh, on the CPU.

Each main runs under ``torch.distributed.run`` (gloo) on the tiny
configurations of its CLI test and writes whole checkpoints, which one
process resumes from, and a one-process checkpoint resumes on the mesh:

* ``main_pretrain_mae`` at ``PARALLEL.FSDP 2`` (2 processes), resumed in
  one process;
* ``main_pretrain_dino`` at ``SEQ 2 x TENSOR 2`` (4 processes), resumed
  in one process ("Resumed (full)"), whose checkpoint resumes at ``FSDP
  2``;
* ``main_downstream`` (few-shot LoRA) at ``SEQ 2 x TENSOR 2`` and at
  ``FSDP 2``, each warm-started from a one-process MAE checkpoint, each
  ``best_`` file restored in one process.

The JSON line's ``mesh`` names the layout; no scan is a placeholder.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from headct_foundation_tpu_torch import main_downstream, main_pretrain_dino, main_pretrain_mae
from headct_foundation_tpu_torch.utils import checkpoint as ckpt
from tests.test_torch_port_cli import _dataset as mae_dataset
from tests.test_torch_port_dino_cli import _dataset as dino_dataset
from tests.test_torch_port_downstream_cli import _dataset as ds_dataset
from tests.test_torch_port_downstream_cli import _mae_checkpoint
from tests.test_torch_port_model_parallel import _free_port

ROOT = Path(__file__).resolve().parent.parent
ST = ["PARALLEL.SEQ", "2", "PARALLEL.TENSOR", "2"]
FSDP = ["PARALLEL.FSDP", "2"]


def _torchrun(module: str, nproc: int, args: list, cwd=ROOT) -> dict:
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(nproc),
           "--master_addr", "localhost", "--master_port", str(_free_port()), "-m", module,
           *args]
    r = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=400,
                       env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-3000:]
    result = json.loads(next(line for line in r.stdout.splitlines()[::-1]
                             if line.startswith('{"cli"')))["cli"]
    assert result["placeholders"] == 0
    return result


def _mesh(**axes) -> dict:
    return {a: axes.get(a, 1) for a in ("data", "fsdp", "seq", "pipe", "tensor")}


def _log(tmp_path) -> str:
    return "".join(p.read_text() for p in (tmp_path / "log").glob("log_rank0_*.txt"))


def test_mae_cli_at_fsdp_resumes_in_one_process(tmp_path):
    cfg = mae_dataset(tmp_path)
    result = _torchrun("headct_foundation_tpu_torch.main_pretrain_mae", 2,
                       ["--cfg", cfg, "--device", "cpu", "--max_epochs", "1", "--opts", *FSDP,
                        "DATA.BATCH_SIZE", "2"])
    assert result["world"] == 2 and result["mesh"] == _mesh(fsdp=2)
    assert np.isfinite(result["epochs"][0]["train"]["loss"])
    latest = str(tmp_path / "model_saved" / "latest_debug.pt")
    result = main_pretrain_mae.run(["--cfg", cfg, "--device", "cpu", "--model_load_path", latest,
                                    "--max_epochs", "2", "--opts", "DATA.BATCH_SIZE", "4"])
    assert f"Resumed from {latest} at epoch 0" in _log(tmp_path)
    assert result["start_epoch"] == 0 and result["mesh"] == _mesh()


def test_dino_cli_at_seq_tensor_and_fsdp_resumes_both_ways(tmp_path):
    cfg = dino_dataset(tmp_path)
    module = "headct_foundation_tpu_torch.main_pretrain_dino"
    latest = str(tmp_path / "model_saved" / "latest_dino_tiny.ckpt")
    result = _torchrun(module, 4, ["--cfg", cfg, "--device", "cpu", "--max_epochs", "1",
                                   "--opts", *ST])
    assert result["world"] == 4 and result["mesh"] == _mesh(seq=2, tensor=2)
    assert np.isfinite(result["epochs"][0]["train"]["loss"])
    payload = ckpt.load_checkpoint(latest)
    assert payload["step"] == 2 and payload["center"].shape == (1, 128)
    qkv = payload["params"]["backbone"]["blocks_0"]["attn"]["qkv"]["kernel"]
    assert qkv.shape == (48, 144)  # whole: 4 heads of q, k and v
    result = main_pretrain_dino.run(["--cfg", cfg, "--device", "cpu", "--model_load_path",
                                     latest, "--max_epochs", "2"])
    assert f"Resumed (full) from {latest} at epoch 0" in _log(tmp_path)
    # the stored epoch is the one that finished, and a resume restarts at it
    assert result["start_epoch"] == 0 and ckpt.load_checkpoint(latest)["step"] == 6
    result = _torchrun(module, 2, ["--cfg", cfg, "--device", "cpu", "--model_load_path", latest,
                                   "--max_epochs", "3", "--opts", *FSDP])
    assert result["mesh"] == _mesh(fsdp=2) and result["start_epoch"] == 1
    assert [e["epoch"] for e in result["epochs"]] == [1, 2]
    assert ckpt.load_checkpoint(latest)["step"] == 8  # 1 step an epoch on 2 data ranks


def test_downstream_cli_at_seq_tensor_and_fsdp_warm_starts_and_restores(tmp_path):
    """A one-process MAE checkpoint warm-starts the downstream main at each
    mesh (the encoder's 30 tensors merged into the whole backbone, each rank
    keeping its shards), and the ``best_`` file each run writes restores in
    one process."""
    import torch

    from headct_foundation_tpu_torch.engines import downstream_engine

    cfg, _ = ds_dataset(tmp_path)
    mae = _mae_checkpoint(tmp_path)
    module = "headct_foundation_tpu_torch.main_downstream"
    args = ["--cfg", cfg, "--device", "cpu", "--lora", "--few_shots", "2", "--max_epochs", "1",
            "--model_load_path", mae]
    best = tmp_path / "model_saved" / "best_vit_tiny.ckpt"
    for nproc, opts, axes in ((4, ST, dict(seq=2, tensor=2)), (2, FSDP, dict(fsdp=2))):
        result = _torchrun(module, nproc, args + ["--opts", *opts], cwd=tmp_path)
        assert result["world"] == nproc and result["mesh"] == _mesh(**axes)
        assert np.isfinite(result["test"]["loss"]) and 0.0 <= result["best_val_mean_auroc"] <= 1
        assert result["warm_start"]["merged"] == 30  # LoRA's 8 tensors are the missing ones
        config = main_downstream.parse_option(args)[1]
        state = downstream_engine.create_train_state(config, 10, 1, dtype=torch.float32,
                                                     device="cpu")
        state, _, _ = ckpt.restore_downstream_state(state, ckpt.load_checkpoint(str(best)))
        assert state.step == 1
        os.remove(best)
