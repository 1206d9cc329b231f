"""PyTorch port: imports no JAX and nothing of the JAX package (it imports
every module and runs a serving forward and tiny MAE train steps, one of them
on the blocked attention path, with those imports blocked), defaults to CUDA,
and builds from its own config copy.

The subprocess blocks the imports with a ``sys.meta_path`` finder rather than
``sys.modules["jax"] = None``: scipy's array-API helpers look ``jax`` up in
``sys.modules`` and fail on a ``None`` entry, while a refused import is what
a machine without JAX gives.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from headct_foundation_tpu_torch import feature_extraction
from headct_foundation_tpu_torch.config import default_config

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "headct_foundation_tpu_torch"

_BLOCKED_RUN = r'''
import importlib, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "headct_foundation_tpu")

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")

sys.meta_path.insert(0, Block())
import numpy as np
import torch
import headct_foundation_tpu_torch as pkg

names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
from headct_foundation_tpu_torch.feature_extraction import FeatureExtractor
from headct_foundation_tpu_torch.ops import attention

attention.set_attention_backend("kernel")
attention.set_pallas_min_t(1)
fe = FeatureExtractor(device="cpu", img_size=24, patch_size=12, in_chans=3, hidden_size=48,
                      mlp_dim=96, num_layers=2, num_heads=4)
out, hidden = fe(np.random.RandomState(0).rand(2, 3, 24, 24, 24))
assert out.shape == (2, 9, 48) and len(hidden) == 2 and bool(torch.isfinite(out).all())
from headct_foundation_tpu_torch.config import default_config
from headct_foundation_tpu_torch.data.transforms import hu16_encode
from headct_foundation_tpu_torch.engines import mae_engine

cfg = default_config()
cfg.merge_from_list(["MAE.INPUT_SIZE", 24, "MAE.PATCH_SIZE", 12, "MAE.ENCODER_DEPTH", 1,
                     "MAE.ENCODER_EMBED_DIM", 48, "MAE.ENCODER_MLP_DIM", 96,
                     "MAE.ENCODER_NUM_HEADS", 4, "MAE.DECODER_DEPTH", 1,
                     "MAE.DECODER_EMBED_DIM", 48, "MAE.DECODER_MLP_DIM", 96,
                     "MAE.DECODER_NUM_HEADS", 4, "MODEL.ROI", [24, 24, 24],
                     "DATA.WIRE_FORMAT", "hu16", "TRAIN.GRAD_CLIP", 0.0,
                     "PARALLEL.PALLAS_MIN_T", 9])
state, _ = mae_engine.create_train_state(cfg, 10, 0, seed=0, device="cpu")
step = mae_engine.make_train_step(augment=True, config=cfg)
wire = torch.from_numpy(hu16_encode(np.random.RandomState(0).uniform(-900, 1500, (2, 1, 24, 24, 24))))
state, metrics = step(state, wire, seed=0)
assert state.step == 1 and bool(torch.isfinite(metrics["loss"]))

# one step on the blocked path: the decoder's T = 9 beyond a lowered VMEM_PATH_MAX_T
from headct_foundation_tpu_torch.ops import flash_attention

seen = []
Blocked = flash_attention.BlockedFusedAttention

class Spy(Blocked):
    @staticmethod
    def forward(ctx, q, k, v, scale=None, kv_len=None):
        seen.append(q.shape[1])
        return Blocked.forward(ctx, q, k, v, scale, kv_len)

flash_attention.VMEM_PATH_MAX_T = 4
flash_attention.BlockedFusedAttention = Spy
state, metrics = step(state, wire, seed=0)
assert state.step == 2 and bool(torch.isfinite(metrics["loss"])) and seen == [9], seen
leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not leaked, leaked
print("imported", len(names), "modules")
'''


def test_port_imports_and_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    n = int(r.stdout.split()[1])
    assert n >= 16, r.stdout


def test_port_sources_name_no_jax():
    pattern = re.compile(r"^\s*(import jax|from jax)\b|headct_foundation_tpu\.", re.M)
    files = sorted(PKG.rglob("*.py")) + sorted(PKG.rglob("*.cu")) + [ROOT / "chip_smoke.py", ROOT / "chip_fault_check.py"]
    assert len(files) >= 20
    hits = [f"{f.relative_to(ROOT)}: {m.group(0)!r}"
            for f in files for m in pattern.finditer(f.read_text())]
    assert not hits, hits


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        feature_extraction.FeatureExtractor()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        feature_extraction.resolve_device("cuda")
    assert feature_extraction.resolve_device("cpu") == torch.device("cpu")
    from headct_foundation_tpu_torch import serve_features
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_features.main(["--img-size", "24"])
    from headct_foundation_tpu_torch.engines import mae_engine
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mae_engine.create_train_state(default_config(), 10, 0)


def test_build_extractor_from_config_copy():
    cfg = default_config()
    cfg.merge_from_list(["VIT.INPUT_SIZE", 24, "VIT.HIDDEN_SIZE", 48, "VIT.MLP_DIM", 96,
                         "VIT.NUM_LAYERS", 1, "VIT.NUM_HEADS", 4, "VIT.USE_BIAS", True])
    fe = feature_extraction.build_extractor_from_config(cfg, device="cpu")
    assert fe.token_grid == (2, 2, 2)
    assert fe.model.blocks[0].attn.qkv.bias is not None
    assert fe(torch.zeros(3, 24, 24, 24))[0].shape == (1, 9, 48)
