"""PyTorch port: imports no JAX and nothing of the JAX package, nor pandas,
orbax, scikit-learn or matplotlib (it imports every module, the token-major
tool's and the CLIs' included, and runs a serving forward, attention maps,
an input of another size, a retrieval mAP, tiny MAE train
steps, one of them on the blocked attention path and one with the fused
Lion update, a checkpoint save and restore, the manifest reader, a tiny
DINO step with its checkpoint, and the downstream CLI end to end (LoRA,
the attentive head, the metrics, the predictions pickle, no plot), with
those imports blocked),
defaults to CUDA, and builds from its own config copy.

The subprocess blocks the imports with a ``sys.meta_path`` finder rather than
``sys.modules["jax"] = None``: scipy's array-API helpers look ``jax`` up in
``sys.modules`` and fail on a ``None`` entry, while a refused import is what
a machine without JAX gives. The finder's spec has no origin, so torch's
presence probe of pandas (``find_spec``) passes over it.
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
import importlib, importlib.abc, importlib.machinery, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "headct_foundation_tpu", "pandas", "orbax",
           "sklearn", "matplotlib")

class Block(importlib.abc.Loader):
    """A spec without an origin for a blocked name, whose loading raises: an
    import fails, and a presence probe by find_spec (torch's dynamo makes
    one for pandas) finds nothing to load, as on a machine without it."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            return importlib.machinery.ModuleSpec(name, self)

    def create_module(self, spec):
        raise ImportError(f"blocked import of {spec.name}")

    def exec_module(self, module):
        raise ImportError(f"blocked import of {module.__name__}")

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
# attention maps, another input size, retrieval
maps = fe.attention_maps(np.random.RandomState(1).rand(2, 3, 24, 24, 24))
assert len(maps) == 2 and maps[0].shape == (2, 4, 9, 9)
out, _ = fe(np.random.RandomState(2).rand(1, 3, 24, 36, 24))
assert out.shape == (1, 13, 48)
from headct_foundation_tpu_torch.eval.retrieval import retrieval_map_per_class

assert set(retrieval_map_per_class(np.random.RandomState(3).randn(6, 8),
                                   {"a": np.array([1, 1, 0, 1, 0, 0])})) == {"a"}
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

# the fused Lion path with the gradient clip
cfg.merge_from_list(["TRAIN.OPTIMIZER", "Lion", "TRAIN.LION_FUSED", True, "TRAIN.GRAD_CLIP", 1.0])
state, _ = mae_engine.create_train_state(cfg, 10, 0, seed=0, device="cpu")
state, metrics = mae_engine.make_train_step(config=cfg)(state, wire, seed=0)
assert type(state.optimizer).__name__ == "Lion" and bool(torch.isfinite(metrics["loss"]))

# a checkpoint in the JAX package's format, written and restored; a manifest
import os, tempfile
from headct_foundation_tpu_torch.data.datasets import read_manifest
from headct_foundation_tpu_torch.utils import checkpoint

with tempfile.TemporaryDirectory() as tmp:
    path = checkpoint.save_checkpoint(state, 0, 1.0, tmp, "latest_x.pt", async_save=True)
    checkpoint.wait_for_saves()
    fresh, _ = mae_engine.create_train_state(cfg, 10, 0, seed=1, device="cpu")
    fresh, epoch, _ = checkpoint.restore_state(fresh, checkpoint.load_checkpoint(path))
    assert fresh.step == state.step == 1 and epoch == 0
    assert all(torch.equal(a, b) for a, b in zip(fresh.model.state_dict().values(),
                                                  state.model.state_dict().values()))
    with open(os.path.join(tmp, "m.csv"), "w") as f:
        f.write("img_path\n/a.nii.gz\n")
    assert read_manifest(os.path.join(tmp, "m.csv")) == [{"img_path": "/a.nii.gz"}]
# a DINO step with the multi-crop and the frozen last layer, and its checkpoint
from headct_foundation_tpu_torch.engines import dino_engine

cfg = default_config()
cfg.merge_from_list(["MODEL.ROI", [24, 24, 24], "VIT.INPUT_SIZE", 24, "VIT.PATCH_SIZE", 12,
                     "VIT.HIDDEN_SIZE", 48, "VIT.MLP_DIM", 96, "VIT.NUM_LAYERS", 1,
                     "VIT.NUM_HEADS", 4, "VIT.NUM_REGISTER_TOKENS", 2,
                     "DINO.HEAD_N_PROTOTYPES", 32, "DINO.HEAD_HIDDEN_DIM", 16,
                     "DINO.BOTTLENECK_DIM", 8, "DINO.USE_BN", False,
                     "DATA.WIRE_FORMAT", "hu16", "PARALLEL.PALLAS_MIN_T", 11])
dino = dino_engine.create_train_state(cfg, 10, 0, 5, seed=0, device="cpu")
dino, metrics = dino_engine.make_train_step(cfg)(dino, wire, 0, 0.99, 0.04, True)
assert dino.step == 1 and bool(torch.isfinite(metrics["loss"]))
with tempfile.TemporaryDirectory() as tmp:
    path = checkpoint.save_checkpoint(dino, 0, 1.0, tmp, "latest_dino.ckpt")
    fresh = dino_engine.create_train_state(cfg, 10, 0, 5, seed=1, device="cpu")
    fresh, epoch, _ = checkpoint.restore_dino_state(fresh, checkpoint.load_checkpoint(path))
    assert fresh.step == 1 and torch.equal(fresh.center, dino.center)
# the downstream CLI end to end: tiny scans, cq500 label manifests, LoRA and
# the attentive head; the metrics without scikit-learn, no plot without matplotlib
import json, pickle
from headct_foundation_tpu_torch import main_downstream
from headct_foundation_tpu_torch.data.datasets import CLASS_MAPPINGS
from headct_foundation_tpu_torch.data.nifti import save_nifti

with tempfile.TemporaryDirectory() as tmp:
    rng = np.random.RandomState(0)
    columns = sorted(CLASS_MAPPINGS["cq500"], key=CLASS_MAPPINGS["cq500"].get)
    scans = []
    for i in range(4):
        p = os.path.join(tmp, f"s{i}.nii.gz")
        save_nifti(p, (rng.uniform(-1000, 0) + rng.rand(30, 32, 28) * 2000).astype(np.float32),
                   np.diag([2.0, 2.0, 2.0, 1.0]))
        scans.append(p)
    for split in ("train", "val", "test"):
        with open(os.path.join(tmp, f"{split}.csv"), "w") as f:
            f.write("img_path," + ",".join(columns) + "\n")
            for i, p in enumerate(scans):
                f.write(p + "," + ",".join(str((i + j) % 2) for j in range(14)) + "\n")
    cfg = ["MODEL.ROI", "[24,24,24]", "VIT.INPUT_SIZE", "24", "VIT.PATCH_SIZE", "12",
           "VIT.HIDDEN_SIZE", "48", "VIT.MLP_DIM", "96", "VIT.NUM_LAYERS", "1",
           "VIT.NUM_HEADS", "4", "DATA.BATCH_SIZE", "250", "TRAIN.MAX_EPOCHS", "1",
           "TRAIN.VAL_EVERY", "1", "DATA.CACHE_DIR", os.path.join(tmp, "cache"),
           "MODEL.DIR", os.path.join(tmp, "m"), "LOG.OUTPUT_DIR", os.path.join(tmp, "log"),
           "OUTPUT", ""]
    for split in ("TRAIN", "VAL", "TEST"):
        cfg += [f"DATA.{split}_CSV_PATH", os.path.join(tmp, f"{split.lower()}.csv")]
    os.chdir(tmp)
    result = main_downstream.run(["--cfg", "configs/downstream/vit_HeadCT_cq500.yaml"
                                  .replace("configs", os.environ["HEADCT_ROOT"] + "/configs"),
                                  "--device", "cpu", "--dataset", "cq500", "--label_name",
                                  "ICH", "--lora", "--classifier", "attentive",
                                  "--opts", *cfg])
    with open(os.path.join(tmp, "preds_pkl", "None_preds.pkl"), "rb") as f:
        preds = pickle.load(f)
    assert preds["fnames"] == scans and result["placeholders"] == 0
    assert 0.0 <= result["test"]["mean_auroc"] <= 1.0
    assert not os.path.exists(os.path.join(tmp, "plots"))  # no matplotlib, no PNG
leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not leaked, leaked
print("imported", len(names), "modules")
'''


def test_port_imports_and_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT), HEADCT_ROOT=str(ROOT))
    r = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    n = int(re.search(r"^imported (\d+) modules$", r.stdout, re.M).group(1))
    assert n >= 24, r.stdout


def test_port_sources_name_no_jax():
    # matplotlib only inside a function (the plots import it where they draw)
    pattern = re.compile(r"^\s*(import (jax|pandas|orbax|sklearn)|from (jax|pandas|orbax|sklearn))"
                         r"\b|^(import|from) matplotlib\b|headct_foundation_tpu\.", re.M)
    files = sorted(PKG.rglob("*.py")) + sorted(PKG.rglob("*.cu")) + [ROOT / "chip_smoke.py", ROOT / "chip_fault_check.py"]
    assert len(files) >= 20
    # the token-major tool and the Lion kernel are the port's own copies
    names = {str(f.relative_to(PKG)) for f in files if PKG in f.parents}
    assert {"tools/experimental_tm_attention.py", "tools/bench_tm_attention.py",
            "ops/lion_kernel.py", "csrc/lion_update.cu", "csrc/tm_attention.cu"} <= names
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
    from headct_foundation_tpu_torch.engines import dino_engine, mae_engine
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mae_engine.create_train_state(default_config(), 10, 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dino_engine.create_train_state(default_config(), 10, 0, 5)
    from headct_foundation_tpu_torch.engines import downstream_engine
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        downstream_engine.create_train_state(default_config(), 10, 0)


def test_build_extractor_from_config_copy():
    cfg = default_config()
    cfg.merge_from_list(["VIT.INPUT_SIZE", 24, "VIT.HIDDEN_SIZE", 48, "VIT.MLP_DIM", 96,
                         "VIT.NUM_LAYERS", 1, "VIT.NUM_HEADS", 4, "VIT.USE_BIAS", True])
    fe = feature_extraction.build_extractor_from_config(cfg, device="cpu")
    assert fe.token_grid == (2, 2, 2)
    assert fe.model.blocks[0].attn.qkv.bias is not None
    assert fe(torch.zeros(3, 24, 24, 24))[0].shape == (1, 9, 48)
