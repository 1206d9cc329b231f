"""PyTorch port: the scipy decode chain and the export, cache, parity and
soak tools, held against the JAX package on the CPU.

* The ``python`` backend (``HEADCT_NATIVE=0``): ``load_and_preprocess``
  (one and three windows) and ``load_and_preprocess_hu16`` byte-equal to the
  JAX package's on the tests' synthetic scans, isotropic and at head CT's
  0.5 x 0.5 x 1.0 mm; a ``DiskCache`` miss equal to JAX's under JAX's key.
* ``tools/export_torch.py``: MAE, DINO (student with the teacher, and the
  teacher alone), downstream (backbone and classifier with its BatchNorm
  statistics) and a pipelined MAE checkpoint against JAX
  ``tools/export_torch.export``, key for key and bit for bit; the exported
  backbone loads into ``FeatureExtractor`` whole.
* ``tools/build_cache.py --packed``: the index and the shards equal the JAX
  tool's on one manifest, each tensor a cache miss's; a second build skips
  what is packed.
* ``tools/parity_check.py``: ``--make-oracle-ckpt`` then the check on two
  scans, PASS at 0.999.
* ``tools/soak_resume.py``: its parse, stitch and checks on the log of a
  real CPU run of the MAE main and its resume from ``latest_``; its kill
  decision on synthetic logs (a kill past epoch K + 1, or at its last
  step, is refused), its choice of file on synthetic ``latest_`` lists (a
  ``*.tmp`` is never chosen) and its checks on a resume at another epoch
  than the chosen file's.
"""

import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from headct_foundation_tpu.data import datasets as jax_ds
from headct_foundation_tpu.data import transforms as jt
from headct_foundation_tpu.engines import mae_engine as jax_mae
from headct_foundation_tpu.parallel.mesh import make_mesh
from headct_foundation_tpu.utils import checkpoint as jax_ckpt
from headct_foundation_tpu_torch import main_pretrain_mae
from headct_foundation_tpu_torch.data import datasets, transforms
from headct_foundation_tpu_torch.engines import dino_engine, downstream_engine, mae_engine
from headct_foundation_tpu_torch.feature_extraction import FeatureExtractor
from headct_foundation_tpu_torch.tools import build_cache, export_torch, parity_check, soak_resume
from headct_foundation_tpu_torch.utils import checkpoint as ckpt
from tests.test_torch_port_cli import _dataset as mae_dataset
from tests.test_torch_port_data import FINE, _scan, jax_native_library  # noqa: F401
from tests.test_torch_port_dino_train import TINY as DINO_TINY
from tests.test_torch_port_downstream_train import TINY as DS_TINY
from tests.test_torch_port_pipeline import _jax_config as jax_pipe_config

ROOT = Path(__file__).resolve().parent.parent
AFFINES = [pytest.param(np.eye(4), id="isotropic"), pytest.param(FINE, id="fine")]
sys.path.insert(0, str(ROOT))  # the JAX tools, as their own tests import them


@pytest.mark.parametrize("affine", AFFINES)
def test_scipy_chain_is_byte_equal_to_jax(tmp_path, monkeypatch, affine):
    p = _scan(tmp_path, affine)
    for roi, chans in (((24, 24, 24), 3), ((24, 20, 16), 1)):
        got = transforms.load_and_preprocess(p, roi, chans)
        want = jt.load_and_preprocess(p, roi, chans)
        assert got.dtype == want.dtype == np.float16
        np.testing.assert_array_equal(got, want)
        got, want = transforms.load_and_preprocess_hu16(p, roi), jt.load_and_preprocess_hu16(p, roi)
        assert got.dtype == want.dtype == np.int16
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(transforms.extract_feature_preprocess(p, (24,) * 3, 3),
                                  jt.extract_feature_preprocess(p, (24,) * 3, 3))
    monkeypatch.setenv("HEADCT_NATIVE", "0")
    for wire in ("windowed", "hu16", "hu8"):
        port = datasets.DiskCache(str(tmp_path / "p"), (24,) * 3, 3, wire=wire)
        jax_cache = jax_ds.DiskCache(str(tmp_path / "j"), (24,) * 3, 3, wire=wire)
        assert port.backend == "python" and port.key(p) == jax_cache._key(p)
        np.testing.assert_array_equal(port.load(p), jax_cache.load(p))


def _assert_same_pt(got_path: str, want_path: str) -> None:
    got = torch.load(got_path, weights_only=False)
    want = torch.load(want_path, weights_only=False)
    assert set(got) == set(want)
    for key in want:
        if isinstance(want[key], dict):
            assert list(got[key]) == list(want[key]) or set(got[key]) == set(want[key]), key
            for name, t in want[key].items():
                assert got[key][name].dtype == t.dtype and torch.equal(got[key][name], t), name
        else:
            assert got[key] == want[key], key


def _port_checkpoints(tmp_path) -> dict:
    """Checkpoints the port writes: MAE, DINO (student, teacher, centre) and
    downstream (the attentive head, its BatchNorm statistics)."""
    from headct_foundation_tpu_torch.config import default_config

    out = {}
    cfg = default_config()
    cfg.merge_from_list(["MAE.INPUT_SIZE", 24, "MAE.PATCH_SIZE", 12, "MAE.ENCODER_DEPTH", 2,
                         "MAE.ENCODER_EMBED_DIM", 48, "MAE.ENCODER_MLP_DIM", 96,
                         "MAE.ENCODER_NUM_HEADS", 4, "MAE.DECODER_DEPTH", 1,
                         "MAE.DECODER_EMBED_DIM", 36, "MAE.DECODER_MLP_DIM", 72,
                         "MAE.DECODER_NUM_HEADS", 4, "MAE.IN_CHANS", 3, "MODEL.ROI", [24] * 3])
    state, _ = mae_engine.create_train_state(cfg, 10, 0, seed=0, dtype=torch.float32,
                                             device="cpu")
    out["mae"] = ckpt.save_checkpoint(state, 2, 0.5, str(tmp_path), "mae.ckpt")
    cfg = default_config()
    cfg.merge_from_list(list(DINO_TINY))
    dino = dino_engine.create_train_state(cfg, 10, 0, 5, seed=0, dtype=torch.float32,
                                          device="cpu")
    out["dino"] = ckpt.save_checkpoint(dino, 1, 0.25, str(tmp_path), "dino.ckpt")
    cfg = default_config()
    cfg.merge_from_list(list(DS_TINY) + ["TRAIN.CLASSIFIER", "attentive"])
    ds = downstream_engine.create_train_state(cfg, 10, 0, seed=0, dtype=torch.float32,
                                              device="cpu")
    out["downstream"] = ckpt.save_checkpoint(ds, 3, 0.75, str(tmp_path), "ds.ckpt")
    return out


def test_export_matches_the_jax_tool(tmp_path):
    from tools.export_torch import export as jax_export

    paths = _port_checkpoints(tmp_path)
    cfg = jax_pipe_config()
    jmesh = make_mesh(data=2, pipe=2, devices=jax.devices()[:4])
    state, _, _ = jax_mae.create_train_state(cfg, jmesh, jax.random.PRNGKey(0), 10, 0,
                                             dtype=jnp.float32)
    assert "blocks" in state.params and "blocks_0" not in state.params
    paths["pipe"] = jax_ckpt.save_checkpoint(state, 0, 0.0, str(tmp_path), "pipe.ckpt")
    for kind, parts in (("mae", ["auto"]), ("pipe", ["auto"]),
                        ("dino", ["auto", "dino-teacher"]), ("downstream", ["auto"])):
        for part in parts:
            got = export_torch.export(paths[kind], str(tmp_path / f"{kind}-{part}-port.pt"), part)
            want = jax_export(paths[kind], str(tmp_path / f"{kind}-{part}-jax.pt"), part)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                _assert_same_pt(g, w)
    sd = torch.load(str(tmp_path / "pipe-auto-port.pt"), weights_only=False)["state_dict"]
    assert sd["blocks.1.attn.qkv.weight"].dim() == 2 and "blocks.attn.qkv.weight" not in sd
    # the exported downstream backbone into the extractor, every weight taken
    fe = FeatureExtractor(checkpoint_path=str(tmp_path / "downstream-auto-port.pt"),
                          img_size=24, patch_size=12, in_chans=3, hidden_size=48, mlp_dim=96,
                          num_layers=2, num_heads=4, device="cpu")
    want = torch.load(str(tmp_path / "downstream-auto-port.pt"), weights_only=False)["state_dict"]
    model_sd = fe.model.state_dict()
    assert all(torch.equal(model_sd[k], v) for k, v in want.items() if k in model_sd)
    assert {k for k in model_sd} <= set(want) | {"patch_embedding.position_embeddings"}


def test_build_cache_matches_the_jax_tool(tmp_path, monkeypatch):
    import tools.build_cache as jax_tool

    scans = [_scan(tmp_path, np.diag([2.0, 1.5, 2.5, 1.0]), f"s{i}.nii.gz", seed=i)
             for i in range(3)]
    manifest = tmp_path / "m.csv"
    manifest.write_text("img_path\n" + "\n".join(scans) + "\n")
    args = ["--csv", str(manifest), "--roi", "24", "--wire", "hu16", "--packed",
            "--workers", "2", "--volumes-per-shard", "2"]
    counts = build_cache.main(args + ["--cache-dir", str(tmp_path / "port")])
    assert counts == {"done": 3, "errors": 0, "packed": 3, "skipped": 0}
    monkeypatch.setattr(sys, "argv", ["build_cache.py"] + args +
                        ["--cache-dir", str(tmp_path / "jax")])
    jax_tool.main()
    index = json.loads((tmp_path / "port" / "pack_index.json").read_text())
    assert index == json.loads((tmp_path / "jax" / "pack_index.json").read_text())
    bins = sorted(f for f in os.listdir(tmp_path / "port") if f.endswith(".bin"))
    assert bins == ["pack_00000.bin", "pack_00001.bin"]
    for b in bins:
        assert (tmp_path / "port" / b).read_bytes() == (tmp_path / "jax" / b).read_bytes()
    cache = datasets.DiskCache(str(tmp_path / "port"), (24,) * 3, 3, wire="hu16")
    for p in scans:
        np.testing.assert_array_equal(cache.load(p), cache.preprocess(p))
    again = build_cache.main(args + ["--cache-dir", str(tmp_path / "port")])
    assert again == {"done": 0, "errors": 0, "packed": 3, "skipped": 3}


def test_parity_check_passes_on_its_oracle_checkpoint(tmp_path, monkeypatch):
    monkeypatch.delenv("HEADCT_EXACT_GELU", raising=False)
    geometry = ["--img-size", "24", "--patch-size", "12", "--in-chans", "3",
                "--hidden-size", "48", "--mlp-dim", "96", "--num-layers", "2",
                "--num-heads", "4"]
    oracle = str(tmp_path / "oracle.pt")
    parity_check.run(["--make-oracle-ckpt", oracle] + geometry)
    scans = tmp_path / "scans"
    scans.mkdir()
    for i in range(2):
        _scan(scans, np.diag([2.0, 1.5, 2.5, 1.0]), f"s{i}.nii.gz", seed=i)
    report = parity_check.run(["--checkpoint", oracle, "--nifti-dir", str(scans),
                               "--device", "cpu", "--report", str(tmp_path / "r.json")]
                              + geometry)
    assert report["pass"] and report["n_scans"] == 2 and report["min_cosine"] >= 0.999
    assert json.loads((tmp_path / "r.json").read_text())["pass"]
    assert "HEADCT_EXACT_GELU" not in os.environ  # the erf GELU was the check's alone


def test_soak_parse_and_stitch_on_a_real_run(tmp_path):
    """Two epochs of the tiny MAE main, then its resume from ``latest_`` for
    a third, in this process: the log's steps parse, the resume's restart
    epoch and "Resumed from" are found, and the checks find the resume and
    the finite losses (and fail a series that jumps back to its start)."""
    cfg = mae_dataset(tmp_path)
    main_pretrain_mae.run(["--cfg", cfg, "--device", "cpu"])
    phase1 = soak_resume.parse_steps(str(tmp_path))
    assert [(r[0], r[1]) for r in phase1] == [(1, 1), (1, 2), (2, 1), (2, 2)]
    latest = str(tmp_path / "model_saved" / "latest_debug.pt")
    main_pretrain_mae.run(["--cfg", cfg, "--device", "cpu", "--model_load_path", latest,
                           "--max_epochs", "3"])
    phase2 = soak_resume.parse_steps(str(tmp_path))[len(phase1):]
    log = "".join(p.read_text() for p in (tmp_path / "log").glob("log_rank0_*.txt"))
    epoch = soak_resume.checkpoint_epoch(latest)
    assert epoch == ckpt.load_checkpoint(latest)["epoch"] == 2  # the resume's own save
    # the clean first run "killed" at its last step: not mid-epoch, as failures() says
    result = soak_resume.stitch(phase1, phase2, phase1[-1], "Resumed from" in log,
                                checkpoint_epoch=1, kill_after_epoch=1, steps_per_epoch=2,
                                scans=6)
    assert result["resume_epoch_restarted"] == 2 and result["steps_phase2"] == 4
    assert result["resumed_log_line"] and result["losses_phase1"] == [
        round(r[2], 5) for r in phase1]
    # the tiny run's four steps are too few for the continuity level
    assert [b for b in soak_resume.failures(result) if "continuous" not in b] == [
        "the kill fell after step 2 of epoch 2, not mid-epoch 2 (of 2 steps)"]
    mid = dict(result, killed_at={"epoch": 2, "step_in_epoch": 1})
    assert not [b for b in soak_resume.failures(mid) if "continuous" not in b]
    jumped = dict(mid, post_resume_loss=result["init_loss"] + 1.0)
    assert soak_resume.failures(jumped)
    # the trainer's epoch lines: steps, placeholders and (none on the CPU) launches
    assert soak_resume.parse_epochs(str(tmp_path)) == [
        {"epoch": e, "steps": 2, "placeholders": 0, "launches": {}} for e in (1, 2, 2, 3)]


def _log_rows(epochs: int, last_steps: int, per_epoch: int = 16) -> list:
    """The (epoch, step, loss) rows of ``epochs`` - 1 whole epochs of
    ``per_epoch`` steps and ``last_steps`` of the next, as logged (from 1)."""
    return [(e, s, 0.5) for e in range(1, epochs + 1)
            for s in range(1, (per_epoch if e < epochs else last_steps) + 1)]


@pytest.mark.parametrize("epochs, last_steps, want", [
    (2, 16, "wait"),   # epoch K = 2 done; K + 1 not begun
    (3, 4, "wait"),    # K + 1 has logged fewer than KILL_MIN_STEPS
    (3, 5, "kill"),
    (3, 8, "kill"),    # the first group of LOSS_FLUSH losses
    (3, 15, "kill"),
    (3, 16, "missed"),  # K + 1's last step: the kill would land at its end
    (4, 1, "missed"),  # a later epoch
    (4, 8, "missed"),
])
def test_soak_kill_decision_on_synthetic_logs(epochs, last_steps, want):
    rows = _log_rows(epochs, last_steps)
    assert soak_resume.kill_decision(rows, 2, 16) == want
    assert soak_resume.KILL_MIN_STEPS == 5


@pytest.mark.parametrize("names, want", [
    (["latest_mae.ckpt"], "latest_mae.ckpt"),
    (["latest_mae.ckpt", "latest_mae.ckpt.tmp"], "latest_mae.ckpt"),  # a torn write beside
    (["latest_mae.ckpt.tmp", "latest_mae.ckpt"], "latest_mae.ckpt"),  # in either order
    (["latest_mae.ckpt.tmp"], None),  # the first write still under way: none yet
    ([], None),
])
def test_soak_never_chooses_a_torn_checkpoint(names, want):
    assert soak_resume.complete_checkpoint([f"/out/model_saved/{n}" for n in names]) == (
        None if want is None else f"/out/model_saved/{want}")


def test_soak_fails_a_resume_at_another_epoch_and_a_kill_outside_epoch_k_plus_1():
    phase1 = _log_rows(3, 8)
    phase2 = [(2, s, 0.5) for s in range(1, 17)] + [(3, s, 0.5) for s in range(1, 17)]
    good = soak_resume.stitch(phase1, phase2, phase1[-1], True, checkpoint_epoch=1,
                              kill_after_epoch=2, steps_per_epoch=16)
    assert soak_resume.failures(good) == []
    assert soak_resume.failures(dict(good, checkpoint_epoch=0)) == [
        "the resume restarted at epoch 2, not at 1, the chosen checkpoint's (epoch 0 from 0)"]
    late = soak_resume.stitch(phase1 + [(4, 1, 0.5)], phase2, (4, 1, 0.5), True,
                              checkpoint_epoch=1, kill_after_epoch=2, steps_per_epoch=16)
    assert soak_resume.failures(late) == [
        "the kill fell after step 1 of epoch 4, not mid-epoch 3 (of 16 steps)"]
    assert soak_resume.failures(dict(good, resumed_log_line=False)) == [
        "the resume did not log 'Resumed from'"]


def test_soak_parses_the_epoch_lines_launches(tmp_path):
    (tmp_path / "log").mkdir()
    (tmp_path / "log" / "log_rank0_x.txt").write_text(
        "[t x] (mae_engine.py 1): INFO Epoch 1 done in 3.1s  train loss 0.4000  iter 0.080s "
        "(data 0.001s)  steps 16  placeholders 0  launches flash_attention_fwd 128, "
        "flash_attention_bwd 128\n"
        "[t x] (mae_engine.py 1): INFO Epoch 2 done in 1.3s  train loss 0.3000  iter 0.080s "
        "(data 0.001s)  steps 16  placeholders 1  launches none\n")
    assert soak_resume.parse_epochs(str(tmp_path)) == [
        {"epoch": 1, "steps": 16, "placeholders": 0,
         "launches": {"flash_attention_fwd": 128, "flash_attention_bwd": 128}},
        {"epoch": 2, "steps": 16, "placeholders": 1, "launches": {}}]
