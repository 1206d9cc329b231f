"""PyTorch port: the study tools' data, configurations and summaries, and
the last helpers, against the JAX package and the JAX tools on the CPU.

* Every pool generator of ``tools/{trajectory,transfer_study,
  wire_equivalence}.py`` bit-equal to the JAX tool's, for two seeds, at
  small sizes; the loaders' batches (their index draws) equal over two
  epochs, the device-pool loaders' on the CPU included.
* The configuration builders value for value: ``_flagship`` of each engine
  with the pretrain mains' effective-LR rule (JAX ``tools/trajectory.py:485-496``),
  ``dino_semantics.tiny_cfg`` and ``transfer_study._cfgs`` at both scales.
* ``class_structure``, ``retrieval_scores`` and the trajectory summary's
  fields equal on the same inputs (the port adds ``device``, ``launches``
  and ``png``).
* ``datafold_read``, ``hu16_window_stack``, ``hu8_window_stack``,
  ``loading_transforms`` and ``unpatchify3d`` equal to the JAX package's.
* ``bench_int8``'s dynamic quantisation equal to the JAX tool's
  ``int8_dynamic`` (``tools/bench_int8.py:86-103``, written out here with
  ``jax.numpy``: it is local to the tool's ``main``) bit for bit, the
  port's product through ``torch._int_mm`` on the CPU; the int8 product
  equal to an int64 one.
"""

import json
from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tools.dino_semantics as jax_sem
import tools.trajectory as jax_traj
import tools.transfer_study as jax_transfer
import tools.wire_equivalence as jax_wire
from headct_foundation_tpu.config import default_config as jax_default_config
from headct_foundation_tpu.data import transforms as jax_transforms
from headct_foundation_tpu.models.patch_embed import unpatchify3d as jax_unpatchify3d
from headct_foundation_tpu.utils.misc import datafold_read as jax_datafold_read
from headct_foundation_tpu_torch.data import transforms
from headct_foundation_tpu_torch.data.nifti import save_nifti
from headct_foundation_tpu_torch.models.patch_embed import patchify3d, unpatchify3d
from headct_foundation_tpu_torch.ops import attention as port_attn
from headct_foundation_tpu_torch.tools import (
    bench_int8,
    dino_semantics,
    trajectory,
    transfer_study,
    wire_equivalence,
)
from headct_foundation_tpu_torch.utils.misc import datafold_read

POOLS = {
    "blob": (trajectory.make_blob_pool, jax_traj.make_blob_pool, dict()),
    "object": (trajectory.make_object_pool, jax_traj.make_object_pool, dict()),
    "class": (trajectory.make_class_pool, jax_traj.make_class_pool, dict(k_classes=3)),
    "class-shared": (trajectory.make_class_pool, jax_traj.make_class_pool,
                     dict(k_classes=3, class_seed=5)),
    "labeled": (trajectory.make_labeled_pool, jax_traj.make_labeled_pool, dict()),
    "hard-class": (transfer_study.make_hard_class_pool, jax_transfer.make_hard_class_pool,
                   dict(k_classes=3, noise=0.15, delta_deg=20.0)),
    "template-class": (transfer_study.make_template_class_pool,
                       jax_transfer.make_template_class_pool,
                       dict(k_classes=3, noise=0.15, warp=0.2)),
}


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name", sorted(POOLS))
def test_pools_are_the_jax_tools_bit_for_bit(name, seed):
    port, jax_fn, kw = POOLS[name]
    got, want = port(5, 2, 12, seed=seed, **kw), jax_fn(5, 2, 12, seed=seed, **kw)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 3])
def test_hu_pool_is_the_jax_tools_bit_for_bit(seed):
    got, want = wire_equivalence.make_hu_pool(3, 12, seed), jax_wire.make_hu_pool(3, 12, seed)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _batches(loader, epochs=2):
    out = []
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        out += [tuple(np.asarray(x) if not isinstance(x, list) else x
                      for x in (b if isinstance(b, tuple) else (b,))) for b in loader]
    return out


def _assert_same_batches(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, list):
                assert a == b
            else:
                np.testing.assert_array_equal(np.asarray(a), b)


def test_loaders_draw_the_jax_tools_batches():
    pool = jax_traj.make_blob_pool(6, 1, 8)
    labels = (np.arange(6) % 2).astype(np.int32)
    _assert_same_batches(_batches(trajectory.SyntheticLoader(pool, 3, 4, seed=2)),
                         _batches(jax_traj.SyntheticLoader(pool, 3, 4, seed=2)))
    port_dev = [(torch.as_tensor(v).numpy(), f)
                for v, f in _batches(trajectory.DevicePoolLoader(pool, 3, 4, device="cpu"))]
    _assert_same_batches(port_dev, _batches(jax_traj.SyntheticLoader(pool, 3, 4)))
    _assert_same_batches(_batches(trajectory.SyntheticLabeledLoader(pool, labels, 3, 4, 1)),
                         _batches(jax_traj.SyntheticLabeledLoader(pool, labels, 3, 4, 1)))
    dev = transfer_study.DevicePoolLabeledLoader(pool, labels, 3, 4, device="cpu")
    _assert_same_batches(_batches(dev), _batches(jax_traj.SyntheticLabeledLoader(pool, labels,
                                                                                3, 4)))
    for port_seq in (transfer_study.SequentialLabeledLoader(pool[:5], labels[:5], 2),
                     transfer_study.DeviceSequentialLabeledLoader(pool[:5], labels[:5], 2,
                                                                  device="cpu")):
        assert len(port_seq) == 3
        _assert_same_batches(_batches(port_seq, 1), _batches(
            jax_transfer.SequentialLabeledLoader(pool[:5], labels[:5], 2), 1))


def _flat(cfg, prefix=""):
    out = {}
    for k, v in cfg.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = list(v) if isinstance(v, tuple) else v
    return out


def _assert_configs_equal(got, want):
    """Every key equal, but the kernel/plain attention crossover, which is
    each package's device default where a tool leaves it: the port's
    DEFAULT_PALLAS_MIN_T (the H100's), the JAX package's 192 (the TPU's)."""
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    key = "PARALLEL.PALLAS_MIN_T"
    if got[key] != want[key]:
        assert (got.pop(key), want.pop(key)) == (
            port_attn.DEFAULT_PALLAS_MIN_T, jax_default_config().PARALLEL.PALLAS_MIN_T)
    assert {k: got[k] for k in got if got[k] != want[k]} == {}


@pytest.mark.parametrize("engine", ["mae", "dino", "downstream"])
def test_flagship_configs_and_the_lr_rule_match_the_jax_tool(engine):
    want = jax_traj._flagship(engine, str(trajectory.ROOT))
    if engine != "downstream":  # JAX tools/trajectory.py:485-496
        want.TRAIN.BASE_LR = want.TRAIN.BASE_LR * 8 / 256
    want.TRAIN.MIN_LR = want.TRAIN.BASE_LR * 1e-3
    _assert_configs_equal(trajectory.apply_lr_rule(trajectory._flagship(engine), engine, 8), want)


def test_tiny_and_transfer_configs_match_the_jax_tools():
    _assert_configs_equal(dino_semantics.tiny_cfg(), jax_sem.tiny_cfg())
    for scale in ("tiny", "flagship"):
        for classifier in ("linear", "attentive"):
            got = transfer_study._cfgs(scale, classifier)
            want = jax_transfer._cfgs(str(trajectory.ROOT), scale, classifier)
            for g, w in zip(got, want):
                _assert_configs_equal(g, w)


def test_class_structure_and_retrieval_scores_match_the_jax_tools():
    rng = np.random.RandomState(0)
    labels = (np.arange(24) % dino_semantics.K_DATA).astype(np.int32)
    feats = rng.randn(24, 16) + 0.8 * np.eye(16)[labels]
    assert dino_semantics.class_structure(feats, labels) == jax_sem.class_structure(feats, labels)
    y = (np.arange(24) % 3).astype(np.int32)
    assert transfer_study.retrieval_scores(feats, y) == jax_transfer.retrieval_scores(feats, y)


def test_trajectory_summary_fields_match_the_jax_tool(tmp_path):
    from headct_foundation_tpu_torch.config import default_config

    rng = np.random.RandomState(1)
    cfg_j, cfg_p = jax_default_config(), default_config()
    for engine in ("mae", "dino", "downstream"):
        args = Namespace(engine=engine, batch=4, accum=1, epochs=2, steps_per_epoch=5,
                         sched_epochs=None, pool_style="blobs",
                         out_prefix=str(tmp_path / engine))
        rec_j, rec = jax_traj.RecordingRun(), trajectory.RecordingRun()
        for _ in range(10):
            d = {"Training Loss": float(rng.rand() + 10.5), "Training lr": float(rng.rand())}
            rec_j.log(d)
            rec.log(d)
        if engine == "downstream":
            rec_j.epoch_aurocs = rec.epoch_aurocs = [0.61234, 0.9]
        want = jax_traj._write_artifacts(args, rec_j, cfg_j, 3.25, str(tmp_path))[0]
        args.out_prefix = str(tmp_path / f"port_{engine}")
        got, losses, head, tail = trajectory._write_artifacts(args, rec, cfg_p, 3.25,
                                                              torch.device("cpu"))
        assert set(got) == set(want) | {"device", "launches", "png"}
        assert {k: got[k] for k in want if k != "backend"} == {
            k: v for k, v in want.items() if k != "backend"}
        assert (head, tail, losses) == (got["head_mean"], got["tail_mean"], rec.losses)
        with open(args.out_prefix + ".json") as f:
            assert json.load(f)["steps"] == 10


def test_datafold_read_matches_the_jax_package(tmp_path):
    records = {"training": [
        {"image": "a.nii.gz", "label": ["l1.nii.gz", "l2.nii.gz"], "fold": 0},
        {"image": "b.nii.gz", "label": "", "fold": 1},
        {"image": "c.nii.gz", "fold": 2}]}
    path = tmp_path / "datalist.json"
    path.write_text(json.dumps(records))
    for fold in (0, 1):
        assert datafold_read(str(path), "/data", fold) == jax_datafold_read(str(path), "/data",
                                                                            fold)
    tr, val = datafold_read(str(path), "/data", 1)
    assert [d["image"] for d in val] == ["/data/b.nii.gz"] and val[0]["label"] == ""


@pytest.mark.parametrize("in_channels", [1, 3])
def test_window_stacks_match_the_jax_package(in_channels):
    hu = np.random.RandomState(4).uniform(-1100, 2100, (1, 6, 5, 4)).astype(np.float32)
    for port, jax_fn, enc in ((transforms.hu16_window_stack, jax_transforms.hu16_window_stack,
                               transforms.hu16_encode),
                              (transforms.hu8_window_stack, jax_transforms.hu8_window_stack,
                               transforms.hu8_encode)):
        q = enc(hu)
        got, want = port(q, in_channels), jax_fn(q, in_channels)
        assert got.shape == (in_channels, 6, 5, 4) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_loading_transforms_matches_the_jax_package(tmp_path):
    vol = np.random.RandomState(5).uniform(-1000, 1500, (20, 18, 14)).astype(np.float32)
    path = str(tmp_path / "s.nii.gz")
    save_nifti(path, vol, np.diag([1.5, 1.5, 2.0, 1.0]))
    got = transforms.loading_transforms((8, 8, 8), 3)(path)
    want = jax_transforms.loading_transforms((8, 8, 8), 3)(path)
    assert got.dtype == np.float16 and got.shape == (3, 8, 8, 8)
    np.testing.assert_array_equal(got, want)


def test_unpatchify3d_matches_the_jax_package():
    x = np.random.RandomState(6).randn(2, 3, 8, 12, 4).astype(np.float32)
    patches = patchify3d(torch.from_numpy(x), (4, 4, 2))
    got = unpatchify3d(patches, (4, 4, 2), (3, 8, 12, 4))
    np.testing.assert_array_equal(got.numpy(), x)
    want = jax_unpatchify3d(jnp.asarray(patches.numpy()), (4, 4, 2), (3, 8, 12, 4))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jax_int8_dynamic(a, b):
    """JAX ``tools/bench_int8.py:86-103`` as written there."""
    sa = jnp.max(jnp.abs(a)).astype(jnp.float32) / 127.0
    sb = jnp.max(jnp.abs(b)).astype(jnp.float32) / 127.0
    qa = jnp.clip(jnp.round(a.astype(jnp.float32) / sa), -127, 127).astype(jnp.int8)
    qb = jnp.clip(jnp.round(b.astype(jnp.float32) / sb), -127, 127).astype(jnp.int8)
    acc = jax.lax.dot_general(qa, qb, (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    return (acc.astype(jnp.float32) * (sa * sb)).astype(jnp.bfloat16)


def test_int8_dynamic_matches_the_jax_tools_formula():
    rng = np.random.RandomState(7)
    a = torch.from_numpy(rng.randn(32, 64).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.randn(48, 64).astype(np.float32)).bfloat16()  # [N, K]
    got = bench_int8.int8_dynamic(a, w)
    want = _jax_int8_dynamic(jnp.asarray(a.float().numpy(), jnp.bfloat16),
                             jnp.asarray(w.float().numpy().T, jnp.bfloat16))
    assert got.dtype == torch.bfloat16 and got.shape == (32, 48)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    a8 = torch.from_numpy(rng.randint(-127, 127, (32, 64)).astype(np.int8))
    w8 = torch.from_numpy(rng.randint(-127, 127, (48, 64)).astype(np.int8))
    assert bench_int8.check_exact(a8, w8) == 0
    assert bench_int8.shapes()[0] == ("mae_mlp", (32 * 513, 768), (768, 3072))
