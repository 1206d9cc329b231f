"""PyTorch port: the host data path held against the JAX package.

* The port's native decoder (built into ``build/native/``) gives the bytes
  of JAX ``load_and_preprocess_native`` on the same file, for the windowed,
  hu16 and hu8 wires and for scaled, flipped and permuted affines.
* ``DiskCache`` keys equal JAX's for every wire and both backends; the port
  serves a per-volume ``.npy`` cache and a packed cache that the JAX package
  wrote, byte for byte, and JAX serves the port's packed cache (the scans
  are deleted first, so every read is a cache hit).
* The ``"training"`` and ``"hu16"`` orders of ``DevicePreprocessor`` on CPU
  tensors match JAX ``DevicePreprocessor`` of the same order (<= 1e-4 abs;
  hu16-encoded within 1 step), also at head CT's 0.5 x 0.5 x 1.0 mm; the
  ``device`` cache backend matches the native one within the JAX tests'
  native-vs-scipy limits (``tests/test_native_loader.py:37-38``: max <
  2e-2, mean < 1e-4), and within 1 hu16 step on a scan with an air border.
* A fault of the JAX reference (ROADMAP.md C.6): at 0.5 x 0.5 x 1.0 mm the
  JAX package's native chain is its scipy chain with the spline prefilter
  left on the z axis, which it does not zoom (<= 1e-3 abs), and is not the
  scipy chain itself (max >= 0.5); the port's native output is the JAX
  package's byte for byte there too.
* A non-cubic ROI takes the scipy chain, as JAX's does (ROADMAP C.11):
  the tensor and the cache key are JAX's.
* A native decoder that cannot be built stops the loaders when they are
  made, for both cache backends: it is never shielded into placeholders.
* ``ThreadedLoader`` yields the JAX loader's batches in its order at world 1
  and at each rank of world 2, a corrupt scan as the placeholder, over two
  epochs with the lookahead; ``close()`` leaves no live thread.
* The ``csv`` manifest reader gives the rows ``pandas.read_csv`` gives.

The JAX package builds its decoder in place (``g++ -o
native/libheadct_native.so``) from every process that imports its tests,
so under ``pytest -n`` a worker can load the library while another writes
it, and its loader then keeps the failure for the life of the process.
``_heal_jax_native`` runs at import, under a file lock in ``build/``:
it waits for the library to settle, clears that cached failure and loads
it again, a few times. It builds nothing itself (a rebuild would write the
file in place under the JAX tests' workers, which take no lock). Every
test here fails, and none skips, when the library does not load.
"""

import fcntl
import os
import threading
import time
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
from scipy import ndimage

from headct_foundation_tpu.data import datasets as jax_ds
from headct_foundation_tpu.data import native_loader as jax_native
from headct_foundation_tpu.data.device_preprocess import DevicePreprocessor as JaxPrep
from headct_foundation_tpu.data.transforms import hu8_encode as jax_hu8_encode
from headct_foundation_tpu.data.transforms import hu16_decode as jax_hu16_decode
from headct_foundation_tpu_torch.config import default_config
from headct_foundation_tpu_torch.data import datasets, native_loader, pipeline
from headct_foundation_tpu_torch.data.device_preprocess import DevicePreprocessor
from headct_foundation_tpu_torch.data.nifti import save_nifti
from headct_foundation_tpu_torch.data.transforms import hu16_encode

REPO = Path(__file__).resolve().parent.parent
SETTLE_S = 2.0  # seconds the JAX library must stay unchanged before it is loaded
SETTLE_TIMEOUT_S = 600.0


def _stat(path: Path):
    try:
        st = path.stat()
    except FileNotFoundError:
        return None
    return st.st_ino, st.st_size, st.st_mtime_ns


def _settle(path: Path) -> None:
    """Wait until ``path`` (present or not) has stayed as it is for
    ``SETTLE_S``: no other process is then writing it."""
    deadline = time.monotonic() + SETTLE_TIMEOUT_S
    last = _stat(path)
    while time.monotonic() < deadline:
        time.sleep(SETTLE_S)
        now = _stat(path)
        if now == last:
            return
        last = now
    raise RuntimeError(f"{path} kept changing for {SETTLE_TIMEOUT_S:.0f} s")


def _heal_jax_native() -> str:
    """Load the JAX package's native library in this process, past a load
    that met a half-written file: wait for the file to settle, forget the
    cached failure and load again (a few times). Builds nothing itself.
    Returns "" or why the library cannot be loaded."""
    if jax_native._LIB is not None:
        return ""
    lock = REPO / "build" / "jax_native.lock"
    lock.parent.mkdir(parents=True, exist_ok=True)
    with open(lock, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            for _ in range(3):
                _settle(Path(jax_native._SO))
                with jax_native._LIB_LOCK:
                    jax_native._LIB, jax_native._LIB_FAILED = None, False
                if jax_native.get_lib() is not None:
                    return ""
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)
    return (f"the JAX native library {jax_native._SO} does not load after it settled "
            f"(3 tries): see the JAX package's native_loader")


JAX_NATIVE_ERROR = _heal_jax_native()


@pytest.fixture(autouse=True)
def jax_native_library():
    """Fail, never skip, without the JAX package's decoder."""
    if JAX_NATIVE_ERROR:
        pytest.fail(JAX_NATIVE_ERROR)


ROI = (24, 24, 24)
FLIP_PERMUTE = np.array([[0.0, -1.0, 0.0, 0.0], [1.5, 0.0, 0.0, 0.0],
                         [0.0, 0.0, 2.0, 0.0], [0.0, 0.0, 0.0, 1.0]])
FINE = np.diag([0.5, 0.5, 1.0, 1.0])  # head CT: 0.5 mm in-plane, 1 mm slices
AFFINES = [pytest.param(np.diag([2.0, 1.5, 2.5, 1.0]), id="scaled"),
           pytest.param(FLIP_PERMUTE, id="flip-permute"),
           pytest.param(FINE, id="fine"),
           pytest.param(np.eye(4), id="identity")]


def _scan(tmp_path, affine, name="s.nii.gz", seed=0, shape=(40, 44, 36)):
    """A smooth volume in [-1000, 2000] HU (the JAX native tests' scan)."""
    rng = np.random.RandomState(seed)
    base = ndimage.gaussian_filter(rng.rand(*shape), 2)
    vol = (base / base.max() * 3000 - 1000).astype(np.float32)
    p = str(tmp_path / name)
    save_nifti(p, vol, affine)
    return p


@pytest.mark.parametrize("affine", AFFINES)
def test_native_output_is_byte_identical_to_jax(tmp_path, affine):
    p = _scan(tmp_path, affine)
    for wire, chans, order in (("windowed", 3, 0), ("windowed", 1, 0), ("windowed", 3, 1),
                               ("hu16", 3, 0)):
        got = native_loader.load_and_preprocess_native(p, ROI, chans, order=order, wire=wire)
        want = jax_native.load_and_preprocess_native(p, ROI, chans, order=order, wire=wire)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes(), (wire, chans, order)
    # hu8: the JAX cache transcodes the native hu16 tensor (data/datasets.py:383-396)
    got = native_loader.load_and_preprocess_native(p, ROI, 3, wire="hu8")
    want = jax_hu8_encode(jax_hu16_decode(jax_native.load_and_preprocess_native(p, ROI, 3,
                                                                                wire="hu16")))
    assert got.dtype == np.uint8 and got.tobytes() == want.tobytes()
    vol, aff = native_loader.decode_native(p)
    want_vol, want_aff = jax_native.decode_native(p)
    assert vol.tobytes() == want_vol.tobytes() and np.array_equal(aff, want_aff)
    # the port builds its own library, never the one in native/
    assert native_loader.library_path().parent.parent == native_loader.BUILD_ROOT
    with pytest.raises(RuntimeError, match="cannot open"):
        native_loader.load_and_preprocess_native(str(tmp_path / "missing.nii.gz"), ROI, 3)


@pytest.mark.parametrize("backend_env", [{}, {"HEADCT_DEVICE_CACHE": "1"}],
                         ids=["native", "device"])
def test_cache_keys_equal_jax(tmp_path, monkeypatch, backend_env):
    for k, v in backend_env.items():
        monkeypatch.setenv(k, v)
    for wire in ("windowed", "hu16", "hu8"):
        for roi, chans in ((ROI, 3), ((96, 96, 96), 1)):
            port = datasets.DiskCache(str(tmp_path / "c"), roi, chans, wire=wire)
            jax_cache = jax_ds.DiskCache(str(tmp_path / "c"), roi, chans, wire=wire)
            assert port.key("/data/a.nii.gz") == jax_cache._key("/data/a.nii.gz"), wire
    monkeypatch.setenv("HEADCT_NATIVE", "0")  # the scipy chain: JAX's "python" key
    monkeypatch.delenv("HEADCT_DEVICE_CACHE", raising=False)
    port = datasets.DiskCache(str(tmp_path / "c"), ROI, 3)
    assert port.backend == "python"
    assert port.key("/data/a.nii.gz") == jax_ds.DiskCache(str(tmp_path / "c"), ROI,
                                                           3)._key("/data/a.nii.gz")


@pytest.mark.parametrize("wire", ["windowed", "hu16"])
def test_a_non_cubic_roi_takes_the_scipy_chain_as_jax(tmp_path, wire):
    """ROADMAP C.11: JAX's ``DiskCache`` takes the native decoder for a
    cubic ROI only (``datasets.py:318``) and the scipy chain for any other;
    the port's took the native chain, which raises on a non-cubic ROI. A
    ``PretrainDataset`` at ``MODEL.ROI [24, 24, 16]`` gives JAX's tensor
    byte for byte under JAX's cache key, with no placeholder."""
    p = _scan(tmp_path, np.diag([2.0, 1.5, 2.5, 1.0]))
    (tmp_path / "m.csv").write_text(f"img_path\n{p}\n")
    roi = (24, 24, 16)
    cfg = default_config()
    cfg.merge_from_list(["MODEL.ROI", list(roi), "MODEL.IN_CHANS", 3,
                         "DATA.WIRE_FORMAT", wire])
    ds = datasets.PretrainDataset(cfg, str(tmp_path / "m.csv"), cache_dir=str(tmp_path / "p"))
    vol, _ = ds[0]
    jax_cache = jax_ds.DiskCache(str(tmp_path / "j"), roi, 3, wire=wire)
    want = jax_cache.load(p)
    assert ds.placeholders == 0
    assert vol.dtype == want.dtype and vol.shape == want.shape
    np.testing.assert_array_equal(vol, want)
    assert ds.cache.key(p) == jax_cache._key(p)


@pytest.mark.parametrize("wire", ["windowed", "hu16", "hu8"])
def test_caches_are_shared_with_jax(tmp_path, wire):
    scans = [_scan(tmp_path, np.diag([2.0, 1.5, 2.5, 1.0]), f"s{i}.nii.gz", seed=i)
             for i in range(3)]
    shape = (1,) + ROI if wire != "windowed" else (3,) + ROI
    dtype = {"windowed": np.float16, "hu16": np.int16, "hu8": np.uint8}[wire]
    # per-volume .npy written by JAX; packed shards written by each package
    jax_cache = jax_ds.DiskCache(str(tmp_path / "npy"), ROI, 3, wire=wire)
    want = {p: jax_cache.load(p) for p in scans}
    with jax_ds.PackedCacheWriter(str(tmp_path / "jax_packed"), shape, volumes_per_shard=2,
                                  dtype=dtype) as w:
        for p in scans:
            w.add(jax_cache._key(p), want[p])
    port_cache = datasets.DiskCache(str(tmp_path / "port_packed"), ROI, 3, wire=wire)
    with datasets.PackedCacheWriter(str(tmp_path / "port_packed"), shape, volumes_per_shard=2,
                                    dtype=dtype) as w:
        for p in scans:
            w.add(port_cache.key(p), want[p])
    for p in scans:
        os.remove(p)  # every read below must hit a cache
    for d in ("npy", "jax_packed"):
        port = datasets.DiskCache(str(tmp_path / d), ROI, 3, wire=wire)
        for p in scans:
            got = port.load(p)
            assert got.dtype == want[p].dtype and got.tobytes() == want[p].tobytes(), d
    jax_reader = jax_ds.DiskCache(str(tmp_path / "port_packed"), ROI, 3, wire=wire)
    for p in scans:
        assert jax_reader.load(p).tobytes() == want[p].tobytes()


@pytest.mark.parametrize("affine", AFFINES[:3])
def test_training_and_hu16_orders_match_jax(tmp_path, affine):
    p = _scan(tmp_path, affine)
    for chans in (3, 1):
        got = DevicePreprocessor(ROI, chans, "cpu", order="training",
                                 decoder=native_loader.decode_native)(p)
        want = np.asarray(JaxPrep(ROI, chans, order="training")(p))
        assert got.shape == (chans,) + ROI
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    got = DevicePreprocessor(ROI, 3, "cpu", order="hu16")(p)
    want = np.asarray(JaxPrep(ROI, 3, order="hu16")(p))
    assert got.shape == (1,) + ROI
    np.testing.assert_allclose(got.numpy(), want, atol=1e-2, rtol=1e-5)  # HU, float32 sums
    steps = np.abs(hu16_encode(got.numpy()).astype(np.int32) - hu16_encode(want).astype(np.int32))
    assert steps.max() <= 1


def test_device_backend_matches_native(tmp_path, monkeypatch):
    """The device cache backend (on the CPU here) against the native one,
    within the JAX tests' native-vs-scipy limits on the windowed wire, and
    hu16 within 1 step. The native chain's spline prefilter starts its
    recursion differently from scipy's at the array's border
    (tests/test_native_loader.py:34-36), which moves voxels there when the
    border is not constant: the windowed limits hold on such a scan too; the
    1-step hu16 limit is held on a scan with an air border, as head CT has."""
    smooth = _scan(tmp_path, np.diag([2.0, 1.5, 2.5, 1.0]))
    rng = np.random.RandomState(0)
    base = ndimage.gaussian_filter(rng.rand(40, 44, 36), 2)
    vol = np.full((40, 44, 36), -1000.0, np.float32)
    vol[6:-6, 6:-6, 6:-6] = (base / base.max() * 3000 - 1000)[6:-6, 6:-6, 6:-6]
    air = str(tmp_path / "air.nii.gz")
    save_nifti(air, vol, np.diag([2.0, 1.5, 2.5, 1.0]))
    wires = {smooth: ("windowed",), air: ("windowed", "hu16")}
    native = {(p, w): datasets.DiskCache(None, ROI, 3, wire=w).load(p)
              for p in wires for w in wires[p]}
    monkeypatch.setenv("HEADCT_DEVICE_CACHE", "1")
    for (p, w), want in native.items():
        got = datasets.DiskCache(None, ROI, 3, wire=w, device="cpu").load(p)
        assert got.dtype == want.dtype and got.shape == want.shape
        if w == "windowed":
            d = np.abs(got.astype(np.float32) - want.astype(np.float32))
            assert d.max() < 2e-2 and d.mean() < 1e-4, (p, d.max(), d.mean())
        else:
            assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


def _head(tmp_path, affine, name="head.nii.gz", seed=0, shape=(64, 64, 24)):
    """A small head: air, a skull shell and noisy brain that reach the z
    border, as a head cut by the scan's slab does."""
    rng = np.random.RandomState(seed)
    grid = np.ogrid[: shape[0], : shape[1], : shape[2]]
    radii = np.array(shape) * np.array([0.38, 0.42, 0.6])
    d = sum(((g - s / 2) / r) ** 2 for g, s, r in zip(grid, shape, radii))
    vol = np.full(shape, -1000.0, np.float32)
    vol[d < 1.0] = 1000.0
    brain = d < 0.8
    vol[brain] = 35.0 + 8.0 * rng.randn(int(brain.sum()))
    p = str(tmp_path / name)
    save_nifti(p, np.round(vol).astype(np.int16), affine, dtype=np.int16)
    return p


def test_jax_native_keeps_the_prefilter_on_an_unzoomed_axis(tmp_path):
    """ROADMAP.md C.6. ``native/headct_native.cpp zoom_cubic`` prefilters
    all three axes but interpolates only those whose size changes, so at 0.5
    x 0.5 x 1.0 mm the z axis stays B-spline coefficients instead of
    samples. Limits: the scipy chain with ``spline_filter1d`` on z left in
    within 1e-3 abs of the native chain (float32 storage against float64);
    the plain scipy chain off by >= 0.5 (it is 0.96 here)."""
    from headct_foundation_tpu.data import transforms as jt

    p = _head(tmp_path, FINE)
    nat = jax_native.load_and_preprocess_native(p, ROI, 3).astype(np.float32)
    port = native_loader.load_and_preprocess_native(p, ROI, 3)
    assert port.tobytes() == jax_native.load_and_preprocess_native(p, ROI, 3).tobytes()
    img = jt.load_nifti(p)
    vol, affine = jt.orientation_ras(np.asarray(img.data, np.float32), img.affine)
    resampled = jt.resample_to_spacing(vol, np.linalg.norm(affine[:3, :3], axis=0))

    def chain(x):
        cropped, _, _ = jt.crop_foreground(x)
        return jt.area_resize(jt.window_stack(cropped, 3), ROI).astype(np.float16)

    kept = ndimage.spline_filter1d(resampled, 3, axis=2, mode="mirror").astype(np.float32)
    assert np.abs(chain(kept).astype(np.float32) - nat).max() <= 1e-3
    assert np.abs(chain(resampled).astype(np.float32) - nat).max() >= 0.5
    np.testing.assert_array_equal(chain(resampled), jt.load_and_preprocess(p, ROI, 3))


@pytest.mark.parametrize("backend_env", [{}, {"HEADCT_DEVICE_CACHE": "1"}],
                         ids=["native", "device"])
def test_a_decoder_that_cannot_be_built_stops_the_loaders(tmp_path, monkeypatch, backend_env):
    for k, v in backend_env.items():
        monkeypatch.setenv(k, v)
    p = _scan(tmp_path, np.eye(4))
    (tmp_path / "m.csv").write_text(f"img_path\n{p}\n")
    cfg = default_config()
    cfg.merge_from_list(["MODEL.ROI", list(ROI), "DATA.BATCH_SIZE", 1,
                         "DATA.CACHE_DIR", str(tmp_path / "cache"),
                         "DATA.TRAIN_CSV_PATH", str(tmp_path / "m.csv"),
                         "DATA.VAL_CSV_PATH", str(tmp_path / "m.csv"),
                         "DATA.TEST_CSV_PATH", str(tmp_path / "m.csv")])
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "library_path", lambda: tmp_path / "b" / "lib.so")
    monkeypatch.setattr(native_loader.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="needs g\\+\\+"):
        datasets.get_pretrain_dataloaders(cfg, device="cpu")
    assert not (tmp_path / "cache").exists() or not os.listdir(tmp_path / "cache")


def _loader_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("headct-torch-loader") and t.is_alive()]


@pytest.mark.parametrize("world", [1, 2])
def test_threaded_loader_yields_the_jax_batches(tmp_path, world):
    scans = [_scan(tmp_path, np.diag([2.0, 1.5, 2.5, 1.0]), f"s{i}.nii.gz", seed=i)
             for i in range(5)]
    bad = tmp_path / "corrupt.nii.gz"
    bad.write_bytes(b"not a nifti" * 50)
    rows = scans[:2] + [str(bad)] + scans[2:]
    manifest = tmp_path / "train.csv"
    pd.DataFrame({"img_path": rows}).to_csv(manifest, index=False)
    cfg = default_config()
    cfg.merge_from_list(["MODEL.ROI", list(ROI), "MODEL.IN_CHANS", 3, "DATA.BATCH_SIZE", 2,
                         "DATA.NUM_WORKERS", 3, "DATA.CACHE_DIR", str(tmp_path / "port"),
                         "DATA.TRAIN_CSV_PATH", str(manifest), "DATA.VAL_CSV_PATH", str(manifest),
                         "DATA.TEST_CSV_PATH", str(manifest)])
    jcfg = cfg.clone()
    jcfg.DATA.CACHE_DIR = str(tmp_path / "jax")
    for rank in range(world):
        loaders = datasets.get_pretrain_dataloaders(cfg, rank, world)
        train = loaders[0]
        if world == 1:
            want_loader = jax_ds.get_pretrain_dataloaders(jcfg)[0]
        else:
            ds = jax_ds.PretrainDataset(jcfg, str(manifest), cache_dir=jcfg.DATA.CACHE_DIR)
            want_loader = jax_ds.ThreadedLoader(
                ds, 2, lambda epoch: jax_ds.distributed_indices(len(rows), rank, world, False),
                num_workers=3)
        assert len(train) == len(want_loader) == -(-(-(-len(rows) // world)) // 2)
        for epoch in range(2):
            train.set_epoch(epoch)
            want_loader.set_epoch(epoch)
            got, want = list(train), list(want_loader)
            assert len(got) == len(want)
            for (gv, gp), (wv, wp) in zip(got, want):
                assert gp == wp and gv.dtype == wv.dtype and gv.tobytes() == wv.tobytes()
        flat = [p for _, paths in got for p in paths]
        if str(bad) in flat:  # the corrupt scan is the placeholder
            vols = np.concatenate([v for v, _ in got])
            assert not vols[flat.index(str(bad))].any()
        for loader in list(loaders) + [want_loader]:
            loader.close()
    assert not _loader_threads()


def test_loader_close_stops_an_abandoned_epoch(tmp_path):
    scans = [_scan(tmp_path, np.eye(4), f"s{i}.nii.gz", seed=i, shape=(20, 20, 20))
             for i in range(6)]
    manifest = tmp_path / "m.csv"
    pd.DataFrame({"img_path": scans}).to_csv(manifest, index=False)
    cfg = default_config()
    cfg.merge_from_list(["MODEL.ROI", list(ROI), "DATA.BATCH_SIZE", 1, "DATA.CACHE_DIR", "",
                         "DATA.TRAIN_CSV_PATH", str(manifest), "DATA.VAL_CSV_PATH", str(manifest),
                         "DATA.TEST_CSV_PATH", str(manifest)])
    loader = datasets.get_pretrain_dataloaders(cfg)[0]
    loader.prefetch = 1
    loader.set_epoch(0)
    it = iter(loader)
    next(it)  # the producer now blocks on its full queue
    loader.close()
    assert not _loader_threads()
    it.close()


def test_prefetcher_passes_cpu_batches_through():
    from headct_foundation_tpu_torch.engines.mae_engine import to_device_batch

    batches = [(np.full((2, 1, 3, 3, 3), i, np.int16), [f"p{i}"]) for i in range(3)]
    got = list(pipeline.DevicePrefetcher(batches, torch.device("cpu")))
    assert all(g is b for g, b in zip(got, batches))
    on_device = torch.zeros((2, 3, 4, 4, 4))
    assert to_device_batch(on_device, torch.device("cpu")) is on_device  # no copy
    assert to_device_batch(batches[0][0], torch.device("cpu")).dtype == torch.int16
    with pytest.raises(ValueError, match="CUDA"):
        pipeline.measure_h2d_mbps(torch.device("cpu"))
    cfg = default_config()
    cfg.DATA.WIRE_FORMAT = "auto"
    assert pipeline.resolve_wire_format(cfg, torch.device("cpu"), probe_mbps=100.0) == "hu8"
    assert pipeline.resolve_wire_format(cfg, torch.device("cpu"), probe_mbps=2000.0) == "hu16"


def test_manifest_reader_gives_the_pandas_rows(tmp_path):
    path = tmp_path / "m.csv"
    path.write_bytes("﻿img_path,ICH,site\n/a/x.nii.gz,0,nyu\n\n\"/b/y, z.nii.gz\",1,"
                     "\"cq500\"\n/c/w.nii.gz,1,rsna\n".encode("utf-8"))
    want = pd.read_csv(path).astype(str).to_dict("records")
    assert datasets.read_manifest(str(path)) == want
