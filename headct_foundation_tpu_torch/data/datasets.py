"""Manifests, the disk cache of preprocessed scans and the threaded loader.

Port of the JAX package's ``data/datasets.py`` for pretraining and the
downstream tasks (reference: src/data/datasets.py):

* ``read_manifest``: a CSV manifest's rows with the standard ``csv``
  module (the port does not need pandas); ``read_table`` its header and
  rows, for the labels that the JAX package takes by column position.
* ``CLASS_MAPPINGS`` / ``get_class_mapping`` (JAX ``:41-59``): each dataset's
  label names and their column positions.
* ``PackedShardReader`` / ``PackedCacheWriter`` (JAX ``:76``, ``:154``):
  the packed cache, volumes stored back to back in ``pack_*.bin`` shards
  indexed by ``pack_index*.json``, in the JAX package's file format.
* ``DiskCache`` (``:258``): one preprocessed tensor per scan, kept as
  ``<key>.npy`` or in a packed shard, under the JAX package's key (``:330``),
  so a cache directory that either package built serves the other. The
  backends (``cache_backend``): ``native`` (the default for a cubic ROI,
  ``data/native_loader.py``), ``device`` (``HEADCT_DEVICE_CACHE=1``:
  ``DevicePreprocessor`` in the training or hu16 order on the card) and
  ``python`` (``HEADCT_NATIVE=0`` or a non-cubic ROI: the scipy chain of
  ``data/transforms.py``).
* ``PretrainDataset`` (``:432``): manifest rows -> wire tensors, a corrupt or
  unreadable scan shielded to the wire format's placeholder and counted
  (reference: datasets.py:70-96). The decoder itself is built when the
  dataset is made: its failure raises, it is never shielded.
* ``distributed_indices`` (``:506``): DistributedSampler's ``rank::world``
  split, padded to a multiple of ``world``.
* ``ThreadedLoader`` (``:555``): a persistent thread pool that collates
  batches ahead of the consumer, across batch and epoch boundaries;
  ``close`` stops and joins its threads.
* ``get_pretrain_dataloaders`` (``:758``): train, val and test loaders of
  this process's rank.
* ``FinetuneDataset`` (``:466``): manifest paths -> (wire tensor, label,
  path), placeholders counted as ``PretrainDataset`` counts them.
* ``weighted_indices`` (``:518``): each rank's 500 draws by weight with
  replacement from ``RandomState(seed + 1000 epoch + rank)``.
* ``get_finetune_dataloaders`` (``:795``): inverse-frequency weighted
  sampling, class weights ``total / max(count, 1)``; the label is the
  manifest column at ``CLASS_MAPPINGS``' position (JAX ``df.iloc[:,
  class_idx]``). ``get_fewshots_dataloaders`` (``:847``): K rows per value
  of the ``TRAIN.LABEL_NAME`` column, drawn with replacement as pandas'
  ``groupby(...).sample(n=K, replace=True, random_state=SEED)`` draws them,
  then shuffled per epoch and split ``rank::world``.

Augmentation is not applied here: it runs on the device inside the train
step (``data/augment.py``).
"""

from __future__ import annotations

import collections
import csv
import glob
import hashlib
import json
import logging
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from headct_foundation_tpu_torch.data.transforms import (
    HU8_PLACEHOLDER,
    HU16_PLACEHOLDER,
    hu8_encode,
    hu16_decode,
    hu16_encode,
    load_and_preprocess,
    load_and_preprocess_hu16,
)

_PIPELINE_VERSION = "v1"  # the JAX package's; part of every cache key
WIRE_FORMATS = ("windowed", "hu16", "hu8")
log = logging.getLogger(__name__)


# Label-column maps (reference: datasets.py:248-253): name -> column position
CLASS_MAPPINGS = {
    "nyu": {"cancer": 1, "hydrocephalus": 2, "edema": 3, "dementia": 4, "IPH": 5,
            "IVH": 6, "SDH": 7, "EDH": 8, "SAH": 9, "ICH": 10, "fracture": 11},
    "longisland": {"cancer": 1, "hydrocephalus": 2, "edema": 3, "dementia": 4,
                   "IPH": 5, "IVH": 6, "SDH": 7, "EDH": 8, "SAH": 9, "ICH": 10,
                   "fracture": 11},
    "rsna": {"epidural": 1, "intraparenchymal": 2, "intraventricular": 3,
             "subarachnoid": 4, "subdural": 5, "any": 6},
    "cq500": {"ICH": 1, "IPH": 2, "IVH": 3, "SDH": 4, "EDH": 5, "SAH": 6,
              "BleedLocation-Left": 7, "BleedLocation-Right": 8, "ChronicBleed": 9,
              "Fracture": 10, "CalvarialFracture": 11, "OtherFracture": 12,
              "MassEffect": 13, "MidlineShift": 14},
}


def get_class_mapping(dataset: str) -> Dict[str, int]:
    if dataset not in CLASS_MAPPINGS:
        raise ValueError(f"Unrecognized dataset: {dataset}")
    return CLASS_MAPPINGS[dataset]


def read_table(path: str) -> Tuple[List[str], List[List[str]]]:
    """A CSV manifest's header and rows, in file order (blank lines skipped,
    a UTF-8 byte-order mark dropped)."""
    with open(path, newline="", encoding="utf-8-sig") as f:
        rows = [r for r in csv.reader(f) if r]
    return rows[0], rows[1:]


def read_manifest(path: str) -> List[Dict[str, str]]:
    """The rows of a CSV manifest, each a dict of column -> string, in file
    order (blank lines skipped and a UTF-8 byte-order mark dropped, as
    ``pandas.read_csv`` does)."""
    with open(path, newline="", encoding="utf-8-sig") as f:
        return [dict(row) for row in csv.DictReader(f)]


class PackedShardReader:
    """Memory-mapped reader of the packed cache: each ``pack_*.bin`` shard is
    a flat [count, *shape] array whose geometry its ``pack_index*.json``
    records. Several index files merge (rank-tagged builds); a later file
    wins on a key collision."""

    def __init__(self, cache_dir: str, index_paths: Sequence[str]):
        self.cache_dir = cache_dir
        self.entries: Dict[str, Tuple[str, int]] = {}
        self._shard_meta: Dict[str, Tuple[int, Tuple[int, ...], np.dtype]] = {}
        self._shards: Dict[str, np.memmap] = {}
        self._lock = threading.Lock()
        for ip in index_paths:
            with open(ip) as f:
                idx = json.load(f)
            meta = idx["meta"]
            shape = tuple(meta["shape"])
            dtype = np.dtype(meta.get("dtype", "float16"))
            for name, count in meta["shard_counts"].items():
                self._shard_meta[name] = (int(count), shape, dtype)
            for key, ent in idx["entries"].items():
                self.entries[key] = (ent[0], int(ent[1]))

    @classmethod
    def open(cls, cache_dir: str) -> Optional["PackedShardReader"]:
        index_paths = sorted(glob.glob(os.path.join(cache_dir, "pack_index*.json")))
        return cls(cache_dir, index_paths) if index_paths else None

    def _shard(self, name: str) -> np.memmap:
        with self._lock:
            mm = self._shards.get(name)
            if mm is None:
                count, shape, dtype = self._shard_meta[name]
                mm = np.memmap(os.path.join(self.cache_dir, name), dtype=dtype, mode="r",
                               shape=(count,) + tuple(shape))
                self._shards[name] = mm
        return mm

    def get(self, key: str) -> Optional[np.ndarray]:
        ent = self.entries.get(key)
        if ent is None:
            return None
        name, slot = ent
        # read here, in the worker thread, not lazily in the collating thread
        return np.asarray(self._shard(name)[slot])

    def __len__(self) -> int:
        return len(self.entries)


class PackedCacheWriter:
    """Append-only writer of packed shards (see ``PackedShardReader``).

    Volumes stream to ``pack_<tag><i>.bin``, ``volumes_per_shard`` each;
    ``close`` writes ``pack_index<tag>.json`` atomically. Opening over an
    index of the same ``tag`` builds on it: its entries are kept, its shards
    are never reopened, and new volumes go to new shards. Rank-parallel
    builds (``tools/build_cache.py --shard``) give each process its own
    ``tag``; the reader merges their indices."""

    def __init__(self, cache_dir: str, shape: Sequence[int], volumes_per_shard: int = 512,
                 dtype=np.float16, tag: str = ""):
        os.makedirs(cache_dir, exist_ok=True)
        self.cache_dir = cache_dir
        self.shape = tuple(shape)
        self.volumes_per_shard = volumes_per_shard
        self.dtype = np.dtype(dtype)
        self.tag = tag
        self.entries: Dict[str, Tuple[str, int]] = {}
        self.shard_counts: Dict[str, int] = {}
        self._shard_idx = -1
        self._slot = volumes_per_shard  # a new shard at the first add
        self._fh = None
        self._cur_name = ""
        prev = os.path.join(cache_dir, f"pack_index{tag}.json")
        if os.path.exists(prev):
            with open(prev) as f:
                idx = json.load(f)
            meta = idx["meta"]
            if tuple(meta["shape"]) != self.shape:
                raise ValueError(f"existing packed index shape {meta['shape']} != {shape}")
            if np.dtype(meta.get("dtype", "float16")) != self.dtype:
                raise ValueError(f"existing packed index dtype {meta.get('dtype')} != "
                                 f"{self.dtype.name}")
            self.entries = {k: (v[0], int(v[1])) for k, v in idx["entries"].items()}
            self.shard_counts = dict(meta["shard_counts"])

    def _roll(self) -> None:
        if self._fh is not None:
            self._fh.close()
        while True:
            self._shard_idx += 1
            self._cur_name = f"pack_{self.tag}{self._shard_idx:05d}.bin"
            path = os.path.join(self.cache_dir, self._cur_name)
            if not os.path.exists(path):
                break
        self._fh = open(path, "xb")  # never truncate a shard a reader may map
        self._slot = 0

    def add(self, key: str, vol: np.ndarray) -> None:
        vol = np.ascontiguousarray(vol, dtype=self.dtype)
        if vol.shape != self.shape:
            raise ValueError(f"volume {vol.shape} does not fit the index's {self.shape}")
        if self._slot >= self.volumes_per_shard:
            self._roll()
        self._fh.write(vol.tobytes())
        self.entries[key] = (self._cur_name, self._slot)
        self.shard_counts[self._cur_name] = self._slot + 1
        self._slot += 1

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        index = {"meta": {"shape": list(self.shape), "dtype": self.dtype.name,
                          "shard_counts": self.shard_counts},
                 "entries": {k: [v[0], v[1]] for k, v in self.entries.items()}}
        path = os.path.join(self.cache_dir, f"pack_index{self.tag}.json")
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(index, f)
        os.replace(tmp, path)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def cache_backend(roi: Sequence[int] = (96, 96, 96)) -> str:
    """The preprocessing backend for ``roi`` (JAX ``DiskCache._backend``,
    ``:309-328``): ``device`` under ``HEADCT_DEVICE_CACHE=1``; ``native``
    for a cubic ROI unless ``HEADCT_NATIVE=0``; else ``python``, the scipy
    chain (``data/transforms.py``), which a non-cubic ROI always takes. Part
    of the cache key, as in the JAX package (the backends agree only to
    ~1e-5). A native decoder that fails to build raises when the cache is
    prepared; it never gives way to the scipy chain."""
    if os.environ.get("HEADCT_DEVICE_CACHE", "0") == "1":
        return "device"
    if os.environ.get("HEADCT_NATIVE", "1") != "0" and len(set(int(r) for r in roi)) == 1:
        return "native"
    return "python"


class DiskCache:
    """Preprocessed wire tensors keyed by sha1(path, roi, channels, pipeline
    version, backend[, wire]), the JAX package's key. Hits come from a packed
    index when the directory has one, else from ``<key>.npy``; a miss
    preprocesses the scan and writes ``<key>.npy`` through a temporary file.
    ``device`` is where the ``device`` backend runs (default ``cuda``)."""

    def __init__(self, cache_dir: Optional[str], roi: Sequence[int], in_channels: int,
                 wire: str = "windowed", device: Any = None):
        if wire not in WIRE_FORMATS:
            raise ValueError(f"wire format must be one of {WIRE_FORMATS}, got {wire!r}")
        self.roi = tuple(int(r) for r in roi)
        self.in_channels = in_channels
        self.wire = wire
        self.backend = cache_backend(self.roi)
        self.device = device
        if cache_dir:
            try:
                os.makedirs(cache_dir, exist_ok=True)
            except OSError:
                log.warning("cache directory %s is not writable; running uncached", cache_dir)
                cache_dir = None
        self.cache_dir = cache_dir
        self._device_prep = None
        self._lock = threading.Lock()
        self._packed: Any = False  # False: not probed yet; None: no packed index

    @property
    def wire_shape(self) -> Tuple[int, ...]:
        if self.wire in ("hu16", "hu8"):
            return (1, *self.roi)
        return (self.in_channels, *self.roi)

    def placeholder(self) -> np.ndarray:
        """A tensor of the wire format that windows to 0 in every channel."""
        if self.wire == "hu16":
            return np.full(self.wire_shape, HU16_PLACEHOLDER, dtype=np.int16)
        if self.wire == "hu8":
            return np.full(self.wire_shape, HU8_PLACEHOLDER, dtype=np.uint8)
        return np.zeros(self.wire_shape, dtype=np.float16)

    def key(self, path: str) -> str:
        wire_tag = "" if self.wire == "windowed" else f"|{self.wire}"
        return hashlib.sha1(f"{path}|{self.roi}|{self.in_channels}|{_PIPELINE_VERSION}"
                            f"|{self.backend}{wire_tag}".encode()).hexdigest()

    def prepare(self) -> "DiskCache":
        """Builds and loads the native library (both backends decode with it)
        and, for the ``device`` backend, its preprocessor on ``device``.
        A failure raises here: inside ``load`` the dataset would shield it
        into a placeholder for every scan."""
        if self.backend == "python":
            return self
        from headct_foundation_tpu_torch.data.native_loader import get_lib

        get_lib()
        if self.backend == "device":
            self._device_preprocessor()
        return self

    def _device_preprocessor(self):
        with self._lock:
            if self._device_prep is None:
                from headct_foundation_tpu_torch.data.device_preprocess import DevicePreprocessor
                from headct_foundation_tpu_torch.data.native_loader import decode_native
                from headct_foundation_tpu_torch.feature_extraction import resolve_device

                self._device_prep = DevicePreprocessor(
                    self.roi, self.in_channels, resolve_device(self.device),
                    order="hu16" if self.wire in ("hu16", "hu8") else "training",
                    decoder=decode_native)
            return self._device_prep

    def preprocess(self, path: str) -> np.ndarray:
        """The scan at ``path`` through this cache's backend, uncached."""
        if self.backend == "device":
            out = self._device_preprocessor()(path).cpu().numpy()
            if self.wire == "hu16":
                return hu16_encode(out)
            if self.wire == "hu8":
                return hu8_encode(out)
            return out.astype(np.float16)
        if self.backend == "python":
            if self.wire == "windowed":
                return load_and_preprocess(path, self.roi, self.in_channels)
            t = load_and_preprocess_hu16(path, self.roi)
            return hu8_encode(hu16_decode(t)) if self.wire == "hu8" else t
        from headct_foundation_tpu_torch.data.native_loader import load_and_preprocess_native

        return load_and_preprocess_native(path, self.roi, self.in_channels, wire=self.wire)

    def _packed_reader(self) -> Optional[PackedShardReader]:
        with self._lock:
            if self._packed is False:
                try:
                    self._packed = PackedShardReader.open(self.cache_dir)
                except (OSError, ValueError, KeyError) as e:
                    # a raise here would be shielded into a placeholder for
                    # every item: serve the .npy files instead, loudly
                    log.warning("packed cache index unreadable in %s (%s); using the "
                                "per-volume .npy files", self.cache_dir, e)
                    self._packed = None
            return self._packed

    def load(self, path: str) -> np.ndarray:
        if not self.cache_dir:
            return self.preprocess(path)
        key = self.key(path)
        packed = self._packed_reader()
        if packed is not None:
            vol = packed.get(key)
            if vol is not None:
                return vol
        cpath = os.path.join(self.cache_dir, key + ".npy")
        if os.path.exists(cpath):
            return np.load(cpath)
        vol = self.preprocess(path)
        tmp = cpath + f".tmp{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:  # np.save would append .npy to a bare path
            np.save(f, vol)
        os.replace(tmp, cpath)
        return vol


class PretrainDataset:
    """A manifest's ``img_path`` rows -> (wire tensor, path). A scan that
    fails to load, or loads with the wrong shape, gives the placeholder;
    ``placeholders`` counts both, ``error_count`` the failed loads (as in
    the JAX package). The cache's backend is built here, so a decoder that
    cannot be built or loaded stops the caller instead."""

    def __init__(self, config: Any, csv_file: str, cache_dir: Optional[str] = None,
                 device: Any = None):
        self.paths = [row["img_path"] for row in read_manifest(csv_file)]
        self.cache = DiskCache(cache_dir, config.MODEL.ROI, int(config.MODEL.IN_CHANS),
                               wire=str(config.DATA.WIRE_FORMAT), device=device).prepare()
        self.placeholder = self.cache.placeholder()
        self.error_count = 0
        self.placeholders = 0

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, str]:
        path = self.paths[idx]
        try:
            vol = self.cache.load(path)
        except Exception as e:  # data-level fault tolerance (reference: datasets.py:70-96)
            log.warning("error loading index %d (%s): %s", idx, path, e)
            self.error_count += 1
            self.placeholders += 1
            return self.placeholder, path
        if vol.shape != self.cache.wire_shape:
            log.warning("wrong shape in index %d (%s): %s", idx, path, vol.shape)
            self.placeholders += 1
            return self.placeholder, path
        return vol, path


class FinetuneDataset:
    """Labelled scans: ``files[i]`` -> (wire tensor, label as a 0-d int64
    array, path), the label from ``label_dict``. A scan that fails to load,
    or loads with the wrong shape, gives the placeholder and label 0, as in
    the JAX package; ``placeholders`` counts both."""

    def __init__(self, config: Any, files: Sequence[str], label_dict: Dict[str, int],
                 cache_dir: Optional[str] = None, device: Any = None):
        self.files = list(files)
        self.label_dict = label_dict
        self.cache = DiskCache(cache_dir, config.MODEL.ROI, int(config.MODEL.IN_CHANS),
                               wire=str(config.DATA.WIRE_FORMAT), device=device).prepare()
        self.placeholder = self.cache.placeholder()
        self.error_count = 0
        self.placeholders = 0

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray, str]:
        path = self.files[idx]
        try:
            vol = self.cache.load(path)
        except Exception as e:  # data-level fault tolerance (reference: datasets.py:70-96)
            log.warning("error loading index %d (%s): %s", idx, path, e)
            self.error_count += 1
            self.placeholders += 1
            return self.placeholder, np.asarray(0, np.int64), path
        if vol.shape != self.cache.wire_shape:
            log.warning("wrong shape in index %d (%s): %s", idx, path, vol.shape)
            self.placeholders += 1
            return self.placeholder, np.asarray(0, np.int64), path
        return vol, np.asarray(int(self.label_dict[path]), np.int64), path


def weighted_indices(weights: np.ndarray, num_samples: int, rank: int, seed: int = 0,
                     epoch: int = 0) -> np.ndarray:
    """DistributedWeightedRandomSampler's draws: ``num_samples`` indices with
    replacement by weight, on each rank its own (reference:
    datasets.py:298-305, 500 a rank an epoch)."""
    p = np.asarray(weights, dtype=np.float64)
    p = p / p.sum()
    rng = np.random.RandomState(seed + 1000 * epoch + rank)
    return rng.choice(len(p), size=num_samples, replace=True, p=p)


def distributed_indices(n: int, rank: int, world: int, shuffle: bool, seed: int = 0,
                        epoch: int = 0) -> np.ndarray:
    """DistributedSampler's split: pad to a multiple of ``world`` with the
    first indices again, then take ``rank::world``."""
    order = np.arange(n)
    if shuffle:
        order = np.random.RandomState(seed + epoch).permutation(n)
    total = -(-n // world) * world
    padded = np.concatenate([order, order[: total - n]])
    return padded[rank::world]


def _drain(q: "queue.Queue") -> None:
    try:
        while True:
            q.get_nowait()
    except queue.Empty:
        pass


def put_or_stop(q: "queue.Queue", item, stop: threading.Event) -> bool:
    """A blocking put that gives up once ``stop`` is set, so an abandoned
    consumer never leaves its producer blocked on a full queue."""
    while True:
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            if stop.is_set():
                return False


class ThreadedLoader:
    """Collated numpy batches from a persistent thread pool.

    Item loads are submitted in a window that spans batch boundaries, and
    when a batch loader driven by ``set_epoch`` (the trainer's) has yielded
    its last batch, the next epoch's production starts at once (bounded by
    ``prefetch``), so checkpoint and validation time at the epoch boundary
    doubles as loading time. A failed item is its dataset's placeholder,
    never missing, so every batch has its full shape. ``close`` stops the
    production and joins every thread."""

    def __init__(self, dataset: Any, batch_size: int, indices_fn: Callable[[int], np.ndarray],
                 num_workers: int = 4, prefetch: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.indices_fn = indices_fn
        # at most 4 threads a core unless HEADCT_LOADER_MAX_WORKERS says otherwise
        cap = (int(os.environ.get("HEADCT_LOADER_MAX_WORKERS", "0") or 0)
               or 4 * (os.cpu_count() or 1))
        self.num_workers = max(1, min(num_workers, cap))
        self.prefetch = prefetch
        self.epoch = 0
        self._pool: Optional[ThreadPoolExecutor] = None
        self._lock = threading.Lock()
        self._epoch_driven = False
        # epoch -> (queue, stop event, producer thread), started ahead of __iter__
        self._pending: Dict[int, Tuple["queue.Queue", threading.Event, threading.Thread]] = {}
        # every producer started and not yet joined
        self._producers: List[Tuple["queue.Queue", threading.Event, threading.Thread]] = []

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self._epoch_driven = True

    def _n_batches(self, n: int) -> int:
        return -(-n // self.batch_size)  # the last batch may be short

    def __len__(self) -> int:
        return self._n_batches(len(self.indices_fn(self.epoch)))

    def close(self) -> None:
        with self._lock:
            producers, self._producers = self._producers, []
            self._pending.clear()
            pool, self._pool = self._pool, None
        for q, stop, _ in producers:
            stop.set()
            _drain(q)
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)
        for _, _, t in producers:
            t.join()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _start_epoch(self, epoch: int):
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(max_workers=self.num_workers,
                                                thread_name_prefix="headct-torch-loader")
            pool = self._pool
        indices = self.indices_fn(epoch)
        batches = [indices[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(self._n_batches(len(indices)))]

        def producer():
            try:
                flat = iter(idx for b in batches for idx in b)
                futures: collections.deque = collections.deque()
                target = self.batch_size + 2 * self.num_workers  # the batch plus busy workers

                def top_up():
                    while len(futures) < target and not stop.is_set():
                        i = next(flat, None)
                        if i is None:
                            return
                        futures.append(pool.submit(self.dataset.__getitem__, int(i)))

                top_up()
                for batch_idx in batches:
                    if stop.is_set():
                        return
                    items = []
                    for _ in batch_idx:
                        items.append(futures.popleft().result())
                        top_up()
                    if not put_or_stop(out_q, collate(items), stop):
                        return
            except Exception as e:  # surfaced to the consumer
                if not stop.is_set():
                    put_or_stop(out_q, e, stop)
            finally:
                put_or_stop(out_q, None, stop)

        t = threading.Thread(target=producer, name=f"headct-torch-loader-epoch{epoch}", daemon=True)
        with self._lock:
            self._producers = [p for p in self._producers if p[2].is_alive()]
            self._producers.append((out_q, stop, t))
        t.start()
        return out_q, stop, t

    def __iter__(self) -> Iterator[Any]:
        epoch = self.epoch
        with self._lock:
            pending = self._pending.pop(epoch, None)
            for q, stop, _ in self._pending.values():  # stale lookaheads
                stop.set()
                _drain(q)
            self._pending.clear()
        if pending is None:
            pending = self._start_epoch(epoch)
        out_q, stop, _ = pending
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
            if self._epoch_driven:  # the next epoch loads while the trainer saves and validates
                nxt = self._start_epoch(epoch + 1)
                with self._lock:
                    self._pending[epoch + 1] = nxt
        finally:
            stop.set()
            _drain(out_q)


def collate(items: List[Any]) -> Any:
    """Stack tuple fields: arrays -> np.stack, the rest (paths) -> lists."""
    first = items[0]
    if isinstance(first, np.ndarray):
        return np.stack(items)
    return tuple(np.stack(column) if isinstance(column[0], np.ndarray) else list(column)
                 for column in zip(*items))


def get_pretrain_dataloaders(config: Any, rank: int = 0, world: int = 1, device: Any = None
                             ) -> Tuple[ThreadedLoader, ThreadedLoader, ThreadedLoader]:
    """Train, val and test loaders of ``rank`` out of ``world``, in manifest
    order (reference: datasets.py:99-183, DistributedSampler shuffle=False).
    ``device`` is where the ``device`` cache backend runs."""

    def make(csv_path: str) -> ThreadedLoader:
        ds = PretrainDataset(config, csv_path, cache_dir=config.DATA.CACHE_DIR, device=device)
        n = len(ds)
        return ThreadedLoader(ds, batch_size=int(config.DATA.BATCH_SIZE),
                              indices_fn=lambda epoch: distributed_indices(n, rank, world, False),
                              num_workers=int(config.DATA.NUM_WORKERS))

    return (make(config.DATA.TRAIN_CSV_PATH), make(config.DATA.VAL_CSV_PATH),
            make(config.DATA.TEST_CSV_PATH))


def _label_column(config: Any, header: List[str], rows: List[List[str]], path: str
                  ) -> Tuple[List[str], np.ndarray]:
    """(paths, labels) of a label manifest: the label is the column at
    ``CLASS_MAPPINGS``' position for ``TRAIN.LABEL_NAME``."""
    class_idx = get_class_mapping(config.DATA.DATASET)[config.TRAIN.LABEL_NAME]
    if class_idx >= len(header):
        raise ValueError(f"{path} has {len(header)} columns; the label {config.TRAIN.LABEL_NAME}"
                         f" is column {class_idx}")
    col = header.index("img_path")
    return ([r[col] for r in rows],
            np.asarray([int(float(r[class_idx])) for r in rows], dtype=np.int64))


def _label_tables(config: Any) -> Dict[str, Tuple[List[str], List[List[str]]]]:
    mapping = get_class_mapping(config.DATA.DATASET)
    if config.TRAIN.LABEL_NAME not in mapping:
        raise ValueError(f"Unknown label name {config.TRAIN.LABEL_NAME!r} for dataset "
                         f"{config.DATA.DATASET!r}; choose one of {sorted(mapping)}")
    return {split: read_table(getattr(config.DATA, f"{split.upper()}_CSV_PATH"))
            for split in ("train", "val", "test")}


def _labelled_loader(config: Any, paths: List[str], labels: np.ndarray,
                     indices_fn: Callable[[int], np.ndarray], device: Any) -> ThreadedLoader:
    ds = FinetuneDataset(config, paths, dict(zip(paths, labels.tolist())),
                         cache_dir=config.DATA.CACHE_DIR, device=device)
    return ThreadedLoader(ds, batch_size=int(config.DATA.BATCH_SIZE), indices_fn=indices_fn,
                          num_workers=int(config.DATA.NUM_WORKERS))


def _eval_loaders(config: Any, tables, rank: int, world: int, device: Any) -> list:
    out = []
    for split in ("val", "test"):
        paths, labels = _label_column(config, *tables[split], split)
        n = len(paths)
        out.append(_labelled_loader(
            config, paths, labels,
            lambda epoch, n=n: distributed_indices(n, rank, world, False), device))
    return out


def get_finetune_dataloaders(config: Any, rank: int = 0, world: int = 1, device: Any = None
                             ) -> Tuple[ThreadedLoader, ThreadedLoader, ThreadedLoader,
                                        Optional[np.ndarray]]:
    """Train loader of ``weighted_indices`` (500 draws a rank an epoch,
    inverse-frequency weights), val and test loaders in manifest order split
    ``rank::world``, and the class weights (reference: datasets.py:236-361)."""
    tables = _label_tables(config)
    paths, y = _label_column(config, *tables["train"], "train")
    num_classes = int(config.DATA.NUM_CLASSES)
    class_weights = None
    if num_classes != 1:
        counts = np.bincount(y, minlength=num_classes)
        class_weights = np.array([len(y) / max(c, 1) for c in counts], dtype=np.float32)
    sample_weights = class_weights[y] if class_weights is not None else np.ones(len(y))
    seed = int(config.SEED)
    train = _labelled_loader(
        config, paths, y,
        lambda epoch: weighted_indices(sample_weights, 500, rank, seed=seed, epoch=epoch), device)
    return (train, *_eval_loaders(config, tables, rank, world, device), class_weights)


def few_shot_rows(labels: Sequence, k: int, seed: int) -> np.ndarray:
    """Row indices of ``k`` draws with replacement per label value, as pandas'
    ``groupby(label).sample(n=k, replace=True, random_state=seed)`` takes
    them: one ``RandomState(seed)``; the label values in sorted order; for
    each, ``choice(count, k)`` into its rows in manifest order."""
    rs = np.random.RandomState(seed)
    labels = np.asarray(labels)
    out = []
    for value in np.unique(labels):
        rows = np.flatnonzero(labels == value)
        out.append(rows[rs.choice(len(rows), size=k, replace=True)])
    return np.concatenate(out)


def get_fewshots_dataloaders(config: Any, rank: int = 0, world: int = 1, device: Any = None
                             ) -> Tuple[ThreadedLoader, ThreadedLoader, ThreadedLoader, None]:
    """``DATA.FEW_SHOTS`` rows per class of the ``TRAIN.LABEL_NAME`` column
    (``few_shot_rows``), shuffled per epoch from ``SEED`` and split
    ``rank::world``; val and test as ``get_finetune_dataloaders``'
    (reference: datasets.py:364-477)."""
    tables = _label_tables(config)
    header, rows = tables["train"]
    if config.TRAIN.LABEL_NAME not in header:
        raise ValueError(f"the train manifest has no {config.TRAIN.LABEL_NAME!r} column")
    by_name = header.index(config.TRAIN.LABEL_NAME)
    picked = few_shot_rows([int(float(r[by_name])) for r in rows], int(config.DATA.FEW_SHOTS),
                           int(config.SEED))
    paths, y = _label_column(config, header, [rows[i] for i in picked], "train")
    n, seed = len(paths), int(config.SEED)
    train = _labelled_loader(
        config, paths, y,
        lambda epoch: distributed_indices(n, rank, world, True, seed=seed, epoch=epoch), device)
    return (train, *_eval_loaders(config, tables, rank, world, device), None)
