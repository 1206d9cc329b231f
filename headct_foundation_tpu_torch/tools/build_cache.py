"""Offline build of the preprocessed-scan cache (the port's counterpart of
the JAX package's ``tools/build_cache.py:39-145``; reference:
cpu_caching.py:13-65, run_cache_data.py:6-29).

    python -m headct_foundation_tpu_torch.tools.build_cache --csv manifest.csv \\
        --cache-dir cache/mae_cache [--roi 96] [--in-chans 3] [--wire windowed|hu16|hu8] \\
        [--shard 0 --num-shards 10] [--workers 16] [--packed] [--volumes-per-shard 512] \\
        [--device]

Threads fill ``data/datasets.py DiskCache`` (the ``<key>.npy`` files, under
the JAX package's keys) from the manifest's ``img_path`` column, read with
the ``csv`` module. ``--shard i --num-shards n`` takes rows i, i + n, ...
so n invocations on any scheduler split a manifest. ``--packed`` also
writes the packed shards (``pack_<tag><i>.bin`` and
``pack_index<tag>.json``, tagged per shard when there are several), which
the loaders then read with no per-volume file opens; rows already in the
index are skipped. ``--device`` preprocesses on the card
(``HEADCT_DEVICE_CACHE=1``). A decoder that cannot be built stops the tool
before any row; a scan that fails is reported and counted.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np

from headct_foundation_tpu_torch.data.datasets import DiskCache, PackedCacheWriter, read_manifest

_DTYPES = {"windowed": np.float16, "hu16": np.int16, "hu8": np.uint8}


def build(csv_path: str, cache_dir: str, roi: int = 96, in_chans: int = 3,
          wire: str = "windowed", shard: int = 0, num_shards: int = 1, workers: int = 8,
          packed: bool = False, volumes_per_shard: int = 512, log=print) -> dict:
    """Fill the cache; returns the counts (``done``, ``errors``, ``packed``:
    the index's entries, ``skipped``: rows already packed)."""
    paths = [row["img_path"] for row in read_manifest(csv_path)][shard::num_shards]
    cache = DiskCache(cache_dir, (roi,) * 3, in_chans, wire=wire).prepare()
    packer, skipped = None, 0
    if packed:
        tag = f"r{shard}_" if num_shards > 1 else ""
        packer = PackedCacheWriter(cache_dir, cache.wire_shape, volumes_per_shard=volumes_per_shard,
                                   dtype=_DTYPES[wire], tag=tag)
        before = len(paths)
        paths = [p for p in paths if cache.key(p) not in packer.entries]
        skipped = before - len(paths)
        if skipped:
            log(f"skipping {skipped} already-packed volumes")

    def one(path: str):
        try:
            return path, cache.load(path)
        except Exception as e:  # reported and counted; the others go on
            print(f"ERROR {path}: {e}", file=sys.stderr)
            return path, None

    done = errors = 0
    t0 = time.time()
    # a sliding window, so that at most ~2x workers volumes wait for the packer
    window = max(2 * workers, 8)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        todo = iter(paths)
        futures: deque = deque()

        def top_up():
            while len(futures) < window:
                p = next(todo, None)
                if p is None:
                    return
                futures.append(pool.submit(one, p))

        top_up()
        while futures:
            path, vol = futures.popleft().result()
            top_up()
            done += 1
            if vol is None:
                errors += 1
            elif packer is not None:
                packer.add(cache.key(path), vol)  # the packer runs on this thread only
            if done % 100 == 0:
                log(f"[{done}/{len(paths)}] {done / (time.time() - t0):.1f} scans/s, "
                    f"{errors} errors")
    n_packed = None
    if packer is not None:
        packer.close()
        n_packed = len(packer.entries)
        log(f"packed index: {n_packed} volumes, {len(packer.shard_counts)} shards")
    log(f"done: {done} scans, {errors} errors, {time.time() - t0:.0f}s")
    return {"done": done, "errors": errors, "packed": n_packed, "skipped": skipped}


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csv", required=True, help="manifest with an img_path column")
    ap.add_argument("--cache-dir", required=True)
    ap.add_argument("--roi", type=int, default=96)
    ap.add_argument("--in-chans", type=int, default=3)
    ap.add_argument("--shard", type=int, default=0)
    ap.add_argument("--num-shards", type=int, default=1)
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 8)
    ap.add_argument("--device", action="store_true",
                    help="preprocess on the card (sets HEADCT_DEVICE_CACHE=1)")
    ap.add_argument("--packed", action="store_true",
                    help="also write the packed shards and their index")
    ap.add_argument("--volumes-per-shard", type=int, default=512)
    ap.add_argument("--wire", choices=tuple(_DTYPES), default="windowed",
                    help="the cache tensor's format (DATA.WIRE_FORMAT)")
    args = ap.parse_args(argv)
    if args.device:
        os.environ["HEADCT_DEVICE_CACHE"] = "1"
    return build(args.csv, args.cache_dir, args.roi, args.in_chans, args.wire, args.shard,
                 args.num_shards, args.workers, args.packed, args.volumes_per_shard)


if __name__ == "__main__":
    main()
