"""Readings that set a cell's limits: the control and the planted faults.

    python -m benchmark.calibrate --workload <cell> --seeds <n> [<n> ...]

For each seed, at the cell's own size on its cards: the plain float32
reference over the compared steps, then the control (the same reference
with every matrix product's operands in float8 e4m3, the step below the
configuration's bf16) and the faults a training cell can have
(``reference/train.py``: half of the batch, one gradient doubled where it
is made, and across cards the average over ranks left out; a state left
unchanged reads 1 by construction), each held against the float32
reference by ``compare.gaps``. Prints one JSON line per seed (rank 0) with
the seconds each reference took. The measured run's own readings come
from the benchmark's runs (their ``checks``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

from benchmark.cells import find


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="control and fault readings of a cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    from benchmark import run as bench_run

    bench_run.cache_env()
    import torch

    from benchmark import compare, harness

    cell = find(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"calibrate: {cell.name} needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 2
    children = bench_run.start_ranks("benchmark.calibrate", argv, cell.chips, args.rank)
    try:
        device = torch.device("cuda", args.rank)
        torch.cuda.set_device(device)
        _, _, all_reduce, _ = bench_run.join_ranks(cell, torch)
        run_cfg = cell.run_config()
        faults = ["half", "altered"] + (["no_exchange"] if cell.chips > 1 else [])
        for seed in args.seeds:
            out = {"workload": cell.name, "seed": seed, "seconds": {}}
            t0 = time.perf_counter()
            raw = harness.reference(cell, run_cfg, seed, device, args.rank, cell.chips, all_reduce)
            out["seconds"]["float32"] = time.perf_counter() - t0
            masks = compare.nought_masks(raw["grads"])
            ref = compare.readings(raw, masks)
            del raw
            out["reference_losses"] = ref["losses"]
            out["left_out"] = sum(int((~m).sum()) for m in masks.values())
            for label, kw in [("control_fp8", {"precision": "fp8"})] + [
                    (f, {"fault": f}) for f in faults]:
                t0 = time.perf_counter()
                got = harness.reference(cell, run_cfg, seed, device, args.rank, cell.chips,
                                        all_reduce, **kw)
                out["seconds"][label] = time.perf_counter() - t0
                out[label] = compare.gaps(compare.readings(got, masks), ref)
                out[f"{label}_worst"] = compare.worst(
                    compare.readings(got, masks)["change_norms"], ref["change_norms"])
                del got
            out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
            if args.rank == 0:
                print(json.dumps(out), flush=True)
    except BaseException:
        for c in children:
            c.terminate()
        raise
    finally:
        codes = [c.wait() for c in children]
    return 1 if any(codes) else 0


if __name__ == "__main__":
    sys.exit(main())
