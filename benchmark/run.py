"""Run one cell of the benchmark once.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted`` (window steps over all cards), ``failed`` (window steps with
a non-finite loss), ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` the
``breakdown``, and last ``checks``:
each compared number with its limit (also the last lines of standard
error). A cell on several cards starts one process per card (NCCL; rank 0
is this process and prints the line). Exits non-zero, printing no result,
without enough CUDA cards, for an unknown cell, when the measured package
cannot be imported, or when ``jax``, ``jaxlib``, ``flax`` or the JAX package
is loaded by the end of the run. Kernel and compiler caches live under
``build/`` of the checkout.
"""

from __future__ import annotations

import os
import time


def _process_age() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


T_START = time.perf_counter() - _process_age()

import argparse  # noqa: E402
import json  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import asdict  # noqa: E402
from typing import List, Optional  # noqa: E402

from benchmark.cells import ROOT, Cell, find  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "headct_foundation_tpu")


def cache_env() -> None:
    """Compiler caches at fixed paths inside the checkout; keep libraries
    from loading JAX."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton-cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch-extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def loaded_forbidden() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _card_power_limit(index: int) -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.splitlines()
        return out[index].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def start_ranks(module: str, argv: Optional[List[str]], chips: int,
                rank: int) -> List[subprocess.Popen]:
    """On rank 0 of a cell on several cards: the environment ``torchrun``
    would give, and ranks 1.. as processes of ``module`` (their standard
    output goes to this process's standard error)."""
    if chips == 1 or rank != 0:
        return []
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
                      WORLD_SIZE=str(chips), RANK="0", LOCAL_RANK="0")
    children = []
    for r in range(1, chips):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r))
        cmd = [sys.executable, "-m", module, *(argv if argv is not None else sys.argv[1:]),
               "--rank", str(r)]
        children.append(subprocess.Popen(cmd, env=env, cwd=str(ROOT), stdout=sys.stderr))
    return children


def join_ranks(cell: Cell, torch):
    """Join the cell's process group (NCCL, and a gloo group for the host's
    decisions); returns (agree, barrier, all_reduce, gloo group), all None
    on one card."""
    world = cell.chips
    if world == 1:
        return None, None, None, None
    import torch.distributed as dist
    from benchmark import harness
    from headct_foundation_tpu_torch.parallel import distributed

    distributed.init_from_env("cuda", config=harness.port_config(cell.run_config()))
    group = dist.new_group(backend="gloo")

    def agree(flag: bool) -> bool:
        t = torch.tensor([int(flag)])
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        return bool(t.item())

    def barrier() -> None:
        dist.barrier(group=group)

    def all_reduce(ts) -> None:
        for t in ts:
            dist.all_reduce(t)
            t.div_(world)

    return agree, barrier, all_reduce, group


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    cache_env()
    import torch

    cell = find(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA card(s), found {n}",
              file=sys.stderr)
        return 2
    children = start_ranks("benchmark.run", argv, cell.chips, args.rank)
    try:
        line = run(cell, args, torch)
    except BaseException:
        for c in children:
            c.terminate()
        raise
    finally:
        codes = [c.wait() for c in children]
    if args.rank != 0:
        return 0
    if any(codes):
        print(f"benchmark: a rank exited with {codes}", file=sys.stderr)
        return 1
    bad = loaded_forbidden()
    if bad:
        print(f"benchmark: the run loaded {bad}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


def run(cell: Cell, args, torch) -> Optional[dict]:
    from benchmark import harness

    rank, world = args.rank, cell.chips
    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    agree, barrier, all_reduce, group = join_ranks(cell, torch)
    setup = {}
    res = harness.run_rank(cell, args.seed, args.seconds, bool(args.trace), device, rank, world,
                           agree, barrier, all_reduce,
                           on_window=lambda: setup.setdefault("s", time.perf_counter() - T_START))
    results = [asdict(res)]
    if world > 1:
        import torch.distributed as dist

        results = [None] * world
        dist.all_gather_object(results, asdict(res), group=group)
        dist.destroy_process_group()
    if rank != 0:
        return None
    from benchmark import compare

    print(f"kernel launches per step: {json.dumps({k: v for k, v in res.launches.items() if v})}",
          file=sys.stderr)
    if res.profile is not None:
        print(f"device ms per traced step by layer: {json.dumps(res.profile['layer_ms'])}",
              file=sys.stderr)
    print(f"change compared without {res.left_out} elements (nought rule); worst parameter: "
          f"gradient {compare.worst(res.readings['grad_norms'], res.reference['grad_norms'])}, "
          f"change {compare.worst(res.readings['change_norms'], res.reference['change_norms'])}",
          file=sys.stderr)
    return result_line(cell, results, setup["s"], bool(args.trace),
                       torch.cuda.get_device_name(device), _card_power_limit(rank))


def result_line(cell: Cell, results: List[dict], setup_s: float, traced: bool,
                device_name: str, power_limit: Optional[str]) -> dict:
    """The last line from every rank's ``harness.RankResult`` (as dicts)."""
    from benchmark import compare, harness

    r0 = harness.RankResult(**results[0])
    world = len(results)
    record = harness.RunRecord(
        cell=cell, run_cfg=cell.run_config(), world=world, batch=int(cell.traffic["batch"]),
        steps=r0.steps, window_s=max(r["window_s"] for r in results),
        intervals_ms=[x for r in results for x in r["intervals_ms"]],
        host_ms=[x for r in results for x in r["host_ms"]],
        data_time_s=sum(r["data_time_s"] for r in results) / world,
        peak_bytes=max(r["peak_bytes"] for r in results), setup_s=setup_s,
        device_name=device_name, profile=r0.profile)
    checks = harness.checks(cell, r0)
    dev = {"platform": "gpu", "kind": record.device_name, "count": world,
           "memory_peak_bytes": record.peak_bytes,
           "power_limit": power_limit}
    values = {k: c["value"] for k, c in checks.items()}
    line = {"correct": compare.verdict(values, cell.limits),
            "attempted": sum(r["steps"] for r in results),
            "failed": sum(r["failed"] for r in results),
            "metrics": harness.metrics(record, cell.per_layer if traced else cell.end_to_end),
            "device": dev}
    if traced:
        busy = [r["profile"]["busy_s"] for r in results]
        windows = [r["profile"]["window_s"] for r in results]
        dev.update(busy_s=sum(busy) / world, window_s=sum(windows) / world)
        line["breakdown"] = r0.profile["breakdown"]
    line["checks"] = checks
    return line


if __name__ == "__main__":
    sys.exit(main())
