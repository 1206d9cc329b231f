"""Device time of a train step by kernel and by call site: the port's
counterpart of the JAX repository's ``tools/op_profile.py``.

    python -m headct_foundation_tpu_torch.tools.op_profile [--engine mae|dino]
        [--batch 32] [--device cpu] [--trace DIR]

Captures ``STEPS`` steady-state steps (after one warm step) of the MAE
CLI's step (``bench.compute_only``'s: the flagship recipe on the hu16 wire)
or the DINO CLI's (``bench_dino.setup``) with ``torch.profiler`` (CPU and
CUDA activity, Python stacks), reads the profile's Chrome trace (its
Python calls are there on every PyTorch version; ``prof.events()`` of some
versions drops them) and prints:

* the kernel categories' shares of device time (``PROFILE_GROUPS``, first
  match on the kernel's name; the rest is "elementwise and other");
* the top kernels by self device time, each with its count, the PyTorch op
  that launched it and the port's own Python frame (module:line) it came
  from (the line is the function's first line, as the trace names a
  Python call). A CUDA kernel's name does not say which line of the model
  made it, as an XLA op's name does; this is its counterpart. A kernel
  launched in the backward pass is traced to the forward op that recorded
  its autograd node (by sequence number), marked "(backward)";
* the top call sites of the "elementwise and other" category (op and
  frame), the casts and copies behind it.

On the CPU (``--device cpu``) the items are the CPU ops' self times. With
``--trace DIR`` the Chrome trace is written there. The last line is one
JSON object with all of the above, the card's name and power limit and the
kernels' launches over the profiled steps.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import tempfile
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional

import torch

from headct_foundation_tpu_torch.bench import (
    SEED,
    cli_state,
    device_info,
    flagship_config,
    launches_since,
    sync,
    wire_batch,
)
from headct_foundation_tpu_torch.engines.mae_engine import kernel_launches
from headct_foundation_tpu_torch.feature_extraction import resolve_device

STEPS = 6
PACKAGE = "headct_foundation_tpu_torch/"
OTHER = "elementwise and other"
PROFILE_GROUPS = [  # (group, substrings of a lowercased kernel or op name), first match wins
    # B3-B5 instantiate the shared kernels with the tag "Blocked" in their names
    ("attention kernels B3/B4/B5", ("blocked",)),
    ("attention kernels B1/B2", ("flash_fwd", "dkv_", "dq_", "delta_kernel")),
    ("GEMMs", ("gemm", "nvjet", "xmma", "cutlass", "cublas", "matmul", "aten::mm",
               "aten::addmm", "aten::bmm")),
    ("per-parameter clip norms", ("lpnorm",)),
    ("AdamW", ("adam", "multi_tensor")),
    ("fused Lion B6", ("lion_kernel",)),
    ("softmax / norms / reductions", ("softmax", "norm", "reduce")),
]
_PY_FRAME = re.compile(r"^(.*\.py)\((\d+)\): (.*)$")
_BACKWARD = "autograd::engine::evaluate_function: "
_KERNELS = ("kernel", "gpu_memcpy", "gpu_memset")  # the trace's device categories
_LAUNCHES = ("cuda_runtime", "cuda_driver")
_RANGES = ("cpu_op", "python_function")


def category(name: str) -> str:
    low = name.lower()
    return next((g for g, keys in PROFILE_GROUPS if any(k in low for k in keys)), OTHER)


def port_frame(frames: List[str]) -> Optional[str]:
    """The innermost frame in the port's package, as "module.py:line func"."""
    for f in frames:
        m = _PY_FRAME.match(f)
        path = m.group(1) if m else f
        if PACKAGE in path and not path.endswith("tools/op_profile.py"):
            rel = path[path.rindex(PACKAGE) + len(PACKAGE):]
            return f"{rel}:{m.group(2)} {m.group(3)}" if m else rel
    return None


def _sweep(trace: List[dict], on_cuda: bool) -> tuple:
    """Walk the host timeline of a Chrome trace (``prof.export_chrome_trace``)
    with the stack of open ranges (ops and Python calls). Returns (the
    stack, outermost first, at each launch by its correlation id; each op
    with its stack and its self time in microseconds)."""
    timeline = sorted((e for e in trace if e.get("ph") == "X" and (
        e.get("cat") in _RANGES or (on_cuda and e.get("cat") in _LAUNCHES))),
        key=lambda e: (e["ts"], -e.get("dur", 0)))
    open_ranges: List[dict] = []
    launches: Dict[Any, List[dict]] = {}
    ops: List[list] = []  # [op, its stack, self microseconds]
    by_id: Dict[int, list] = {}
    for e in timeline:
        while open_ranges and open_ranges[-1]["ts"] + open_ranges[-1].get("dur", 0) <= e["ts"]:
            open_ranges.pop()
        if e["cat"] in _LAUNCHES:
            launches[e.get("args", {}).get("correlation")] = list(open_ranges)
            continue
        if e["cat"] == "cpu_op":
            parent = next((r for r in reversed(open_ranges) if r["cat"] == "cpu_op"), None)
            if parent is not None:
                by_id[id(parent)][2] -= e.get("dur", 0)
            by_id[id(e)] = [e, list(open_ranges), float(e.get("dur", 0))]
            ops.append(by_id[id(e)])
        open_ranges.append(e)
    return launches, ops


def _site(stack: List[dict]) -> tuple:
    """(Python frames innermost first, below any backward node; the
    innermost op; the innermost autograd backward node) of a stack."""
    frames: List[str] = []
    op = None
    for e in reversed(stack):
        if e["cat"] == "python_function":
            frames.append(e["name"])
        elif e["name"].startswith(_BACKWARD):
            return frames, op, e
        elif op is None:
            op = e
    return frames, op, None


def _seq(e: dict) -> int:
    return int(e.get("args", {}).get("Sequence number", -1))


def parse(trace: List[dict], on_cuda: bool, steps: int, top: int = 18) -> Dict[str, Any]:
    """Categories, top kernels and elementwise call sites of a Chrome
    trace's events. A kernel hangs from its launch (the same correlation
    id), its op is the innermost op open at the launch ("(direct launch)"
    for a kernel launched outside any op, as the port's ctypes wrappers
    launch) and its frame the innermost open Python call in the port's
    package; a kernel under an autograd backward node takes the frames of
    the forward op that recorded the node (the same sequence number). On
    the CPU the items are the ops' self times."""
    launches, ops = _sweep(trace, on_cuda)
    forward: Dict[int, List[str]] = {}  # sequence number -> the outermost forward op's frames
    for op, stack, _ in ops:
        frames, _, node = _site(stack)
        if _seq(op) >= 0 and node is None and not op["name"].startswith(_BACKWARD):
            forward.setdefault(_seq(op), frames)
    if on_cuda:
        items = [(e["name"], float(e.get("dur", 0)), launches.get(e.get("args", {}).get("correlation")))
                 for e in trace if e.get("ph") == "X" and e.get("cat") in _KERNELS]
    else:
        items = [(op["name"], us, stack + [op]) for op, stack, us in ops if us > 0]
    per_kernel: Dict[tuple, List[float]] = defaultdict(lambda: [0.0, 0])
    total = 0.0
    for name, us, stack in items:
        total += us
        op_name, frame = "(no launch found)", None
        if stack is not None:
            frames, op, node = _site(stack)
            op_name = (op["name"] if op is not None
                       else "(direct launch)" if on_cuda else "(autograd node)")
            frame = port_frame(frames)
            if frame is None and node is not None and _seq(node) in forward:
                frame = port_frame(forward[_seq(node)])
                frame = frame and f"{frame} (backward)"
            if node is not None:
                op_name = f"{op_name} in {node['name'][len(_BACKWARD):]}"
        slot = per_kernel[(category(name), name, op_name, frame)]
        slot[0] += us
        slot[1] += 1
    if total <= 0:
        raise RuntimeError("the profile recorded no device time")
    cats: Dict[str, float] = defaultdict(float)
    sites: Dict[tuple, List[float]] = defaultdict(lambda: [0.0, 0])
    for (cat, _, op_name, frame), (us, n) in per_kernel.items():
        cats[cat] += us
        if cat == OTHER:
            sites[(op_name, frame)][0] += us
            sites[(op_name, frame)][1] += n

    def row(us, n):
        return {"share": 100 * us / total, "ms_per_step": us / steps / 1e3,
                "count_per_step": n / steps}

    return {
        "device_ms_per_step": total / steps / 1e3,
        "categories": {c: 100 * us / total for c, us in sorted(cats.items(), key=lambda kv: -kv[1])},
        "top_kernels": [{"kernel": name, "category": cat, "op": op_name, "frame": frame,
                         **row(us, n)}
                        for (cat, name, op_name, frame), (us, n) in
                        sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:top]],
        "elementwise_sites": [{"op": op_name, "frame": frame, **row(us, n),
                               "share_of_category": 100 * us / max(cats[OTHER], 1e-30)}
                              for (op_name, frame), (us, n) in
                              sorted(sites.items(), key=lambda kv: -kv[1][0])[:top]],
    }


def capture(run_step: Callable[[], Any], steps: int, device: torch.device,
            trace_dir: Optional[str] = None) -> tuple:
    """(the Chrome trace's events, host seconds) of ``steps`` calls of
    ``run_step`` under ``torch.profiler`` with Python stacks; the trace is
    kept in ``trace_dir`` when given."""
    from torch.profiler import ProfilerActivity, profile

    sync(device)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if device.type == "cuda" else [])
    with profile(activities=activities, with_stack=True) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run_step()
        sync(device)
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="headct_op_profile_") as tmp:
        path = os.path.join(trace_dir or tmp, f"op_profile_{os.getpid()}.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"], wall


def _mae(batch: int, device: torch.device, cfg=None):
    from headct_foundation_tpu_torch import main_pretrain_mae

    cfg = cfg if cfg is not None else flagship_config()
    wire = torch.from_numpy(wire_batch(cfg, batch)).to(device)
    step = main_pretrain_mae.make_train_step(cfg)
    return cli_state(cfg, device), lambda s: step(s, wire, SEED)


def _dino(batch: int, device: torch.device):
    from headct_foundation_tpu_torch.tools import bench_dino

    _, state, step_once, _ = bench_dino.setup(batch, device=device)
    return state, step_once


def run(engine: str = "mae", batch: int = 32, steps: int = STEPS, top: int = 18, device=None,
        trace_dir: Optional[str] = None, cfg=None) -> Dict[str, Any]:
    """Profile ``steps`` steps of the engine's CLI step and parse them;
    ``cfg`` replaces the MAE's recipe."""
    device = resolve_device(device)
    state, step_once = _mae(batch, device, cfg) if engine == "mae" else _dino(batch, device)
    holder = [state]
    losses: List[torch.Tensor] = []

    def run_step():
        holder[0], metrics = step_once(holder[0])
        losses.append(metrics["loss"])

    run_step()  # warm, outside the profile
    sync(device)
    before = kernel_launches()
    trace, wall = capture(run_step, steps, device, trace_dir)
    launches = launches_since(before)
    if not torch.isfinite(torch.stack(losses)).all():
        raise RuntimeError(f"op_profile: a loss is not finite: {[x.item() for x in losses]}")
    return {"engine": engine, "batch_per_gpu": batch, "steps": steps,
            "final_loss": float(losses[-1].item()),
            "host_ms_per_profiled_step": wall / steps * 1e3, "device": device_info(device),
            "launches": launches, **parse(trace, device.type == "cuda", steps, top)}


def report(out: Dict[str, Any]) -> None:
    """The human-readable tables."""
    unit = "device" if out["device"]["name"] != "cpu" else "CPU op"
    print(f"op_profile: {out['steps']} {out['engine']} steps at batch {out['batch_per_gpu']}, "
          f"{unit} time {out['device_ms_per_step']:.3f} ms a step (host "
          f"{out['host_ms_per_profiled_step']:.1f} ms a profiled step), final loss "
          f"{out['final_loss']:.4f} | {out['device']['name']}, {out['device']['power_limit']}",
          flush=True)
    print("== categories (share of " + unit + " time) ==")
    for name, share in out["categories"].items():
        print(f"  {share:5.1f}%  {name}")
    print("== top kernels by self time: share, ms a step, count a step, op, frame ==")
    for r in out["top_kernels"]:
        print(f"  {r['share']:5.1f}%  {r['ms_per_step']:8.3f}  x{r['count_per_step']:g}  "
              f"[{r['category']}] {r['kernel'][:70]}  <- {r['op']} @ {r['frame']}")
    print("== elementwise and other, by call site ==")
    for r in out["elementwise_sites"]:
        print(f"  {r['share']:5.1f}%  {r['ms_per_step']:8.3f}  x{r['count_per_step']:g}  "
              f"{r['op']} @ {r['frame']}")


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--engine", choices=("mae", "dino"), default="mae")
    ap.add_argument("--batch", type=int, default=None, help="default: 32 (mae), 16 (dino)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--trace", default=None, help="write the Chrome trace to this directory")
    args = ap.parse_args(argv)
    batch = args.batch or (32 if args.engine == "mae" else 16)
    out = run(args.engine, batch, device=args.device, trace_dir=args.trace)
    report(out)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
