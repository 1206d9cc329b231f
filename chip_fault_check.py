#!/usr/bin/env python3
"""Planted-fault check of the blocked kernels' comparison in chip_smoke.py.

    python3 chip_fault_check.py    (from the repository root; needs one CUDA card and nvcc)

For each fault in FAULTS, copies the port's package and ``chip_smoke.py``
into a temporary directory, plants the fault in the copy's CUDA header (one
skipped tile of the walk in a bfloat16 kernel), builds the copy's blocked
kernels there and runs chip_smoke's blocked kernel phase on each of its
cases alone. A case that comes out FAILED has caught the fault. The faults
sit in the bfloat16 (tensor-core) kernels, so every bfloat16 case must catch
each of them and every float32 case (the CUDA-core kernels) must pass; the
script exits non-zero otherwise. The repository's own files are not touched.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
PKG = "headct_foundation_tpu_torch"

FAULTS = [  # (name, header under csrc/, kernel definition, anchor in its tile loop, line
    # planted after the anchor)
    ("B3 skips key tile 1", "flash_fwd.cuh", "\nflash_fwd_tc_kernel(",
     "for (int n0 = 0; n0 < kv_len; n0 += kBlockN) {", "if (n0 == kBlockN) continue;"),
    # B4/B5: the consumer warpgroup takes walked tile 1 off the ring without
    # using it, so the producer and the mbarriers run on as before
    ("B4 skips query tile 1", "flash_bwd_sm90.cuh", "\ndkv_wgmma_kernel(",
     "bar_wait(full + 8 * st, (i / kStages) & 1);",
     "if (i == 1) { bar_arrive(empty + 8 * st); continue; }"),
    ("B5 skips key tile 1", "flash_bwd_sm90.cuh", "\ndq_wgmma_kernel(",
     "bar_wait(full + 8 * st, (i / kStages) & 1);",
     "if (i == 1) { bar_arrive(empty + 8 * st); continue; }"),
]

# Run inside the copy: each blocked case alone; prints which ones failed.
RUN = r"""
import json, chip_smoke
from headct_foundation_tpu_torch.ops import _build

_build.build_all(["flash_attention_blocked_fwd", "flash_attention_blocked_bwd"])
caught = []
for case in list(chip_smoke.BLOCKED_CASES):
    chip_smoke.BLOCKED_CASES = [case]
    try:
        chip_smoke.phase_blocked_kernels()
        caught.append(False)
    except RuntimeError:
        caught.append(True)
print("CAUGHT " + json.dumps(caught), flush=True)
"""


def plant(source: str, kernel: str, loop: str, line: str) -> str:
    """``line`` right after the first ``loop`` anchor in ``kernel``."""
    at = source.index(kernel)
    at = source.index(loop, at) + len(loop)
    return source[:at] + " " + line + source[at:]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_fault_check: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    want = [case[3] == torch.bfloat16 for case in chip_smoke.BLOCKED_CASES]
    ok = True
    for name, header, kernel, loop, line in FAULTS:
        with tempfile.TemporaryDirectory() as tmp:
            copy = Path(tmp)
            shutil.copytree(ROOT / PKG, copy / PKG,
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(ROOT / "chip_smoke.py", copy / "chip_smoke.py")
            path = copy / PKG / "csrc" / header
            path.write_text(plant(path.read_text(), kernel, loop, line))
            print(f"fault {name}: planted `{line}` in {kernel.strip()} of csrc/{header}",
                  flush=True)
            r = subprocess.run([sys.executable, "-c", RUN], cwd=copy, text=True,
                               capture_output=True, env=dict(os.environ, PYTHONPATH=str(copy)),
                               timeout=900)
        sys.stdout.write(r.stdout)
        done = [ln for ln in r.stdout.splitlines() if ln.startswith("CAUGHT ")]
        if r.returncode != 0 or not done:
            print(f"fault {name}: the run failed (exit {r.returncode}):\n{r.stderr[-3000:]}",
                  flush=True)
            ok = False
            continue
        caught = json.loads(done[-1][len("CAUGHT "):])
        right = caught == want
        ok &= right
        print(f"fault {name}: caught by {sum(caught)} of {len(caught)} cases, every bfloat16 "
              f"case and no float32 one: {'ok' if right else 'FAILED'}", flush=True)
    print(json.dumps({"ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
