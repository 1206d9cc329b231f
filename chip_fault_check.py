#!/usr/bin/env python3
"""Planted-fault check of the attention kernels' comparisons in chip_smoke.py.

    python3 chip_fault_check.py    (from the repository root; needs one CUDA card and nvcc)

For each fault in FAULTS, copies the port's package and ``chip_smoke.py``
into a temporary directory, plants the fault in the copy's CUDA header (one
skipped tile of the walk in a wgmma kernel: the bfloat16 forward, the
float32 forward, the bfloat16 dK/dV or dQ pass), builds the copy's
attention kernels there and runs, each on its cases one at a time,
chip_smoke's whole-sequence forward phase (B1), its whole-sequence backward
phase (B2) and its blocked kernel phase (B3, B4, B5). A case that comes out
FAILED has caught the fault. The forwards' faults show on the B1 and B3
paths (they run the same kernels); the dK/dV and dQ passes' faults on the
B2 and blocked paths (B2 runs B4's and B5's kernels with Tq = Tk = kv_len =
T). The backward phase holds B2 against its plain version on the kernel
forward's own o and lse, so a faulty forward does not show there. A case
must catch a fault exactly when it is of the faulty kernel's dtype and the
kernel walks more than one tile in it: a walk of one tile never reaches the
skipped tile (the forward at (2, 9, 3, 12) walks one 64-key tile, so no
planted tile can show there), and the other dtype runs other kernels (the
float32 backward passes run on the CUDA cores and are not planted). The
script exits non-zero otherwise. The repository's own files are not
touched.
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

# Rows of the walked tiles: the bf16 forward's 64-key tiles (csrc/flash_fwd_sm90.cuh
# kKeys), the float32 forward's 64, 32 above a padded head dim of 64
# (csrc/flash_fwd_f32_sm90.cuh Tiles), B5's 64-key and B4's 64-query tiles, 32
# above a padded head dim of 64 (csrc/flash_bwd_sm90.cuh walk_rows).
FWD_KEYS, BWD_ROWS = 64, 64


def padded(d: int) -> int:
    return next(p for p in (16, 32, 48, 64, 128) if d <= p)


def tiles(n: int, rows: int) -> int:
    return -(-n // rows)


FAULTS = [  # (name, header under csrc/, kernel definition, anchor in its consumers' walk,
    # line planted after the anchor, paths it shows on, tiles the kernel walks for q
    # [B, Tq, H, D] against kv_len keys, the operands' dtype). The consumer warpgroups
    # take walked tile 1 off the ring without using it, so the producers and the
    # mbarriers run on as before.
    ("B1/B3 skip key tile 1", "flash_fwd_sm90.cuh", "\nflash_fwd_wgmma_kernel(",
     "bar_wait(full + 8 * st, (i / kStages) & 1);",
     "if (i == 1) { bar_arrive(empty + 8 * st); continue; }", ("whole", "blocked"),
     lambda shape, kv_len: tiles(kv_len, FWD_KEYS), torch.bfloat16),
    ("B1/B3 float32 skip key tile 1", "flash_fwd_f32_sm90.cuh", "\nflash_fwd_tf32_kernel(",
     "bar_wait(full + 8 * st, (i / kStages) & 1);",
     "if (i == 1) { bar_arrive(empty + 8 * st); continue; }", ("whole", "blocked"),
     lambda shape, kv_len: tiles(kv_len, FWD_KEYS // 2 if padded(shape[3]) > 64 else FWD_KEYS),
     torch.float32),
    ("B4 skips query tile 1", "flash_bwd_sm90.cuh", "\ndkv_wgmma_kernel(",
     "bar_wait(full + 8 * st, (i / kStages) & 1);",
     "if (i == 1) { bar_arrive(empty + 8 * st); continue; }", ("whole_bwd", "blocked"),
     lambda shape, kv_len: tiles(shape[1],
                                 BWD_ROWS // 2 if padded(shape[3]) > 64 else BWD_ROWS),
     torch.bfloat16),
    ("B5 skips key tile 1", "flash_bwd_sm90.cuh", "\ndq_wgmma_kernel(",
     "bar_wait(full + 8 * st, (i / kStages) & 1);",
     "if (i == 1) { bar_arrive(empty + 8 * st); continue; }", ("whole_bwd", "blocked"),
     lambda shape, kv_len: tiles(kv_len, BWD_ROWS), torch.bfloat16),
]

# The paths, each a chip_smoke phase run on one of its case lists.
PATHS = ("whole", "whole_bwd", "blocked")

# Run inside the copy: each case of each phase alone; prints which ones failed.
RUN = r"""
import json, chip_smoke
from headct_foundation_tpu_torch.ops import _build
from headct_foundation_tpu_torch.ops.flash_attention import (
    fused_attention, fused_attention_bwd, fused_attention_bwd_reference, fused_attention_reference)

_build.build_all(["flash_attention_fwd", "flash_attention_bwd", "flash_attention_blocked_fwd",
                  "flash_attention_blocked_bwd"])
phases = {
    "whole": ("KERNEL_CASES", lambda: chip_smoke.phase_kernels(fused_attention,
                                                                fused_attention_reference)),
    "whole_bwd": ("BWD_CASES", lambda: chip_smoke.phase_bwd_kernels(
        fused_attention, fused_attention_bwd, fused_attention_bwd_reference)),
    "blocked": ("BLOCKED_CASES", chip_smoke.phase_blocked_kernels),
}
caught = {}
for path, (cases, phase) in phases.items():
    caught[path] = []
    for case in list(getattr(chip_smoke, cases)):
        setattr(chip_smoke, cases, [case])
        try:
            phase()
            caught[path].append(False)
        except RuntimeError:
            caught[path].append(True)
print("CAUGHT " + json.dumps(caught), flush=True)
"""


def plant(source: str, kernel: str, loop: str, line: str) -> str:
    """``line`` right after the first ``loop`` anchor in ``kernel``'s body
    (before the next kernel definition); raises ValueError where the anchor
    is not there."""
    at = source.index(kernel)
    end = source.find("__global__", at)
    at = source.index(loop, at, len(source) if end < 0 else end) + len(loop)
    return source[:at] + " " + line + source[at:]


def expected(paths, walked, faulty) -> dict:
    """Per path, per chip_smoke case: whether the fault, planted in the
    kernel of dtype ``faulty``, must be caught."""
    import chip_smoke

    whole = [("whole" in paths and dtype == faulty and walked(shape, shape[1]) > 1)
             for shape, dtype, *_ in chip_smoke.KERNEL_CASES]
    whole_bwd = [("whole_bwd" in paths and dtype == faulty and walked(shape, shape[1]) > 1)
                 for shape, dtype, *_ in chip_smoke.BWD_CASES]
    blocked = [("blocked" in paths and dtype == faulty
                and walked(shape, tk if kv_len is None else kv_len) > 1)
               for shape, tk, kv_len, dtype, *_ in chip_smoke.BLOCKED_CASES]
    return {"whole": whole, "whole_bwd": whole_bwd, "blocked": blocked}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_fault_check: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    ok = True
    for name, header, kernel, loop, line, paths, walked, faulty in FAULTS:
        want = expected(paths, walked, faulty)
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
        counts = ", ".join(f"{path} {sum(caught[path])} of {len(caught[path])} cases "
                           f"(expected {sum(want[path])})" for path in caught)
        print(f"fault {name}: caught by {counts}: every {str(faulty)[6:]} case walking more "
              f"than one tile of the faulty kernel and no other: {'ok' if right else 'FAILED'}",
              flush=True)
    print(json.dumps({"ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
