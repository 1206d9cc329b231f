"""Build the port's CUDA kernels with ``nvcc`` at first use and load them.

Each source under ``csrc/`` compiles on its own into a shared library with a
plain C interface (``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC``), loaded with ``ctypes``. The library lands in
``<repo>/build/kernels/<name>-<hash of the source>/``, a directory that
``.gitignore`` lists, so an edited source (or shared ``.cuh`` header) builds
anew and an unchanged one is reused; ptxas's report of the build is saved
beside it (``ptxas_log``). ``build_all`` starts one ``nvcc`` per source, all
at once.

Nothing falls back: a missing ``nvcc`` or a failed build raises. ``load``
runs in the ``setup.kernels`` span (``utils/tracing.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

from headct_foundation_tpu_torch.utils import tracing

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "kernels"

# library name -> source file under csrc/ (flash_attention_blocked_bwd holds
# two kernels, B4 and B5, and tm_attention two, B7 and B8, each with its own
# C entry)
SOURCES = {"flash_attention_fwd": "flash_attention_fwd.cu",
           "flash_attention_bwd": "flash_attention_bwd.cu",
           "flash_attention_blocked_fwd": "flash_attention_blocked_fwd.cu",
           "flash_attention_blocked_bwd": "flash_attention_blocked_bwd.cu",
           "lion_update": "lion_update.cu",
           "tm_attention": "tm_attention.cu"}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
# ptxas's report (registers, shared memory, spills) of each build this process ran
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built at first use "
                       "and need the CUDA toolkit on PATH or in /usr/local/cuda")


def library_path(name: str) -> Path:
    """Where the library lands: keyed by its source, the shared headers
    under csrc/ and the flags, so an edit to any of them builds anew."""
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_ROOT / f"{name}-{digest}" / f"lib{name}.so"


def _start(name: str):
    out = library_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {SOURCES[name]} (exit {proc.returncode}):\n{log}")
    out.with_suffix(".ptxas.log").write_text(log)
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing


def build_all(names: Iterable[str] = tuple(SOURCES)) -> None:
    """Compile every named kernel that is not built yet, in parallel."""
    with _lock:
        started = {}
        failures = []
        try:
            for n in names:
                started[n] = _start(n)
        finally:
            # wait for every nvcc started, even when a start or a build failed
            for n, s in started.items():
                try:
                    _finish(n, s)
                except RuntimeError as e:
                    failures.append(e)
        if failures:
            raise failures[0]


def ptxas_log(name: str) -> str:
    """ptxas's report of the library's build: this process's, else the one
    saved beside the library; a library cached without one is built anew."""
    build_all([name])
    if name in build_logs:
        return build_logs[name]
    saved = library_path(name).with_suffix(".ptxas.log")
    if not saved.exists():
        with _lock:
            library_path(name).unlink(missing_ok=True)
        build_all([name])
    return saved.read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed (callers
    cache what they take from it)."""
    with tracing.span("setup.kernels"):
        build_all([name])
        return ctypes.CDLL(str(library_path(name)))
