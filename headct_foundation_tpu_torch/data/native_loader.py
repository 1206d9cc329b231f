"""ctypes bindings to the repository's C++ scan decoder and preprocessor.

Port of the JAX package's ``data/native_loader.py``. ``native/headct_native.cpp``
runs the whole host chain of one scan with no Python in the loop: NIfTI
decode (gzip included), RAS orientation, cubic B-spline resample to 1 mm,
foreground crop, the HU window stack and the 'area' resize to the ROI, in
float16 (or the hu16 wire's int16). The calls release the GIL, so the
loader's worker threads decode scans in parallel.

The library is compiled with ``g++`` at first use into
``<repo>/build/native/<hash of the source and the host's CPU>/`` (``.gitignore`` lists
``build/``), with the JAX loader's flags in its order (``:37-55``):
``-O3 -march=native -ffp-contract=off`` first, then the portable flags;
libdeflate first, then zlib alone. The same source built with the same
flags gives the JAX loader's bytes on the same file: decompression is
lossless and ``-ffp-contract=off`` keeps the floating-point results.
Nothing is written into ``native/``, and the library that the JAX loader
builds there is never loaded.

This is the port's one host decoder: when the library cannot be built or
loaded, the call raises with the compiler's message. It needs ``g++`` and
zlib's header (``zlib.h``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from headct_foundation_tpu_torch.data.transforms import hu8_encode, hu16_decode

_ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE = _ROOT / "native" / "headct_native.cpp"
BUILD_ROOT = _ROOT / "build" / "native"

# (codegen, inflate) flag sets in the JAX loader's order
_MARCH = (["-march=native", "-ffp-contract=off"], [])
_INFLATE = (["-ldeflate"], ["-DHEADCT_NO_LIBDEFLATE"])

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # g++ time of this process's build, if it built


def _host_tag() -> bytes:
    """The machine and CPU model: ``-march=native`` code and the libraries it
    links are the building host's."""
    model = ""
    try:
        with open("/proc/cpuinfo") as f:
            model = next((line for line in f if line.startswith("model name")), "")
    except OSError:
        pass
    return f"{platform.machine()}|{model.strip()}".encode()


def library_path() -> Path:
    """Keyed by the source and the host, so an edited source or another
    machine (another CPU for ``-march=native``, other libraries to link)
    builds anew instead of loading a library made for the first."""
    digest = hashlib.sha256(SOURCE.read_bytes() + _host_tag()).hexdigest()[:16]
    return BUILD_ROOT / digest / "libheadct_native.so"


def _build(out: Path) -> None:
    """Compile ``SOURCE`` into ``out``; raises with every attempt's message."""
    global build_seconds
    if shutil.which("g++") is None:
        raise RuntimeError("the native scan decoder needs g++ to build "
                           f"{SOURCE.relative_to(_ROOT)}; g++ was not found")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    errors: List[str] = []
    t0 = time.perf_counter()
    for march in _MARCH:
        for inflate in _INFLATE:
            cmd = ["g++", "-O3", *march, "-shared", "-fPIC", "-std=c++17",
                   str(SOURCE), "-o", str(tmp), "-lz", *inflate]
            r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
            if r.returncode == 0:
                build_seconds = time.perf_counter() - t0
                flags = ["g++", "-O3", *march, "-shared", "-fPIC", "-std=c++17", "-lz", *inflate]
                out.with_suffix(".flags").write_text(" ".join(flags) + "\n")
                os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
                return
            errors.append(f"{' '.join(cmd)}\n{r.stderr.strip()[-2000:]}")
    tmp.unlink(missing_ok=True)
    raise RuntimeError("could not build the native scan decoder "
                       "(it needs g++ and zlib's header zlib.h):\n" + "\n\n".join(errors))


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises if it cannot be."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            lib.headct_abi_version.restype = ctypes.c_int
            lib.headct_abi_version.argtypes = []
            if lib.headct_abi_version() < 4:
                raise RuntimeError(f"{path} predates the hu16 wire (ABI < 4)")
            lib.headct_preprocess_ex.restype = ctypes.c_int
            lib.headct_preprocess_ex.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint16), ctypes.c_char_p, ctypes.c_int]
            lib.headct_decode_open.restype = ctypes.c_void_p
            lib.headct_decode_open.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_double),
                ctypes.c_char_p, ctypes.c_int]
            lib.headct_decode_read.restype = ctypes.c_int
            lib.headct_decode_read.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
            lib.headct_decode_close.restype = None
            lib.headct_decode_close.argtypes = [ctypes.c_void_p]
            _lib = lib
    return _lib


def load_and_preprocess_native(path: str, roi: Sequence[int], in_channels: int,
                               order: int = 0, wire: str = "windowed") -> np.ndarray:
    """One scan -> its cached tensor.

    ``wire='windowed'``: float16 [C, *roi], order 0 the training chain
    (window before the resize), order 1 the notebook chain (resize first).
    ``'hu16'``: the int16 [1, *roi] fixed-point HU of the raw-HU resize.
    ``'hu8'``: that tensor transcoded to the uint8 codes (the 0.05-HU
    intermediate is 10x below hu8's finest step), as the JAX cache does.
    Raises RuntimeError on a decode error."""
    if wire == "hu8":
        return hu8_encode(hu16_decode(load_and_preprocess_native(path, roi, in_channels,
                                                                 wire="hu16")))
    lib = get_lib()
    r = int(roi[0])
    if any(int(x) != r for x in roi):
        raise ValueError(f"the native chain takes a cubic ROI, got {tuple(roi)}")
    if wire == "hu16":
        channels, order = 1, 2
    elif wire == "windowed":
        channels = in_channels
    else:
        raise ValueError(f"unknown wire format {wire!r}")
    out = np.empty(channels * r * r * r, dtype=np.uint16)
    err = ctypes.create_string_buffer(256)
    rc = lib.headct_preprocess_ex(os.fsencode(path), r, channels, order,
                                  out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                                  err, len(err))
    if rc != 0:
        raise RuntimeError(f"native preprocess failed for {path}: {err.value.decode()}")
    return out.view(np.int16 if wire == "hu16" else np.float16).reshape(channels, r, r, r)


def decode_native(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """NIfTI decode and RAS orientation only: (float32 [X, Y, Z] volume,
    [3, 4] affine). Feeds the on-device preprocessing. Raises RuntimeError."""
    lib = get_lib()
    shape = (ctypes.c_int * 3)()
    affine = (ctypes.c_double * 12)()
    err = ctypes.create_string_buffer(256)
    h = lib.headct_decode_open(os.fsencode(path), shape, affine, err, len(err))
    if not h:
        raise RuntimeError(f"native decode failed for {path}: {err.value.decode()}")
    try:
        vol = np.empty((shape[0], shape[1], shape[2]), dtype=np.float32)
        if lib.headct_decode_read(h, vol.ctypes.data_as(ctypes.POINTER(ctypes.c_float))) != 0:
            raise RuntimeError(f"native decode read failed for {path}")
    finally:
        lib.headct_decode_close(h)
    return vol, np.ctypeslib.as_array(affine).reshape(3, 4).copy()
