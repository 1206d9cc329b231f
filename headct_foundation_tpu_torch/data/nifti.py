"""Minimal pure-numpy NIfTI-1 reader with RAS reorientation.

Replaces the reference's MONAI ``LoadImaged`` + ``Orientationd`` (reference:
src/data/transforms.py:139-152), which wrap nibabel/ITK C extensions; neither
is available in this environment, and the needed subset — parse a NIfTI-1
header, apply scl slope/inter, compute the affine, reorient to RAS — is small
and self-contained.

Format reference: the public NIfTI-1 specification (nifti1.h field offsets).
Supports .nii and .nii.gz, all common datatypes, sform/qform/pixdim affines.

The PyTorch port's own copy of the JAX package's ``data/nifti.py`` (numpy
only), plus ``load_nifti_bytes`` so the embedding server decodes a request
body in memory.
"""

from __future__ import annotations

import gzip
import struct
from typing import Optional, Tuple

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}


class NiftiImage:
    def __init__(self, data: np.ndarray, affine: np.ndarray, header: dict):
        self.data = data
        self.affine = affine
        self.header = header

    @property
    def spacing(self) -> np.ndarray:
        """Voxel spacing per spatial axis, derived from the affine."""
        return np.linalg.norm(self.affine[:3, :3], axis=0)


def _quaternion_to_affine(b, c, d, qfac, pixdim, offsets) -> np.ndarray:
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    R = np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * b * c - 2 * a * d, 2 * b * d + 2 * a * c],
            [2 * b * c + 2 * a * d, a * a + c * c - b * b - d * d, 2 * c * d - 2 * a * b],
            [2 * b * d - 2 * a * c, 2 * c * d + 2 * a * b, a * a + d * d - c * c - b * b],
        ]
    )
    R = R @ np.diag([pixdim[0], pixdim[1], pixdim[2] * qfac])
    aff = np.eye(4)
    aff[:3, :3] = R
    aff[:3, 3] = offsets
    return aff


def load_nifti(path: str, dtype: Optional[np.dtype] = np.float32) -> NiftiImage:
    """Read a .nii / .nii.gz file into (data, affine)."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read()
    return _parse(raw, str(path), dtype)


def load_nifti_bytes(blob: bytes, dtype: Optional[np.dtype] = np.float32) -> NiftiImage:
    """Decode the bytes of a .nii or .nii.gz file (gzip told by its magic)."""
    raw = gzip.decompress(blob) if blob[:2] == b"\x1f\x8b" else blob
    return _parse(raw, "<bytes>", dtype)


def _parse(raw: bytes, path: str, dtype: Optional[np.dtype]) -> NiftiImage:
    if len(raw) < 348:
        raise ValueError(f"{path}: too short for a NIfTI-1 header ({len(raw)} bytes)")
    sizeof_hdr = struct.unpack_from("<i", raw, 0)[0]
    if sizeof_hdr != 348:
        # try big endian
        if struct.unpack_from(">i", raw, 0)[0] == 348:
            end = ">"
        else:
            raise ValueError(f"{path}: not a NIfTI-1 file (sizeof_hdr={sizeof_hdr})")
    else:
        end = "<"

    dim = struct.unpack_from(f"{end}8h", raw, 40)
    ndim = dim[0]
    shape = tuple(max(int(d), 1) for d in dim[1 : 1 + max(ndim, 3)])
    datatype = struct.unpack_from(f"{end}h", raw, 70)[0]
    pixdim = struct.unpack_from(f"{end}8f", raw, 76)
    vox_offset = int(struct.unpack_from(f"{end}f", raw, 108)[0])
    scl_slope = struct.unpack_from(f"{end}f", raw, 112)[0]
    scl_inter = struct.unpack_from(f"{end}f", raw, 116)[0]
    qform_code = struct.unpack_from(f"{end}h", raw, 252)[0]
    sform_code = struct.unpack_from(f"{end}h", raw, 254)[0]
    quatern = struct.unpack_from(f"{end}3f", raw, 256)
    qoffset = struct.unpack_from(f"{end}3f", raw, 268)
    srow = np.array(
        [
            struct.unpack_from(f"{end}4f", raw, 280),
            struct.unpack_from(f"{end}4f", raw, 296),
            struct.unpack_from(f"{end}4f", raw, 312),
        ]
    )
    magic = raw[344:348]
    if magic[:3] not in (b"n+1", b"ni1"):
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

    np_dtype = _DTYPES.get(datatype)
    if np_dtype is None:
        raise ValueError(f"{path}: unsupported NIfTI datatype code {datatype}")

    count = int(np.prod(shape))
    data = np.frombuffer(
        raw, dtype=np.dtype(np_dtype).newbyteorder(end), count=count, offset=vox_offset
    ).reshape(shape, order="F")

    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        data = data.astype(np.float32) * slope + scl_inter
    if dtype is not None:
        data = np.ascontiguousarray(data.astype(dtype))

    if sform_code > 0:
        affine = np.eye(4)
        affine[:3, :] = srow
    elif qform_code > 0:
        qfac = -1.0 if pixdim[0] < 0 else 1.0
        affine = _quaternion_to_affine(*quatern, qfac, pixdim[1:4], qoffset)
    else:
        affine = np.diag([pixdim[1], pixdim[2], pixdim[3], 1.0])

    header = {
        "shape": shape,
        "datatype": datatype,
        "pixdim": pixdim[1:4],
        "sform_code": sform_code,
        "qform_code": qform_code,
    }
    return NiftiImage(data, affine, header)


def save_nifti(
    path: str,
    data: np.ndarray,
    affine: Optional[np.ndarray] = None,
    dtype: np.dtype = np.float32,
    scl_slope: float = 1.0,
    scl_inter: float = 0.0,
) -> None:
    """Write a minimal NIfTI-1 file (sform affine). For tests/tools.

    ``dtype`` may be float32 or int16 (the common stored type of real CT,
    usually with scl_slope/scl_inter rescaling to HU). With int16, ``data``
    must be the STORED values (pre-rescale): readers return
    ``stored * scl_slope + scl_inter``, so HU floats must be inverse-scaled
    by the caller first — values that don't round-trip raise instead of
    silently truncating/wrapping."""
    if affine is None:
        affine = np.eye(4)
    dtype = np.dtype(dtype)
    codes = {np.dtype(np.float32): (16, 32), np.dtype(np.int16): (4, 16)}
    assert dtype in codes, f"unsupported save dtype {dtype}"
    datatype, bitpix = codes[dtype]
    data = np.asarray(data)
    if dtype == np.int16:
        stored = data.astype(np.int16)
        if not np.array_equal(stored.astype(data.dtype), data):
            raise ValueError(
                "save_nifti(dtype=int16) expects STORED integer values "
                "representable in int16 (readers apply scl_slope/scl_inter); "
                "inverse-rescale first: stored = (hu - scl_inter) / scl_slope"
            )
        data = stored
    else:
        data = data.astype(dtype)
    ndim = data.ndim
    dim = [ndim] + list(data.shape) + [1] * (7 - ndim)
    header = bytearray(352)  # 348 header + 4 pad to vox_offset 352
    struct.pack_into("<i", header, 0, 348)
    struct.pack_into("<8h", header, 40, *dim)
    struct.pack_into("<h", header, 70, datatype)
    struct.pack_into("<h", header, 72, bitpix)
    spacing = np.linalg.norm(affine[:3, :3], axis=0)
    struct.pack_into("<8f", header, 76, 1.0, *spacing, *([1.0] * (7 - 3)))
    struct.pack_into("<f", header, 108, 352.0)  # vox_offset
    struct.pack_into("<f", header, 112, scl_slope)
    struct.pack_into("<f", header, 116, scl_inter)
    struct.pack_into("<h", header, 254, 1)  # sform_code
    struct.pack_into("<4f", header, 280, *affine[0])
    struct.pack_into("<4f", header, 296, *affine[1])
    struct.pack_into("<4f", header, 312, *affine[2])
    header[344:348] = b"n+1\x00"

    payload = bytes(header) + np.asfortranarray(data).tobytes(order="F")
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(payload)


def orientation_ras(data: np.ndarray, affine: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Reorient a 3D volume (+affine) to RAS axis codes.

    Equivalent to MONAI/nibabel ``Orientation(axcodes='RAS')``: find, for each
    output axis, the input axis whose direction cosine dominates it, flip
    where negative, and permute.
    """
    assert data.ndim >= 3
    R = affine[:3, :3]
    # for each input axis j, the world axis it most aligns with
    best = np.argmax(np.abs(R), axis=0)  # world axis per input axis
    assert len(set(best.tolist())) == 3, f"degenerate affine {R}"
    flips = [np.sign(R[best[j], j]) for j in range(3)]

    # apply flips on input axes with negative direction
    out = data
    new_affine = affine.copy()
    for j in range(3):
        if flips[j] < 0:
            out = np.flip(out, axis=j)
            # translate origin to the other end of the axis
            new_affine[:3, 3] = new_affine[:3, 3] + new_affine[:3, j] * (data.shape[j] - 1)
            new_affine[:3, j] = -new_affine[:3, j]

    # permute so input axis order maps to world (R, A, S)
    perm = [int(np.where(best == world)[0][0]) for world in range(3)]
    out = np.transpose(out, perm + list(range(3, data.ndim)))
    perm_affine = np.eye(4)
    perm_affine[:3, :3] = new_affine[:3, :3][:, perm]
    perm_affine[:3, 3] = new_affine[:3, 3]
    return np.ascontiguousarray(out), perm_affine
