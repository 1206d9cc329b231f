"""PyTorch port: on-device preprocessing held against the JAX package.

One synthetic scan is written with each package's ``save_nifti`` (the bytes
must match) and run through each package's ``DevicePreprocessor``: a
0.5 x 0.5 x 1.0 mm scan runs the cubic resample, a 1 mm scan the identity
skip, and a foreground in one corner makes the bbox crop act. The
background is air (-1000 HU), so the resample's ringing stays far from the
x > 0 foreground threshold in both.
"""

import numpy as np
import pytest
import torch

from headct_foundation_tpu.data.device_preprocess import DevicePreprocessor as JaxPrep
from headct_foundation_tpu.data.nifti import save_nifti as jax_save_nifti
from headct_foundation_tpu_torch.data.device_preprocess import (
    DevicePreprocessor,
    area_axis_operator,
    device_area_ops,
)
from headct_foundation_tpu_torch.data.nifti import load_nifti, load_nifti_bytes, save_nifti


def _corner_scan(integral: bool) -> np.ndarray:
    rng = np.random.RandomState(0)
    vol = np.full((44, 40, 22), -1000.0, np.float32)
    vol[:20, :17, :9] = 30.0 + 20.0 * rng.randn(20, 17, 9)  # foreground in one corner
    vol[2:6, 3:7, 1:4] = 900.0                              # a bright (bone) patch
    return np.round(vol) if integral else vol + 0.25


@pytest.mark.parametrize("spacing,integral", [((0.5, 0.5, 1.0), True),
                                              ((1.0, 1.0, 1.0), False)])
@pytest.mark.parametrize("in_chans", [3, 1])
def test_device_preprocess_matches_jax(tmp_path, spacing, integral, in_chans):
    vol = _corner_scan(integral)
    affine = np.diag(list(spacing) + [1.0])
    p_jax, p_port = str(tmp_path / "jax.nii.gz"), str(tmp_path / "port.nii.gz")
    jax_save_nifti(p_jax, vol, affine)
    save_nifti(p_port, vol, affine)
    assert load_nifti(p_port).data.tobytes() == vol.astype(np.float32).tobytes()

    want = np.asarray(JaxPrep((24, 24, 24), in_chans)(p_jax))
    prep = DevicePreprocessor((24, 24, 24), in_chans, "cpu")
    got = prep(p_port)
    assert got.shape == (in_chans, 24, 24, 24) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    # the foreground crop acted: the corner fills the ROI, so no air is left
    assert float(got[-1].min()) > 0.0
    with open(p_port, "rb") as f:  # bytes in (the server's path) == path in
        torch.testing.assert_close(prep(f.read()), got, rtol=0, atol=0)


def test_device_area_ops_match_host_operator():
    vol = torch.full((30, 20, 10), -5.0)
    vol[4:17, 2:9, 3:10] = 1.0
    ops = device_area_ops(vol, (8, 8, 8))
    for op, n, (s, e) in zip(ops, vol.shape, [(4, 17), (2, 9), (3, 10)]):
        np.testing.assert_array_equal(op.numpy(), area_axis_operator(n, s, e, 8))
    empty = device_area_ops(torch.full((6, 6, 6), -1.0), (4, 4, 4))  # keeps whole axes
    np.testing.assert_array_equal(empty[0].numpy(), area_axis_operator(6, 0, 6, 4))


def test_nifti_bytes_and_bad_input(tmp_path):
    vol = np.arange(24, dtype=np.int16).reshape(2, 3, 4)
    p = str(tmp_path / "s.nii")
    save_nifti(p, vol, dtype=np.int16)
    with open(p, "rb") as f:
        raw = f.read()
    np.testing.assert_array_equal(load_nifti_bytes(raw).data, vol.astype(np.float32))
    with pytest.raises(ValueError):
        load_nifti_bytes(b"not a nifti at all")
