"""chip_fault_check.py and tools/ablate_attention_fwd.py on the CPU: every
planted fault finds its kernel and its anchor in its CUDA header, and every
ablation its text, so a refactor that moves one fails here and not in a GPU
run; and which chip_smoke cases must catch each fault.
"""

import pytest
import torch

import chip_fault_check as fc
import chip_smoke
from headct_foundation_tpu_torch.tools import ablate_attention_fwd as ab

CSRC = fc.ROOT / fc.PKG / "csrc"
_IDS = [f[0] for f in fc.FAULTS]


@pytest.mark.parametrize("fault", fc.FAULTS, ids=_IDS)
def test_fault_plants_inside_its_kernel(fault):
    _, header, kernel, anchor, line, _, _ = fault
    source = (CSRC / header).read_text()
    planted = fc.plant(source, kernel, anchor, line)
    at = planted.index(line)
    start = planted.index(kernel)
    end = planted.find("__global__", start)
    assert start < at < (len(planted) if end < 0 else end), "planted outside the kernel"
    assert planted[:at].endswith(anchor + " ")
    assert planted.replace(" " + line, "", 1) == source


def test_plant_refuses_an_anchor_outside_the_kernel():
    source = (CSRC / "flash_bwd_sm90.cuh").read_text()
    assert "neg_lse2[half] = " in source  # B5's, after B4's body ends
    with pytest.raises(ValueError):
        fc.plant(source, "\ndkv_wgmma_kernel(", "neg_lse2[half] = ", "x;")


@pytest.mark.parametrize("fault", fc.FAULTS, ids=_IDS)
def test_fault_expectations(fault):
    """A fault must be caught on each path it shows on by some bfloat16 case,
    by no float32 case, and by no case whose walk is one tile long."""
    _, _, _, _, _, paths, walked = fault
    want = fc.expected(paths, walked)
    kv = {"whole": [c[0][1] for c in chip_smoke.KERNEL_CASES],
          "blocked": [c[1] if c[2] is None else c[2] for c in chip_smoke.BLOCKED_CASES]}
    shapes = {"whole": [c[0] for c in chip_smoke.KERNEL_CASES],
              "blocked": [c[0] for c in chip_smoke.BLOCKED_CASES]}
    dtypes = {"whole": [c[1] for c in chip_smoke.KERNEL_CASES],
              "blocked": [c[3] for c in chip_smoke.BLOCKED_CASES]}
    for path in ("whole", "blocked"):
        assert len(want[path]) == len(dtypes[path])
        assert any(want[path]) == (path in paths)
        for w, dtype, shape, n in zip(want[path], dtypes[path], shapes[path], kv[path]):
            if dtype == torch.float32 or walked(shape, n) == 1:
                assert not w
    if "whole" in paths:  # bf16 (2, 9, 3, 12) walks a single key tile
        at = [c[:2] for c in chip_smoke.KERNEL_CASES].index(((2, 9, 3, 12), torch.bfloat16))
        assert not want["whole"][at]


@pytest.mark.parametrize("name", list(ab.ABLATIONS))
def test_ablation_edits_apply(name):
    source = (CSRC / "flash_fwd_sm90.cuh").read_text()
    edited = ab.ablate(source, ab.ABLATIONS[name])
    assert (edited == source) == (name == "none")
    with pytest.raises(ValueError):
        ab.ablate(edited, [("no such text", "")])


def test_ablations_need_cuda():
    if torch.cuda.is_available():
        pytest.skip("runs where there is no CUDA card")
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        ab.run()
