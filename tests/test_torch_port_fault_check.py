"""chip_fault_check.py and tools/ablate_attention_{fwd,bwd}.py on the CPU:
every planted fault finds its kernel and its anchor in its CUDA header, and
every ablation its text, so a refactor that moves one fails here and not in
a GPU run; and which chip_smoke cases must catch each fault.
"""

import pytest
import torch

import chip_fault_check as fc
import chip_smoke
from headct_foundation_tpu_torch.tools import ablate_attention_bwd as ab_bwd
from headct_foundation_tpu_torch.tools import ablate_attention_fwd as ab

CSRC = fc.ROOT / fc.PKG / "csrc"
_IDS = [f[0] for f in fc.FAULTS]


@pytest.mark.parametrize("fault", fc.FAULTS, ids=_IDS)
def test_fault_plants_inside_its_kernel(fault):
    _, header, kernel, anchor, line, *_ = fault
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
    """A fault must be caught on each path it shows on by some case of the
    faulty kernel's dtype, by no case of the other dtype, and by no case
    whose walk is one tile long."""
    _, _, _, _, _, paths, walked, faulty = fault
    want = fc.expected(paths, walked, faulty)
    cases = {"whole": chip_smoke.KERNEL_CASES, "whole_bwd": chip_smoke.BWD_CASES}
    kv = {p: [c[0][1] for c in cases[p]] for p in cases}
    shapes = {p: [c[0] for c in cases[p]] for p in cases}
    dtypes = {p: [c[1] for c in cases[p]] for p in cases}
    kv["blocked"] = [c[1] if c[2] is None else c[2] for c in chip_smoke.BLOCKED_CASES]
    shapes["blocked"] = [c[0] for c in chip_smoke.BLOCKED_CASES]
    dtypes["blocked"] = [c[3] for c in chip_smoke.BLOCKED_CASES]
    assert set(want) == set(fc.PATHS) == set(dtypes)
    for path in fc.PATHS:
        assert len(want[path]) == len(dtypes[path])
        assert any(want[path]) == (path in paths)
        for w, dtype, shape, n in zip(want[path], dtypes[path], shapes[path], kv[path]):
            if dtype != faulty or walked(shape, n) == 1:
                assert not w
    if "whole" in paths:  # (2, 9, 3, 12) walks a single key tile
        at = [c[:2] for c in chip_smoke.KERNEL_CASES].index(((2, 9, 3, 12), faulty))
        assert not want["whole"][at]


@pytest.mark.parametrize("fault", [f for f in fc.FAULTS if "whole_bwd" in f[5]],
                         ids=[f[0] for f in fc.FAULTS if "whole_bwd" in f[5]])
def test_backward_faults_shown_by_the_whole_sequence_cases(fault):
    """B4's and B5's planted faults, which B2 runs too, must be caught by the
    MAE decoder's bf16 case and by the block edges from T = 65 on, and by
    none of T = 63, 64 (one walked tile)."""
    want = fc.expected(*fault[5:])["whole_bwd"]
    at = {c[:2]: w for c, w in zip(chip_smoke.BWD_CASES, want)}
    bf16 = torch.bfloat16
    assert at[(chip_smoke.MAE_DECODER, bf16)] and at[((2, 513, 2, 48), bf16)]
    assert at[((2, 65, 2, 48), bf16)] and at[((2, 129, 3, 64), bf16)]
    assert not at[((2, 63, 2, 48), bf16)] and not at[((2, 64, 2, 48), bf16)]
    assert not at[(chip_smoke.MAE_DECODER, torch.float32)]


@pytest.mark.parametrize("name", list(ab.ABLATIONS))
def test_ablation_edits_apply(name):
    source = (CSRC / "flash_fwd_sm90.cuh").read_text()
    edited = ab.ablate(source, ab.ABLATIONS[name])
    assert (edited == source) == (name == "none")
    with pytest.raises(ValueError):
        ab.ablate(edited, [("no such text", "")])


@pytest.mark.parametrize("name", list(ab.F32_ABLATIONS))
def test_float32_ablation_edits_apply(name):
    """Each float32 ablation finds its texts in its headers (the exponentials
    in the softmax shared with the bfloat16 kernel) and keeps the
    parentheses balanced."""
    edits = ab.by_header(ab.F32_ABLATIONS[name])
    assert set(edits) <= {ab.HEADER, ab.F32_HEADER}
    changed = False
    for header, header_edits in edits.items():
        source = (fc.ROOT / fc.PKG / header).read_text()
        edited = ab.ablate(source, header_edits)
        changed |= edited != source
        assert edited.count("(") - edited.count(")") == source.count("(") - source.count(")")
    assert changed == (name != "none")


def test_ablations_need_cuda():
    if torch.cuda.is_available():
        pytest.skip("runs where there is no CUDA card")
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        ab.run()
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        ab.run("float32")


@pytest.mark.parametrize("name", list(ab_bwd.ABLATIONS))
def test_backward_ablation_edits_apply(name):
    source = (CSRC / "flash_bwd_sm90.cuh").read_text()
    edited = ab_bwd.ablate(source, ab_bwd.ABLATIONS[name])
    assert (edited == source) == (name == "none")
    # each edit leaves the parentheses as balanced as they were
    assert edited.count("(") - edited.count(")") == source.count("(") - source.count(")")
    with pytest.raises(ValueError):
        ab_bwd.ablate(edited, [("no such text", "")])


def test_backward_ablations_need_cuda():
    if torch.cuda.is_available():
        pytest.skip("runs where there is no CUDA card")
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        ab_bwd.run()


def test_float32_forward_fault_shown_by_the_float32_cases():
    """The float32 forward's planted fault must be caught by the serving
    case, by T = 65, 128 and 129 (two walked 64-key tiles) and T = 33 at
    head dim 128 (two 32-key tiles), and by the blocked float32 cases, and by
    none of T = 63, 64 or 32 at head dim 128 (one walked tile), and by no
    whole-sequence backward case (B2 is held on the kernel forward's own o,
    lse)."""
    fault = next(f for f in fc.FAULTS if f[7] == torch.float32)
    want = fc.expected(*fault[5:])
    at = {c[:2]: w for c, w in zip(chip_smoke.KERNEL_CASES, want["whole"])}
    f32 = torch.float32
    assert at[(chip_smoke.SERVING, f32)] and at[((2, 65, 2, 48), f32)]
    assert at[((2, 128, 2, 64), f32)] and at[((2, 129, 2, 64), f32)]
    assert at[((2, 33, 2, 128), f32)] and at[((2, 129, 3, 64), f32)]
    assert not at[((2, 63, 2, 48), f32)] and not at[((2, 64, 2, 48), f32)]
    assert not at[((2, 32, 2, 128), f32)] and not at[((2, 9, 3, 12), f32)]
    assert not any(want["whole_bwd"])
    blocked = [w for c, w in zip(chip_smoke.BLOCKED_CASES, want["blocked"]) if c[3] == f32]
    assert blocked and all(blocked)
