"""The counting functions against a hand count at the published widths and
against ``torch.utils.flop_counter.FlopCounterMode`` on the reference."""

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import cells, counts
from benchmark.reference import dino as ref_dino
from benchmark.reference import mae as ref_mae
from benchmark.tests.tiny import tiny_cell

# one volume's forward at 96^3 (ViT-B/12, patch 12: 512 patches of 5184 voxels)
PATCH = 2 * 512 * 5184 * 768                                   # 4,076,863,488
BLOCK_LINEARS = 3 * 768 * 768 + 768 * 768 + 2 * 768 * 3072     # 7,077,888 multiply-adds a token
MAE_96 = (PATCH
          + 12 * (2 * 129 * BLOCK_LINEARS + 4 * 129 * 129 * 768)   # encoder on 128 kept + CLS
          + 2 * 129 * 768 * 768                                    # decoder embedding
          + 8 * (2 * 513 * BLOCK_LINEARS + 4 * 513 * 513 * 768)    # decoder on 512 + CLS
          + 2 * 513 * 768 * 5184)                                  # voxel head
DINO_CROP = (PATCH
             + 12 * (2 * 517 * BLOCK_LINEARS + 4 * 517 * 517 * 768)   # 512 + CLS + 4 registers
             + 2 * (768 * 2048 + 2048 * 2048 + 2048 * 256 + 256 * 65536))


def test_mae_flops_at_the_published_widths():
    cfg = cells.find("mae-vitb12.96.b64").run_config()
    assert MAE_96 == 95_403_405_312
    assert counts.forward_flops_per_volume("mae", cfg)["trained"] == MAE_96
    assert counts.model_flops_per_volume("mae", cfg) == 3 * MAE_96


def test_dino_flops_at_the_published_widths():
    cfg = cells.find("dino-vitb12.96.b64").run_config()
    assert DINO_CROP == 101_798_776_832
    # 4 crops through the student (forward and backward), 2 through the teacher
    assert counts.model_flops_per_volume("dino", cfg) == 3 * 4 * DINO_CROP + 2 * DINO_CROP


def test_mae_192_counts_the_longer_sequences():
    cfg = cells.find("mae-vitb12.192.b8").run_config()
    f = (2 * 4096 * 5184 * 768 + 12 * (2 * 1025 * BLOCK_LINEARS + 4 * 1025 ** 2 * 768)
         + 2 * 1025 * 768 * 768 + 8 * (2 * 4097 * BLOCK_LINEARS + 4 * 4097 ** 2 * 768)
         + 2 * 4097 * 768 * 5184)
    assert counts.forward_flops_per_volume("mae", cfg)["trained"] == f


def test_attention_work_of_one_decoder_call():
    B, H, T, D = 64, 16, 513, 48
    q = B * H * T * D * 2            # one bf16 operand
    lse = B * H * T * 4
    flops, nbytes = counts.attention_work((B, H, T, T, D, True))
    assert flops == 14 * B * H * T * T * D
    assert nbytes == (4 * q + lse) + (8 * q + lse)
    peak = counts.PEAKS["NVIDIA H100 80GB HBM3"]
    assert counts.attention_bound_s([(B, H, T, T, D, True)], peak) == max(
        flops / 989e12, nbytes / 3.35e12)


def test_attention_calls_follow_the_cells():
    mae = counts.attention_calls("mae", cells.find("mae-vitb12.96.b64").run_config(), 64)
    assert mae.count((64, 12, 129, 129, 64, True)) == 12
    assert mae.count((64, 16, 513, 513, 48, True)) == 8
    dino = counts.attention_calls("dino", cells.find("dino-vitb12.96.b64").run_config(), 64)
    assert dino.count((256, 12, 517, 517, 64, True)) == 12
    assert dino.count((128, 12, 517, 517, 64, False)) == 12


def _counted(fn) -> int:
    mode = FlopCounterMode(display=False)
    with mode:
        fn()
    return mode.get_total_flops()


@pytest.mark.parametrize("engine", ["mae", "dino"])
def test_counts_equal_the_flop_counter_on_the_reference(engine):
    cell = tiny_cell(engine)
    cfg = cell.run_config()
    batch = 3
    torch.manual_seed(0)
    model = ref_mae if engine == "mae" else ref_dino
    P = {n: torch.randn(shape) * 0.02 for n, shape, _ in model.spec(cfg)}
    P.update(model.frozen(cfg, "cpu"))
    for p in P.values():
        p.requires_grad_(True)
    size = int(cell.traffic["input_size"])
    per_volume = counts.forward_flops_per_volume(engine, cfg)
    if engine == "mae":
        L = (size // 12) ** 3
        wire = torch.randint(-8000, 20000, (batch, 1, size, size, size), dtype=torch.int16)
        draw = {"noise": torch.rand(batch, L),
                "augment": {"flip": torch.zeros(3, batch, dtype=torch.bool),
                            "shift": torch.zeros(batch), "shift_on": torch.zeros(batch, dtype=torch.bool)}}
        forward = _counted(lambda: ref_mae.loss(P, wire, draw, cfg))
        assert forward == batch * per_volume["trained"]
        both = _counted(lambda: ref_mae.loss(P, wire, draw, cfg).backward())
    else:
        crops = torch.rand(4 * batch, 3, size, size, size)
        teacher = _counted(lambda: ref_dino.network(P, crops[:2 * batch], cfg, "float32").detach())
        student = _counted(lambda: ref_dino.network(P, crops, cfg, "float32"))
        assert teacher == batch * per_volume["teacher"]
        assert student == batch * per_volume["trained"]
        both = teacher + _counted(lambda: ref_dino.network(P, crops, cfg, "float32").sum().backward())
    # the backward needs at most twice the forward (no input gradient of the image)
    assert both <= batch * counts.model_flops_per_volume(engine, cfg)


def test_no_share_can_pass_100_percent_from_a_miscount():
    """The attention bound counts no more than the work the model's own
    count holds for attention."""
    cfg = cells.find("mae-vitb12.96.b64").run_config()
    calls = counts.attention_calls("mae", cfg, 64)
    attn = sum(4.0 * B * H * tq * tk * D for B, H, tq, tk, D, _ in calls)
    assert math.isclose(attn / 64, 12 * 4 * 129 ** 2 * 768 + 8 * 4 * 513 ** 2 * 768)
