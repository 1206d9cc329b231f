"""The check sees the faults a training cell can have: a run with the
timed path broken underneath (the harness's look for a card skipped, the
rest of the run as the benchmark drives it, at a tiny size on the CPU)
comes out not correct under the cell's limits. And the control, the
reference in float8, fails them too."""

import json
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import compare, harness
from benchmark.reference import train as ref_train
from benchmark.tests.tiny import tiny_cell

ROOT = Path(__file__).resolve().parents[2]


def _run(engine):
    res = harness.run_rank(tiny_cell(engine), 2 ** 31 + 9, 0.3, False, torch.device("cpu"))
    return compare.gaps(res.readings, res.reference), tiny_cell(engine).limits


def _plant(monkeypatch, engine, fault):
    from headct_foundation_tpu_torch.engines import dino_engine, mae_engine
    from headct_foundation_tpu_torch.models.mae import MaskedAutoencoderViT

    mod = mae_engine if engine == "mae" else dino_engine
    update = mod.apply_update
    if fault == "unchanged":  # the step returns its state unchanged
        def skip(state, *rest):
            state.optimizer.zero_grad(set_to_none=True)
            state.step += 1
            return state
        monkeypatch.setattr(mod, "apply_update", skip)
    elif fault == "altered":  # one gradient doubled where it is made
        def doubled(state, *rest):
            net = state.model if engine == "mae" else state.student
            name = ref_train.altered_leaf([n for n, _ in net.named_parameters()])
            dict(net.named_parameters())[name].grad.mul_(2.0)
            return update(state, *rest)
        monkeypatch.setattr(mod, "apply_update", doubled)
    elif fault == "half" and engine == "mae":  # the mean over half of the batch
        loss = MaskedAutoencoderViT.forward_loss

        def half(self, imgs, pred, mask, patches=slice(None)):
            h = imgs.shape[0] // 2
            return loss(self, imgs[:h], pred[:h], mask[:h], patches)
        monkeypatch.setattr(MaskedAutoencoderViT, "forward_loss", half)
    elif fault == "half":
        dino_loss = dino_engine.dino_loss

        def half(s, t, center, temp, ncrops):
            h = t.shape[0] // 4
            return dino_loss(torch.cat([c[:h] for c in s.chunk(ncrops)]),
                             torch.cat([c[:h] for c in t.chunk(2)]), center, temp, ncrops)
        monkeypatch.setattr(dino_engine, "dino_loss", half)


@pytest.mark.parametrize("engine", ["mae", "dino"])
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_planted_fault_is_not_correct(monkeypatch, engine, fault):
    _plant(monkeypatch, engine, fault)
    gaps, limits = _run(engine)
    assert not compare.verdict(gaps, limits), gaps


@pytest.mark.parametrize("engine", ["mae", "dino"])
def test_the_float8_control_is_not_correct(engine):
    cell = tiny_cell(engine)
    cfg = cell.run_config()
    raw = harness.reference(cell, cfg, 12345, torch.device("cpu"), 0, 1)
    masks = compare.nought_masks(raw["grads"])
    control = harness.reference(cell, cfg, 12345, torch.device("cpu"), 0, 1, precision="fp8")
    gaps = compare.gaps(compare.readings(control, masks), compare.readings(raw, masks))
    assert not compare.verdict(gaps, cell.limits), gaps


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("fault", ["none", "no_exchange"])
def test_the_exchange_between_ranks_left_out_is_not_correct(tmp_path, fault):
    port, out = _free_port(), tmp_path / "gaps.json"
    procs = [subprocess.Popen([sys.executable, "-m", "benchmark.tests.ddp_worker", str(r), "2",
                               str(port), fault, str(out)], cwd=ROOT) for r in range(2)]
    codes = [p.wait(timeout=600) for p in procs]
    assert codes == [0, 0]
    got = json.loads(out.read_text())
    assert got["steps"] >= 1
    ok = compare.verdict(got["gaps"], got["limits"])
    if fault == "none":
        assert all(v < 0.2 for v in got["gaps"].values()), got
    else:
        assert not ok, got
