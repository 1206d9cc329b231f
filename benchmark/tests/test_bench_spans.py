"""The span reductions (``benchmark/spans.py``) on hand-built records and a
hand-built Chrome trace, against a hand count: host ms by span over the
complete steps, device ms by the launching span (the autograd thread's
launches under the loop thread's span), idle gaps by the span open when
each began, the idle share from both stretches, the all-reduce entry's
skew over ranks; the span stretches driven through the harness at a tiny
size on the CPU; the all-reduce counters' readers on two gloo ranks,
untraced, traced and with the span stretches, against ``_buckets``'
reckoning and against what the window's own epoch counted per step."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import cells, data, harness, span_run, spans, trace
from benchmark.tests.tiny import tiny_cell

ROOT = Path(__file__).resolve().parents[2]
MS = 1_000_000  # ns


def _rec(name, start, end, id_, parent=None, step=None, device=None):
    return {"name": name, "start": start * MS, "end": end * MS, "id": id_, "parent": parent,
            "step": step, "thread": 1, "device": None if device is None else device * MS}


def records():
    """Two complete steps (7, 8) after the tail of a step cut by the
    stretch's start (no step id, no ``step`` span)."""
    return [
        _rec("bwd", 0, 5, 0), _rec("update", 5, 6, 1),                    # the cut step
        _rec("augment", 11, 12, 4, parent=3, step=7),
        _rec("fwd", 12, 20, 5, parent=3, step=7),
        _rec("bwd", 20, 40, 6, parent=3, step=7),
        _rec("allreduce", 40, 45, 7, parent=3, step=7, device=100),
        _rec("optimizer", 46, 49, 9, parent=8, step=7),
        _rec("update", 45, 50, 8, parent=3, step=7),
        _rec("step", 11, 50, 3, step=7),
        _rec("drain", 50, 54, 10, step=7),
        _rec("allreduce", 90, 94, 13, parent=12, step=8, device=150),
        _rec("step", 62, 100, 12, step=8),
        _rec("augment", 110, 111, 15, parent=14, step=9),                # step 9 not finished
    ]


def test_host_ms_by_span_over_the_complete_steps():
    ms = spans.host_ms(records())
    assert ms == pytest.approx({"augment": 0.5, "fwd": 4.0, "bwd": 10.0,
                                "allreduce": 4.5, "optimizer": 1.5, "update": 2.5,
                                "step": (39 + 38) / 2, "drain": 2.0})
    assert spans.entries(records()) == {7: 100 * MS, 8: 150 * MS}
    assert spans.host_ms(records()[:2]) == {}


def test_entry_skew_is_the_median_spread_over_ranks_of_shared_steps():
    r0 = {7: 100 * MS, 8: 150 * MS, 9: 200 * MS}
    r1 = {7: 103 * MS, 8: 151 * MS, 9: 210 * MS}
    r2 = {7: 101 * MS, 8: 157 * MS}                 # step 9 not reached by every rank
    assert spans.entry_skew_ms([r0, r1, r2]) == pytest.approx((3 + 7) / 2)
    assert spans.entry_skew_ms([r0]) is None and spans.entry_skew_ms([r0, {}]) is None


def _ann(tid, ts, dur, name):
    return {"ph": "X", "cat": "user_annotation", "pid": 1, "tid": tid, "ts": ts, "dur": dur,
            "name": name}


def _op(tid, ts, dur, name):
    return {"ph": "X", "cat": "cpu_op", "pid": 1, "tid": tid, "ts": ts, "dur": dur, "name": name,
            "args": {}}


def _launch(tid, ts, corr):
    return {"ph": "X", "cat": "cuda_runtime", "pid": 1, "tid": tid, "ts": ts, "dur": 1,
            "name": "cudaLaunchKernel", "args": {"correlation": corr}}


def _kernel(ts, dur, corr, name="k"):
    return {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": ts, "dur": dur, "name": name,
            "args": {"correlation": corr}}


def chrome():
    """The loop thread 1 in ``step`` [0, 100] with ``augment`` [2, 10], ``fwd``
    [10, 40] and ``bwd`` [40, 80] (it blocks there while autograd's thread 2
    launches), then ``optimizer`` inside ``update`` [80, 95]; the
    prefetcher's thread 3; a launch after the step."""
    return [
        _ann(1, 0, 100, "step"), _ann(1, 2, 8, "augment"), _ann(1, 10, 30, "fwd"),
        _ann(1, 40, 40, "bwd"), _ann(1, 80, 15, "update"), _ann(1, 85, 8, "optimizer"),
        _ann(1, 85.5, 7, "Optimizer.step#AdamW.step"),         # torch's own: not a span
        _launch(1, 3, 1), _kernel(5, 10, 1),                   # augment  [5, 15]
        _launch(1, 12, 2), _kernel(15, 20, 2),                 # fwd      [15, 35]
        _op(2, 45, 30, "autograd::engine::evaluate_function: MmBackward0"),
        _launch(2, 50, 3), _kernel(50, 20, 3),                 # bwd      [50, 70]
        _launch(1, 86, 4), _kernel(86, 4, 4),                  # optimizer [86, 90]
        _launch(1, 96, 5), _kernel(96, 2, 5),                  # step itself [96, 98]
        _launch(3, 20, 6), _kernel(99, 1, 6),                  # (other thread) [99, 100]
        _launch(1, 105, 7), _kernel(110, 5, 7),                # (no span) [110, 115]
        _kernel(120, 5, 99),                                   # no launch: (other thread)
    ]


def test_device_ms_by_the_launching_span_and_the_autograd_thread_rule():
    ms = spans.device_ms(chrome(), steps=1)
    assert ms == pytest.approx({"augment": 0.010, "fwd": 0.020, "bwd": 0.020,
                                "optimizer": 0.004, "step": 0.002, "(other thread)": 0.006,
                                "(no span)": 0.005})


def test_idle_gaps_by_the_span_open_when_each_began():
    # busy [5, 35] [50, 70] [86, 90] [96, 98] [99, 100] [110, 115] [120, 125];
    # the gaps begin in fwd (35), bwd (70), optimizer (90), step (98), after
    # the step (100, 115)
    ms = spans.idle_ms(chrome(), steps=1)
    assert ms == pytest.approx({"fwd": 0.015, "bwd": 0.016, "optimizer": 0.006, "step": 0.001,
                                "(no span)": 0.015})
    busy_us, gaps = spans.busy_and_gaps(chrome())
    assert busy_us == pytest.approx(30 + 20 + 4 + 2 + 1 + 5 + 5) and len(gaps) == 6


def test_idle_share_and_metrics_from_every_rank():
    assert spans.idle_span_pct(95.0, 100.0) == pytest.approx(5.0)
    rank = spans.reduce_rank(records(), chrome(), 1, [_rec("setup.init_weights", 0, 9000, 0),
                                                      _rec("setup.build", 0, 1000, 1)], 50.0)
    assert rank["s_steps"] == 2 and rank["busy_ms"] == pytest.approx(0.067)
    other = dict(rank, host_ms=dict(rank["host_ms"], step=40.0, allreduce=6.5),
                 entries={7: 104 * MS, 8: 150 * MS})
    got = spans.metrics([rank, other])
    assert got == pytest.approx({"step_host_ms": (38.5 + 40.0) / 2,
                                 "allreduce_host_ms": (4.5 + 6.5) / 2, "allreduce_skew_ms": 2.0})
    one = spans.metrics([rank])
    assert one["step_host_ms"] == pytest.approx(38.5)
    assert one["init_weights_s"] == pytest.approx(9.0)
    assert one["augment_span_ms"] == pytest.approx(0.010)
    assert one["device_idle_span_pct"] == pytest.approx(100 * (1 - 0.067 / 50.0))
    assert set(one) | set(got) == set(spans.UNITS)
    # a checkout without spans reads nothing
    empty = {"host_ms": {}, "period_ms": None, "entries": {}, "device_ms": {}, "idle_ms": {},
             "busy_ms": None, "setup_s": {}}
    assert spans.metrics([empty]) == {}


def _fake_parse(events, steps):
    return {"steps": steps, "layer_ms": {}, "busy_s": 0.0, "window_s": 1.0, "idle_pct": 0.0,
            "allreduce_exposed_ms": None, "breakdown": {"device_ops": [], "idle_gaps": []}}


@pytest.mark.parametrize("engine", ["mae", "dino"])
def test_the_span_stretches_through_the_harness(monkeypatch, engine):
    """The CPU profile has no device work, which ``trace.parse`` refuses:
    it is stubbed; the stretches, their steps and the host spans are real."""
    from headct_foundation_tpu_torch.utils import tracing

    monkeypatch.setattr(trace, "parse", _fake_parse)
    monkeypatch.setattr(harness, "Tracer", span_run.SpanTracer)
    monkeypatch.setattr(data, "TimedRing", span_run.SpanRing)
    monkeypatch.setattr(span_run, "SETUP", [])
    tracing.enable()
    try:
        res = harness.run_rank(tiny_cell(engine), 2 ** 31 + 77, 0.3, True, torch.device("cpu"))
    finally:
        tracing.disable()
        tracing.take()
    sp = res.profile["spans"]
    assert sp["s_steps"] == span_run.SPAN_STEPS
    assert res.profile["stretch_steps"] == 2 * 2 + span_run.STRETCH
    assert sp["control_period_ms"] > 0
    assert {"step", "augment", "fwd", "bwd", "update", "optimizer", "drain"} <= set(
        sp["host_ms"])
    assert sp["host_ms"]["step"] > sp["host_ms"]["fwd"] + sp["host_ms"]["bwd"]
    assert len(sp["s_step_ms"]) == span_run.SPAN_STEPS and sp["period_ms"] > 0
    assert {"setup.build", "setup.init_weights", "setup.to_device", "setup.optimizer"} <= set(
        sp["setup_s"])
    assert sp["busy_ms"] is None and sp["entries"] == {}  # no card, one rank
    assert not tracing.enabled()


_WORKER = r'''
import json, sys
import torch
import torch.distributed as dist
from benchmark import cells, harness, weights
from benchmark.reference import mae as ref_mae
from benchmark.tests.tiny import tiny_cell
from headct_foundation_tpu_torch.parallel import distributed

from benchmark import span_run, trace
from headct_foundation_tpu_torch.engines import mae_engine

rank, world, out, mode = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(2)
distributed.BUCKET_BYTES = 1 << 18
epochs = []  # each train_one_epoch's stats: the compared steps', then the window's
epoch = mae_engine.train_one_epoch

def spied(*args, **kw):
    state, stats = epoch(*args, **kw)
    epochs.append(stats)
    return state, stats

mae_engine.train_one_epoch = spied
if mode != "plain":  # the CPU profile has no device work, which trace.parse refuses
    trace.parse = lambda events, steps: {
        "steps": steps, "layer_ms": {}, "busy_s": 0.0, "window_s": 1.0, "idle_pct": 0.0,
        "allreduce_exposed_ms": None, "breakdown": {"device_ops": [], "idle_gaps": []}}
if mode == "span_run":
    span_run.install()
cell = tiny_cell("mae", name="mae-vitb12.96.b64.ddp4")
cell.chips = world
distributed.init_from_env("cpu", config=harness.port_config(cell.run_config()))
group = dist.new_group(backend="gloo")

def agree(flag):
    t = torch.tensor([int(flag)])
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item())

res = harness.run_rank(cell, 2 ** 32 + 5, 0.5, mode != "plain", torch.device("cpu"), rank,
                       world, agree, lambda: dist.barrier(group=group))
record = harness.RunRecord(cell=cell, run_cfg=cell.run_config(), world=world,
                           batch=int(cell.traffic["batch"]), steps=res.steps, window_s=1.0,
                           intervals_ms=[], host_ms=[], data_time_s=0.0, peak_bytes=0,
                           setup_s=0.0, device_name="cpu", profile=res.profile)
window = epochs[-1]
trainable = weights.trainable(ref_mae.spec(cell.run_config()))  # (name, shape, ...)
buckets = distributed._buckets([torch.zeros(())] + [torch.zeros(s[1]) for s in trainable])
if rank == 0:
    json.dump({"mb": cells.reader("allreduce_mb")(record),
               "calls": cells.reader("allreduce_calls")(record),
               "want_calls": len(buckets),
               "want_bytes": sum(t.numel() * 4 for b in buckets for t in b),
               "epochs": len(epochs), "window_steps": window["steps"],
               "window_calls": window["allreduce"]["calls"] / window["steps"],
               "window_bytes": window["allreduce"]["bytes"] / window["steps"]}, open(out, "w"))
dist.destroy_process_group()
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("mode", ["plain", "traced", "span_run"])
def test_the_allreduce_counters_read_per_step_as_the_buckets_reckon(tmp_path, mode):
    """Two gloo ranks of a tiny data-parallel cell (its reference's
    exchange does not pass through the counted function): the readers'
    per-step figure, which divides the process's count by the steps it
    reckons the run took, is what the window's own epoch counted per step."""
    port, out = _free_port(), tmp_path / "out.json"
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=str(ROOT), RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE="2", MASTER_ADDR="localhost", MASTER_PORT=str(port))
        procs.append(subprocess.Popen([sys.executable, "-c", _WORKER, str(rank), "2", str(out),
                                       mode],
                                      cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(o[-3000:] for o in outs)
    got = json.loads(out.read_text())
    assert got["want_calls"] > 1 and got["epochs"] == 2
    assert got["calls"] == got["want_calls"] == got["window_calls"]
    assert got["mb"] * 1e6 == pytest.approx(got["want_bytes"], rel=1e-12)
    assert got["mb"] * 1e6 == pytest.approx(got["window_bytes"], rel=1e-12)
    if mode == "span_run":
        assert got["window_steps"] > 2 * 2 + span_run.STRETCH


def test_the_counter_readers_find_nothing_on_one_card():
    cell = cells.find("mae-vitb12.96.b64")
    record = harness.RunRecord(cell=cell, run_cfg=cell.run_config(), world=1, batch=64, steps=10,
                               window_s=1.0, intervals_ms=[], host_ms=[], data_time_s=0.0,
                               peak_bytes=0, setup_s=0.0, device_name="cpu", profile=None)
    assert cells.reader("allreduce_mb")(record) is None
    assert cells.reader("allreduce_calls")(record) is None


def test_the_last_line_adds_the_span_metrics_and_the_cost(capsys):
    from dataclasses import asdict

    rank = spans.reduce_rank(records(), chrome(), 1, [_rec("setup.init_weights", 0, 9000, 0)],
                             50.0)
    rank["control_period_ms"] = 49.0
    prof = {"steps": 2, "layer_ms": {"models": 10.0}, "busy_s": 0.03, "window_s": 0.032,
            "idle_pct": 6.25, "allreduce_exposed_ms": 1.5,
            "breakdown": {"device_ops": [], "idle_gaps": []}, "spans": rank}
    res = asdict(harness.RankResult(
        steps=20, window_s=3.0, intervals_ms=[150.0] * 20, host_ms=[20.0] * 20,
        data_time_s=0.001, peak_bytes=2 ** 34, launches={}, profile=prof,
        readings={"losses": [1.0], "grad_norms": {"a": 1.0}, "change_norms": {"a": 1.0}},
        reference={"losses": [1.0], "grad_norms": {"a": 1.0}, "change_norms": {"a": 1.0}}))
    cell = cells.find("mae-vitb12.96.b64.ddp4")
    line = span_run._result_line(cell, [res, res], 30.0, True, "NVIDIA H100 80GB HBM3", "700 W")
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert got["allreduce_exposed_ms"] == 1.5 and got["allreduce_skew_ms"] == 0.0
    assert got["step_host_ms"] == pytest.approx(38.5)
    assert line["span_cost"] == {"s_period_ms": 50.0, "window_median_ms": 150.0,
                                 "control_period_ms": 49.0}
    err = capsys.readouterr().err
    assert "span idle ms per step" in err and "rank 1: window dispatch ms 20.000" in err
    json.dumps(line)
