"""PyTorch port: the spans of ``utils/tracing.py`` and the all-reduce counters.

* Off (the default) ``span`` returns one shared no-op object: a MAE epoch
  opens no span, reads no span clock, enters no ``record_function`` and
  leaves no record.
* On, tiny MAE and DINO epochs of 9 steps record exactly the span tree the
  port documents (the downstream loop its ``step`` and ``drain``): per step
  one ``step`` at the top; in ``step`` the windowing's ``augment``, then per
  micro-batch ``augment``, ``fwd`` and ``bwd``, then ``update`` holding
  ``optimizer``; ``drain`` after the eighth step and at the end; every step
  id ``state.step`` at the step's entry; a child inside its parent's
  interval.
* Losses and parameters are bit-equal with spans on and off.
* ``data_time`` is the wait on the loader, outside the ``step`` span, and
  ``iter_time`` holds both.
* A span nests in the one open on its thread and takes its step id; only
  ``allreduce`` records a CUDA event, and only while spans are on.
* Under ``torch.profiler`` spans appear as ``user_annotation`` ranges.
* Two gloo processes count ``all_reduce_sum_.calls`` and ``.bytes`` as
  ``_buckets`` reckons them (``BUCKET_BYTES`` made small), report them in the
  epoch's stats, and open one ``allreduce`` span per step inside ``step``.
"""

import json
import os
import socket
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from headct_foundation_tpu_torch.config import default_config
from headct_foundation_tpu_torch.data.transforms import hu16_encode
from headct_foundation_tpu_torch.engines import dino_engine, downstream_engine, mae_engine
from headct_foundation_tpu_torch.utils import tracing

ROOT = Path(__file__).resolve().parent.parent
MAE_TINY = ["MAE.INPUT_SIZE", 24, "MAE.PATCH_SIZE", 12, "MAE.IN_CHANS", 3,
            "MAE.ENCODER_DEPTH", 1, "MAE.ENCODER_EMBED_DIM", 24, "MAE.ENCODER_MLP_DIM", 48,
            "MAE.ENCODER_NUM_HEADS", 2, "MAE.DECODER_DEPTH", 1, "MAE.DECODER_EMBED_DIM", 24,
            "MAE.DECODER_MLP_DIM", 48, "MAE.DECODER_NUM_HEADS", 2, "MAE.POS_EMBED", "sincos",
            "MODEL.ROI", [24, 24, 24], "DATA.WIRE_FORMAT", "hu16", "TRAIN.OPTIMIZER", "AdamW",
            "TRAIN.BASE_LR", 1e-3, "TRAIN.MIN_LR", 1e-6, "TRAIN.GRAD_CLIP", 1.0]
VIT_TINY = ["MODEL.ROI", [24, 24, 24], "MODEL.IN_CHANS", 3, "VIT.INPUT_SIZE", 24,
            "VIT.PATCH_SIZE", 12, "VIT.IN_CHANS", 3, "VIT.HIDDEN_SIZE", 24, "VIT.MLP_DIM", 48,
            "VIT.NUM_LAYERS", 1, "VIT.NUM_HEADS", 2, "VIT.NUM_REGISTER_TOKENS", 2,
            "VIT.POS_EMBED", "sincos", "TRAIN.OPTIMIZER", "AdamW", "DATA.WIRE_FORMAT", "hu16"]
DINO_TINY = VIT_TINY + ["DINO.HEAD_N_PROTOTYPES", 32, "DINO.HEAD_HIDDEN_DIM", 32,
                        "DINO.BOTTLENECK_DIM", 16, "DINO.LOCAL_CROP_NUM", 2, "DINO.USE_BN", False,
                        "TRAIN.MAX_EPOCHS", 2, "TRAIN.GRAD_CLIP", 1.0, "TRAIN.BASE_LR", 1e-3,
                        "TRAIN.MIN_LR", 1e-6]
STEPS, START = 9, 1000  # 9 steps from state.step 1000: drains after the 8th and at the end


def _wires(k: int, batch: int = 2, seed: int = 7) -> list:
    rng = np.random.RandomState(seed)
    return [hu16_encode(rng.uniform(-1000, 1500, (batch, 1, 24, 24, 24))) for _ in range(k)]


def _epoch(engine: str, accum: int = 1, loader=None):
    """A tiny epoch of ``STEPS`` steps: (state, stats, records taken)."""
    cfg = default_config()
    if engine == "mae":
        cfg.merge_from_list(MAE_TINY)
        state, _ = mae_engine.create_train_state(cfg, 2 * START, 0, seed=3, device="cpu")
        step = mae_engine.make_train_step(augment=True, accum_steps=accum, config=cfg)
        mod = mae_engine
    else:
        cfg.merge_from_list(DINO_TINY + ["TRAIN.ACCUM_STEPS", accum])
        state = dino_engine.create_train_state(cfg, 2 * START, 0, 2 * START, seed=3, device="cpu")
        step = dino_engine.make_train_step(cfg)
        mod = dino_engine
    tracing.take()  # the set-up's spans
    state.step = START
    state, stats = mod.train_one_epoch(cfg, state, step, loader or _wires(STEPS), 5, 0, 2)
    return state, stats, tracing.take()


@pytest.fixture
def spans_on():
    tracing.take()
    tracing.enable()
    try:
        yield
    finally:
        tracing.disable()
        tracing.take()


def test_off_span_is_one_shared_noop_and_a_step_records_nothing(monkeypatch):
    assert not tracing.enabled()
    assert tracing.span("step", 3) is tracing.span("fwd") is tracing.OFF
    with tracing.span("fwd") as got:
        assert got is None

    def refused(*a, **k):
        raise AssertionError("a span did work while spans were off")

    monkeypatch.setattr(tracing, "_Span", refused)
    monkeypatch.setattr(tracing, "Record", refused)
    monkeypatch.setattr(torch.profiler, "record_function", refused)
    state, stats, records = _epoch("mae")
    assert records == [] and state.step == START + STEPS and stats["steps"] == STEPS


def _tree(records):
    by_id = {r.id: r for r in records}
    for r in records:
        if r.parent is not None:
            p = by_id[r.parent]
            assert p.start <= r.start <= r.end <= p.end, (r, p)
            assert r.step == p.step, (r, p)
    return by_id


@pytest.mark.parametrize("engine,accum", [("mae", 1), ("mae", 2), ("dino", 1)])
def test_on_an_epoch_records_exactly_the_span_tree(spans_on, engine, accum):
    state, stats, records = _epoch(engine, accum)
    assert state.step == START + STEPS and stats["steps"] == STEPS
    by_id = _tree(records)
    assert {r.thread for r in records} == {records[0].thread}  # all on the loop's thread
    top = [r for r in records if r.parent is None]
    assert Counter(r.name for r in top) == {"step": STEPS, "drain": 2}
    assert [r.step for r in top if r.name == "step"] == list(range(START, START + STEPS))
    assert [r.step for r in top if r.name == "drain"] == [START + 7, START + STEPS - 1]
    steps = sorted((r for r in top if r.name == "step"), key=lambda r: r.start)
    for s in steps:
        kids = sorted((r for r in records if r.parent == s.id), key=lambda r: r.start)
        want = ["augment"] + ["augment", "fwd", "bwd"] * accum + ["update"]
        assert [k.name for k in kids] == want
        update = kids[-1]
        assert [r.name for r in records if r.parent == update.id] == ["optimizer"]
        assert all(r.step == s.step for r in kids)
    assert not any(r.name == "allreduce" for r in records)  # one process exchanges nothing
    assert set(by_id) == {r.id for r in records}


@pytest.mark.parametrize("engine", ["mae", "dino"])
def test_losses_and_parameters_are_bit_equal_with_spans_on_and_off(engine):
    runs = []
    for on in (False, True):
        if on:
            tracing.enable()
        try:
            state, stats, records = _epoch(engine)
        finally:
            tracing.disable()
        assert bool(records) == on
        model = state.model if engine == "mae" else state.student
        runs.append((stats["loss"], {k: v.clone() for k, v in model.state_dict().items()}))
    (loss_off, params_off), (loss_on, params_on) = runs
    assert loss_on == loss_off
    assert all(torch.equal(params_on[k], params_off[k]) for k in params_off)


def test_the_downstream_loop_records_step_and_drain(spans_on):
    cfg = default_config()
    cfg.merge_from_list(VIT_TINY + ["DATA.NUM_CLASSES", 2])
    state = downstream_engine.create_train_state(cfg, 2 * START, 0, seed=3, dtype=torch.float32,
                                                 device="cpu")
    step = downstream_engine.make_train_step(cfg, compute_dtype=torch.float32)
    tracing.take()
    state.step = START
    loader = [(w, np.array([0, 1]), ["a", "b"]) for w in _wires(STEPS)]
    state, stats = downstream_engine.train_one_epoch(cfg, state, step, loader, 5, 0, 1)
    records = tracing.take()
    _tree(records)
    top = [r for r in records if r.parent is None]
    assert Counter(r.name for r in top) == {"step": STEPS, "drain": 2}
    assert [r.step for r in top if r.name == "step"] == list(range(START, START + STEPS))
    assert [r.step for r in top if r.name == "drain"] == [START + 7, START + STEPS - 1]
    assert stats["allreduce"] == {"calls": 0, "bytes": 0} and stats["steps"] == STEPS


class _SlowLoader:
    """Batches that each take ``delay`` seconds to come."""

    def __init__(self, wires, delay):
        self.wires, self.delay = wires, delay

    def __iter__(self):
        for w in self.wires:
            time.sleep(self.delay)
            yield w


def test_data_time_is_the_wait_on_the_loader_outside_the_step(spans_on):
    _, stats, records = _epoch("mae", loader=_SlowLoader(_wires(STEPS), 0.02))
    assert 0.02 <= stats["data_time"] < stats["iter_time"]
    steps = sorted((r for r in records if r.name == "step"), key=lambda r: r.start)
    assert len(steps) == STEPS
    step_s = np.mean([r.end - r.start for r in steps]) / 1e9
    assert step_s + stats["data_time"] <= stats["iter_time"]
    gaps = [(b.start - a.end) / 1e9 for a, b in zip(steps, steps[1:])]
    assert min(gaps) >= 0.02  # the loader's wait lies between two steps


def test_a_span_nests_in_the_open_one_and_takes_its_step(spans_on):
    with tracing.span("step", 5) as outer:
        with tracing.span("fwd") as inner:
            pass
    with tracing.span("drain") as alone:
        pass
    assert [r.name for r in tracing.take()] == ["fwd", "step", "drain"]
    assert inner.parent == outer.id and inner.step == 5 and inner.event is None
    assert alone.parent is None and alone.step is None
    assert tracing.take() == []
    assert tracing.calibrate() is None  # no CUDA device here


class _Event:
    def __init__(self, enable_timing=False):
        self.recorded = False

    def record(self):
        self.recorded = True


def test_only_the_allreduce_span_records_an_event_and_only_while_on(monkeypatch):
    monkeypatch.setattr(tracing, "_cuda_ready", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    with tracing.span("allreduce") as off:
        pass
    assert off is None and tracing.take() == []
    tracing.enable()
    try:
        with tracing.span("step", 2):
            with tracing.span("allreduce") as ar:
                pass
    finally:
        tracing.disable()
    got = {r.name: r for r in tracing.take()}
    assert got["allreduce"] is ar and isinstance(ar.event, _Event) and ar.event.recorded
    assert got["step"].event is None and ar.step == 2


def test_spans_are_user_annotations_under_the_profiler(spans_on):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.span("step", 0):
            with tracing.span("fwd"):
                torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert {"step", "fwd"} <= names
    assert {r.name for r in tracing.take()} == {"step", "fwd"}


_DP_WORKER = r'''
import json, sys
import numpy as np, torch
from headct_foundation_tpu_torch.config import default_config
from headct_foundation_tpu_torch.data.transforms import hu16_encode
from headct_foundation_tpu_torch.engines import mae_engine
from headct_foundation_tpu_torch.parallel import distributed
from headct_foundation_tpu_torch.utils import tracing

tiny, out = json.loads(sys.argv[1]), sys.argv[2]
distributed.BUCKET_BYTES = 40000  # several buckets, one tensor larger than a bucket
distributed.init_from_env("cpu", 2)
cfg = default_config()
cfg.merge_from_list(tiny)
state, _ = mae_engine.create_train_state(cfg, 20, 0, seed=0, device="cpu")
step = mae_engine.make_train_step(augment=True, config=cfg)
rng = np.random.RandomState(distributed.rank())
wires = [hu16_encode(rng.uniform(-1000, 1500, (2, 1, 24, 24, 24))) for _ in range(3)]
tracing.enable()
state, stats = mae_engine.train_one_epoch(cfg, state, step, wires, 5, 0, 1)
records = tracing.take()
ids = {r.id: r for r in records}
grads = [torch.zeros(())] + [p for p in state.model.parameters() if p.requires_grad]
buckets = distributed._buckets(grads)
json.dump({"stats": stats["allreduce"], "steps": stats["steps"],
           "counters": [distributed.all_reduce_sum_.calls, distributed.all_reduce_sum_.bytes],
           "buckets": len(buckets), "bucket_bytes": sum(t.numel() * 4 for t in grads),
           "allreduce": [[r.step, ids[r.parent].name] for r in records if r.name == "allreduce"]},
          open(out, "w"))
distributed.shutdown()
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_count_the_buckets_they_exchange(tmp_path):
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=str(ROOT), RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE="2", MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _DP_WORKER, json.dumps(MAE_TINY),
             str(tmp_path / f"{rank}.json")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=180)[0] for p in procs]  # a hung rendezvous fails here
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(o[-2000:] for o in outs)
    for rank in range(2):
        got = json.loads((tmp_path / f"{rank}.json").read_text())
        steps = got["steps"]
        assert steps == 3 and got["buckets"] > 2
        want = {"calls": steps * got["buckets"], "bytes": steps * got["bucket_bytes"]}
        assert got["stats"] == want
        assert got["counters"] == [want["calls"], want["bytes"]]
        assert got["allreduce"] == [[s, "step"] for s in range(steps)]
