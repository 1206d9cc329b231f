"""The trace reduction on a small synthetic Chrome trace, against a hand
count: layers by call site (a backward kernel through its forward op),
busy and idle time, NCCL time no compute hides, and idle gaps by what the
launching thread was doing."""

import pytest

from benchmark import trace

PKG = "/src/headct_foundation_tpu_torch/"


def _py(tid, ts, dur, path, line, fn):
    return {"ph": "X", "cat": "python_function", "pid": 1, "tid": tid, "ts": ts, "dur": dur,
            "name": f"{path}({line}): {fn}"}


def _op(tid, ts, dur, name, seq=None):
    e = {"ph": "X", "cat": "cpu_op", "pid": 1, "tid": tid, "ts": ts, "dur": dur, "name": name,
         "args": {}}
    if seq is not None:
        e["args"]["Sequence number"] = seq
    return e


def _launch(tid, ts, corr):
    return {"ph": "X", "cat": "cuda_runtime", "pid": 1, "tid": tid, "ts": ts, "dur": 1,
            "name": "cudaLaunchKernel", "args": {"correlation": corr}}


def _kernel(ts, dur, name, corr):
    return {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": ts, "dur": dur, "name": name,
            "args": {"correlation": corr}}


def synthetic():
    return [
        _py(1, 0, 100, PKG + "engines/mae_engine.py", 10, "grads"),
        _py(1, 5, 10, PKG + "data/augment.py", 5, "apply_mae_augment"),
        _launch(1, 8, 1), _kernel(20, 10, "elementwise_kernel", 1),          # augment
        _py(1, 20, 20, PKG + "ops/attention.py", 92, "dot_product_attention"),
        _launch(1, 25, 2), _kernel(30, 20, "flash_fwd_wgmma_kernel", 2),     # attention
        _op(1, 26, 2, "aten::mm", seq=7),
        _launch(1, 45, 3), _kernel(50, 10, "sm90_gemm", 3),                  # models
        _py(1, 60, 30, "/usr/lib/torch/optim/adamw.py", 1, "step"),
        _launch(1, 62, 4), _kernel(70, 10, "multi_tensor_apply_kernel", 4),  # optimizer
        _launch(1, 65, 5), _kernel(75, 20, "ncclDevKernel_AllReduce", 5),    # 15 us exposed
        # the autograd thread: mm's backward, traced to the forward op by sequence number
        _op(2, 100, 20, "autograd::engine::evaluate_function: MmBackward0", seq=7),
        _launch(2, 105, 6), _kernel(110, 5, "sm90_gemm_bwd", 6),             # attention
    ]


def test_layers_busy_idle_and_exposed_allreduce_by_hand():
    out = trace.parse(synthetic(), steps=1)
    ms = out["layer_ms"]
    assert ms == pytest.approx({"augment": 0.010, "attention": 0.025, "models": 0.010,
                                "optimizer": 0.010, "allreduce": 0.020})
    # busy [20, 60] + [70, 95] + [110, 115] of the window [0, 115]
    assert out["busy_s"] == pytest.approx(70e-6)
    assert out["window_s"] == pytest.approx(115e-6)
    assert out["idle_pct"] == pytest.approx(100 * 45 / 115)
    # the NCCL kernel [75, 95] overlaps the optimizer's [70, 80]: 15 us alone
    assert out["allreduce_exposed_ms"] == pytest.approx(0.015)


def test_idle_gaps_by_what_the_launching_thread_was_doing():
    gaps = dict(trace.parse(synthetic(), steps=1)["breakdown"]["idle_gaps"])
    # [0, 20] and [60, 70]: the main thread inside grads (the optimizer's frame
    # is not the package's); [95, 110]: the autograd thread had no op open
    assert gaps == pytest.approx({"engines/mae_engine.py:10 grads": 30e-6,
                                  "(no op open)": 15e-6})


def test_top_device_ops_and_no_nccl_without_ranks():
    events = [e for e in synthetic() if "nccl" not in e["name"].lower()]
    out = trace.parse(events, steps=2)
    assert out["allreduce_exposed_ms"] is None
    top = out["breakdown"]["device_ops"]
    assert top[0] == ["flash_fwd_wgmma_kernel", pytest.approx(20e-6)]
    assert out["layer_ms"]["attention"] == pytest.approx(0.0125)


def test_a_trace_without_device_work_is_refused():
    with pytest.raises(RuntimeError):
        trace.parse([e for e in synthetic() if e["cat"] != "kernel"], steps=1)
