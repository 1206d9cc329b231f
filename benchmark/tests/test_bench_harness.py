"""The benchmark's files, its isolation from JAX, the cell lookup, the last
line, and the harness end to end at a tiny size on the CPU."""

import ast
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import cells, compare, harness, run
from benchmark.tests.tiny import tiny_cell

HERE = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "headct_foundation_tpu"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_nothing_imports_jax_or_the_jax_package_by_whole_top_level_name():
    for path in HERE.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, f"{path} imports {tops & FORBIDDEN}"
    # the port's name begins with the JAX package's: whole names only
    assert "headct_foundation_tpu_torch".split(".")[0] not in FORBIDDEN


def test_the_reference_imports_nothing_of_the_measured_package():
    for path in (HERE / "reference").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert tops <= {"__future__", "math", "typing", "numpy", "torch", "benchmark"}, path
        assert not any(m.startswith("benchmark.") and not m.startswith("benchmark.reference")
                       for m in _imports(path)), path


def test_a_run_loads_no_jax_in_its_process():
    code = ("import sys; import benchmark.run as r; r.cache_env(); "
            "from benchmark import harness, calibrate; harness._engine('mae'); "
            "harness._engine('dino'); "
            "from headct_foundation_tpu_torch.parallel import distributed; "
            "print(r.loaded_forbidden())")
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_benchmark_json_keeps_to_the_contract():
    spec = cells.spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"] and spec["command"][-1] == "benchmark.run"
    rs = spec["run_seconds"]
    assert 1 <= rs <= 51 and (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    names += [c["name"] for c in spec["configs"]] + [w["name"] for w in spec["workloads"]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (HERE.parent / c["file"]).exists() and c["file"].startswith("benchmark/")
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    assert sum(w["chips"] == 4 for w in spec["workloads"]) <= 1
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in spec["end_to_end"])
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"]) and m["better"] in ("lower", "higher")


@pytest.mark.parametrize("name", [w["name"] for w in cells.spec()["workloads"]])
def test_each_cell_finds_its_files_by_name(name):
    cell = cells.find(name)
    assert cell.engine in ("mae", "dino")
    assert set(cell.limits) == {"loss_gap", "grad_gap", "update_gap"}
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cells.reader(m["name"]))
    assert {"input_size", "batch", "ring", "compared_steps", "trace_steps", "ref_rows",
            "steps_per_epoch", "epoch", "why"} <= set(cell.traffic)


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError, match="unknown workload"):
        cells.find("no-such-cell")
    with pytest.raises(KeyError):
        cells.reader("no_such_metric")


def _fake_result(traced: bool) -> dict:
    prof = {"steps": 2, "layer_ms": {"attention": 2.0, "augment": 1.0, "optimizer": 3.0,
                                     "models": 10.0}, "busy_s": 0.03, "window_s": 0.032,
            "idle_pct": 6.25, "allreduce_exposed_ms": None,
            "breakdown": {"device_ops": [["k", 0.01]], "idle_gaps": [["x", 0.002]]}}
    res = harness.RankResult(steps=20, window_s=3.0, intervals_ms=[150.0] * 20,
                             host_ms=[20.0] * 20, data_time_s=0.001, peak_bytes=2 ** 34,
                             launches={"flash_attention_fwd": 8.0},
                             profile=prof if traced else None,
                             readings={"losses": [1.0], "grad_norms": {"a": 1.0},
                                       "change_norms": {"a": 1.0}},
                             reference={"losses": [1.0], "grad_norms": {"a": 1.0},
                                        "change_norms": {"a": 1.0}})
    from dataclasses import asdict
    return asdict(res)


@pytest.mark.parametrize("traced", [False, True])
def test_the_last_line_has_the_contract_keys_and_the_checks_last(traced):
    cell = cells.find("mae-vitb12.96.b64")
    line = run.result_line(cell, [_fake_result(traced)], 31.5, traced,
                           "NVIDIA H100 80GB HBM3", "700.00 W")
    keys = ["correct", "attempted", "failed", "metrics", "device"] + (
        ["breakdown"] if traced else []) + ["checks"]
    assert list(line) == keys
    assert line["correct"] is True and line["attempted"] == 20
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    wanted = cell.per_layer if traced else cell.end_to_end
    got = set(line["metrics"])
    assert got <= {m["name"] for m in wanted}
    if traced:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert "allreduce_exposed_ms" not in got  # one card: the reader finds nothing
        assert line["metrics"]["step_mfu"]["value"] < 100
    else:
        assert line["metrics"]["train_volumes_per_s"]["value"] == pytest.approx(20 * 64 / 3.0)
        assert line["metrics"]["setup_s"]["value"] == 31.5
    json.dumps(line)


@pytest.mark.parametrize("engine", ["mae", "dino"])
def test_a_tiny_run_drives_the_epoch_loop_and_agrees_with_the_reference(engine):
    res = harness.run_rank(tiny_cell(engine), 2 ** 31 + 77, 0.5, False, torch.device("cpu"))
    assert res.steps >= 1 and res.failed == 0
    gaps = compare.gaps(res.readings, res.reference)
    assert all(math.isfinite(v) and v < 0.2 for v in gaps.values()), gaps
