"""Find a cell's files by name.

``BENCHMARK.json`` lists the configurations, the cells and the metrics.
A cell ``<name>`` with configuration ``<config>`` and traffic ``<traffic>``
reads ``benchmark/configs/<config>.json`` (through the entry's ``file``),
``benchmark/traffic/<traffic>.json`` and ``benchmark/limits/<name>.json``;
metric ``<m>`` is read by ``benchmark/metrics/<m>.py``'s ``read(run)``. A
metric applies to a cell unless its ``workloads`` list leaves the cell out.
"""

from __future__ import annotations

import copy
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    engine: str            # "mae" or "dino"
    config: dict           # the configuration file
    traffic: dict          # the traffic file
    chips: int
    limits: Dict[str, float]
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)

    def run_config(self) -> dict:
        """The configuration as run: the file's sections with the traffic's
        input size, batch and data-parallel width, and the LR scaled to the
        global batch (BASE_LR x batch x cards / 256, MIN_LR 1e-3 of it) as
        the pretraining CLIs scale it."""
        cfg = copy.deepcopy(self.config["config"])
        t = self.traffic
        size = int(t["input_size"])
        cfg["MODEL"]["ROI"] = [size] * 3
        cfg["MAE" if self.engine == "mae" else "VIT"]["INPUT_SIZE"] = size
        cfg.setdefault("DATA", {})["BATCH_SIZE"] = int(t["batch"])
        cfg.setdefault("PARALLEL", {})["DATA"] = self.chips
        base = float(cfg["TRAIN"]["BASE_LR"]) * int(t["batch"]) * self.chips / 256
        cfg["TRAIN"]["BASE_LR"], cfg["TRAIN"]["MIN_LR"] = base, base * 1e-3
        return cfg


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``; KeyError for an unknown one."""
    s = spec(root)
    cells = {w["name"]: w for w in s["workloads"]}
    if name not in cells:
        raise KeyError(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in s["configs"]}
    config = _json(root / configs[w["config"]]["file"])
    traffic = _json(HERE / "traffic" / f"{w['traffic']}.json")
    return Cell(name=name, engine=config["engine"], config=config, traffic=traffic,
                chips=int(w["chips"]), limits=_json(HERE / "limits" / f"{name}.json"),
                end_to_end=[m for m in s["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in s["per_layer"] if _applies(m, name)])


def reader(metric: str) -> Callable:
    """``benchmark/metrics/<metric>.py``'s ``read``."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.exists():
        raise KeyError(f"no reader {path} for metric {metric!r}")
    mod_spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read
