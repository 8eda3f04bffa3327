"""``BENCHMARK.json`` and the files it names, resolved by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
the configuration is ``configs/<config>.json``, the mix
``traffic/<traffic>.json`` and every metric's reader
``metrics/<metric>.py``.  Adding a configuration, a mix, a cell or a
per-layer metric is adding files and entries: nothing here lists them.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SPEC_PATH = ROOT / "BENCHMARK.json"


@dataclass
class Metric:
    name: str
    unit: str
    #: cells that report it; None: every cell that reports ``moves`` (a
    #: per-layer metric) or every cell (an end-to-end one)
    workloads: Optional[List[str]]
    moves: Optional[str] = None


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]


def load_spec(path: Path = SPEC_PATH) -> dict:
    return json.loads(Path(path).read_text())


def _metric(entry: dict) -> Metric:
    return Metric(entry["name"], entry["unit"], entry.get("workloads"),
                  entry.get("moves"))


def load_json(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` under the benchmark's folder."""
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no file {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def cell(name: str, spec: Optional[dict] = None) -> Cell:
    """The cell *name* of ``BENCHMARK.json``, with its configuration, its
    mix and the metrics it reports."""
    spec = load_spec() if spec is None else spec
    for entry in spec["workloads"]:
        if entry["name"] == name:
            break
    else:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    e2e = [_metric(m) for m in spec["end_to_end"]]
    e2e = [m for m in e2e if m.workloads is None or name in m.workloads]
    reported = {m.name for m in e2e}
    layer = [_metric(m) for m in spec["per_layer"]]
    layer = [m for m in layer
             if (name in m.workloads if m.workloads is not None
                 else m.moves in reported)]
    return Cell(name, int(entry["chips"]),
                load_json("configs", entry["config"]),
                load_json("traffic", entry["traffic"]), e2e, layer)


def reader(metric_name: str) -> Callable:
    """The ``read(run)`` function of ``metrics/<metric_name>.py``."""
    path = HERE / "metrics" / f"{metric_name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader {path.relative_to(ROOT)}")
    module_name = "benchmark_metric_" + "".join(
        c if c.isalnum() else "_" for c in metric_name)
    mod_spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read


def read_metrics(metrics: List[Metric], run) -> Dict[str, dict]:
    """``{name: {"value", "unit"}}`` of each metric whose reader found
    something to read in *run*."""
    out = {}
    for m in metrics:
        value = reader(m.name)(run)
        if value is not None:
            out[m.name] = {"value": float(value), "unit": m.unit}
    return out
