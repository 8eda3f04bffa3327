"""``BENCHMARK.json`` and the files it names, resolved by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
the configuration is ``configs/<config>.json``, the mix
``traffic/<traffic>.json`` and every metric's reader
``metrics/<metric>.py``.  Three more parts are plug points, each a module
named by a key that may be left out:

- a configuration's ``"reference"``: ``references/<name>.py``, with
  ``grids(image, config, device)`` and ``results(grids, config, entry,
  compare="signed")``, the comparable tuples of one stream entry
  (``check.reference_grids`` / ``reference_results``); without the key,
  ``reference.py``;
- a mix's ``"request"``: ``requests/<name>.py``, with ``make(config, path,
  device, search_config_overrides)``, which returns a function of one
  stream entry giving ``(last_stats, results)``, and optionally
  ``as_tuples(results)`` for the comparison (default ``check.as_tuples``);
  without the key, ``requests/engine.py``;
- a mix's ``"generator"``: ``generators/<name>.py``, with ``make(config,
  mix, seed, device, n_bytes) -> traffic.Traffic``; without the key,
  ``traffic.make``.

Adding a configuration, a mix, a cell, a per-layer metric, a reference, a
request or a generator is adding files and entries: nothing here lists
them.  Everything is found under one folder, this one unless a caller
gives another laid out alike (its parent holds that ``BENCHMARK.json``).
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SPEC_PATH = ROOT / "BENCHMARK.json"
#: the request of a mix that names none
DEFAULT_REQUEST = "engine"


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
    #: the folder its files and plug modules were found under
    folder: Path = HERE


def load_spec(path: Path = SPEC_PATH) -> dict:
    return json.loads(Path(path).read_text())


def _metric(entry: dict) -> Metric:
    return Metric(entry["name"], entry["unit"], entry.get("workloads"),
                  entry.get("moves"))


def _file(kind: str, name: str, suffix: str, folder: Path) -> Path:
    """``<kind>/<name><suffix>`` under *folder*; FileNotFoundError naming
    it where it is not there."""
    folder = Path(folder)
    path = folder / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no file {path.relative_to(folder.parent)}")
    return path


def load_json(kind: str, name: str, folder: Path = HERE) -> dict:
    """``<kind>/<name>.json`` under *folder*."""
    return json.loads(_file(kind, name, ".json", folder).read_text())


def module(kind: str, name: str, folder: Path = HERE) -> ModuleType:
    """The module ``<kind>/<name>.py`` under *folder*, loaded from its
    file."""
    path = _file(kind, name, ".py", folder)
    module_name = f"benchmark_{kind}_" + "".join(
        c if c.isalnum() else "_" for c in name)
    mod_spec = importlib.util.spec_from_file_location(module_name, path)
    loaded = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(loaded)
    return loaded


def cell(name: str, spec: Optional[dict] = None, folder: Path = HERE) -> Cell:
    """The cell *name* of ``BENCHMARK.json`` (the one beside *folder*
    unless *spec* is given), with its configuration, its mix and the
    metrics it reports."""
    folder = Path(folder)
    if spec is None:
        spec = load_spec(folder.parent / "BENCHMARK.json")
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
                load_json("configs", entry["config"], folder),
                load_json("traffic", entry["traffic"], folder), e2e, layer,
                folder)


def generator(cell: Cell) -> Callable:
    """The ``make`` that builds *cell*'s image and stream: its mix's
    ``generators/<name>.py``, or ``traffic.make``."""
    name = cell.traffic.get("generator")
    if name is None:
        from . import traffic

        return traffic.make
    return module("generators", name, cell.folder).make


def request(cell: Cell) -> ModuleType:
    """The module whose ``make`` builds *cell*'s request: its mix's
    ``requests/<name>.py``, or this folder's ``requests/engine.py``."""
    name = cell.traffic.get("request")
    if name is None:
        return module("requests", DEFAULT_REQUEST)
    return module("requests", name, cell.folder)


def reader(metric_name: str, folder: Path = HERE) -> Callable:
    """The ``read(run)`` function of ``metrics/<metric_name>.py``."""
    return module("metrics", metric_name, folder).read


def read_metrics(metrics: List[Metric], run, folder: Path = HERE
                 ) -> Dict[str, dict]:
    """``{name: {"value", "unit"}}`` of each metric whose reader found
    something to read in *run*."""
    out = {}
    for m in metrics:
        value = reader(m.name, folder)(run)
        if value is not None:
            out[m.name] = {"value": float(value), "unit": m.unit}
    return out
