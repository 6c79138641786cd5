"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of the
checkout, a configuration ``cardbench/configs/<config>.json``, a traffic mix
``cardbench/traffic/<traffic>.json``, a cell's limits
``cardbench/cells/<cell>.json``, a traffic kind's driver
``cardbench/drivers/<kind>.py`` and a metric's reader
``cardbench/metrics/<metric>.py``. A new cell, configuration, traffic mix or
metric is new files and new entries in ``BENCHMARK.json``; nothing here
names one.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def benchmark(root: Path = ROOT) -> Dict[str, Any]:
    return json.loads((root / "BENCHMARK.json").read_text())


def _named(kind: str, name: str, suffix: str, base: Path) -> Path:
    if not NAME.match(name):
        raise ValueError(f"{kind} name {name!r} is not a valid name")
    return base / kind / (name + suffix)


def load_json(kind: str, name: str, base: Path = HERE) -> Dict[str, Any]:
    return json.loads(_named(kind, name, ".json", base).read_text())


def load_module(kind: str, name: str, base: Path = HERE) -> ModuleType:
    """``cardbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = _named(kind, name, ".py", base)
    spec = importlib.util.spec_from_file_location(f"cardbench_{kind}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def workload(bench: Dict[str, Any], name: str) -> Dict[str, Any]:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                   f"{[w['name'] for w in bench['workloads']]}")


def metrics_for(bench: Dict[str, Any], cell: str, trace: bool) -> List[Dict[str, Any]]:
    """The metrics a run of ``cell`` reports: the end-to-end ones untraced,
    the per-layer ones traced; a metric with ``workloads`` only in those."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def cell_files(bench: Dict[str, Any], name: str, base: Path = HERE):
    """(workload entry, configuration, traffic, cell limits) of a cell."""
    w = workload(bench, name)
    return (w, load_json("configs", w["config"], base), load_json("traffic", w["traffic"], base),
            load_json("cells", name, base))
