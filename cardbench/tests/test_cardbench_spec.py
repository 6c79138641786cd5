"""BENCHMARK.json against the contract's form, and every file found by name."""
import json
import re
import shutil

import pytest

import check
import spec
from conftest import BENCH, ROOT, tiny_cell
from reference.weights import flatten, make_params

TEXT = re.compile(r"^[^\t\n]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark()


def test_keys_and_sizes(bench):
    assert set(bench) == TOP
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert bench["paths"] == ["cardbench"] and bench["command"][1] == "cardbench/run.py"
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(bench, group):
    names = [e["name"] for e in bench[group]]
    assert len(names) == len(set(names))
    for e in bench[group]:
        assert spec.NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert spec.UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert TEXT.match(e[key]), (e["name"], key)
        for key in ("config", "traffic"):
            if key in e:
                assert spec.NAME.match(e[key])
        for key in e.get("reduced", []):
            assert spec.NAME.match(key)


def test_every_cell_reports_what_it_must(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for w in bench["workloads"]:
        assert len(spec.metrics_for(bench, w["name"], False)) >= 2
        assert spec.metrics_for(bench, w["name"], True)
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
    configs = {c["name"] for c in bench["configs"]}
    assert configs == {w["config"] for w in bench["workloads"]}
    assert len({(w["config"], w["traffic"]) for w in bench["workloads"]}) == len(
        bench["workloads"])


def test_files_found_by_name(bench):
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
        for key in c["reduced"]:
            assert key in cfg and cfg["published"][key] != cfg[key]
    for w in bench["workloads"]:
        _, cfg, traffic, cell = spec.cell_files(bench, w["name"])
        assert spec.load_module("drivers", traffic["kind"]).run
        leaves = cell.get("leaves", {})
        assert set(cell["limits"]) == set(check.NUMBERS) | set(leaves)
        tree = dict(flatten(make_params(tiny_cell(w["name"])[1], 0, "cpu")))
        assert set(leaves.values()) <= set(tree), leaves
        assert traffic["node_drift"] > 0
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.load_module("metrics", m["name"]).read)


def test_new_files_need_no_edit(tmp_path, bench):
    """A metric, a traffic mix and a cell added as files (and entries) in a
    copy are found with no edit to any file that is there."""
    base = tmp_path / "cardbench"
    shutil.copytree(BENCH, base, ignore=shutil.ignore_patterns("__pycache__"))
    (base / "metrics" / "steps.total.py").write_text(
        "def read(ctx):\n    return float(ctx['steps'])\n")
    traffic = json.loads((base / "traffic" / "tree.4x1x2048.json").read_text())
    (base / "traffic" / "tree.4x1x4096.json").write_text(json.dumps(dict(traffic, seq_len=4096)))
    (base / "cells" / "falcon-mamba.tree-4k.json").write_text(
        (base / "cells" / "falcon-mamba.tree.json").read_text())
    new = json.loads(json.dumps(bench))
    new["workloads"].append({"name": "falcon-mamba.tree-4k", "config": "falcon-mamba-7b-2of64",
                             "traffic": "tree.4x1x4096", "chips": 1, "why": "longer rows"})
    new["per_layer"].append({"name": "steps.total", "unit": "steps", "better": "higher",
                             "source": "host_clock", "layer": "device",
                             "moves": "train_tokens_per_s", "workloads": ["falcon-mamba.tree-4k"]})
    w, cfg, t, cell = spec.cell_files(new, "falcon-mamba.tree-4k", base)
    assert t["seq_len"] == 4096 and cfg["name"] == "falcon-mamba-7b-2of64"
    names = [m["name"] for m in spec.metrics_for(new, "falcon-mamba.tree-4k", True)]
    assert names == ["steps.total"]
    assert spec.load_module("metrics", "steps.total", base).read({"steps": 7}) == 7.0


def test_bad_names_are_refused():
    with pytest.raises(ValueError):
        spec.load_json("configs", "../BENCHMARK")
