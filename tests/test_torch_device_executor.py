"""The port's card executor (``device``) against the JAX package's ``jax``
executor, on the CPU.

The JAX side runs in one subprocess with 12 forced host devices: five
registry scenarios through ``run_scenario(spec, executor="jax")``, four
``codec_x_protocol`` cells (fp32 and int8 x dissemination and segmented)
through ``run_sweep(..., executor="jax")`` and one traced run. The port's
side runs ``DeviceExecutor(device="cpu", proxy_elems=4)``, the reference's
``arange`` proxy, and every ``ScenarioResult.to_dict()`` must equal the
reference's but for the executor's name.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro.scenario import executors as ref_executors  # noqa: E402
from repro.scenario import run_scenario as ref_run_scenario  # noqa: E402
from repro.scenario import scenarios as ref_scenarios  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.scenario import (ChurnEvent, DeviceExecutor, SweepSpec, executors,  # noqa: E402
                                  run_scenario, run_sweep, scenarios)
from repro_torch.scenario import __main__ as scenario_cli  # noqa: E402
from repro_torch.scenario.cache import PlanCache  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("paper_table3", "quantized_table3", "topk_sweep", "mesh_smoke", "churn_storm")
GRID = {"codec": ("fp32", "int8"), "protocol": ("dissemination", "segmented")}
TRACED = "churn_storm"

JAX_SIDE = textwrap.dedent("""
    import json, sys
    from repro import obs
    from repro.scenario import SweepSpec, run_scenario, run_sweep, scenarios

    out, names, traced = sys.argv[1], sys.argv[2].split(","), sys.argv[4]
    grid = json.loads(sys.argv[3])
    base = scenarios.get_sweep("codec_x_protocol")
    sweep = SweepSpec(name=base.name, base=base.base, grid=grid)
    results = {}
    for n in names:  # the traced scenario runs once, under a recorder
        if n != traced:
            results[n] = run_scenario(scenarios.get(n), executor="jax")
            continue
        with obs.recording(obs.Recorder()) as rec:
            results[n] = run_scenario(scenarios.get(n), executor="jax")
    report, results[traced].report = results[traced].report, None
    spans = [(s.name, s.cat, s.track) for s in rec.spans if s.track == "exec/jax"]
    json.dump({
        "scenarios": {n: res.to_dict() for n, res in results.items()},
        "cells": [c.result.to_dict() for c in run_sweep(sweep, executor="jax").cells],
        "counters": report["counters"], "spans": spans,
    }, open(out, "w"))
""")


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_device_executor") / "r.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=12")
    proc = subprocess.run(
        [sys.executable, "-c", JAX_SIDE, str(out), ",".join(NAMES), json.dumps(GRID), TRACED],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(out.read_text())


def _cpu():
    return DeviceExecutor(device="cpu", proxy_elems=4)


def _as_jax(d):
    """A result's ``to_dict()`` with the reference's executor name, through
    JSON as the reference's came (tuples as lists)."""
    assert d["executor"] == "device"
    return json.loads(json.dumps({**d, "executor": "jax"}))


@pytest.mark.parametrize("name", NAMES)
def test_scenario_result_equals_the_jax_executors(name, jax_side):
    ex = _cpu()
    got = run_scenario(scenarios.get(name), executor=ex).to_dict()
    assert _as_jax(got) == jax_side["scenarios"][name]
    # the card view holds the same rounds, each with finite outputs
    assert [r.numerics_ok for r in ex.run.rounds] == [r["numerics_ok"] if "numerics_ok" in r
                                                      else None for r in got["rounds_detail"]]
    assert all(r.finite and r.device_ms is None for r in ex.run.rounds)
    assert ex.run.peak_bytes is None and len(ex.run.plans) >= 1


def test_name_string_and_jax_alias_run_the_device_executor(jax_side):
    got = run_scenario("quantized_table3", executor=executors.get("jax").__class__(
        device="cpu", proxy_elems=4))
    assert _as_jax(got.to_dict()) == jax_side["scenarios"]["quantized_table3"]


def test_sweep_cells_equal_the_jax_executors(jax_side):
    base = scenarios.get_sweep("codec_x_protocol")
    sweep = SweepSpec(name=base.name, base=base.base, grid=GRID)
    ex, cache = _cpu(), PlanCache()
    got = run_sweep(sweep, executor=ex, plan_cache=cache)
    assert got.executor == "device" and len(got.cells) == len(jax_side["cells"]) == 4
    for cell, want in zip(got.cells, jax_side["cells"]):
        assert _as_jax(cell.result.to_dict()) == want
    # one card view a cell, every cell planned through the one cache
    assert [r.scenario for r in ex.runs] == [c.spec.name for c in got.cells]
    assert cache.counters["overlay_misses"] == 1


def test_names_and_capabilities_equal_the_references():
    as_ours = {"jax": "device"}
    assert executors.names() == [as_ours.get(n, n) for n in ref_executors.names()]
    ref_caps = ref_executors.capability_table()
    assert executors.capability_table() == {as_ours.get(n, n): caps
                                           for n, caps in ref_caps.items()}
    assert DeviceExecutor.capabilities() == ref_caps["jax"]
    assert isinstance(executors.get("device"), DeviceExecutor)
    assert isinstance(executors.get("jax"), DeviceExecutor)
    ex = _cpu()
    assert executors.get(ex) is ex


def test_flooding_with_churn_raises_as_the_reference():
    churned = dict(churn=(ChurnEvent(1, "leave", 3),), rounds=2)
    spec = scenarios.get("paper_flooding_baseline").replace(**churned)
    ref_spec = ref_scenarios.get("paper_flooding_baseline").replace(**churned)
    with pytest.raises(ValueError, match="cannot mask churned nodes"):
        run_scenario(spec, executor=_cpu())
    with pytest.raises(ValueError, match="cannot mask churned nodes"):
        ref_run_scenario(ref_spec, executor="jax")


def test_device_executor_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert executors.get("device").device is None
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_scenario("paper_table3", executor=DeviceExecutor())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_scenario("paper_table3", executor="jax")


def test_traced_run_attaches_a_run_report(jax_side):
    with obs.recording(obs.Recorder()) as rec:
        res = run_scenario(scenarios.get(TRACED), executor=_cpu())
    report = res.report
    assert report is not None and res.to_dict()["report"] == report
    assert report["counters"] == jax_side["counters"]
    for key in ("transmissions", "slots", "bytes.payload_mb", "bytes.wire_mb"):
        assert report["counters"][key] > 0
    spans = [[s.name, s.cat, s.track.replace("device", "jax")] for s in rec.spans
             if s.track == "exec/device"]
    assert spans == jax_side["spans"]


def test_traced_card_rounds_count_their_device_time(monkeypatch):
    """On the card each round's CUDA-event time is added to the run's
    ``device.round_ms`` counter; a stand-in time checks the wiring here."""
    real = executors._timed_round

    def timed(*args):
        return real(*args)[0], 1.25

    monkeypatch.setattr(executors, "_timed_round", timed)
    ex = _cpu()
    with obs.recording(obs.Recorder()):
        res = run_scenario(scenarios.get("topk_sweep"), executor=ex)
    assert [r.device_ms for r in ex.run.rounds] == [1.25] * 3
    assert res.report["counters"]["device.round_ms"] == 3.75


def test_cli_runs_a_sweep_on_the_cpu(capsys):
    assert scenario_cli.main(["--sweep", "payload_latency_curve", "--device", "cpu",
                              "--proxy-elems", "4"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    want = run_sweep(scenarios.get_sweep("payload_latency_curve"), executor="plan").table()
    assert [r["payload"] for r in rows] == ["v3s", "v2", "b0", "v3l", "b1", "b2", "b3"]
    for row, plan_row in zip(rows, want):
        assert row["executor"] == "device" and row["finite"] and row["numerics_ok"] == [True]
        for key in ("transmissions", "slots", "bytes_mb", "bytes_on_wire_mb"):
            assert row[key] == plan_row[key], key
    # a host executor refuses the card's options instead of ignoring them
    with pytest.raises(SystemExit):
        scenario_cli.main(["--sweep", "payload_latency_curve", "--executor", "plan",
                           "--proxy-elems", "4"])
    assert "takes no --proxy-elems" in capsys.readouterr().err
