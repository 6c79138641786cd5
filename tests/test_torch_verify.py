"""The port's static plan verifier and determinism lint (``repro_torch.verify``)
against the JAX package's (``repro.verify``), on the CPU.

* **Certificates:** every registry scenario and every cell of the gated
  sweeps (``table3_full``, ``async_vs_sync``, ``optimized_vs_mst``) gives
  the reference's summary exactly: epochs, ``ok`` / ``invariant``, and each
  certificate's kind, counts, invariants in order, skipped classes with
  their reasons, completion slots, peak link flows and wire MB, compared
  with ``==``. The scale scenarios and the annealed cells are in
  ``test_torch_verify_scale.py``.
* **Rejection:** each of the reference test's 16 defects, built as the same
  hand-made plan in both packages, raises in both with the same invariant
  and the same message.
* **Wiring:** the card executor's ``verify=`` modes on the CPU, the shared
  cache, the ``verify`` span track, and ``verify_result`` over every host
  executor's result and the card executor's rounds (flooding's all-gather and
  mesh_smoke's churn among them), with the reference's counts.
* **CLI and lint:** ``python -m repro_torch.verify --all`` prints the
  reference's lines (timings stripped); the lint is clean over
  ``src/repro_torch`` with the port's allowlist, finds the reference's two
  recorder reads without it, and each rule fires on the reference test's
  fixtures with the same (line, rule, detail) in both packages.
"""
import dataclasses
import os
import re
import subprocess
import sys
import warnings
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.verify as jax_verify  # noqa: E402
import repro.verify.lint as jax_lint  # noqa: E402
from repro import obs as jax_obs  # noqa: E402
from repro.core.graph import Graph as JaxGraph  # noqa: E402
from repro.core.graph import TopologySpec as JaxTopologySpec  # noqa: E402
from repro.core.graph import make_topology as jax_make_topology  # noqa: E402
from repro.core.network import as_compiled_network as jax_as_compiled_network  # noqa: E402
from repro.core.plan import make_policy as jax_make_policy  # noqa: E402
from repro.core.replan import SparsePlanner as JaxSparsePlanner  # noqa: E402
from repro.scenario import run_scenario as jax_run_scenario  # noqa: E402
from repro.scenario import scenarios as jax_scenarios  # noqa: E402
from repro.scenario.cache import PlanCache as JaxPlanCache  # noqa: E402
from repro.scenario.executors import _member_testbed as jax_member_testbed  # noqa: E402
from repro.scenario.executors import membership_rounds as jax_membership_rounds  # noqa: E402
from repro.verify.invariants import SlotRecord as JaxSlotRecord  # noqa: E402

import repro_torch.verify as verify  # noqa: E402
import repro_torch.verify.lint as lint  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core.graph import Graph, TopologySpec, make_topology  # noqa: E402
from repro_torch.core.network import as_compiled_network  # noqa: E402
from repro_torch.core.plan import make_policy  # noqa: E402
from repro_torch.core.replan import SparsePlanner  # noqa: E402
from repro_torch.scenario import executors, run_scenario, scenarios  # noqa: E402
from repro_torch.scenario.cache import PlanCache  # noqa: E402
from repro_torch.scenario.executors import EngineExecutor, _member_testbed  # noqa: E402
from repro_torch.scenario.executors import membership_rounds  # noqa: E402
from repro_torch.verify.invariants import SlotRecord  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_ROOT = os.path.join(ROOT, "src", "repro_torch")
SCALE = ("scale_1000", "scale_100k", "scale_1m")
GATED = ("table3_full", "async_vs_sync", "optimized_vs_mst")


def cases(scale: bool):
    """(sweep or None, scenario name or cell index): the registry scenarios
    and gated sweep cells, split into the scale ones (the three scale
    scenarios, the annealed cells) and the rest."""
    out = [(None, name) for name in scenarios.names() if (name in SCALE) == scale]
    for sweep in GATED:
        for cell in scenarios.get_sweep(sweep).cells():
            if (cell.spec.optimizer is not None) == scale:
                out.append((sweep, cell.index))
    return out


def case_id(case):
    sweep, key = case
    return key if sweep is None else f"{sweep}[{key}]"


def specs(case):
    """The same ScenarioSpec from both packages' registries."""
    sweep, key = case
    if sweep is None:
        return scenarios.get(key), jax_scenarios.get(key)
    return (scenarios.get_sweep(sweep).cells()[key].spec,
            jax_scenarios.get_sweep(sweep).cells()[key].spec)


def cert_fields(cert):
    return (cert.kind, cert.n, cert.n_slots, cert.transmissions, list(cert.invariants),
            list(cert.skipped.items()), cert.completion_slot, cert.segment_completion,
            cert.max_link_flows, cert.wire_mb)


def summary(out):
    return (out["scenario"], out["mode"], out["ok"], out["error"], out["invariant"],
            out["epochs"], [cert_fields(c) for c in out["certificates"]])


def assert_same_certificates(case):
    ours, theirs = specs(case)
    got = verify.verify_scenario_plans(ours, plan_cache=PlanCache(), mode="strict")
    want = jax_verify.verify_scenario_plans(theirs, plan_cache=JaxPlanCache(), mode="strict")
    assert summary(got) == summary(want)
    assert [c.to_dict() for c in got["certificates"]] == \
        [c.to_dict() for c in want["certificates"]]


PORT = SimpleNamespace(
    verify=verify, Graph=Graph, SlotRecord=SlotRecord, scenarios=scenarios, PlanCache=PlanCache,
    membership_rounds=membership_rounds, make_policy=make_policy, TopologySpec=TopologySpec,
    make_topology=make_topology, SparsePlanner=SparsePlanner,
    as_compiled_network=as_compiled_network, member_testbed=_member_testbed,
    run_plan=lambda spec: executors.get("plan").execute(spec))
REF = SimpleNamespace(
    verify=jax_verify, Graph=JaxGraph, SlotRecord=JaxSlotRecord, scenarios=jax_scenarios,
    PlanCache=JaxPlanCache, membership_rounds=jax_membership_rounds,
    make_policy=jax_make_policy, TopologySpec=JaxTopologySpec,
    make_topology=jax_make_topology, SparsePlanner=JaxSparsePlanner,
    as_compiled_network=jax_as_compiled_network, member_testbed=jax_member_testbed,
    run_plan=lambda spec: jax_run_scenario(spec, executor="plan"))


@pytest.mark.parametrize("case", cases(scale=False), ids=case_id)
def test_certificates_equal_the_reference(case):
    assert_same_certificates(case)


def test_the_tables_equal_the_reference():
    assert verify.INVARIANT_CLASSES == jax_verify.INVARIANT_CLASSES
    assert verify.VERIFY_MODES == jax_verify.VERIFY_MODES
    assert lint.SPEC_FIELD_ROLES == jax_lint.SPEC_FIELD_ROLES
    from repro.verify.__main__ import GATED_SWEEPS as JAX_GATED
    from repro_torch.verify.__main__ import GATED_SWEEPS

    assert GATED_SWEEPS == JAX_GATED == GATED


def test_sparse_planner_output_certificates_equal_the_reference():
    """The reference test's k-NN(400) plan and its repair after three
    leaves, verified as exchange policies in both packages."""
    got, want = [], []
    for P, out in ((PORT, got), (REF, want)):
        g = P.make_topology(P.TopologySpec(kind="knn", n=400, seed=0, k=8, n_subnets=4))
        planner = P.SparsePlanner(g)
        base = planner.plan(range(g.n))
        patched = planner.replan(base, sorted(set(range(g.n)) - {7, 99, 255}))
        for plan in (base, patched):
            mst, colors = plan.member_mst()
            policy = P.make_policy("mosgu_exchange", mst, mst=mst, colors=colors)
            out.append(cert_fields(P.verify.verify_policy(policy, payload_mb=1.0)))
    assert got == want


def test_verify_plan_on_compiled_plans_equals_the_reference():
    from repro.core.schedule import compile_dissemination as jax_compile
    from repro.core.graph import build_mst as jax_build_mst, color_graph as jax_color
    from repro_torch.core.schedule import compile_dissemination
    from repro_torch.core.graph import build_mst, color_graph

    got = []
    for P, compile_, build_mst_, color in ((PORT, compile_dissemination, build_mst, color_graph),
                                           (REF, jax_compile, jax_build_mst, jax_color)):
        g = P.make_topology(P.TopologySpec(kind="erdos_renyi", n=10, seed=1))
        mst = build_mst_(g)
        plan = compile_(mst, color(mst))
        got.append(cert_fields(P.verify.verify_plan(plan, graph=mst, payload_mb=21.2)))
    assert got[0] == got[1]


# ---------------------------------------------------------------------------
# rejection: the reference test's 16 defects, in both packages
# ---------------------------------------------------------------------------

def _facts_for(P, name):
    spec = P.scenarios.get(name)
    cache = P.PlanCache()
    overlay = cache.overlay(spec)
    _, mod, members, _ = next(iter(P.membership_rounds(spec, overlay)))
    mt = tuple(members)
    policy = cache.policy(spec, mt, lambda: mod.build_graph()[0])
    return P.verify.PlanFacts.from_policy(policy), spec, mt, cache


def _hand_facts(P, sends_by_slot, colors, kind="dissemination"):
    """Facts over the 0 - 1 - 2 path, one (color, sends) a slot."""
    path = P.Graph(np.array([[0.0, 1.0, 0.0], [1.0, 0.0, 1.0], [0.0, 1.0, 0.0]]))
    slots = []
    for color, sends in sends_by_slot:
        arr = np.asarray(sends, dtype=np.int64).reshape(-1, 3)
        slots.append(P.SlotRecord(color, arr[:, 0].copy(), arr[:, 1].copy(), arr[:, 2].copy()))
    return P.verify.PlanFacts(n=3, kind=kind, slots=slots, colors=np.asarray(colors),
                              payload_fraction=1.0, n_payloads=3, graph=path)


def _node_out_of_range(P):
    facts = _hand_facts(P, [(0, [(0, 1, 0)])], [0, 1, 0])
    facts.slots[0].dst[0] = 3
    P.verify.verify_facts(facts)


def _color_swapped(P):
    facts, *_ = _facts_for(P, "paper_table3")
    target = next(r for r in facts.slots if r.color >= 0 and len(r))
    target.color = int(next(c for c in np.unique(facts.colors) if c >= 0 and c != target.color))
    P.verify.verify_facts(facts)


def _dead_access(P):
    facts, spec, members, _ = _facts_for(P, "paper_table3")
    net = P.as_compiled_network(P.member_testbed(spec, members))
    net.access_rate[:] = 0.0
    P.verify.verify_facts(facts, network=net)


def _dead_trunk(P):
    facts, spec, members, _ = _facts_for(P, "paper_table3")
    net = P.as_compiled_network(P.member_testbed(spec, members))
    net.spec = dataclasses.replace(net.spec, trunk_mbps=0.0)
    P.verify.verify_facts(facts, network=net)


def _dropped_final_slot(P):
    facts, *_ = _facts_for(P, "paper_table3")
    P.verify.verify_facts(facts)  # the intact plan passes
    facts.slots = facts.slots[:-1]
    P.verify.verify_facts(facts)


def _exchange_wrong_payload(P):
    _, spec, members, cache = _facts_for(P, "paper_table3")
    facts = P.verify.PlanFacts.from_policy(
        P.make_policy("mosgu_exchange", cache.subgraph(spec, members, lambda: None)))
    rec = next(r for r in facts.slots if len(r))
    rec.payload[0] = (rec.src[0] + 1) % facts.n
    P.verify.verify_facts(facts)


def _counting_disagreement(P):
    facts, *_ = _facts_for(P, "paper_table3")
    P.verify.verify_facts(facts, payload_mb=1.0, expected_stats={
        "n_slots": facts.n_slots, "transmissions": facts.transmissions + 1})


def _tampered_report(P):
    spec = P.scenarios.get("paper_table3")
    result = P.run_plan(spec)
    result.rounds[0].bytes_on_wire_mb *= 1.001
    P.verify.verify_result(spec, result)


DEFECTS = {
    "node_out_of_range": (_node_out_of_range, "structure/node-range"),
    "self_send": (lambda P: P.verify.verify_facts(_hand_facts(P, [(0, [(0, 0, 0)])], [0, 1, 0])),
                  "structure/node-range"),
    "edge_not_in_graph": (lambda P: P.verify.verify_facts(
        _hand_facts(P, [(0, [(0, 1, 0), (0, 2, 0)])], [0, 1, 0])), "structure/edges-in-graph"),
    "half_duplex": (lambda P: P.verify.verify_facts(
        _hand_facts(P, [(0, [(0, 1, 0), (1, 2, 1)])], [0, 0, 1])), "schedule/half-duplex"),
    "color_swapped": (_color_swapped, "schedule/color-discipline"),
    "improper_coloring": (lambda P: P.verify.verify_facts(
        _hand_facts(P, [(0, [(0, 1, 0)])], [0, 0, 1])), "schedule/proper-coloring"),
    "duplicate_link": (lambda P: P.verify.verify_facts(
        _hand_facts(P, [(0, [(0, 1, 0), (0, 1, 1)])], [0, 1, 0])), "schedule/degree-cap"),
    "dead_access_link": (_dead_access, "capacity/admissible"),
    "dead_trunk": (_dead_trunk, "capacity/admissible"),
    "send_before_possession": (lambda P: P.verify.verify_facts(
        _hand_facts(P, [(0, [(0, 1, 2)])], [0, 1, 0])), "progress/causal-possession"),
    "dropped_final_slot": (_dropped_final_slot, "progress/completeness"),
    "exchange_wrong_payload": (_exchange_wrong_payload, "progress/causal-possession"),
    "negative_staleness": (lambda P: P.verify.check_admission_schedule(5, -1),
                           "staleness/window-negative"),
    "admission_cycle": (lambda P: P.verify.check_admission_acyclic(3, [(0, 2), (1, 0), (2, 1)]),
                        "staleness/admission-acyclic"),
    "counting_disagreement": (_counting_disagreement, "conservation/bytes-on-wire"),
    "tampered_report": (_tampered_report, "conservation/bytes-on-wire"),
}


@pytest.mark.parametrize("defect", sorted(DEFECTS))
def test_defect_names_the_reference_invariant(defect):
    build, invariant = DEFECTS[defect]
    raised = []
    for P in (PORT, REF):
        with pytest.raises(P.verify.VerificationError) as err:
            build(P)
        raised.append((err.value.invariant, str(err.value), err.value.details))
    assert raised[0] == raised[1]
    assert raised[0][0] == invariant


def test_sixteen_defects_cover_every_class():
    assert len(DEFECTS) == 16
    assert {inv for _, inv in DEFECTS.values()} == set(verify.INVARIANT_CLASSES)


# ---------------------------------------------------------------------------
# wiring: the card executor's modes, the shared cache, verify_result
# ---------------------------------------------------------------------------

# chip_smoke.py's phase-3 scenarios
PATH_SPECS = {
    "paper_table3": lambda s: s.get("paper_table3"),
    "quantized_table3": lambda s: s.get("quantized_table3"),
    "quantized_table3_int4": lambda s: s.get("quantized_table3").replace(
        name="quantized_table3_int4", codec="int4"),
    "topk_sweep": lambda s: s.get("topk_sweep"),
    "mesh_smoke": lambda s: s.get("mesh_smoke"),
    "mesh_smoke_int8": lambda s: s.get("mesh_smoke").replace(name="mesh_smoke_int8",
                                                            codec="int8"),
    "paper_flooding_baseline": lambda s: s.get("paper_flooding_baseline"),
}


def _cpu_run(spec, **kw):
    return run_scenario(spec, executor=executors.DeviceExecutor(device="cpu", proxy_elems=4),
                        **kw)


@pytest.mark.parametrize("name", ["paper_table3", "mesh_smoke", "paper_flooding_baseline"])
def test_strict_leaves_the_rounds_as_off(name):
    spec = scenarios.get(name)
    default, off, strict = ([r.to_dict() for r in _cpu_run(spec, **kw).rounds]
                            for kw in ({}, {"verify": "off"}, {"verify": "strict"}))
    assert default == off == strict


def test_strict_verifies_on_the_runs_cache():
    cache = PlanCache()
    _cpu_run(scenarios.get("paper_table3"), plan_cache=cache, verify="strict")
    assert cache.counters["policy_misses"] == 1
    assert cache.counters["policy_hits"] >= 1
    assert cache.counters["verified_misses"] == 1
    _cpu_run(scenarios.get("paper_table3"), plan_cache=cache, verify="strict")
    assert cache.counters["verified_misses"] == 1 and cache.counters["verified_hits"] == 1


def test_strict_rejects_before_the_first_round(monkeypatch):
    """A violating plan never reaches a gossip round."""
    def boom(*a, **kw):
        raise verify.VerificationError("schedule/half-duplex", "injected")

    def no_round(*a, **kw):
        raise AssertionError("a round ran")

    monkeypatch.setattr(verify, "_epoch_certificate", boom)
    monkeypatch.setattr(executors, "_timed_round", no_round)
    with pytest.raises(verify.VerificationError) as err:
        _cpu_run(scenarios.get("paper_table3"), verify="strict")
    assert err.value.invariant == "schedule/half-duplex"


def test_warn_mode_warns_and_runs(monkeypatch):
    def boom(*a, **kw):
        raise verify.VerificationError("schedule/half-duplex", "injected")

    monkeypatch.setattr(verify, "_epoch_certificate", boom)
    spec = scenarios.get("paper_table3")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = verify.verify_scenario_plans(spec, mode="warn")
    assert not out["ok"] and out["invariant"] == "schedule/half-duplex"
    assert any(issubclass(w.category, verify.VerificationWarning) for w in caught)
    with pytest.raises(verify.VerificationError):
        verify.verify_scenario_plans(spec, mode="strict")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        run = _cpu_run(spec, verify="warn")
    assert any(issubclass(w.category, verify.VerificationWarning) for w in caught)
    assert run.rounds and run.rounds[0].numerics_ok is True


def test_unknown_mode_raises():
    spec = scenarios.get("paper_table3")
    with pytest.raises(ValueError, match="verify must be one of"):
        _cpu_run(spec, verify="paranoid")
    with pytest.raises(ValueError, match="verify mode"):
        verify.verify_scenario_plans(spec, mode="off")


def test_off_does_not_import_the_verifier():
    code = ("import sys\n"
            "from repro_torch.scenario import DeviceExecutor, run_scenario\n"
            "run = run_scenario('paper_table3', executor=DeviceExecutor(device='cpu', "
            "proxy_elems=4))\n"
            "assert run.rounds[0].numerics_ok\n"
            "print(sorted(m for m in sys.modules if m.startswith('repro_torch.verify')))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "[]"


def _verify_trace(o, pkg, registry):
    """The verify spans' (name, members) and the verify counters of two
    scenarios verified under a recorder."""
    with o.recording(o.Recorder()) as rec:
        for name in ("paper_table3", "churn_storm"):
            pkg.verify_scenario_plans(registry.get(name), mode="strict")
    spans = [(e["name"], e["args"].get("members")) for e in o.chrome_trace(rec)["traceEvents"]
             if e.get("ph") == "X" and e.get("cat") == "verify"]
    return spans, {k: v for k, v in rec.counters.items() if k.startswith("verify.")}


def test_verify_track_and_counters_match_the_reference():
    spans, counters = _verify_trace(obs, verify, scenarios)
    assert (spans, counters) == _verify_trace(jax_obs, jax_verify, jax_scenarios)
    assert len(spans) == counters["verify.plans"] == 7  # paper_table3's epoch, churn_storm's 6


@pytest.mark.parametrize("name, executor", [
    ("paper_table3", "plan"), ("paper_table3", "engine"), ("paper_table3", "netsim"),
    ("churn_storm", "engine"), ("lossy_links", "engine"), ("async_stragglers", "event"),
    ("lossy_links", "event")])
def test_verify_result_on_host_executors_equals_the_reference(name, executor):
    spec, ref_spec = scenarios.get(name), jax_scenarios.get(name)
    ex = EngineExecutor(device="cpu") if executor == "engine" else executors.get(executor)
    cache = PlanCache()
    verify.verify_scenario_plans(spec, plan_cache=cache, mode="strict")
    got = verify.verify_result(spec, ex.execute(spec, plan_cache=cache), plan_cache=cache)
    want = jax_verify.verify_result(ref_spec, jax_run_scenario(ref_spec, executor=executor))
    assert got == want == spec.rounds


@pytest.mark.parametrize("name", sorted(PATH_SPECS))
def test_verify_result_accepts_the_card_runners_rounds(name):
    spec, ref_spec = PATH_SPECS[name](scenarios), PATH_SPECS[name](jax_scenarios)
    cache = PlanCache()
    run = _cpu_run(spec, plan_cache=cache, verify="strict")
    got = verify.verify_result(spec, run, plan_cache=cache)
    want = jax_verify.verify_result(ref_spec, jax_run_scenario(ref_spec, executor="plan"))
    assert got == want == len(run.rounds) == spec.rounds


def test_planted_byte_fault_on_a_card_round_is_rejected():
    """chip_smoke.py's planted fault, on the CPU run: one more MB on the
    wire in quantized_table3's first round."""
    spec = scenarios.get("quantized_table3")
    run = _cpu_run(spec)
    assert verify.verify_result(spec, run) == 1
    bad = dataclasses.replace(run, rounds=[dataclasses.replace(
        run.rounds[0], bytes_on_wire_mb=run.rounds[0].bytes_on_wire_mb + 1.0)])
    with pytest.raises(verify.VerificationError) as err:
        verify.verify_result(spec, bad)
    assert err.value.invariant == "conservation/bytes-on-wire"
    assert verify.verify_result(spec, run) == 1  # the run itself is untouched


# ---------------------------------------------------------------------------
# the CLI and the determinism lint
# ---------------------------------------------------------------------------

def _strip(text):
    return re.sub(r", [0-9.]+s\)", ")", text).splitlines()


def test_cli_scenarios_and_sweep_print_the_references_lines(capsys):
    from repro.verify.__main__ import main as jax_main
    from repro_torch.verify.__main__ import main

    for argv in (["--scenario", "paper_table3", "paper_flooding_baseline", "churn_storm"],
                 ["--sweep", "payload_latency_curve", "codec_x_protocol"]):
        assert main(argv) == 0
        ours = capsys.readouterr().out
        assert jax_main(argv) == 0
        assert _strip(ours) == _strip(capsys.readouterr().out)
        assert "verified ✓" in ours


def test_cli_lint_is_clean_with_the_ports_allowlist(capsys):
    from repro_torch.verify.__main__ import main

    assert main(["--lint"]) == 0
    assert capsys.readouterr().out.splitlines() == ["lint: 0 finding(s)"]


def test_the_allowlist_is_the_references_one_line():
    assert lint.load_allowlist(lint.ALLOWLIST) == [
        ("obs/recorder.py", "wall-clock", "time.perf_counter() read")]
    assert lint.load_allowlist(lint.ALLOWLIST) == jax_lint.load_allowlist(
        os.path.join(ROOT, "tools", "lint_allowlist.txt"))


def test_lint_without_the_allowlist_finds_the_two_recorder_reads():
    got = [(f.path, f.line, f.rule, f.detail) for f in lint.lint_tree(PORT_ROOT)]
    want = [(f.path, f.line, f.rule, f.detail) for f in jax_lint.lint_tree(PORT_ROOT)]
    assert got == want
    assert len(got) == 2
    assert {(p, r) for p, _, r, _ in got} == {("repro_torch/obs/recorder.py", "wall-clock")}
    assert lint.filter_allowed(lint.lint_tree(PORT_ROOT), lint.load_allowlist(lint.ALLOWLIST)) == []


# the reference test's fixtures: (source, module path, findings' (line, rule))
LINT_FIXTURES = {
    "numpy_rng": ("import numpy as np\nx = np.random.rand(3)\nrng = np.random.default_rng()\n"
                  "ok = np.random.default_rng(42)\n", "repro/somemod.py",
                  [(2, "unseeded-rng"), (3, "unseeded-rng")]),
    "stdlib_rng": ("import random\nx = random.random()\nr = random.Random()\n"
                   "ok = random.Random(7)\n", "repro/somemod.py",
                   [(2, "unseeded-rng"), (3, "unseeded-rng")]),
    "wall_clock_virtual": ("import time\nt = time.time()\np = time.perf_counter()\n",
                           "repro/core/events.py", [(2, "wall-clock"), (3, "wall-clock")]),
    "wall_clock_elsewhere": ("import time\nt = time.time()\np = time.perf_counter()\n",
                             "repro/core/graph.py", []),
    "dict_order": ("def thing_fingerprint(spec):\n"
                   "    out = [v for v in set(spec.values)]\n"
                   "    for k in spec.extras.keys():\n"
                   "        out.append(k)\n"
                   "    out += [v for v in sorted(set(spec.more))]\n"
                   "    return tuple(out)\n"
                   "def not_a_key_builder(spec):\n"
                   "    return list(set(spec.values))\n", "repro/somemod.py",
                   [(2, "dict-order-in-fingerprint"), (3, "dict-order-in-fingerprint")]),
}


@pytest.mark.parametrize("fixture", sorted(LINT_FIXTURES))
def test_lint_rule_fires_as_the_references(fixture, tmp_path):
    source, rel, want = LINT_FIXTURES[fixture]
    path = tmp_path / "fixture.py"
    path.write_text(source)
    got = [(f.line, f.rule, f.detail) for f in lint.lint_file(str(path), rel)]
    assert got == [(f.line, f.rule, f.detail) for f in jax_lint.lint_file(str(path), rel)]
    assert sorted((line, rule) for line, rule, _ in got) == want


def test_fingerprint_coverage_of_the_ports_spec_and_cache(monkeypatch):
    assert lint.check_fingerprint_coverage(PORT_ROOT) == []
    trimmed = {k: v for k, v in lint.SPEC_FIELD_ROLES.items() if k != "codec"}
    monkeypatch.setattr(lint, "SPEC_FIELD_ROLES", trimmed)
    monkeypatch.setattr(jax_lint, "SPEC_FIELD_ROLES", trimmed)
    got = [str(f) for f in lint.check_fingerprint_coverage(PORT_ROOT)]
    assert got == [str(f) for f in jax_lint.check_fingerprint_coverage(PORT_ROOT)]
    assert any("ScenarioSpec.codec is not classified" in f for f in got)
