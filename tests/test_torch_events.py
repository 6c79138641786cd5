"""The port's event engine, ``estimate_throughput`` and event executor held
to the JAX package's on the CPU (``repro.core.events``,
``repro.core.network``, ``repro.scenario``), with ``==``: the copy keeps the
reference's heap tie-breaking, seeded draw order and float operand order.

* ``AsyncEventEngine``: four rounds (one of them over a churned member
  set) per protocol x staleness x drop rate x underlay: every
  ``RoundTiming`` field, the event log in order, the per-attempt transfers,
  ``link_busy``, ``link_free``, ``node_spans`` and ``virtual_spans``.
* ``estimate_throughput`` on a live policy and on its compiled plan, and
  its ±15% contract against multi-round runs of the event executor.
* The event executor against ``run_scenario(spec, executor="event")`` on
  the registry (``scale_1000`` runs on plan and engine, as its spec says)
  and on ``async_vs_sync``'s 27 cells, every ``RoundReport`` field, and
  its virtual spans and counters under a recorder; staleness 0 equal to
  the netsim executor's bytes; the capability errors.
"""
import ast
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import obs as ref_obs  # noqa: E402
from repro.core.events import AsyncEventEngine as RefEngine  # noqa: E402
from repro.core.events import plan_slots as ref_plan_slots  # noqa: E402
from repro.core.events import policy_slots as ref_policy_slots  # noqa: E402
from repro.core.graph import TopologySpec as RefTopologySpec  # noqa: E402
from repro.core.graph import make_topology as ref_make_topology  # noqa: E402
from repro.core.network import as_network_model as ref_network  # noqa: E402
from repro.core.network import estimate_throughput as ref_estimate_throughput  # noqa: E402
from repro.core.network import get_preset as ref_get_preset  # noqa: E402
from repro.core.plan import compile_policy as ref_compile_policy  # noqa: E402
from repro.core.plan import make_policy as ref_make_policy  # noqa: E402
from repro.scenario import run_scenario as ref_run_scenario  # noqa: E402
from repro.scenario import run_sweep as ref_run_sweep  # noqa: E402
from repro.scenario import scenarios as ref_scenarios  # noqa: E402
from repro.scenario.spec import ScenarioSpec as RefScenarioSpec  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import (AsyncEventEngine, TopologySpec, compile_policy,  # noqa: E402
                              estimate_throughput, make_policy, make_topology, plan_slots,
                              policy_slots)
from repro_torch.core.network import as_network_model, get_preset  # noqa: E402
from repro_torch.scenario import executors, run_sweep, scenarios  # noqa: E402
from repro_torch.scenario.spec import ScenarioSpec  # noqa: E402

PROTOCOLS = ("mosgu", "segmented", "flooding")
EVENT_SCENARIOS = ("lossy_links", "churn_storm", "paper_table3", "quantized_table3",
                   "topk_sweep", "segmented_sweep", "async_stragglers")
# the ±15% contract of estimate_throughput against multi-round runs
TOL_LO, TOL_HI = 0.85, 1.15


def _policies(protocol, n=8, seed=3, kind="erdos_renyi"):
    spec = dict(kind=kind, n=n, seed=seed)
    return (make_policy(protocol, make_topology(TopologySpec(**spec)), n_segments=3),
            ref_make_policy(protocol, ref_make_topology(RefTopologySpec(**spec)), n_segments=3))


def _fields(obj):
    """A result dataclass as its fields (the two packages' classes differ,
    so the dataclasses themselves never compare equal)."""
    return dataclasses.asdict(obj)


def _slots_equal(a, b):
    assert len(a) == len(b)
    for (s, d), (rs, rd) in zip(a, b):
        assert s.dtype == rs.dtype and d.dtype == rd.dtype
        np.testing.assert_array_equal(s, rs)
        np.testing.assert_array_equal(d, rd)


@pytest.mark.parametrize("preset", ("paper_lan", "wan"))
@pytest.mark.parametrize("drop_rate", (0.0, 0.15))
@pytest.mark.parametrize("staleness", (0, 1, 2))
@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_event_engine_equals_the_reference(protocol, staleness, drop_rate, preset):
    n = 8
    pol, ref_pol = _policies(protocol, n)
    slots, ref_slots = policy_slots(pol), ref_policy_slots(ref_pol)
    _slots_equal(slots, ref_slots)
    sub, ref_sub = _policies(protocol, n - 1, seed=5)  # the churned epoch's plan
    sub_slots, ref_sub_slots = policy_slots(sub), ref_policy_slots(ref_sub)
    _slots_equal(sub_slots, ref_sub_slots)
    under, ref_under = get_preset(preset, n), ref_get_preset(preset, n)
    full, churned = tuple(range(n)), tuple(u for u in range(n) if u != 3)
    kw = dict(max_staleness=staleness, drop_rate=drop_rate, drop_seed=13, record_events=True)
    ours, ref = AsyncEventEngine(**kw), RefEngine(**kw)
    rng = np.random.default_rng(4)
    for r, members in enumerate((full, full, churned, full)):
        compute = 1.0 + rng.random(len(members)) * 2.0
        a, b = ((slots, ref_slots) if members == full else (sub_slots, ref_sub_slots))
        ours.add_round(members, as_network_model(under.masked(members)), a, 9.8, compute.copy())
        ref.add_round(members, ref_network(ref_under.masked(members)), b, 9.8, compute.copy())
    got, want = ours.run(), ref.run()
    assert [_fields(t) for t in got] == [_fields(t) for t in want]  # every field, ==
    assert [t.makespan_s for t in got] == [t.makespan_s for t in want]
    assert [(t.mean_transfer_s(), t.mean_bandwidth_mbps()) for t in got] == \
        [(t.mean_transfer_s(), t.mean_bandwidth_mbps()) for t in want]
    assert ours.events == ref.events and len(ours.events) > 0
    assert ours.transfers == ref.transfers
    assert ours.link_busy == ref.link_busy and ours.link_free == ref.link_free
    for r in range(4):
        np.testing.assert_array_equal(ours.node_spans(r), ref.node_spans(r))
    assert ours.virtual_spans() == ref.virtual_spans()
    if drop_rate:
        assert sum(t.drops for t in got) > 0


def test_event_engine_plan_slots_and_empty_run():
    pol, ref_pol = _policies("mosgu")
    _slots_equal(plan_slots(compile_policy(pol)), ref_plan_slots(ref_compile_policy(ref_pol)))
    _slots_equal(plan_slots(pol), policy_slots(pol))
    assert AsyncEventEngine().run() == RefEngine().run() == []


@pytest.mark.parametrize("compiled", (False, True), ids=("policy", "plan"))
@pytest.mark.parametrize("staleness", (0, 1, 2))
@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_estimate_throughput_equals_the_reference(protocol, staleness, compiled):
    pol, ref_pol = _policies(protocol, 10)
    plan, ref_plan = ((compile_policy(pol), ref_compile_policy(ref_pol)) if compiled
                      else (pol, ref_pol))
    for preset in ("paper_lan", "edge"):
        got = estimate_throughput(plan, preset, 21.2e6, max_staleness=staleness,
                                  compute_time_s=5.0, compute_jitter_s=4.0)
        want = ref_estimate_throughput(ref_plan, preset, 21.2e6, max_staleness=staleness,
                                       compute_time_s=5.0, compute_jitter_s=4.0)
        assert _fields(got) == _fields(want)


def _async_spec(cls, **over):
    topo = TopologySpec if cls is ScenarioSpec else RefTopologySpec
    base = dict(name="async_test", overlay=topo(kind="erdos_renyi", n=8, seed=3),
                protocol="mosgu", payload="v3s", rounds=8, max_staleness=1,
                compute_time_s=2.0, compute_jitter_s=1.5, executors=("event",))
    base.update(over)
    return cls(**base)


@pytest.mark.parametrize("staleness", (0, 1, 2))
@pytest.mark.parametrize("protocol", ("mosgu", "segmented"))
def test_estimate_throughput_within_15pct_of_the_event_executor(protocol, staleness):
    spec = _async_spec(ScenarioSpec, protocol=protocol, max_staleness=staleness)
    ex = executors.get("event")
    res = ex.execute(spec)
    comp = [r.completed_at_s for r in res.rounds]
    warm = staleness + 2
    measured = (comp[-1] - comp[warm - 1]) / (len(comp) - warm)
    est = estimate_throughput(ex.policy, ex._net, ex.wire_send_mb * 1e6,
                              max_staleness=staleness, compute_time_s=spec.compute_time_s,
                              compute_jitter_s=spec.compute_jitter_s)
    assert TOL_LO <= est.steady_period_s / measured <= TOL_HI
    assert res.to_dict() == ref_run_scenario(
        _async_spec(RefScenarioSpec, protocol=protocol, max_staleness=staleness),
        executor="event").to_dict()


def test_async_stragglers_steady_rate_within_15pct_of_the_estimate():
    spec = scenarios.get("async_stragglers")
    ex = executors.get("event")
    comp = [r.completed_at_s for r in ex.execute(spec).rounds]
    warm = spec.max_staleness + 2
    measured = (comp[-1] - comp[warm - 1]) / (len(comp) - warm)
    est = estimate_throughput(ex.policy, ex._net, ex.wire_send_mb * 1e6,
                              max_staleness=spec.max_staleness,
                              compute_time_s=spec.compute_time_s,
                              compute_jitter_s=spec.compute_jitter_s)
    assert TOL_LO <= est.steady_period_s / measured <= TOL_HI


@pytest.mark.parametrize("name", EVENT_SCENARIOS)
def test_event_executor_round_reports_equal_the_reference(name):
    got = executors.get("event").execute(scenarios.get(name))
    want = ref_run_scenario(ref_scenarios.get(name), executor="event")
    assert got.to_dict() == want.to_dict()
    for r in got.rounds:
        assert r.admitted_at_s is not None and r.completed_at_s > r.admitted_at_s
        assert all(ev["applied_at_s"] == r.admitted_at_s for ev in r.churn_applied)
    if name == "lossy_links":
        assert all(r.drops > 0 for r in got.rounds)
    if name == "churn_storm":
        assert any(r.churn_applied for r in got.rounds)


def test_async_vs_sync_cells_on_event_equal_the_reference():
    got = run_sweep(scenarios.get_sweep("async_vs_sync"), executor="event")
    want = ref_run_sweep(ref_scenarios.get_sweep("async_vs_sync"), executor="event")
    assert len(got.cells) == len(want.cells) == 27
    for c, w in zip(got.cells, want.cells):
        assert c.coords == w.coords
        assert c.result.to_dict() == w.result.to_dict()
    assert got.to_dict()["marginals"] == want.to_dict()["marginals"]


def _virtual(spans):
    return [(s.name, s.track, s.cat, s.t0, s.t1, s.args) for s in spans
            if s.cat in ("event-round", "node", "compute", "link")]


def test_event_executor_writes_the_references_virtual_spans_and_counters():
    spec = scenarios.get("lossy_links")
    with obs.recording(obs.Recorder()) as rec:
        got = executors.get("event").execute(spec)
    ref_rec = ref_obs.Recorder()
    with ref_obs.recording(ref_rec):
        want = ref_run_scenario(ref_scenarios.get("lossy_links"), executor="event")
    assert {k: v for k, v in got.to_dict().items() if k != "report"} == \
        {k: v for k, v in want.to_dict().items() if k != "report"}
    assert got.report["cache"] == want.report["cache"]
    assert _virtual(rec.spans) == _virtual(ref_rec.spans) and _virtual(rec.spans)
    rounds = [s for s in rec.spans if s.track == "rounds"]
    assert sum(s.duration_s for s in rounds) == pytest.approx(got.total_time_s)
    for key in ("event.retries", "bytes.wire_mb", "transmissions", "slots", "drops"):
        assert rec.counters[key] == ref_rec.counters[key], key
    assert rec.gauges["event.makespan_s"] == ref_rec.gauges["event.makespan_s"]
    assert [(s.name, s.track, s.cat) for s in rec.spans if s.track == "exec/event"] == \
        [(s.name, s.track, s.cat) for s in ref_rec.spans if s.track == "exec/event"]


NETSIM_CAPABLE = [n for n in scenarios.names() if "netsim" in scenarios.get(n).executors]


@pytest.mark.parametrize("name", NETSIM_CAPABLE)
def test_staleness_zero_bytes_equal_the_netsim_executor(name):
    spec = scenarios.get(name)
    assert spec.max_staleness == 0
    fluid = executors.get("netsim").execute(spec)
    event = executors.get("event").execute(spec)
    assert len(fluid.rounds) == len(event.rounds)
    for a, b in zip(fluid.rounds, event.rounds):
        assert (b.bytes_on_wire_mb, b.transmissions, b.bytes_mb, b.n_slots, b.members) == \
            (a.bytes_on_wire_mb, a.transmissions, a.bytes_mb, a.n_slots, a.members)


def test_staleness_window_semantics():
    sync = executors.get("event").execute(_async_spec(ScenarioSpec, max_staleness=0))
    for prev, cur in zip(sync.rounds, sync.rounds[1:]):
        assert cur.admitted_at_s == prev.completed_at_s  # the barrier
    pipe = executors.get("event").execute(_async_spec(ScenarioSpec, max_staleness=2))
    assert any(cur.admitted_at_s < prev.completed_at_s
               for prev, cur in zip(pipe.rounds, pipe.rounds[1:]))
    assert pipe.rounds[-1].completed_at_s < sync.rounds[-1].completed_at_s
    comp = [r.completed_at_s for r in pipe.rounds]
    assert all(a < b for a, b in zip(comp, comp[1:]))


@pytest.mark.parametrize("ex,spec,flag,providers", [
    ("plan", "lossy_links", "supports_drops", "['engine', 'event']"),
    ("netsim", "async_stragglers", "supports_staleness", "['event']"),
    ("engine", "async_stragglers", "supports_staleness", "['event']"),
    ("event", "paper_table3/moves_payloads", "moves_payloads", "['engine']"),
    ("plan", "paper_table3/provides_numerics", "provides_numerics", "[]"),
])
def test_capability_errors_name_the_providers(ex, spec, flag, providers):
    name, _, need = spec.partition("/")
    s = scenarios.get(name)
    if need:
        s = s.replace(require=(need,))
    runner = executors.EngineExecutor(device="cpu") if ex == "engine" else executors.get(ex)
    with pytest.raises(ValueError, match=f"executor '{ex}' lacks capability '{flag}'") as err:
        runner.execute(s)
    # ``providers`` are the host executors with the flag; the card executor
    # (``device``, the reference's ``jax``) provides numerics and moves payloads
    want = sorted(ast.literal_eval(providers)
                  + (["device"] if getattr(executors.DeviceExecutor, flag) else []))
    assert str(err.value).endswith(f"executors providing it: {want}")
