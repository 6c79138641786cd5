"""The port's plan cache against the JAX package's, on the CPU.

* One cache threaded through the same sequence of executor runs and sweeps
  (``table3_full`` and ``codec_x_protocol`` among them) leaves the
  reference's ``counters`` after every call, and the same ``stats()``.
* The plan executor's batched ``run_cells`` equals serial ``execute``
  field for field, and both equal the reference's batched sweep.
* The engine and event executors give the same rows with a shared cache as
  with a cold one.
* A traced run's ``RunReport`` equals the reference's: counters, bytes,
  gauges, the plan-cache delta, and the span count of every category (the
  wall seconds aside).
* ``record_trace=True`` through ``execute`` and ``run_sweep`` keeps the
  reference's fluid-simulator send traces (netsim) and event log (event),
  and leaves the rows as they are without it.
"""
import pytest

pytest.importorskip("torch")

from repro import obs as jax_obs  # noqa: E402
from repro.scenario import run_scenario as jax_run_scenario  # noqa: E402
from repro.scenario import run_sweep as jax_run_sweep  # noqa: E402
from repro.scenario import executors as jax_executors  # noqa: E402
from repro.scenario import scenarios as jax_scenarios  # noqa: E402
from repro.scenario.cache import PlanCache as JaxPlanCache  # noqa: E402
from repro.scenario.cache import overlay_fingerprint as jax_overlay_fingerprint  # noqa: E402
from repro.scenario.cache import policy_key as jax_policy_key  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.scenario import executors, run_sweep, scenarios  # noqa: E402
from repro_torch.scenario.cache import PlanCache, overlay_fingerprint, policy_key  # noqa: E402
from repro_torch.scenario.executors import EngineExecutor  # noqa: E402

# (kind, name, executor): the calls both packages make with one cache
SEQUENCE = (("scenario", "paper_table3", "plan"), ("scenario", "paper_table3", "netsim"),
            ("sweep", "table3_full", "plan"), ("scenario", "churn_storm", "engine"),
            ("sweep", "codec_x_protocol", "plan"), ("scenario", "churn_storm", "plan"),
            ("scenario", "lossy_links", "event"), ("sweep", "table3_full", "plan"),
            ("sweep", "wan_sweep", "plan"), ("scenario", "paper_table3", "plan"))


def _ours(kind, name, ex, cache):
    ex = EngineExecutor(device="cpu") if ex == "engine" else executors.get(ex)
    if kind == "sweep":
        return run_sweep(scenarios.get_sweep(name), executor=ex, plan_cache=cache)
    return ex.execute(scenarios.get(name), plan_cache=cache)


def _theirs(kind, name, ex, cache):
    if kind == "sweep":
        return jax_run_sweep(jax_scenarios.get_sweep(name), executor=ex, plan_cache=cache)
    return jax_run_scenario(jax_scenarios.get(name), executor=ex, plan_cache=cache)


def test_one_cache_through_a_sequence_leaves_the_reference_counters():
    cache, ref = PlanCache(), JaxPlanCache()
    for call in SEQUENCE:
        got, want = _ours(*call, cache), _theirs(*call, ref)
        assert got.to_dict() == want.to_dict(), call
        assert cache.counters == ref.counters, call
    assert cache.stats() == ref.stats()
    assert cache.snapshot() == ref.snapshot()
    cache.reset()
    assert set(cache.counters.values()) == {0}
    assert cache.stats()["unique_policies"] == ref.stats()["unique_policies"] > 0


def test_keys_and_fingerprints_match_the_reference():
    for name in ("paper_table3", "scale_1000", "hetero_edge"):
        ours, theirs = scenarios.get(name), jax_scenarios.get(name)
        assert overlay_fingerprint(ours) == jax_overlay_fingerprint(theirs)
        members = tuple(range(ours.n))
        assert policy_key(ours, members) == jax_policy_key(theirs, members)
    cell = scenarios.get_sweep("optimized_vs_mst").cells()[1].spec
    ref_cell = jax_scenarios.get_sweep("optimized_vs_mst").cells()[1].spec
    assert overlay_fingerprint(cell) == jax_overlay_fingerprint(ref_cell)


@pytest.mark.parametrize("name", ("table3_full", "codec_x_protocol", "wan_sweep",
                                  "payload_latency_curve", "optimized_vs_mst"))
def test_batched_run_cells_equals_serial_and_the_reference(name):
    sweep = scenarios.get_sweep(name)
    cache = PlanCache()
    batched = executors.get("plan").run_cells(sweep.cells(), plan_cache=cache)
    serial = [executors.get("plan").execute(c.spec) for c in sweep.cells()]
    want = jax_run_sweep(jax_scenarios.get_sweep(name), executor="plan")
    assert len(batched) == len(serial) == len(want.cells)
    for b, s, w in zip(batched, serial, want.cells):
        assert [r.to_dict() for r in b.rounds] == [r.to_dict() for r in s.rounds]
        assert b.to_dict() == s.to_dict() == w.result.to_dict()
    got = run_sweep(sweep, executor="plan")
    assert got.to_dict() == want.to_dict()
    assert got[0].result.to_dict() == batched[0].to_dict()


@pytest.mark.parametrize("ex,name", (("engine", "codec_x_protocol"), ("engine", "table3_full"),
                                     ("event", "table3_full"), ("event", "wan_sweep")))
def test_engine_and_event_rows_equal_with_a_shared_or_a_cold_cache(ex, name):
    make = (lambda: EngineExecutor(device="cpu")) if ex == "engine" else (
        lambda: executors.get("event"))
    sweep = scenarios.get_sweep(name)
    shared = run_sweep(sweep, executor=make())
    cold = [make().execute(c.spec, plan_cache=PlanCache()) for c in sweep.cells()]
    assert [c.result.to_dict() for c in shared.cells] == [r.to_dict() for r in cold]
    assert shared.cache_stats["policy_hits"] > 0
    want = jax_run_sweep(jax_scenarios.get_sweep(name), executor=ex)
    assert shared.to_dict() == want.to_dict()


def _without_wall_seconds(report):
    out = dict(report)
    out["phases"] = {k: v["spans"] for k, v in report["phases"].items()}
    return out


@pytest.mark.parametrize("name", ("churn_storm", "optimized_vs_mst"))
def test_a_traced_runs_report_equals_the_references(name):
    if name == "optimized_vs_mst":
        spec = scenarios.get_sweep(name).cells()[1].spec
        ref_spec = jax_scenarios.get_sweep(name).cells()[1].spec
    else:
        spec, ref_spec = scenarios.get(name), jax_scenarios.get(name)
    cache, ref_cache = PlanCache(), JaxPlanCache()
    with obs.recording(obs.Recorder()) as rec:
        got = executors.get("plan").execute(spec, plan_cache=cache)
        again = executors.get("plan").execute(spec, plan_cache=cache)
    with jax_obs.recording(jax_obs.Recorder()) as ref_rec:
        want = jax_run_scenario(ref_spec, executor="plan", plan_cache=ref_cache)
        want_again = jax_run_scenario(ref_spec, executor="plan", plan_cache=ref_cache)
    for a, b in ((got, want), (again, want_again)):
        assert a.report is not None and b.report is not None
        assert _without_wall_seconds(a.report) == _without_wall_seconds(b.report)
        assert {k: v for k, v in a.to_dict().items() if k != "report"} == \
            {k: v for k, v in b.to_dict().items() if k != "report"}
    assert again.report["cache"].get("policy_misses", 0) == 0
    assert rec.counters == ref_rec.counters
    assert len(rec.samples) == len(ref_rec.samples)
    obs.validate_trace(obs.chrome_trace(rec))
    assert executors.get("plan").execute(spec).report is None


@pytest.mark.parametrize("ex,name", (("netsim", "paper_table3"), ("netsim", "churn_storm"),
                                     ("event", "lossy_links"), ("event", "async_stragglers")))
def test_record_trace_keeps_the_references_send_trace_and_event_log(ex, name):
    ours, theirs = executors.get(ex), jax_executors.get(ex)
    got = ours.execute(scenarios.get(name), record_trace=True)
    want = theirs.execute(jax_scenarios.get(name), record_trace=True)
    assert got.to_dict() == want.to_dict()
    assert got.to_dict() == executors.get(ex).execute(scenarios.get(name)).to_dict()
    if ex == "netsim":
        traces = [s.send_trace for s in got.sim_results]
        assert all(traces) and traces == [s.send_trace for s in want.sim_results]
        assert executors.get(ex).execute(scenarios.get(name)).sim_results[0].send_trace is None
    else:
        assert ours._engine.events and ours._engine.events == theirs._engine.events


def test_run_sweep_with_record_trace_keeps_the_references_send_traces():
    got = run_sweep(scenarios.get_sweep("table3_full"), executor="netsim", record_trace=True)
    want = jax_run_sweep(jax_scenarios.get_sweep("table3_full"), executor="netsim",
                         record_trace=True)
    assert got.to_dict() == want.to_dict()
    traces = [[s.send_trace for s in c.result.sim_results] for c in got.cells]
    assert all(all(t) for t in traces)
    assert traces == [[s.send_trace for s in c.result.sim_results] for c in want.cells]
