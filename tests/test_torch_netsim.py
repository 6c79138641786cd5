"""The port's fluid simulator (``repro_torch.core.netsim``) and its two
timing executors against the JAX package's, on the CPU.

* ``simulate_policy`` over the grid of the four presets x every scenario
  the port registers x codec {fp32, int8, top-k}: every :class:`SimResult`
  field equal to the reference's, the per-transfer durations and the launch
  trace included; the paper's wrappers (flooding, MOSGU live and replayed
  from a compiled plan, the two exchange units), ``compare_protocols`` and
  :class:`TestbedSpec` (``from_overlay``, routing, masking) likewise.
* The ``plan`` and ``netsim`` executors: every registered scenario's
  ``RoundReport``s and ``to_dict()`` (``totals`` with ``time_s``) equal to
  the reference executors', churn epochs included; ``run_sweep`` of
  ``table3_full`` and ``wan_sweep`` on both, tables and ``marginals()``.
* The reference's +-15% contract of the analytic model: the port's ``plan``
  round times within 15% of its ``netsim`` ones on every registered
  scenario the fluid simulator runs, every round.
* Underlays on a spec (a preset name, a ``NetworkSpec``, a ``TestbedSpec``)
  validate and serialize as the reference's; the card executor runs the
  scenarios this slice registers (the all-gather for the flooding
  baseline) with the plan executor's counts.
"""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.compress import make_codec as ref_make_codec  # noqa: E402
from repro.core import netsim as ref  # noqa: E402
from repro.core.network import NetworkSpec as RefNetworkSpec  # noqa: E402
from repro.core.network import get_preset as ref_get_preset  # noqa: E402
from repro.core.plan import compile_policy as ref_compile_policy  # noqa: E402
from repro.core.plan import make_policy as ref_make_policy  # noqa: E402
from repro.scenario import run_scenario as ref_run_scenario  # noqa: E402
from repro.scenario import run_sweep as ref_run_sweep  # noqa: E402
from repro.scenario import scenarios as ref_scenarios  # noqa: E402
from repro.scenario.spec import ScenarioSpec as RefScenarioSpec  # noqa: E402
from repro_torch.compress import make_codec  # noqa: E402
from repro_torch.core import netsim  # noqa: E402
from repro_torch.core.network import NetworkSpec, get_preset  # noqa: E402
from repro_torch.core.plan import compile_policy, make_policy  # noqa: E402
from repro_torch.scenario import executors, run_scenario, run_sweep, scenarios  # noqa: E402
from repro_torch.scenario.spec import ScenarioSpec  # noqa: E402

PRESETS = ("paper_lan", "wan", "edge", "congested")
CODECS = ("fp32", "int8", "topk")
# the registry's scenarios that the plan and netsim executors run: lossy_links
# needs drops, async_stragglers the staleness window, and scale_1000 (N=1000)
# runs on plan and engine only (tests/test_torch_gossip_engine.py and
# tests/test_torch_events.py hold them on the engine and event executors);
# scale_100k and scale_1m are counting-only sparse cells
# (tests/test_torch_sparse_scale.py)
ENGINE_AND_EVENT_ONLY = ("async_stragglers", "lossy_links", "scale_1000", "scale_100k",
                         "scale_1m")
SCENARIOS = tuple(n for n in scenarios.names() if n not in ENGINE_AND_EVENT_ONLY)
SIM_FIELDS = ("total_time_s", "mean_transfer_s", "mean_bandwidth_mbps", "n_transfers",
              "max_concurrency", "bytes_on_wire_mb", "per_transfer_s", "send_trace")
# the +-15% acceptance bound of the analytic timing model (the reference's)
TOL_LO, TOL_HI = 0.85, 1.15


def assert_sims_equal(got, want):
    for f in SIM_FIELDS:
        assert getattr(got, f) == getattr(want, f), f


def _codecs(codec):
    c, rc = make_codec(codec), ref_make_codec(codec)
    return (None, None) if c.name == "fp32" else (c, rc)


def _policies(name):
    ours, theirs = scenarios.get(name), ref_scenarios.get(name)
    kw = dict(mst_algorithm=ours.mst_algorithm, coloring_algorithm=ours.coloring_algorithm,
              n_segments=ours.n_segments)
    return (ours, make_policy(ours.protocol, ours.overlay_graph(), **kw),
            theirs, ref_make_policy(theirs.protocol, theirs.overlay_graph(), **kw))


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("name", SCENARIOS)
@pytest.mark.parametrize("preset", PRESETS)
def test_fluid_simulation_equals_the_reference(preset, name, codec):
    ours, pol, theirs, ref_pol = _policies(name)
    c, rc = _codecs(codec)
    got = netsim.simulate_policy(pol, get_preset(preset, ours.n), ours.payload_mb(),
                                 record_trace=True, codec=c)
    want = ref.simulate_policy(ref_pol, ref_get_preset(preset, theirs.n), theirs.payload_mb(),
                               record_trace=True, codec=rc)
    assert got.n_transfers > 0
    assert_sims_equal(got, want)


def test_paper_wrappers_equal_the_reference():
    g = scenarios.get("paper_table3").overlay_graph()
    g_ref = ref_scenarios.get("paper_table3").overlay_graph()
    bed, ref_bed = netsim.TestbedSpec(n=10), ref.TestbedSpec(n=10)
    for mb in (9.8, 21.2):
        assert_sims_equal(netsim.simulate_flooding(g, bed, mb), ref.simulate_flooding(g_ref, ref_bed, mb))
        assert_sims_equal(netsim.simulate_mosgu(g, bed, mb), ref.simulate_mosgu(g_ref, ref_bed, mb))
        plan = compile_policy(make_policy("mosgu", g))
        replayed = netsim.simulate_mosgu(g, bed, mb, plan=plan)
        assert_sims_equal(replayed, ref.simulate_mosgu(
            g_ref, ref_bed, mb, plan=ref_compile_policy(ref_make_policy("mosgu", g_ref))))
        assert_sims_equal(replayed, netsim.simulate_mosgu(g, bed, mb))  # the IR as-is
        assert_sims_equal(netsim.simulate_broadcast_exchange(bed, mb),
                          ref.simulate_broadcast_exchange(ref_bed, mb))
        assert_sims_equal(netsim.simulate_mosgu_exchange(g, bed, mb),
                          ref.simulate_mosgu_exchange(g_ref, ref_bed, mb))


@pytest.mark.parametrize("kw", [
    dict(topology="erdos_renyi", model_mb=21.2, seed=3),
    dict(topology="watts_strogatz", model_mb=49.0, n=12, seed=2, full_dissemination=True),
    dict(topology="complete", model_mb=9.8, protocols=("segmented", "tree_allreduce"),
         n_segments=3),
])
def test_compare_protocols_equals_the_reference(kw):
    got, want = netsim.compare_protocols(**kw), ref.compare_protocols(**kw)
    assert list(got) == list(want)
    for k in want:
        assert_sims_equal(got[k], want[k])
    spec = kw.copy()
    got = netsim.compare_protocols(spec=netsim.TestbedSpec(n=spec.get("n", 10), trunk_mbps=8.0),
                                   **spec)
    want = ref.compare_protocols(spec=ref.TestbedSpec(n=spec.get("n", 10), trunk_mbps=8.0),
                                 **spec)
    for k in want:
        assert_sims_equal(got[k], want[k])


def test_testbed_spec_equals_the_reference():
    for name in SCENARIOS:
        ov, ref_ov = scenarios.get(name).overlay, ref_scenarios.get(name).overlay
        bed, ref_bed = netsim.TestbedSpec.from_overlay(ov), ref.TestbedSpec.from_overlay(ref_ov)
        assert dataclasses.asdict(bed) == dataclasses.asdict(ref_bed)
        members = tuple(range(0, bed.n, 3))
        for b, rb in ((bed, ref_bed), (bed.masked(members), ref_bed.masked(members))):
            assert dataclasses.asdict(b) == dataclasses.asdict(rb)
            for u in range(b.n):
                assert b.subnet(u) == rb.subnet(u)
                for v in range(b.n):
                    assert b.links_for(u, v) == rb.links_for(u, v)
                    assert b.latency(u, v) == rb.latency(u, v)


def _run(ex, ours, theirs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the flooding estimate's contract warning
        return executors.get(ex).execute(ours), ref_run_scenario(theirs, executor=ex)


@pytest.mark.parametrize("name", SCENARIOS)
@pytest.mark.parametrize("ex", ("plan", "netsim"))
def test_executor_round_reports_equal_the_reference(ex, name):
    ours, theirs = scenarios.get(name), ref_scenarios.get(name)
    if ex == "netsim":
        assert executors.get(ex).provides_timing
    got, want = _run(ex, ours, theirs)
    assert got.to_dict() == want.to_dict()
    assert got.total_time_s == want.total_time_s > 0
    assert got.to_dict()["totals"]["time_s"] is not None
    for r in got.rounds:
        assert None not in (r.total_time_s, r.mean_transfer_s, r.mean_bandwidth_mbps,
                            r.max_concurrency)
    if ex == "netsim":
        assert len(got.sim_results) == len(want.sim_results) == ours.rounds
        for g, w in zip(got.sim_results, want.sim_results):
            assert_sims_equal(g, w)


@pytest.mark.parametrize("underlay", PRESETS)
@pytest.mark.parametrize("name", ("churn_storm", "segmented_sweep", "paper_flooding_baseline"))
def test_executors_on_every_underlay_equal_the_reference(name, underlay):
    ours = scenarios.get(name).replace(underlay=underlay, codec="int8")
    theirs = ref_scenarios.get(name).replace(underlay=underlay, codec="int8")
    for ex in ("plan", "netsim"):
        got, want = _run(ex, ours, theirs)
        assert got.to_dict() == want.to_dict(), ex


@pytest.mark.parametrize("sweep", ("table3_full", "wan_sweep"))
@pytest.mark.parametrize("ex", ("plan", "netsim"))
def test_sweep_tables_and_marginals_equal_the_reference(ex, sweep):
    got = run_sweep(scenarios.get_sweep(sweep), executor=ex)
    want = ref_run_sweep(ref_scenarios.get_sweep(sweep), executor=ex)
    assert got.executor == ex and got.table() == want.table()
    assert got.marginals() == want.marginals()
    assert all(row["mean_time_s"] > 0 for rows in got.marginals().values()
               for row in rows.values())
    assert got.to_dict()["marginals"] == want.to_dict()["marginals"]


@pytest.mark.parametrize("name", [n for n in SCENARIOS
                                  if "netsim" in scenarios.get(n).executors])
def test_plan_within_15pct_of_fluid_on_registry(name):
    spec = scenarios.get(name)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        analytic = executors.get("plan").execute(spec)
    fluid = executors.get("netsim").execute(spec)
    for ra, rf in zip(analytic.rounds, fluid.rounds):
        ratio = ra.total_time_s / rf.total_time_s
        assert TOL_LO < ratio < TOL_HI, (name, ra.round, ratio)


def test_broadcast_exchange_estimate_is_exact():
    """All-at-once equal flows on a shared bottleneck: the closed form
    equals the fluid simulator (to its float rounding)."""
    from repro_torch.core.network import estimate_timing

    g = scenarios.get("paper_flooding_baseline").overlay_graph()
    pol, bed = make_policy("broadcast_exchange", g), netsim.TestbedSpec(n=10)
    sim = netsim.simulate_policy(pol, bed, 21.2)
    assert estimate_timing(pol, bed, 21.2e6).total_time_s == pytest.approx(sim.total_time_s,
                                                                          rel=1e-3)


def test_underlays_on_a_spec_serialize_as_the_reference():
    base, ref_base = scenarios.get("paper_table3"), ref_scenarios.get("paper_table3")
    for und, ref_und in (("edge", "edge"), (NetworkSpec(n=10, router_kind="line", n_subnets=4),
                                           RefNetworkSpec(n=10, router_kind="line", n_subnets=4)),
                         (netsim.TestbedSpec(n=10, trunk_mbps=12.0),
                          ref.TestbedSpec(n=10, trunk_mbps=12.0))):
        ours, theirs = base.replace(underlay=und), ref_base.replace(underlay=ref_und)
        assert ours.to_dict() == theirs.to_dict()
        assert ScenarioSpec.from_dict(ours.to_dict()).to_dict() == ours.to_dict()
        assert RefScenarioSpec.from_dict(ours.to_dict()).to_dict() == theirs.to_dict()
        got, want = _run("plan", ours, theirs)
        assert got.to_dict() == want.to_dict()
    assert base.testbed() == netsim.TestbedSpec.from_overlay(base.overlay)
    assert base.replace(underlay="wan").testbed() == get_preset("wan", 10)
    with pytest.raises(ValueError, match="unknown router_kind"):
        base.replace(underlay=NetworkSpec(n=10, router_kind="ring"))
    with pytest.raises(ValueError, match="unknown network preset 'moon'"):
        base.replace(underlay="moon")


def test_executor_registry_and_capabilities():
    assert sorted(executors.EXECUTORS) == ["device", "engine", "event", "netsim", "plan"]
    assert isinstance(executors.get("jax"), executors.DeviceExecutor)
    with pytest.raises(ValueError, match="unknown executor 'tpu'"):
        executors.get("tpu")
    stragglers = scenarios.get("paper_table3").replace(compute_time_s=1.0)
    for ex in ("plan", "netsim"):
        with pytest.raises(ValueError, match=f"executor '{ex}' lacks capability "
                                             "'supports_staleness'"):
            executors.get(ex).execute(stragglers)
    with pytest.raises(ValueError, match="lacks capability 'supports_drops'.*: "
                                         "\\['engine', 'event'\\]"):
        executors.get("netsim").execute(scenarios.get("paper_table3").replace(drop_rate=0.1))


@pytest.mark.parametrize("name", ("paper_flooding_baseline", "hetero_edge", "campus_wan",
                                  "segmented_sweep"))
def test_card_runner_runs_the_new_scenarios(name):
    """The card executor on the CPU at the JAX executor's proxy size: each
    round's counts are the plan executor's, but the flooding baseline's,
    which the device runs as an all-gather (m (m - 1) sends, one slot),
    and every live node ends at the FedAvg mean."""
    spec = scenarios.get(name)
    counted = executors.get("plan").execute(spec).rounds
    ex = executors.DeviceExecutor(device="cpu", proxy_elems=4)
    run_scenario(name, executor=ex)
    run = ex.run
    assert len(run.rounds) == len(counted) == spec.rounds
    for r, c in zip(run.rounds, counted):
        assert r.members == c.members and r.numerics_ok and r.finite
        if spec.protocol == "flooding":
            m = len(r.members)
            assert (r.n_slots, r.transmissions) == (1, m * (m - 1))
        else:
            assert (r.n_slots, r.transmissions, r.bytes_mb, r.bytes_on_wire_mb) == \
                (c.n_slots, c.transmissions, c.bytes_mb, c.bytes_on_wire_mb)
