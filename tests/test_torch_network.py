"""The port's network model (``repro_torch.core.network``) against the JAX
package's (``repro.core.network``), on the CPU.

The copy does the reference's float operations in the reference's order,
so every result is held *equal*, not close:

* the analytic timing (:class:`TimingProfile` walked from each registered
  scenario's policy, then ``estimate`` at the codec's per-send wire size)
  over the grid of the four presets x every scenario the port registers x
  codec {fp32, int8, top-k}: every :class:`TimingEstimate` field, the
  ``per_slot_s`` arrays included, the profile's counts, and the
  ``contract_warning`` text with the warning it raises;
* the compiled networks (routes, hops, latencies, access rates, link
  capacities) of every preset at several sizes, masked to members, of the
  named fabrics and of explicit router edges; validation errors, the
  fingerprints and ``to_dict``;
* ``estimate_timing`` of a compiled plan and of a live policy, and
  ``slot_length_for_network``.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.compress import make_codec as ref_make_codec  # noqa: E402
from repro.compress import per_send_wire_mb as ref_wire_mb  # noqa: E402
from repro.core import network as ref  # noqa: E402
from repro.core.graph import build_mst as ref_build_mst  # noqa: E402
from repro.core.graph import color_graph as ref_color_graph  # noqa: E402
from repro.core.netsim import TestbedSpec as RefTestbed  # noqa: E402
from repro.core.plan import compile_policy as ref_compile_policy  # noqa: E402
from repro.core.plan import make_policy as ref_make_policy  # noqa: E402
from repro.scenario import scenarios as ref_scenarios  # noqa: E402
from repro_torch.compress import make_codec, per_send_wire_mb  # noqa: E402
from repro_torch.core import network  # noqa: E402
from repro_torch.core.graph import build_mst, color_graph  # noqa: E402
from repro_torch.core.netsim import TestbedSpec as PortTestbed  # noqa: E402
from repro_torch.core.plan import compile_policy, make_policy  # noqa: E402
from repro_torch.scenario import scenarios  # noqa: E402

PRESETS = ("paper_lan", "wan", "edge", "congested")
CODECS = ("fp32", "int8", "topk")
# lossy_links, async_stragglers and scale_1000 run on the engine and event
# executors (tests/test_torch_gossip_engine.py, tests/test_torch_events.py);
# scale_100k and scale_1m are counting-only sparse cells
# (tests/test_torch_sparse_scale.py)
SCENARIOS = tuple(n for n in scenarios.names()
                  if n not in ("async_stragglers", "lossy_links", "scale_1000", "scale_100k",
                               "scale_1m"))


def _policies(name):
    """The scenario's round-0 policy in both packages, on its own overlay."""
    ours, theirs = scenarios.get(name), ref_scenarios.get(name)
    kw = dict(mst_algorithm=ours.mst_algorithm, coloring_algorithm=ours.coloring_algorithm,
              n_segments=ours.n_segments)
    return (ours, make_policy(ours.protocol, ours.overlay_graph(), **kw),
            theirs, ref_make_policy(theirs.protocol, theirs.overlay_graph(), **kw))


def _wire(ours, pol, theirs, ref_pol, codec):
    c = make_codec(codec)
    rc = ref_make_codec(codec)
    got = per_send_wire_mb(None if c.name == "fp32" else c, ours.payload_mb(),
                           pol.payload_fraction)
    want = ref_wire_mb(None if rc.name == "fp32" else rc, theirs.payload_mb(),
                       ref_pol.payload_fraction)
    assert got == want
    return got


def _estimate(profile, size_mb):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        est = profile.estimate(size_mb)
    return est, [str(w.message) for w in caught]


def assert_estimates_equal(got, want):
    for f in ("total_time_s", "mean_transfer_s", "mean_bandwidth_mbps", "n_transfers",
              "max_concurrency", "contract_warning"):
        assert getattr(got, f) == getattr(want, f), f
    if want.per_slot_s is None:
        assert got.per_slot_s is None
    else:
        assert got.per_slot_s.dtype == want.per_slot_s.dtype
        np.testing.assert_array_equal(got.per_slot_s, want.per_slot_s)


def test_the_presets_and_scenarios_are_the_references():
    assert tuple(network.NETWORK_PRESETS) == tuple(ref.NETWORK_PRESETS) == PRESETS
    assert set(SCENARIOS) < set(scenarios.names()) == set(ref_scenarios.names())
    assert len(SCENARIOS) == 9 and len(scenarios.names()) == 14


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("name", SCENARIOS)
@pytest.mark.parametrize("preset", PRESETS)
def test_timing_estimate_equals_the_reference(preset, name, codec):
    ours, pol, theirs, ref_pol = _policies(name)
    size = _wire(ours, pol, theirs, ref_pol, codec)
    prof = network.TimingProfile.from_policy(pol, network.get_preset(preset, ours.n))
    ref_prof = ref.TimingProfile.from_policy(ref_pol, ref.get_preset(preset, theirs.n))
    assert prof.measure_stats() == ref_prof.measure_stats()
    assert (prof.sync, prof.n_slots, prof.total_slots) == \
        (ref_prof.sync, ref_prof.n_slots, ref_prof.total_slots)
    (got, got_w), (want, want_w) = _estimate(prof, size), _estimate(ref_prof, size)
    assert_estimates_equal(got, want)
    assert got_w == want_w
    assert (got.contract_warning is None) == (not got_w)


def test_flooding_on_a_hub_heavy_overlay_warns_as_the_reference():
    """The event-mode contract warning fires where the reference's does
    (a Barabasi-Albert overlay's hub), with the reference's text."""
    from repro.core.graph import TopologySpec as RefTopologySpec
    from repro.core.graph import make_topology as ref_make_topology
    from repro_torch.core.graph import TopologySpec, make_topology

    kw = dict(kind="barabasi_albert", n=12, m=2, seed=3)
    prof = network.TimingProfile.from_policy(
        make_policy("flooding", make_topology(TopologySpec(**kw))), "paper_lan")
    ref_prof = ref.TimingProfile.from_policy(
        ref_make_policy("flooding", ref_make_topology(RefTopologySpec(**kw))), "paper_lan")
    (got, got_w), (want, want_w) = _estimate(prof, 49.0), _estimate(ref_prof, 49.0)
    assert want.contract_warning is not None and want_w
    assert_estimates_equal(got, want)
    assert got_w == want_w


def _compiled_equal(got, want):
    assert got.n == want.n and got.trunk_edges == want.trunk_edges
    for f in ("node_subnet", "access_rate", "route_trunks", "route_hops", "latency_table"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert getattr(got, f).dtype == getattr(want, f).dtype, f
    np.testing.assert_array_equal(got.link_capacities(), want.link_capacities())
    for i in range(got.n_links):
        assert got.link_name(i) == want.link_name(i)
    for u in range(got.n):
        for v in range(got.n):
            assert got.links_for(u, v) == want.links_for(u, v)
            assert got.latency(u, v) == want.latency(u, v)
    for link in {l for u in range(got.n) for v in range(got.n) for l in got.links_for(u, v)}:
        assert got.capacity(link) == want.capacity(link)


@pytest.mark.parametrize("n", (4, 10, 12, 17))
@pytest.mark.parametrize("preset", PRESETS)
def test_compiled_presets_equal_the_reference(preset, n):
    spec, ref_spec = network.get_preset(preset, n), ref.get_preset(preset, n)
    assert spec.to_dict() == ref_spec.to_dict()
    assert spec.fingerprint() == ref_spec.fingerprint()
    _compiled_equal(spec.build(), ref_spec.build())
    members = tuple(range(1, n, 2))
    _compiled_equal(spec.masked(members).build(), ref_spec.masked(members).build())
    assert network.underlay_fingerprint(preset, n) == ref.underlay_fingerprint(preset, n)


@pytest.mark.parametrize("kw", [
    dict(router_kind="line", n_subnets=5, n=11),
    dict(router_kind="star", n_subnets=4, n=9, access_range=(2.0, 20.0), het_seed=7),
    dict(router_edges=((0, 1), (2, 1), (3, 2), (1, 0)), n_subnets=4, n=13),
    dict(n=5, n_subnets=3, node_ids=(0, 2, 5, 9, 11), phys_n=12),
])
def test_fabrics_and_explicit_edges_equal_the_reference(kw):
    spec, ref_spec = network.NetworkSpec(**kw), ref.NetworkSpec(**kw)
    assert spec.router_edges == ref_spec.router_edges
    assert spec.fingerprint() == ref_spec.fingerprint() and spec.to_dict() == ref_spec.to_dict()
    _compiled_equal(spec.build(), ref_spec.build())
    for kind in network.ROUTER_KINDS:
        assert network.router_graph_edges(kind, 5) == ref.router_graph_edges(kind, 5)


@pytest.mark.parametrize("kw,match", [
    (dict(n=0), "at least one node"),
    (dict(n_subnets=0), "n_subnets"),
    (dict(router_kind="ring"), "unknown router_kind"),
    (dict(router_edges=((0, 5),)), "outside"),
    (dict(access_range=(5.0, 1.0)), "bad access_range"),
    (dict(trunk_mbps=0.0), "positive"),
    (dict(n_subnets=4, router_edges=((0, 1), (2, 3))), "disconnects"),
])
def test_bad_networks_raise_the_references_errors(kw, match):
    for mod in (network, ref):
        with pytest.raises(ValueError, match=match):
            mod.NetworkSpec(**kw).build()


def test_underlay_forms_and_fingerprints():
    for form in ("edge", network.get_preset("edge", 10), network.get_preset("edge", 10).build(),
                 PortTestbed(n=10)):
        assert isinstance(network.as_compiled_network(form, 10), network.CompiledNetwork)
    with pytest.raises(TypeError, match="not a network model"):
        network.as_network_model(42)
    fps = {network.underlay_fingerprint(u, n) for u, n in (
        ("wan", 10), ("wan", 12), (network.NetworkSpec(n=10), None),
        (network.NetworkSpec(n=10, trunk_mbps=8.0), None), (PortTestbed(n=10), None),
        (PortTestbed(n=10, access_mbps=24.0), None))}
    assert len(fps) == 6
    assert network.underlay_fingerprint(PortTestbed(n=12)) == \
        ref.underlay_fingerprint(RefTestbed(n=12))


@pytest.mark.parametrize("protocol", ("mosgu", "segmented", "tree_allreduce",
                                      "broadcast_exchange", "flooding"))
def test_estimate_timing_of_a_plan_and_a_policy(protocol):
    g = scenarios.get("paper_table3").overlay_graph()
    g_ref = ref_scenarios.get("paper_table3").overlay_graph()
    for under, ref_under in ((PortTestbed(n=10), RefTestbed(n=10)), ("wan", "wan")):
        got = network.estimate_timing(make_policy(protocol, g), under, 21.2e6)
        want = ref.estimate_timing(ref_make_policy(protocol, g_ref), ref_under, 21.2e6)
        assert_estimates_equal(got, want)
        got = network.estimate_timing(compile_policy(make_policy(protocol, g)), under, 9.8e6)
        want = ref.estimate_timing(ref_compile_policy(ref_make_policy(protocol, g_ref)),
                                   ref_under, 9.8e6)
        assert_estimates_equal(got, want)


@pytest.mark.parametrize("size_mb", (9.8, 21.2, 49.0))
def test_slot_length_for_network(size_mb):
    g = scenarios.get("paper_table3").overlay_graph()
    g_ref = ref_scenarios.get("paper_table3").overlay_graph()
    mst, mst_ref = build_mst(g), ref_build_mst(g_ref)
    colors, colors_ref = color_graph(mst), ref_color_graph(mst_ref)
    for under, ref_under in ((PortTestbed(n=10), RefTestbed(n=10)), ("edge", "edge")):
        got = network.slot_length_for_network(mst, colors, under, size_mb)
        assert got > 0
        assert got == ref.slot_length_for_network(mst_ref, colors_ref, ref_under, size_mb)
