"""Property-based parity of the port's verifier with the JAX package's
(needs the optional ``hypothesis``; skipped cleanly without it).

Over the reference test's ``overlays()`` strategy and its protocols (the
plans its ``certified_facts()`` draws), the same overlay goes through both
packages' ``make_policy``; the plan and three canonical mutations of it (a
send over a non-edge added to a used slot, a colored slot's color swapped,
a suffix of slots dropped) get the same verdict from both verifiers: both
accept, or both raise with the same invariant and message.

The port is held to the reference's verdict on a dropped suffix, not to
"always rejected": a flooding plan's last slots can be redundant (every
node already holds every payload), so cutting them leaves a complete plan
that both verifiers accept. Cutting at the certificate's
``completion_slot`` or earlier always removes a delivery some node needs,
and must raise ``progress/completeness`` in both.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("hypothesis", reason="property tests need the optional dev extra")
from hypothesis import assume, given, settings, strategies as st  # noqa: E402

import repro.verify as jax_verify  # noqa: E402
from repro.core.plan import make_policy as jax_make_policy  # noqa: E402
from test_verify_properties import PROTOCOLS, overlays  # noqa: E402

import repro_torch.verify as verify  # noqa: E402
from repro_torch.core.graph import TopologySpec, make_topology  # noqa: E402
from repro_torch.core.plan import make_policy  # noqa: E402


@st.composite
def paired_facts(draw):
    """(port facts, reference facts) of one plan the reference certifies."""
    topo, g = draw(overlays())
    protocol = draw(st.sampled_from(PROTOCOLS))
    ref = jax_verify.PlanFacts.from_policy(jax_make_policy(protocol, g))
    jax_verify.verify_facts(ref)  # certified before it is mutated
    ours = make_topology(TopologySpec(**dataclasses.asdict(topo)))
    port = verify.PlanFacts.from_policy(make_policy(protocol, ours))
    return port, ref


def verdict(pkg, facts):
    """None when the plan verifies, else (invariant, message)."""
    try:
        pkg.verify_facts(facts)
    except pkg.VerificationError as err:
        return err.invariant, str(err)
    return None


def same_verdict(port, ref):
    got, want = verdict(verify, port), verdict(jax_verify, ref)
    assert got == want
    return got


def add_send(facts, idx, src, dst):
    rec = facts.slots[idx]
    rec.src = np.append(rec.src, src)
    rec.dst = np.append(rec.dst, dst)
    rec.payload = np.append(rec.payload, src % facts.n_payloads)


@settings(max_examples=25, deadline=None)
@given(pair=paired_facts())
def test_certified_plans_get_the_same_certificate(pair):
    port, ref = pair
    assert same_verdict(port, ref) is None
    got = verify.verify_facts(port, payload_mb=1.0)
    want = jax_verify.verify_facts(ref, payload_mb=1.0)
    assert got.to_dict() == want.to_dict()


@settings(max_examples=25, deadline=None)
@given(pair=paired_facts(), data=st.data())
def test_edge_added_to_used_slot_same_verdict(pair, data):
    port, ref = pair
    used = [i for i, rec in enumerate(ref.slots) if len(rec)]
    idx = data.draw(st.sampled_from(used))
    free = np.argwhere(ref.graph.adj == 0)
    free = free[free[:, 0] != free[:, 1]]
    assume(len(free))
    src, dst = free[data.draw(st.integers(0, len(free) - 1))]
    for facts in (port, ref):
        add_send(facts, idx, src, dst)
    got = same_verdict(port, ref)
    assert got is not None and got[0] in ("structure/edges-in-graph", "schedule/half-duplex",
                                          "progress/causal-possession")


@settings(max_examples=25, deadline=None)
@given(pair=paired_facts(), data=st.data())
def test_swapped_slot_color_same_verdict(pair, data):
    port, ref = pair
    colored = [i for i, rec in enumerate(ref.slots) if rec.color >= 0 and len(rec)]
    assume(colored)
    idx = data.draw(st.sampled_from(colored))
    palette = sorted(c for c in np.unique(ref.colors) if c >= 0)
    assume(len(palette) > 1)
    color = data.draw(st.sampled_from([c for c in palette if c != ref.slots[idx].color]))
    for facts in (port, ref):
        facts.slots[idx].color = color
    got = same_verdict(port, ref)
    assert got is not None and got[0] == "schedule/color-discipline"


@settings(max_examples=25, deadline=None)
@given(pair=paired_facts(), data=st.data())
def test_dropped_suffix_same_verdict(pair, data):
    port, ref = pair
    cut = data.draw(st.integers(1, max(1, len(ref.slots) - 1)))
    for facts in (port, ref):
        facts.slots = facts.slots[:-cut]
    got = same_verdict(port, ref)
    assert got is None or got[0] == "progress/completeness"


@settings(max_examples=25, deadline=None)
@given(pair=paired_facts(), data=st.data())
def test_cut_at_or_before_completion_is_rejected(pair, data):
    port, ref = pair
    cert = verify.verify_facts(port)
    assert cert.completion_slot == jax_verify.verify_facts(ref).completion_slot
    keep = data.draw(st.integers(0, cert.completion_slot))
    for facts in (port, ref):
        facts.slots = facts.slots[:keep]
    got = same_verdict(port, ref)
    assert got is not None and got[0] == "progress/completeness"


def test_flooding_can_end_in_redundant_slots():
    """The cause of the reference's failing
    ``test_verify_properties.py::test_dropped_sends_rejected``: on some
    overlays flooding's last slot delivers nothing new, so the plan without
    it still verifies in both packages."""
    found = 0
    for seed in range(40):
        topo = TopologySpec(kind="erdos_renyi", n=8, seed=seed, p=0.45, n_subnets=2)
        g = make_topology(topo)
        if not g.is_connected():
            continue
        port = verify.PlanFacts.from_policy(make_policy("flooding", g))
        cert = verify.verify_facts(port)
        if cert.completion_slot < port.n_slots - 1:
            from repro.core.graph import TopologySpec as JaxTopologySpec, make_topology as jax_mt

            ref = jax_verify.PlanFacts.from_policy(jax_make_policy(
                "flooding", jax_mt(JaxTopologySpec(**dataclasses.asdict(topo)))))
            port.slots, ref.slots = port.slots[:-1], ref.slots[:-1]
            assert same_verdict(port, ref) is None
            found += 1
    assert found
