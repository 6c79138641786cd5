"""The port's queue engine, payload wire, MOSGU facade and engine executor
held to the JAX package's on the CPU (``repro.core.gossip``,
``repro.compress``, ``repro.core.protocol``, ``repro.scenario``).

* ``GossipEngine`` over every policy of ``make_policy`` on ER / WS /
  complete overlays at n 6 and 10, with and without a seeded drop function,
  two rounds (top-k's residuals carried): every slot's sends and drops, the
  FIFO and received snapshots after each slot, the slot counts and
  ``round_wire_bytes`` exactly; the aggregates (per segment where
  segmented) within 1e-6 of max |x| of ``fedavg_numpy``.
* The payload wire (``encode_payload`` / ``decode_payload``) for fp32,
  bf16, int8, int4 and top-k over three rounds: bytes on the wire, decoded
  values and top-k's residuals bit-identical. The numpy reference divides
  in IEEE f32, as the plain quantize does, so no code moves by a scale's
  ulp (R8 concerns the Pallas kernel in interpret mode, not this wire):
  int8 and int4 codes and scales are equal, and the decoded values within
  1e-6 of max |x| follow.
* ``MOSGUProtocol``: rounds, churn, rotation and ``round_traffic`` exactly.
* ``EngineExecutor(device="cpu")`` against ``run_scenario(spec,
  executor="engine")`` on the registry, every ``RoundReport`` field.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.compress import make_codec as ref_make_codec  # noqa: E402
from repro.core.gossip import GossipEngine as RefEngine  # noqa: E402
from repro.core.gossip import fedavg_numpy  # noqa: E402
from repro.core.graph import TopologySpec as RefTopologySpec  # noqa: E402
from repro.core.graph import make_topology as ref_make_topology  # noqa: E402
from repro.core.plan import make_policy as ref_make_policy  # noqa: E402
from repro.core.protocol import MOSGUConfig as RefConfig  # noqa: E402
from repro.core.protocol import MOSGUProtocol as RefProtocol  # noqa: E402
from repro.scenario import executors as ref_executors  # noqa: E402
from repro.scenario import scenarios as ref_scenarios  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.compress import EncodedPayload, make_codec  # noqa: E402
from repro_torch.core import (GossipEngine, MOSGUConfig, MOSGUProtocol, TopologySpec,  # noqa: E402
                              fedavg, make_policy, make_topology)
from repro_torch.kernels import launch_counts, reset_launches  # noqa: E402
from repro_torch.scenario import executors, run_sweep, scenarios  # noqa: E402
from repro_torch.scenario.executors import EngineExecutor  # noqa: E402

PROTOCOLS = ("dissemination", "segmented", "flooding", "tree_allreduce", "broadcast_exchange",
             "mosgu_exchange")
# the protocols whose nodes start the round holding their own payloads
WITH_PAYLOADS = ("dissemination", "segmented", "flooding", "mosgu_exchange")
# one wire a topology, so every engine case moves encoded payloads
TOPOLOGY_CODECS = {"erdos_renyi": "int8", "watts_strogatz": "topk", "complete": "bf16"}
CODECS = ("fp32", "bf16", "int8", "int4", "topk")
SEGMENTS = 3
DROP_RATE = 0.2


def _overlays(kind, n, seed=4):
    return (make_topology(TopologySpec(kind=kind, n=n, seed=seed)),
            ref_make_topology(RefTopologySpec(kind=kind, n=n, seed=seed)))


def _drops(seed, round_idx):
    """A fresh seeded drop function: each engine draws from its own copy of
    the same stream."""
    rng = np.random.default_rng([seed, round_idx])
    return lambda slot, src, dst: bool(rng.random() < DROP_RATE)


def _payloads(n, protocol, round_idx, size=300):
    """Per node one array (a list of SEGMENTS for segmented), numpy for the
    reference and the same values as CPU tensors for the port."""
    rng = np.random.default_rng([11, round_idx])
    parts = SEGMENTS if protocol == "segmented" else 1
    arrs = [[(rng.normal(size=(size,)) * (u + 1)).astype(np.float32) for _ in range(parts)]
            for u in range(n)]
    ref = [a if parts > 1 else a[0] for a in arrs]
    ours = [[torch.from_numpy(x.copy()) for x in a] if parts > 1 else torch.from_numpy(a[0].copy())
            for a in arrs]
    return ours, ref


def _max_decoded(engine):
    return max(float(np.abs(np.asarray(engine._decode(p))).max())
               for p in engine._store.values())


def assert_aggregates_close(ours, want, scale):
    tol = 1e-6 * scale
    for got_node, want_node in zip(ours, want):
        if isinstance(want_node, list):  # per segment
            for g, w in zip(got_node, want_node):
                np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol)
        else:
            np.testing.assert_allclose(got_node.numpy(), want_node, rtol=0, atol=tol)


@pytest.mark.parametrize("drops", (False, True), ids=("clean", "drops"))
@pytest.mark.parametrize("n", (6, 10))
@pytest.mark.parametrize("kind", tuple(TOPOLOGY_CODECS))
@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_engine_slots_snapshots_and_wire_equal_the_reference(protocol, kind, n, drops):
    g, g_ref = _overlays(kind, n)
    kw = dict(n_segments=SEGMENTS)
    pol, ref_pol = make_policy(protocol, g, **kw), ref_make_policy(protocol, g_ref, **kw)
    codec = TOPOLOGY_CODECS[kind]
    ours = GossipEngine(policy=pol, codec=make_codec(codec))
    ref = RefEngine(policy=ref_pol, codec=ref_make_codec(codec))
    traced = pol.trace_queues
    assert traced == ref_pol.trace_queues
    for r in range(2):
        ours.drop_fn = _drops(7, r) if drops else None
        ref.drop_fn = _drops(7, r) if drops else None
        payloads = _payloads(n, protocol, r) if protocol in WITH_PAYLOADS else (None, None)
        ours.begin_round(r, payloads[0])
        ref.begin_round(r, payloads[1])
        slots = 0
        while not ref.is_round_complete():
            assert not ours.is_round_complete()
            got, want = ours.step(), ref.step()
            assert (got.slot_idx, got.color, got.sends, got.dropped) == \
                (want.slot_idx, want.color, want.sends, want.dropped)
            assert ours.received_snapshot() == ref.received_snapshot()
            if traced:
                assert ours.queue_snapshot() == ref.queue_snapshot()
            slots += 1
            assert slots < 10_000
        assert ours.is_round_complete()
        assert ours.slot_idx == ref.slot_idx
        assert ours.round_wire_bytes == ref.round_wire_bytes
        assert (ours.round_wire_bytes > 0) == (protocol in WITH_PAYLOADS)
        if protocol in WITH_PAYLOADS:
            assert_aggregates_close(ours.aggregate(fedavg), ref.aggregate(fedavg_numpy),
                                    _max_decoded(ref))
    if drops:
        assert any(rep.dropped for rep in ref.reports)


def test_engine_run_round_writes_the_slot_spans_and_counters():
    g, g_ref = _overlays("erdos_renyi", 10)
    ours = GossipEngine(policy=make_policy("dissemination", g), codec=make_codec("int8"),
                        drop_fn=_drops(3, 0))
    with obs.recording(obs.Recorder()) as rec:
        n_slots = ours.run_round(0, _payloads(10, "dissemination", 0)[0])
    ref = RefEngine(policy=ref_make_policy("dissemination", g_ref), codec=ref_make_codec("int8"),
                    drop_fn=_drops(3, 0))
    assert n_slots == ref.run_round(0, _payloads(10, "dissemination", 0)[1])
    slot_spans = [s for s in rec.spans if s.cat == "engine-slot"]
    assert [(s.name, s.track, s.args) for s in slot_spans] == \
        [(f"slot {i}", "engine", {"round": 0}) for i in range(n_slots)]
    assert rec.counters["engine.slot_sends"] == sum(len(r.sends) for r in ref.reports)
    assert rec.counters["engine.slot_drops"] == sum(len(r.dropped) for r in ref.reports)
    assert rec.counters["engine.slot_wire_bytes"] == ref.round_wire_bytes
    assert rec.counters["codec.encodes"] == 10 and "codec.decodes" not in rec.counters


def _tree(rng, r):
    return {"a": (rng.normal(size=(3, 700)) * 3 * (r + 1)).astype(np.float32),
            "b": [rng.normal(size=(50,)).astype(np.float32) + r,
                  (rng.normal(size=(1030,)) * 1e-3).astype(np.float32)]}


def _leaves(data):
    """The WireLeaf / tensor leaves of an encoded tree, in tree order."""
    if isinstance(data, dict):
        return [x for k in sorted(data) for x in _leaves(data[k])]
    if isinstance(data, (list, tuple)):
        return [x for v in data for x in _leaves(v)]
    return [data]


@pytest.mark.parametrize("codec", CODECS)
def test_payload_wire_equals_the_reference(codec):
    ours, ref = make_codec(codec), ref_make_codec(codec)
    rng = np.random.default_rng(5)
    state, ref_state = ours.init_state(), ref.init_state()
    for r in range(3):
        tree = _tree(rng, r)
        mine = {"a": torch.from_numpy(tree["a"].copy()),
                "b": [torch.from_numpy(x.copy()) for x in tree["b"]]}
        got, state = ours.encode_payload(mine, state)
        want, ref_state = ref.encode(tree, ref_state)
        assert isinstance(got, EncodedPayload) and got.codec == want.codec
        assert got.bytes_on_wire == want.bytes_on_wire == sum(
            ours.wire_bytes(x.size) for x in (tree["a"], *tree["b"]))
        dec, ref_dec = ours.decode_payload(got), ref.decode(want)
        scale = max(float(np.abs(x).max()) for x in (tree["a"], *tree["b"]))
        for d, w in ((dec["a"], ref_dec["a"]), *zip(dec["b"], ref_dec["b"])):
            assert d.dtype == torch.float32 and tuple(d.shape) == w.shape
            if codec in ("int8", "int4"):
                np.testing.assert_allclose(d.numpy(), w, rtol=0, atol=1e-6 * scale)
            else:
                np.testing.assert_array_equal(d.numpy(), w)
        if codec in ("int8", "int4"):
            for leaf, ref_leaf in zip(_leaves(got.data), _leaves(want.data)):
                # int4's reference packs the flat codes; the port keeps (1, C, chunk / 2)
                np.testing.assert_array_equal(leaf["codes"].numpy().reshape(-1),
                                              ref_leaf["codes"].reshape(-1))
                np.testing.assert_array_equal(leaf["scales"][0].numpy(), ref_leaf["scales"])
        if codec == "topk":  # the residual a leaf path, carried into the next round
            assert sorted(state) == sorted(ref_state) == ["a", "b/0", "b/1"]
            for key in ref_state:
                np.testing.assert_array_equal(state[key].numpy(), ref_state[key])
        else:
            assert state is None and ref_state is None
    with pytest.raises(ValueError, match="encoded with"):
        make_codec("int8" if codec != "int8" else "int4").decode_payload(got)


def test_fedavg_equals_fedavg_numpy_on_pytrees():
    rng = np.random.default_rng(2)
    trees = [{"w": rng.normal(size=(4, 5)).astype(np.float32),
              "b": (rng.normal(size=(7,)).astype(np.float32),)} for _ in range(6)]
    got = fedavg([{"w": torch.from_numpy(t["w"]), "b": (torch.from_numpy(t["b"][0]),)}
                  for t in trees])
    want = fedavg_numpy(trees)
    scale = max(float(np.abs(t["w"]).max()) for t in trees)
    assert isinstance(got["b"], tuple) and tuple(got["w"].shape) == (4, 5)
    np.testing.assert_allclose(got["w"].numpy(), want["w"], rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(got["b"][0].numpy(), want["b"][0], rtol=0, atol=1e-6 * scale)


def _protocols(mode, kind="watts_strogatz", n=10, seed=3):
    g, g_ref = _overlays(kind, n, seed)
    return (MOSGUProtocol(g, MOSGUConfig(gossip_mode=mode, n_segments=SEGMENTS)),
            RefProtocol(g_ref, RefConfig(gossip_mode=mode, n_segments=SEGMENTS)))


def _round_equal(got, want, scale=None):
    assert {k: got[k] for k in ("n_slots", "transmissions", "drops")} == \
        {k: want[k] for k in ("n_slots", "transmissions", "drops")}
    assert ("aggregates" in got) == ("aggregates" in want)
    if "aggregates" in want:
        assert_aggregates_close(got["aggregates"], want["aggregates"], scale)


@pytest.mark.parametrize("mode", ("dissemination", "segmented", "tree_allreduce"))
def test_mosgu_protocol_equals_the_reference(mode):
    ours, ref = _protocols(mode)
    assert [e for e in ours.mst.edges()] == [e for e in ref.mst.edges()]
    assert ours.colors.tolist() == ref.colors.tolist()
    assert ours.slot_length_s(21.2) == ref.slot_length_s(21.2)
    assert ours.round_traffic(21.2e6) == ref.round_traffic(21.2e6)
    pay, ref_pay = _payloads(10, mode, 0)
    _round_equal(ours.run_round(0, pay, drop_fn=_drops(9, 0)),
                 ref.run_round(0, ref_pay, drop_fn=_drops(9, 0)),
                 max(float(np.abs(np.asarray(p)).max()) for p in ref_pay))
    ours.node_leaves(7)
    ref.node_leaves(7)
    assert ours.moderator.members == ref.moderator.members
    assert ours.round_traffic(9.8e6) == ref.round_traffic(9.8e6)
    _round_equal(ours.run_round(1), ref.run_round(1))
    costs = {2: 12.5, 8: 0.7, 9: 30.25}
    ours.node_joins(7, costs)
    ref.node_joins(7, costs)
    assert [e for e in ours.mst.edges()] == [e for e in ref.mst.edges()]
    assert ours.colors.tolist() == ref.colors.tolist()
    assert ours.round_traffic(1e6) == ref.round_traffic(1e6)
    votes = {u: (u * 3) % 10 for u in range(10)}
    assert ours.rotate_moderator(votes) == ref.rotate_moderator(votes)
    assert ours.moderator.moderator_id == ref.moderator.moderator_id
    pay, ref_pay = _payloads(10, mode, 2)
    _round_equal(ours.run_round(2, pay), ref.run_round(2, ref_pay),
                 max(float(np.abs(np.asarray(p)).max()) for p in ref_pay))


ENGINE_SCENARIOS = ("lossy_links", "churn_storm", "paper_table3", "quantized_table3",
                    "topk_sweep", "segmented_sweep", "scale_1000")


@pytest.mark.parametrize("name", ENGINE_SCENARIOS)
def test_engine_executor_round_reports_equal_the_reference(name):
    ours, ref = EngineExecutor(device="cpu"), ref_executors.get("engine")
    got = ours.execute(scenarios.get(name))
    want = ref.execute(ref_scenarios.get(name))
    assert got.to_dict() == want.to_dict()
    assert ours._engine.round_wire_bytes == ref._engine.round_wire_bytes
    assert ours._engine.slot_idx == ref._engine.slot_idx
    if name == "lossy_links":
        assert all(r.drops > 0 for r in got.rounds)
        assert all(r.transmissions > 90 for r in got.rounds)  # retransmissions counted
    if name in ("quantized_table3", "topk_sweep"):  # the codec scenarios move payloads
        assert ours._engine.round_wire_bytes > 0


def test_engine_executor_error_feedback_persists_and_resets_on_churn():
    spec = scenarios.get("churn_storm").replace(codec="topk")
    ex = EngineExecutor(device="cpu")
    engines = []
    orig = ex.begin_epoch

    def spy(mod, members):
        orig(mod, members)
        engines.append(ex._engine)

    ex.begin_epoch = spy
    res = ex.execute(spec)
    # one engine an epoch: rounds 1-5 each change the membership
    assert len(engines) == len({tuple(r.members) for r in res.rounds}) == 6
    ref = ref_executors.get("engine")
    assert res.to_dict() == ref.execute(ref_scenarios.get("churn_storm").replace(
        codec="topk")).to_dict()
    last = engines[-1]
    assert sorted(last._ef_states) == sorted(range(len(res.rounds[-1].members)))
    for key, st in last._ef_states.items():
        np.testing.assert_array_equal(st[""].numpy(), ref._engine._ef_states[key][""])


def test_engine_executor_defaults_to_the_card():
    assert executors.get("engine").device is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="runs on a CUDA device by default"):
            executors.get("engine").execute(scenarios.get("quantized_table3"))


def test_engine_executor_capabilities_and_sweep():
    caps, ref_caps = executors.capability_table(), ref_executors.capability_table()
    assert caps == {{"jax": "device"}.get(k, k): ref_caps[k] for k in ref_caps}
    assert executors.names() == [{"jax": "device"}.get(n, n) for n in ref_executors.names()]
    ex = EngineExecutor(device="cpu")
    assert executors.get(ex) is ex
    sweep = scenarios.get_sweep("codec_x_protocol")
    got = run_sweep(sweep, executor=ex)
    from repro.scenario import run_sweep as ref_run_sweep

    want = ref_run_sweep(ref_scenarios.get_sweep("codec_x_protocol"), executor="engine")
    assert got.executor == "engine" and len(got.cells) == len(want.cells)
    for c, w in zip(got.cells, want.cells):
        assert c.result.to_dict() == w.result.to_dict()
    with pytest.raises(ValueError, match="executor 'engine' lacks capability "
                                         "'supports_staleness'.*: \\['event'\\]"):
        ex.execute(scenarios.get("async_stragglers"))


@pytest.mark.gpu
def test_engine_payloads_on_the_card_launch_the_gossip_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g, _ = _overlays("erdos_renyi", 6)
    for codec, kernels in (("int8", ("quantize", "dequantize", "gossip_mix")),
                           ("topk", ("topk_select", "gossip_mix"))):
        engine = GossipEngine(policy=make_policy("dissemination", g), codec=make_codec(codec))
        cpu = GossipEngine(policy=make_policy("dissemination", g), codec=make_codec(codec))
        pay, _ = _payloads(6, "dissemination", 0, size=5000)
        reset_launches()
        engine.run_round(0, [p.cuda() for p in pay])
        aggs = engine.aggregate(fedavg)
        counts = launch_counts()
        for k in kernels:
            assert counts[k] > 0, (codec, k)
        cpu.run_round(0, pay)
        for a, c in zip(aggs, cpu.aggregate(fedavg)):
            assert a.is_cuda
            np.testing.assert_allclose(a.cpu().numpy(), c.numpy(), rtol=0,
                                       atol=1e-6 * float(max(p.abs().max() for p in pay)))
        assert all(torch.equal(aggs[0], a) for a in aggs[1:])
