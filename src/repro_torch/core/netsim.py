"""Event-driven testbed simulator of the paper's evaluation setup (the
port's copy of ``repro.core.netsim``, numpy only).

The paper measures on 10 physical devices behind 3 routers (Fig. 3): every
transfer traverses the sender's access link, the inter-router trunk when the
endpoints live in different subnets, and the receiver's access link.
Concurrent transfers share link capacity, which is why naive flooding
collapses while the MST and coloring schedule keeps contention low.

A deterministic fluid-flow simulation reproduces that: at any instant each
flow's rate is the least of its links' fair shares (capacity / flows on the
link, shrunk by the goodput-collapse factor); the simulation advances to
the next flow completion or latency expiry and re-solves the rates.
:func:`simulate_policy` interprets the communication-plan IR
(:mod:`repro_torch.core.plan`): slot policies run with a drain barrier
between slots (the paper's self-clocked slots); event policies (flooding)
launch new flows the instant a delivery completes.

Metrics, as the paper's three tables:
  * bandwidth (MB/s): mean per-transfer achieved rate         (Table III)
  * single transfer time (s): mean flow duration              (Table IV)
  * total round time (s): wall time for full dissemination    (Table V)

Every function does the reference's float operations in the reference's
order, so a :class:`SimResult` equals the reference's
(``tests/test_torch_netsim.py``). The reference's observability spans are
left out.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..compress.codec import per_send_wire_mb
from .graph import Graph, TopologySpec, build_mst, color_graph, subnet_of
from .network import (  # noqa: F401  (LinkId re-exported: historical home)
    CompiledNetwork,
    LinkId,
    NetworkSpec,
    as_network_model,
    mask_underlay,
)
from .plan import (
    BroadcastOncePolicy,
    CommPolicy,
    DisseminationPolicy,
    FloodingPolicy,
    MstExchangePolicy,
    ReplayPolicy,
    Send,
    SlotPlan,
)


@dataclass
class TestbedSpec:
    """Physical underlay: N devices across `n_subnets` routers.

    Since the network-model API (:mod:`repro_torch.core.network`) this is a
    back-compat wrapper over the default paper network — 3 subnets behind a
    full router mesh, uniform access rates. Routing (:meth:`links_for`) and
    latency (:meth:`latency`) delegate to the compiled network model built
    from :meth:`to_network`, so hop counts and trunk traversals are derived
    from the actual routing path rather than assumed; for the full-mesh
    default the results are byte-identical to the historical hardcoded
    0-or-2-hop rule (pinned by ``tests/test_network.py`` in the reference).
    """

    n: int = 10
    n_subnets: int = 3
    access_mbps: float = 12.0  # device<->router capacity, MB/s
    trunk_mbps: float = 30.0  # router<->router capacity, MB/s
    base_latency_s: float = 0.15  # per-transfer protocol overhead (FTP setup)
    hop_latency_s: float = 0.35  # extra latency per router hop
    per_flow_cap_mbps: float = 11.0  # single-flow application ceiling (FTP/disk)
    # Goodput collapse under contention (paper I: packet loss -> retransmission
    # -> queuing delays): with k flows on a link, usable capacity shrinks by
    # 1/(1 + collapse_gamma * max(0, k - collapse_k0)).
    collapse_gamma: float = 0.05
    collapse_k0: int = 3
    # Collapse compounds over sustained congestion episodes; longer transfers
    # (bigger models) suffer more loss/retransmission, so the effective gamma
    # scales with sqrt(model_size / collapse_ref_mb) (paper Table III trend).
    collapse_ref_mb: float = 30.0
    # Churn masking (scenario runner): when the healthy membership is a
    # subset of the physical testbed, ``node_ids[i]`` is the physical node id
    # of dense index i and ``phys_n`` the physical device count, so subnet
    # routing follows the *physical* layout rather than the dense reindexing.
    node_ids: Optional[Tuple[int, ...]] = None
    phys_n: Optional[int] = None

    @classmethod
    def from_overlay(cls, overlay: TopologySpec, **overrides) -> "TestbedSpec":
        """Derive the physical underlay from the overlay's subnet/cost model.

        ``n`` and ``n_subnets`` are taken from the :class:`TopologySpec`, so
        the routing (:meth:`subnet`, via the shared
        :func:`repro_torch.core.graph.subnet_of`) and the overlay's edge costs are
        two views of one subnet layout. Latencies are scaled from the
        overlay's ping ranges relative to the paper testbed's defaults
        (intra-subnet midpoint 0.95 ms ~ 0.15 s FTP setup; inter-subnet
        midpoint 24 ms ~ 0.35 s per router hop), so the default overlay spec
        reproduces the paper's underlay exactly while a slower overlay yields
        a proportionally slower underlay.
        """
        intra_mid = (overlay.intra_cost_ms[0] + overlay.intra_cost_ms[1]) / 2.0
        inter_mid = (overlay.inter_cost_ms[0] + overlay.inter_cost_ms[1]) / 2.0
        derived = dict(
            n=overlay.n,
            n_subnets=overlay.n_subnets,
            base_latency_s=0.15 * (intra_mid / 0.95),
            hop_latency_s=0.35 * (inter_mid / 24.0),
        )
        derived.update(overrides)
        return cls(**derived)

    def subnet(self, node: int) -> int:
        if self.node_ids is not None:
            return subnet_of(self.node_ids[node], self.phys_n or self.n,
                             self.n_subnets)
        return subnet_of(node, self.n, self.n_subnets)

    def masked(self, members) -> "TestbedSpec":
        """The testbed restricted to ``members`` — the shared
        :func:`repro_torch.core.network.mask_underlay` rule."""
        return mask_underlay(self, members)

    def to_network(self) -> NetworkSpec:
        """This testbed as a declarative :class:`NetworkSpec` (mesh fabric)."""
        return NetworkSpec(
            name="testbed", n=self.n, n_subnets=self.n_subnets,
            router_kind="mesh", access_mbps=self.access_mbps,
            trunk_mbps=self.trunk_mbps, base_latency_s=self.base_latency_s,
            hop_latency_s=self.hop_latency_s,
            per_flow_cap_mbps=self.per_flow_cap_mbps,
            collapse_gamma=self.collapse_gamma, collapse_k0=self.collapse_k0,
            collapse_ref_mb=self.collapse_ref_mb,
            node_ids=self.node_ids, phys_n=self.phys_n)

    def _compiled(self) -> CompiledNetwork:
        """Lazily compiled routing view (rebuilt if routing fields change)."""
        key = (self.n, self.n_subnets, self.access_mbps, self.trunk_mbps,
               self.base_latency_s, self.hop_latency_s,
               self.node_ids, self.phys_n)
        cached = self.__dict__.get("_net")
        if cached is None or cached[0] != key:
            cached = (key, self.to_network().build())
            self.__dict__["_net"] = cached
        return cached[1]

    def links_for(self, src: int, dst: int) -> List[LinkId]:
        return self._compiled().links_for(src, dst)

    def capacity(self, link: LinkId) -> float:
        return self._compiled().capacity(link)

    def latency(self, src: int, dst: int) -> float:
        return self._compiled().latency(src, dst)


@dataclass
class _Flow:
    src: int
    dst: int
    owner: int
    size_mb: float
    remaining_mb: float
    links: List[LinkId]
    start: float
    latency_left: float  # setup latency before bytes move
    done_at: Optional[float] = None


@dataclass
class SimResult:
    total_time_s: float
    mean_transfer_s: float
    mean_bandwidth_mbps: float
    n_transfers: int
    max_concurrency: int
    # Exact bytes that crossed links, MB: the sum of per-flow wire sizes
    # (codec-encoded when simulate_policy ran with a payload codec).
    bytes_on_wire_mb: float = 0.0
    per_transfer_s: List[float] = field(default_factory=list)
    # Optional launch trace for cross-executor equivalence tests:
    # send_trace[t] = the (src, dst, payload) flows launched in batch t
    # (one batch per slot for slot policies; per trigger for event policies).
    send_trace: Optional[List[List[Send]]] = None


class FluidSimulator:
    """Max-min-ish fair-share fluid flow simulator over the network links.

    ``spec`` is any *network model* (:class:`TestbedSpec`,
    :class:`repro_torch.core.network.CompiledNetwork`): the simulator only ever
    calls ``links_for`` / ``capacity`` / ``latency`` and reads the
    contention constants, so every underlay shape the network API can
    declare runs here unchanged.
    """

    def __init__(self, spec: Union[TestbedSpec, CompiledNetwork],
                 congestion_scale: float = 1.0) -> None:
        self.spec = spec
        self.congestion_scale = congestion_scale
        self.t = 0.0
        self.flows: List[_Flow] = []
        self.finished: List[_Flow] = []
        self.max_concurrency = 0

    def add_flow(self, src: int, dst: int, owner: int, size_mb: float) -> None:
        self.flows.append(
            _Flow(
                src,
                dst,
                owner,
                size_mb,
                size_mb,
                self.spec.links_for(src, dst),
                self.t,
                self.spec.latency(src, dst),
            )
        )

    def _rates(self) -> Dict[int, float]:
        counts: Dict[LinkId, int] = {}
        for i, f in enumerate(self.flows):
            if f.latency_left > 0:
                continue
            for l in f.links:
                counts[l] = counts.get(l, 0) + 1
        rates = {}
        sp = self.spec
        for i, f in enumerate(self.flows):
            if f.latency_left > 0:
                continue
            gamma = sp.collapse_gamma * self.congestion_scale
            share = min(
                sp.capacity(l)
                / counts[l]
                / (1.0 + gamma * max(0, counts[l] - sp.collapse_k0))
                for l in f.links
            )
            rates[i] = min(share, sp.per_flow_cap_mbps)
        return rates

    def run_until_drained(self, on_complete) -> None:
        """Advance until no flows remain. ``on_complete(flow)`` may add flows."""
        while self.flows:
            self.max_concurrency = max(self.max_concurrency, len(self.flows))
            rates = self._rates()
            # next event: a latency expiry or a flow completion
            dt = np.inf
            for i, f in enumerate(self.flows):
                if f.latency_left > 0:
                    dt = min(dt, f.latency_left)
                else:
                    r = rates[i]
                    if r > 0:
                        dt = min(dt, f.remaining_mb / r)
            if not np.isfinite(dt):
                raise RuntimeError("simulation stalled")
            dt = max(dt, 1e-12)
            self.t += dt
            still: List[_Flow] = []
            completed: List[_Flow] = []
            for i, f in enumerate(self.flows):
                if f.latency_left > 0:
                    f.latency_left = max(0.0, f.latency_left - dt)
                    still.append(f)
                    continue
                f.remaining_mb -= rates[i] * dt
                if f.remaining_mb <= 1e-9:
                    f.done_at = self.t
                    completed.append(f)
                else:
                    still.append(f)
            self.flows = still
            for f in completed:
                self.finished.append(f)
                on_complete(f)


def _collect(sim: FluidSimulator, send_trace: Optional[List[List[Send]]] = None) -> SimResult:
    """Assemble the paper's three metrics from a drained simulator."""
    durations = [f.done_at - f.start for f in sim.finished]
    rates = [f.size_mb / d for f, d in zip(sim.finished, durations)]
    return SimResult(
        total_time_s=sim.t,
        mean_transfer_s=float(np.mean(durations)),
        mean_bandwidth_mbps=float(np.mean(rates)),
        n_transfers=len(durations),
        max_concurrency=sim.max_concurrency,
        bytes_on_wire_mb=float(sum(f.size_mb for f in sim.finished)),
        per_transfer_s=durations,
        send_trace=send_trace,
    )


# ---------------------------------------------------------------------------
# The one protocol driver: interpret a communication policy over the testbed
# ---------------------------------------------------------------------------


def simulate_policy(
    policy: CommPolicy,
    spec: Union[TestbedSpec, NetworkSpec, CompiledNetwork, str],
    model_mb: float,
    record_trace: bool = False,
    max_slots: int = 100_000,
    codec=None,
) -> SimResult:
    """Execute a communication policy on the fluid network.

    Slot policies are self-clocked: slot k+1's sends start when slot k's
    transfers complete (the paper's fixed slot length upper-bounds the same
    thing; we report the achieved time, which the fixed slot would round up).
    Event policies launch follow-up flows the instant a delivery completes.
    Each flow carries ``model_mb × policy.payload_fraction`` MB (fractions
    below 1 model segmented gossip), encoded through ``codec`` (a
    :class:`repro_torch.compress.Codec`) when one is given — compressed transfers
    are both smaller and, being shorter-lived, suffer less goodput collapse.

    ``spec`` is any underlay declaration the network API resolves: a
    :class:`TestbedSpec`, a :class:`repro_torch.core.network.NetworkSpec`, a
    compiled model, or a preset name (sized to ``policy.n``).

    """
    spec = as_network_model(spec, n=policy.n)
    size_mb = per_send_wire_mb(codec, model_mb, policy.payload_fraction)
    sim = FluidSimulator(spec, (size_mb / spec.collapse_ref_mb) ** 0.5)
    trace: Optional[List[List[Send]]] = [] if record_trace else None
    policy.reset()

    def launch(sends: Sequence[Send]) -> None:
        if trace is not None:
            trace.append(list(sends))
        for src, dst, payload in sends:
            sim.add_flow(src, dst, payload, size_mb)

    if policy.sync == "event":
        launch(policy.initial_sends())

        def on_complete(f: _Flow) -> None:
            launch(policy.on_delivered(f.src, f.dst, f.owner))

        sim.run_until_drained(on_complete)
    else:
        t = 0
        while not policy.done():
            if t >= max_slots:
                raise RuntimeError(f"{policy.kind} did not converge")
            sends = policy.emit(t)
            tup = sends.tuples()
            launch(tup)
            policy.commit(t, sends)
            sim.run_until_drained(lambda f: None)
            t += 1
    return _collect(sim, trace)


# ---------------------------------------------------------------------------
# Back-compat wrappers (each is now one policy + the shared driver)
# ---------------------------------------------------------------------------


def simulate_flooding(
    overlay: Graph, spec: TestbedSpec, model_mb: float
) -> SimResult:
    """Uncoordinated flooding: forward every new model to every neighbour
    immediately on receipt. All of a node's sends contend on its access link.
    """
    return simulate_policy(FloodingPolicy(overlay), spec, model_mb)


def simulate_mosgu(
    overlay: Graph,
    spec: TestbedSpec,
    model_mb: float,
    plan: Optional[SlotPlan] = None,
    mst_algorithm: str = "prim",
    coloring_algorithm: str = "bfs",
) -> SimResult:
    """Slot-scheduled gossip on the colored MST (live policy, or a compiled
    plan replayed through :class:`repro_torch.core.plan.ReplayPolicy`)."""
    if plan is not None:
        return simulate_policy(ReplayPolicy(plan), spec, model_mb)
    mst = build_mst(overlay, mst_algorithm)
    colors = color_graph(mst, coloring_algorithm)
    return simulate_policy(DisseminationPolicy(mst, colors), spec, model_mb)


def simulate_broadcast_exchange(spec: TestbedSpec, model_mb: float) -> SimResult:
    """The paper's broadcast baseline for one FL communication round.

    The *overlay* is complete (paper IV-B: every node connects to every other
    node), so conventional broadcasting means all N nodes push their local
    model to the other N-1 concurrently — N·(N-1) flows contending on every
    access link and the trunks. This is why the paper's broadcast columns are
    identical across underlay topologies (merged cells in Tables III–V).
    """
    return simulate_policy(BroadcastOncePolicy(spec.n), spec, model_mb)


def simulate_mosgu_exchange(
    topology_graph: Graph, spec: TestbedSpec, model_mb: float
) -> SimResult:
    """One MOSGU exchange step: two colored slots on the MST.

    Each node multicasts its *own* current model to its MST neighbours during
    its color's slot (slot 0 = color 0 senders, slot 1 = color 1), matching
    the paper's per-round measurement unit. Full dissemination (Table I) is
    simulated by :func:`simulate_mosgu`.
    """
    mst = build_mst(topology_graph)
    colors = color_graph(mst)
    return simulate_policy(MstExchangePolicy(mst, colors), spec, model_mb)


def compare_protocols(
    topology: str,
    model_mb: float,
    n: int = 10,
    seed: int = 0,
    spec: Optional[TestbedSpec] = None,
    full_dissemination: bool = False,
    protocols: Optional[Sequence[str]] = None,
    n_segments: int = 4,
) -> Dict[str, SimResult]:
    """Run protocols on one (topology, model size); the benchmark unit.

    Delegates to the scenario layer
    (:func:`repro_torch.scenario.runner.compare_protocols`), which builds one
    single-round :class:`~repro_torch.scenario.spec.ScenarioSpec` per
    protocol and runs it on the netsim executor.

    Default (``protocols=None``) reproduces the paper's two-column tables:
    ``full_dissemination=False`` measures one exchange step per round;
    ``True`` runs until every node holds all N models (Table I semantics).
    Passing ``protocols`` (names from :func:`repro_torch.core.plan.make_policy`)
    instead runs each named policy to completion over the same overlay.
    """
    from ..scenario.runner import compare_protocols as _compare  # lazy: no cycle

    return _compare(topology, model_mb, n=n, seed=seed, spec=spec,
                    full_dissemination=full_dissemination,
                    protocols=protocols, n_segments=n_segments)
