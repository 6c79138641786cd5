"""Network-model API: pluggable underlays with analytic round timing (the
port's copy of ``repro.core.network``, numpy only).

The paper's headline results are the *transfer time* and *bandwidth* of a
gossip round on a physical network (Tables III-V). This module declares
that network and prices a plan on it:

* :class:`NetworkSpec` declares an underlay: a router graph (``mesh`` /
  ``line`` / ``star`` or explicit edges) with shortest-path routing,
  per-node access rates (uniform, or drawn from a seed), trunk capacity,
  latency constants and the goodput-collapse model;
* :meth:`NetworkSpec.build` compiles it into a :class:`CompiledNetwork`,
  the runtime network model (``links_for``, ``capacity``, ``latency`` and
  the contention constants) that the fluid simulator
  (:mod:`repro_torch.core.netsim`) and the analytic model below both read;
* :data:`NETWORK_PRESETS` names four shapes (``paper_lan``, the default
  3-subnet testbed, ``wan``, ``edge``, ``congested``);
* :class:`TimingProfile` / :func:`estimate_timing` is the analytic timing
  model: a closed-form per-slot bottleneck and contention formula over a
  plan, which the ``plan`` executor uses for round times without running
  the fluid simulation.

Every class and function does the float operations of the reference in
the reference's order, so its results equal the reference's
(``tests/test_torch_network.py``). Tolerance contract, as the reference's:
for slot-synchronous policies the analytic estimate tracks the fluid
simulator within ±15% on every registry scenario and preset; for the
event-driven flooding baseline an effective-concurrency approximation holds
±15% on the registry and preset set and degrades on hub-heavy overlays,
where the estimate carries a :class:`TimingContractWarning`.
:func:`estimate_throughput` walks one round through the event engine
(:mod:`repro_torch.core.events`) for the steady-state rounds/s of an
asynchronously pipelined plan, within ±15% of multi-round engine runs.
Left out: the reference's observability counters.
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .graph import Graph, subnet_of

# A physical link: ("access-up"/"access-down", node, -1) or ("trunk", r1, r2)
# with r1 < r2. Shared with (and re-exported by) repro_torch.core.netsim.
LinkId = Tuple[str, int, int]

ROUTER_KINDS = ("mesh", "line", "star")


# ---------------------------------------------------------------------------
# Declarative spec
# ---------------------------------------------------------------------------


@dataclass
class NetworkSpec:
    """A declared physical underlay: devices behind a routed trunk fabric.

    Every field is plain data, so specs serialize, sweep (``underlay=`` is a
    :class:`~repro_torch.scenario.spec.ScenarioSpec` field and therefore a sweep
    axis) and fingerprint for the plan cache. :meth:`build` compiles the
    spec into the runtime :class:`CompiledNetwork`.
    """

    name: str = "custom"
    n: int = 10
    n_subnets: int = 3
    # Router fabric: a named shape over ``n_subnets`` routers, or explicit
    # undirected router edges. Transfers follow shortest paths (hop count,
    # deterministic low-index tie-break) across the fabric.
    router_kind: str = "mesh"  # mesh | line | star
    router_edges: Optional[Tuple[Tuple[int, int], ...]] = None
    # Access links. ``access_range`` switches on per-node heterogeneity:
    # rates are drawn uniformly from the range, deterministically from
    # ``het_seed`` and the *physical* node id (stable under churn masking).
    access_mbps: float = 12.0
    access_range: Optional[Tuple[float, float]] = None
    het_seed: int = 0
    trunk_mbps: float = 30.0
    base_latency_s: float = 0.15  # per-transfer protocol overhead (FTP setup)
    hop_latency_s: float = 0.35  # extra latency per router hop on the path
    per_flow_cap_mbps: float = 11.0  # single-flow application ceiling
    # Goodput collapse under contention (same model as TestbedSpec): with k
    # flows on a link, capacity shrinks by 1/(1 + gamma * max(0, k - k0));
    # gamma additionally scales with sqrt(size / collapse_ref_mb).
    collapse_gamma: float = 0.05
    collapse_k0: int = 3
    collapse_ref_mb: float = 30.0
    # Churn masking (scenario runner): ``node_ids[i]`` is the physical id of
    # dense index i, ``phys_n`` the physical device count — heterogeneous
    # rates and subnet routing follow the physical layout.
    node_ids: Optional[Tuple[int, ...]] = None
    phys_n: Optional[int] = None

    def __post_init__(self) -> None:
        if self.router_edges is not None:
            # fully normalized (low-high, deduped, sorted): equivalent
            # spellings compare equal and share cache fingerprints
            self.router_edges = tuple(sorted(
                {(min(a, b), max(a, b)) for a, b in self.router_edges}))
        if self.access_range is not None:
            self.access_range = tuple(self.access_range)  # type: ignore

    # -- validation ----------------------------------------------------------
    def validate(self) -> "NetworkSpec":
        if self.n < 1:
            raise ValueError("a network needs at least one node")
        if self.n_subnets < 1:
            raise ValueError("n_subnets must be >= 1")
        if self.router_edges is None and self.router_kind not in ROUTER_KINDS:
            raise ValueError(
                f"unknown router_kind {self.router_kind!r}; "
                f"known: {ROUTER_KINDS} (or pass explicit router_edges)")
        if self.router_edges is not None:
            bad = [e for e in self.router_edges
                   if not all(0 <= r < self.n_subnets for r in e)]
            if bad:
                raise ValueError(
                    f"router_edges {bad} name routers outside "
                    f"[0, {self.n_subnets})")
        if self.access_range is not None:
            lo, hi = self.access_range
            if not (0 < lo <= hi):
                raise ValueError(f"bad access_range {self.access_range}")
        if self.access_mbps <= 0 or self.trunk_mbps <= 0:
            raise ValueError("link capacities must be positive")
        return self

    # -- derived views -------------------------------------------------------
    def subnet(self, node: int) -> int:
        """Dense node index -> router subnet (physical layout under churn)."""
        if self.node_ids is not None:
            return subnet_of(self.node_ids[node], self.phys_n or self.n,
                             self.n_subnets)
        return subnet_of(node, self.n, self.n_subnets)

    def masked(self, members: Sequence[int]) -> "NetworkSpec":
        """The network restricted to ``members`` (dense reindexing), keeping
        the physical subnet layout and per-node heterogeneity."""
        return mask_underlay(self, members)

    def build(self) -> "CompiledNetwork":
        """Compile to the runtime network model (routes + rate tables)."""
        return CompiledNetwork(self.validate())

    # -- identity ------------------------------------------------------------
    def fingerprint(self) -> Tuple[Any, ...]:
        """Hashable identity (plan-cache key component)."""
        return ("network",) + _field_tuple(self)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["type"] = "NetworkSpec"
        return d


def mask_underlay(spec, members: Sequence[int]):
    """One underlay spec restricted to the healthy ``members`` — THE churn
    masking rule (dense reindexing; ``phys_n`` pins the physical layout so
    subnet routing and seeded per-node rates survive the renumbering).
    Shared by :meth:`NetworkSpec.masked` and
    :meth:`repro_torch.core.netsim.TestbedSpec.masked` so the two underlay
    flavours cannot drift apart."""
    return dataclasses.replace(
        spec, n=len(members), node_ids=tuple(members),
        phys_n=spec.phys_n or spec.n)


def router_graph_edges(kind: str, n_subnets: int) -> Tuple[Tuple[int, int], ...]:
    """The undirected router edges of a named fabric shape.

    ``mesh`` — every router pair directly trunked (the paper's implicit
    assumption); ``line`` — routers chained 0-1-2-…; ``star`` — router 0 is
    the hub every other router trunks into (campus/WAN core).
    """
    r = n_subnets
    if kind == "mesh":
        return tuple((i, j) for i in range(r) for j in range(i + 1, r))
    if kind == "line":
        return tuple((i, i + 1) for i in range(r - 1))
    if kind == "star":
        return tuple((0, i) for i in range(1, r))
    raise ValueError(f"unknown router_kind {kind!r}; known: {ROUTER_KINDS}")


# ---------------------------------------------------------------------------
# Compiled model
# ---------------------------------------------------------------------------


class CompiledNetwork:
    """The runtime network model: precomputed routes and rate tables.

    This is the interface every consumer programs against (the *NetworkModel
    protocol*): ``n``, ``links_for``, ``capacity``, ``latency``, ``subnet``,
    plus the contention constants (``per_flow_cap_mbps``, ``collapse_*``).
    :class:`repro_torch.core.netsim.TestbedSpec` satisfies the same protocol by
    delegating to a compiled default-mesh network, so the fluid simulator
    accepts either interchangeably.
    """

    def __init__(self, spec: NetworkSpec) -> None:
        self.spec = spec
        self.n = spec.n
        self.per_flow_cap_mbps = spec.per_flow_cap_mbps
        self.collapse_gamma = spec.collapse_gamma
        self.collapse_k0 = spec.collapse_k0
        self.collapse_ref_mb = spec.collapse_ref_mb
        # dense node -> subnet table first: an underlay declared with fewer
        # devices than the overlay maps trailing nodes past n_subnets-1
        # (subnet_of is monotone in the node id), and named fabrics extend
        # to cover every mapped router — for the mesh this reproduces the
        # historical TestbedSpec behaviour (extra subnets, direct trunks)
        self.node_subnet = np.array([spec.subnet(u) for u in range(spec.n)],
                                    dtype=np.int64)
        r = max(spec.n_subnets,
                int(self.node_subnet.max(initial=0)) + 1)
        edges = (spec.router_edges if spec.router_edges is not None
                 else router_graph_edges(spec.router_kind, r))
        self.trunk_edges: Tuple[Tuple[int, int], ...] = tuple(sorted(set(edges)))
        self._trunk_index = {e: i for i, e in enumerate(self.trunk_edges)}
        # all-pairs shortest router paths (hop count, low-index tie-break);
        # a fabric that disconnects any subnet pair is rejected here, before
        # the analytic profile builder could silently route around it
        self._paths = _router_paths(r, self.trunk_edges)
        if len(self._paths) != r * r:
            reachable = {d for (s, d) in self._paths if s == 0}
            missing = sorted(set(range(r)) - reachable)
            raise ValueError(
                f"router graph disconnects subnets (e.g. {missing} "
                f"unreachable from 0); every subnet pair needs a route")
        self.access_rate = self._access_rates()
        # per-subnet-pair trunk routes, padded for vectorized gathers:
        # route_trunks[s, d] lists trunk indices (-1 padded), route_hops[s, d]
        # the router-hop count the latency model charges.
        max_len = max((len(p) for p in self._paths.values()), default=0)
        self.route_trunks = -np.ones((r, r, max(max_len, 1)), dtype=np.int64)
        self.route_hops = np.zeros((r, r), dtype=np.int64)
        for (s, d), path in self._paths.items():
            for j, e in enumerate(path):
                self.route_trunks[s, d, j] = self._trunk_index[e]
            # the paper's rule generalized: an intra-subnet transfer pays no
            # router-hop latency; a routed transfer pays one hop per router
            # on the path (trunk count + 1) — for the default full mesh this
            # reproduces the historical 0-or-2 exactly.
            self.route_hops[s, d] = len(path) + 1 if path else 0
        self.latency_table = (spec.base_latency_s
                              + self.route_hops * spec.hop_latency_s)

    def _access_rates(self) -> np.ndarray:
        spec = self.spec
        # cover every referenced physical id (an underlay declared smaller
        # than the overlay maps node ids past phys_n; see node_subnet above)
        phys_n = spec.phys_n or spec.n
        if spec.node_ids is not None:
            phys_n = max(phys_n, max(spec.node_ids) + 1)
        else:
            phys_n = max(phys_n, spec.n)
        if spec.access_range is None:
            phys = np.full(phys_n, spec.access_mbps, dtype=np.float64)
        else:
            lo, hi = spec.access_range
            # one vectorized draw over the full *physical* id range, then
            # index: the rate a device was assigned survives churn masking
            # and sub-sampling because the stream is drawn in id order (a
            # longer draw keeps its prefix)
            phys = np.random.default_rng(spec.het_seed).uniform(lo, hi, phys_n)
        if spec.node_ids is not None:
            return phys[np.asarray(spec.node_ids, dtype=np.int64)]
        return phys[:spec.n]

    # -- NetworkModel protocol ----------------------------------------------
    def subnet(self, node: int) -> int:
        return int(self.node_subnet[node])

    def trunks_between(self, s: int, d: int) -> List[Tuple[int, int]]:
        """The trunk edges a subnet-``s`` -> subnet-``d`` transfer traverses."""
        if s == d:
            return []
        path = self._paths.get((s, d))
        if path is None:
            raise ValueError(f"router graph disconnects subnets {s} and {d}")
        return list(path)

    def links_for(self, src: int, dst: int) -> List[LinkId]:
        s, d = self.subnet(src), self.subnet(dst)
        links: List[LinkId] = [("access-up", src, -1)]
        links.extend(("trunk", a, b) for a, b in self.trunks_between(s, d))
        links.append(("access-down", dst, -1))
        return links

    def capacity(self, link: LinkId) -> float:
        if link[0] == "trunk":
            return self.spec.trunk_mbps
        return float(self.access_rate[link[1]])

    def latency(self, src: int, dst: int) -> float:
        return float(self.latency_table[self.subnet(src), self.subnet(dst)])

    # -- link indexing for the vectorized timing model ----------------------
    @property
    def n_links(self) -> int:
        return 2 * self.n + len(self.trunk_edges)

    def link_capacities(self) -> np.ndarray:
        """Capacity per link index: [access-up x n | access-down x n | trunks]."""
        return np.concatenate([
            self.access_rate, self.access_rate,
            np.full(len(self.trunk_edges), self.spec.trunk_mbps)])

    def link_name(self, idx: int) -> LinkId:
        if idx < self.n:
            return ("access-up", idx, -1)
        if idx < 2 * self.n:
            return ("access-down", idx - self.n, -1)
        a, b = self.trunk_edges[idx - 2 * self.n]
        return ("trunk", a, b)


def _router_paths(
    n_subnets: int, edges: Sequence[Tuple[int, int]]
) -> Dict[Tuple[int, int], List[Tuple[int, int]]]:
    """BFS all-pairs shortest paths over the router graph.

    Returns, per ordered router pair, the list of (normalized) trunk edges
    on the path. Deterministic: BFS visits neighbours in ascending index
    order, so equal-length paths tie-break toward low router ids.
    """
    adj: Dict[int, List[int]] = {r: [] for r in range(n_subnets)}
    for a, b in edges:
        adj[a].append(b)
        adj[b].append(a)
    for r in adj:
        adj[r] = sorted(set(adj[r]))
    out: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
    for s in range(n_subnets):
        prev = {s: -1}
        queue = [s]
        while queue:
            nxt: List[int] = []
            for u in queue:
                for v in adj[u]:
                    if v not in prev:
                        prev[v] = u
                        nxt.append(v)
            queue = nxt
        for d in prev:
            path: List[Tuple[int, int]] = []
            u = d
            while prev[u] != -1:
                path.append((min(u, prev[u]), max(u, prev[u])))
                u = prev[u]
            out[(s, d)] = list(reversed(path))
    return out


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------

# name -> factory(n) -> NetworkSpec. Every preset is a plain spec, so
# ``ScenarioSpec(underlay="wan")`` and sweep axes over preset names work
# everywhere a spec does.
NETWORK_PRESETS: Dict[str, Callable[[int], NetworkSpec]] = {}


def register_preset(name: str):
    """Decorator: register a ``factory(n) -> NetworkSpec`` under ``name``."""

    def deco(fn: Callable[[int], NetworkSpec]):
        NETWORK_PRESETS[name] = fn
        return fn

    return deco


@register_preset("paper_lan")
def _paper_lan(n: int = 10) -> NetworkSpec:
    """The paper's testbed: 3 subnets behind a full router mesh, uniform
    12 MB/s access, 30 MB/s trunks (the :class:`TestbedSpec` defaults)."""
    return NetworkSpec(name="paper_lan", n=n)


@register_preset("wan")
def _wan(n: int = 10) -> NetworkSpec:
    """A campus-to-campus WAN: 4 sites chained over slow long-haul trunks
    (line fabric — cross-site transfers may traverse several trunks), with
    much higher per-hop latency."""
    return NetworkSpec(
        name="wan", n=n, n_subnets=4, router_kind="line",
        trunk_mbps=8.0, base_latency_s=0.25, hop_latency_s=1.2)


@register_preset("edge")
def _edge(n: int = 10) -> NetworkSpec:
    """Heterogeneous edge deployment: per-device access rates drawn from
    3–16 MB/s (seeded), all sites homed on one hub router (star fabric)."""
    return NetworkSpec(
        name="edge", n=n, n_subnets=4, router_kind="star",
        access_range=(3.0, 16.0), trunk_mbps=20.0, hop_latency_s=0.5)


@register_preset("congested")
def _congested(n: int = 10) -> NetworkSpec:
    """The paper fabric under aggressive goodput collapse: loss-driven
    retransmission sets in at 2 concurrent flows and grows 4x faster."""
    return NetworkSpec(
        name="congested", n=n, collapse_gamma=0.2, collapse_k0=1,
        per_flow_cap_mbps=9.0)


def get_preset(name: str, n: int = 10) -> NetworkSpec:
    """A fresh preset spec sized to ``n`` devices."""
    try:
        factory = NETWORK_PRESETS[name]
    except KeyError:
        raise ValueError(
            f"unknown network preset {name!r}; known: "
            f"{sorted(NETWORK_PRESETS)}") from None
    return factory(n)


def as_network_model(
    underlay: Union[str, NetworkSpec, "CompiledNetwork", Any],
    n: Optional[int] = None,
):
    """Resolve anything underlay-shaped to a runtime network model.

    Accepts a preset name, a :class:`NetworkSpec` (compiled here), an
    object exposing ``to_network()`` (:class:`repro_torch.core.netsim.
    TestbedSpec` — compiled so hot loops skip its per-call delegation), or
    any object already satisfying the NetworkModel protocol
    (:class:`CompiledNetwork` passes through unchanged).
    """
    if isinstance(underlay, str):
        underlay = get_preset(underlay, n if n is not None else 10)
    if isinstance(underlay, NetworkSpec):
        return underlay.build()
    if hasattr(underlay, "to_network"):
        return underlay.to_network().build()
    if hasattr(underlay, "links_for") and hasattr(underlay, "capacity"):
        return underlay
    raise TypeError(f"not a network model: {underlay!r}")


def as_compiled_network(
    underlay: Union[str, NetworkSpec, "CompiledNetwork", Any],
    n: Optional[int] = None,
) -> "CompiledNetwork":
    """Like :func:`as_network_model` but always a :class:`CompiledNetwork`
    (the vectorized timing model needs the compiled route/rate tables)."""
    model = as_network_model(underlay, n)
    if isinstance(model, CompiledNetwork):
        return model
    raise TypeError(f"cannot compile network model {model!r}")


def _field_tuple(obj) -> Tuple[Any, ...]:
    """A dataclass's field values as a flat tuple (cheap ``astuple`` without
    its deepcopy recursion — all underlay fields are already plain data)."""
    return tuple(getattr(obj, f) for f in obj.__dataclass_fields__)


def underlay_fingerprint(underlay: Union[str, NetworkSpec, Any],
                         n: Optional[int] = None) -> Tuple[Any, ...]:
    """Hashable identity of an underlay declaration (plan-cache key)."""
    if isinstance(underlay, str):
        return ("preset", underlay, n)
    if isinstance(underlay, NetworkSpec):
        return underlay.fingerprint()
    if isinstance(underlay, CompiledNetwork):
        return underlay.spec.fingerprint()
    # dataclass underlays (TestbedSpec) identify by their field values
    if dataclasses.is_dataclass(underlay):
        return (type(underlay).__name__,) + _field_tuple(underlay)
    return ("object", id(underlay))


# ---------------------------------------------------------------------------
# Analytic timing: closed-form per-slot bottleneck + contention
# ---------------------------------------------------------------------------


class TimingContractWarning(UserWarning):
    """The analytic timing estimate is outside its documented tolerance
    contract (DESIGN.md §12): event-driven flooding over a hub-heavy
    overlay, where the effective-concurrency discount misprices the hub's
    access-link burstiness (observed worst case ±38% vs the fluid
    simulator on the 384-cell Barabási–Albert grid)."""


@dataclass
class TimingEstimate:
    """Analytic round-timing results, field-compatible with the fluid
    simulator's :class:`~repro_torch.core.netsim.SimResult` metrics."""

    total_time_s: float
    mean_transfer_s: float
    mean_bandwidth_mbps: float
    n_transfers: int
    max_concurrency: int
    per_slot_s: Optional[np.ndarray] = None
    # set when this estimate is outside the module's tolerance contract
    # (a TimingContractWarning was emitted); None = in contract
    contract_warning: Optional[str] = None


class TimingProfile:
    """The payload-independent timing structure of one (plan, network) pair.

    Construction walks the plan once and aggregates, per slot and per
    traversed physical link: flow count, latency sum and latency max —
    everything the closed-form needs. :meth:`estimate` then evaluates the
    formula for any per-send wire size as pure numpy array work, which is
    what makes whole sweep grids (many payload/codec cells over one plan)
    cost one profile + N vector evaluations instead of N fluid simulations.

    The closed form, per slot, per link ``l`` with ``k`` flows of size
    ``S`` (MB), capacity ``C`` and collapse factor
    ``coll = 1 + gamma_eff * max(0, k_eff - k0)``::

        drain_l = mean_latency_l + k * S / min(C / coll, k * cap)
        floor_l = max_latency_l  + S / min(cap, C)
        T_slot  = max_l max(drain_l, floor_l)

    and the round time is the sum over slots (the self-clocked drain
    barrier). Mean latency — not max — is the first-order-correct offset
    because flows start draining at their own staggered latencies. For
    event-driven policies (flooding) there is no slot barrier: links are
    aggregated over the whole round and the collapse factor is evaluated at
    an effective concurrency ``k_eff = min(0.65 * max adjacent-wave count,
    K)`` — adjacent forwarding waves overlap in flight, while launch ramps
    and early finishers keep the byte-weighted concurrency below the raw
    peak (0.65 reproduces the fluid simulator's byte-weighted average; see
    the module tolerance contract).
    """

    #: event-mode effective-concurrency discount (byte-weighted average
    #: concurrency / peak adjacent-wave concurrency in the fluid simulator)
    EVENT_CONCURRENCY_DISCOUNT = 0.65

    #: hub-heaviness threshold for the out-of-contract warning: per-sender
    #: flow-count skew (busiest access-up link / mean) at or above this
    #: marks the overlay hub-heavy. For flooding the per-sender flow count
    #: is proportional to overlay degree, so this is exactly the degree
    #: skew; 1.5 was calibrated to fire on every shape of the documented
    #: 384-cell Barabási–Albert outlier grid (n ∈ {8, 10, 12, 16} × 6
    #: seeds, m = 2; observed skews 1.54–2.48) while regular families
    #: (Watts–Strogatz ≤ 1.5 boundary-exclusive, complete = 1.0) stay
    #: silent. Genuinely hub-heavy Erdős–Rényi draws also fire — the
    #: warning tracks the structural cause, not the generator's name.
    HUB_SKEW_WARN_THRESHOLD = 1.5

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_policy(cls, policy, network, max_slots: int = 1_000_000
                    ) -> "TimingProfile":
        """Walk a :class:`~repro_torch.core.plan.CommPolicy` once, vectorized —
        no Python send tuples are materialized (the N=1000 sweep path)."""
        network = as_compiled_network(network, n=policy.n)
        builder = _ProfileBuilder(network)
        policy.reset()
        t = 0
        while not policy.done():
            if t >= max_slots:
                raise RuntimeError(f"{policy.kind} did not converge")
            sends = policy.emit(t)
            policy.commit(t, sends)
            builder.add_slot(sends.src, sends.dst)
            t += 1
        return builder.finish(policy.sync)

    @classmethod
    def from_plan(cls, plan, network) -> "TimingProfile":
        """Profile an already-compiled :class:`~repro_torch.core.plan.SlotPlan`."""
        network = as_compiled_network(network, n=plan.n)
        builder = _ProfileBuilder(network)
        for slot in plan.slots:
            arr = np.asarray(slot.sends, dtype=np.int64).reshape(-1, 3)
            builder.add_slot(arr[:, 0], arr[:, 1])
        sync = "event" if plan.kind == "flooding" else "slot"
        return builder.finish(sync)

    # -- evaluation (implemented by the frozen profile) ----------------------
    def estimate(self, size_mb: float) -> TimingEstimate:
        """Closed-form timing for one per-send wire size (MB)."""
        raise NotImplementedError

    def measure_stats(self) -> Dict[str, float]:
        """The :func:`repro_torch.core.plan.measure_policy` counting stats, free —
        the profile walk already counted them, so a consumer needing both
        timing and counts pays for one policy walk, not two."""
        return {"n_slots": self.total_slots,
                "transmissions": self.n_transfers,
                "max_concurrent_sends": self.max_concurrency}


class _ProfileBuilder:
    """Accumulates per-slot link aggregates from vectorized send arrays."""

    def __init__(self, network) -> None:
        self.net = network
        n = network.n
        self.rows: List[Tuple[np.ndarray, ...]] = []
        self.flow_lat: List[np.ndarray] = []
        self.flow_entry: List[np.ndarray] = []  # per-incidence local entry idx
        self.flow_ids: List[np.ndarray] = []  # per-incidence slot-local flow
        self.total_slots = 0  # every emitted slot, empty ones included
        self._subnet = network.node_subnet
        self._lat_table = network.latency_table
        self._route_trunks = network.route_trunks  # (r, r, max_len)
        self._trunk_base = 2 * n

    def add_slot(self, src: np.ndarray, dst: np.ndarray) -> None:
        self.total_slots += 1
        if src.size == 0:
            return
        n = self.net.n
        ssub = self._subnet[src]
        dsub = self._subnet[dst]
        lat = self._lat_table[ssub, dsub]
        # per-flow link incidences: up, down, and the route's trunks
        trunk_rows = self._route_trunks[ssub, dsub]  # (F, max_len)
        tmask = trunk_rows >= 0
        flow_idx = np.arange(src.size)
        inc_flow = np.concatenate([
            flow_idx, flow_idx, np.repeat(flow_idx, tmask.sum(axis=1))])
        inc_link = np.concatenate([
            src, n + dst, self._trunk_base + trunk_rows[tmask]])
        # aggregate to unique (link) rows for this slot
        order = np.argsort(inc_link, kind="stable")
        inc_link_s, inc_flow_s = inc_link[order], inc_flow[order]
        links, first = np.unique(inc_link_s, return_index=True)
        counts = np.diff(np.concatenate((first, [inc_link_s.size])))
        lat_inc = lat[inc_flow_s]
        lat_sum = np.add.reduceat(lat_inc, first)
        lat_max = np.maximum.reduceat(lat_inc, first)
        self.rows.append((links, counts.astype(np.float64), lat_sum, lat_max))
        # per-incidence entry position (into this slot's unique rows), in
        # original incidence order, for the per-flow bottleneck estimate
        entry_of_inc = np.empty(inc_link.size, dtype=np.int64)
        entry_of_inc[order] = np.repeat(
            np.arange(links.size), counts)
        self.flow_entry.append(entry_of_inc)
        self.flow_ids.append(inc_flow)
        self.flow_lat.append(lat)

    def finish(self, sync: str) -> "_FrozenProfile":
        return _FrozenProfile(self.net, sync, self.rows, self.flow_lat,
                              self.flow_entry, self.flow_ids,
                              self.total_slots)


class _FrozenProfile(TimingProfile):
    """The evaluatable profile (all arrays flattened and frozen)."""

    def __init__(self, network, sync, rows, flow_lat, flow_entry, flow_ids,
                 total_slots=None):
        # deliberately *not* calling TimingProfile.__init__ — this is the
        # real layout; the parent class documents the contract
        self.network = network
        self.sync = sync
        self.n_slots = len(rows)  # non-empty slots (the timed ones)
        self.total_slots = len(rows) if total_slots is None else total_slots
        caps = network.link_capacities()
        z64 = np.zeros(0, np.int64)
        zf = np.zeros(0, np.float64)
        self._e_slot = (np.concatenate(
            [np.full(r[0].size, t, np.int64) for t, r in enumerate(rows)])
            if rows else z64)
        self._e_link = np.concatenate([r[0] for r in rows]) if rows else z64
        self._e_count = np.concatenate([r[1] for r in rows]) if rows else zf
        self._e_lat_sum = np.concatenate([r[2] for r in rows]) if rows else zf
        self._e_lat_max = np.concatenate([r[3] for r in rows]) if rows else zf
        self._e_cap = caps[self._e_link] if rows else zf
        self._f_lat = np.concatenate(flow_lat) if flow_lat else zf
        self.n_transfers = int(self._f_lat.size)
        self.max_concurrency = int(max((l.size for l in flow_lat), default=0))
        # global per-incidence (entry, flow) indices
        entry_off = np.cumsum([0] + [r[0].size for r in rows])
        flow_off = np.cumsum([0] + [l.size for l in flow_lat])
        self._i_entry = (np.concatenate(
            [e + entry_off[t] for t, e in enumerate(flow_entry)])
            if flow_entry else z64)
        self._i_flow = (np.concatenate(
            [f + flow_off[t] for t, f in enumerate(flow_ids)])
            if flow_ids else z64)
        # event-mode aggregates: per-link totals + peak adjacent-wave counts
        self._ev_up_skew = 0.0
        if sync == "event" and rows:
            links, inv = np.unique(self._e_link, return_inverse=True)
            K = np.zeros(links.size)
            np.add.at(K, inv, self._e_count)
            lat_sum = np.zeros(links.size)
            np.add.at(lat_sum, inv, self._e_lat_sum)
            lat_max = np.zeros(links.size)
            np.maximum.at(lat_max, inv, self._e_lat_max)
            # per (slot, link) dense counts for adjacent-wave peaks
            dense = np.zeros((self.n_slots, links.size))
            dense[self._e_slot, inv] = self._e_count
            pair = dense + np.vstack((dense[1:], np.zeros((1, links.size))))
            kpair = pair.max(axis=0)
            self._ev_link = links
            self._ev_K = K
            self._ev_lat_mean = lat_sum / K
            self._ev_lat_max = lat_max
            self._ev_kpair = kpair
            self._ev_cap = caps[links]
            # per-sender concentration: flow counts over access-up links
            # (link indices < n by the CompiledNetwork layout) — for
            # flooding this is proportional to overlay degree, the
            # hub-heaviness signal of the tolerance contract
            up = K[links < network.n]
            self._ev_up_skew = float(up.max() / up.mean()) if up.size else 0.0

    # -- the closed form -----------------------------------------------------
    def _collapse(self, k_eff: np.ndarray, size_mb: float) -> np.ndarray:
        net = self.network
        gamma = net.collapse_gamma * (size_mb / net.collapse_ref_mb) ** 0.5
        return 1.0 + gamma * np.maximum(0.0, k_eff - net.collapse_k0)

    def estimate(self, size_mb: float) -> TimingEstimate:
        size_mb = float(size_mb)
        net = self.network
        cap = net.per_flow_cap_mbps
        contract_msg: Optional[str] = None
        if self.n_transfers == 0:
            return TimingEstimate(0.0, 0.0, 0.0, 0, 0,
                                  np.zeros(self.n_slots))
        if self.sync == "event":
            coll = self._collapse(
                np.minimum(self.EVENT_CONCURRENCY_DISCOUNT * self._ev_kpair,
                           self._ev_K), size_mb)
            R = np.minimum(self._ev_cap / coll, self._ev_K * cap)
            drain = self._ev_lat_mean + self._ev_K * size_mb / R
            floor = self._ev_lat_max + size_mb / np.minimum(cap, self._ev_cap)
            total = float(np.maximum(drain, floor).max())
            per_slot = None
            if self._ev_up_skew > self.HUB_SKEW_WARN_THRESHOLD:
                contract_msg = (
                    f"event-driven timing estimate on a hub-heavy overlay: "
                    f"per-sender access-link skew {self._ev_up_skew:.2f} > "
                    f"{self.HUB_SKEW_WARN_THRESHOLD} is outside the +/-15% "
                    f"accuracy contract (DESIGN.md §12; worst observed "
                    f"deviation ±38% on the barabasi_albert outlier "
                    f"grid) — treat total_time_s as a lower-confidence "
                    f"ordering signal, or use the async event engine")
                warnings.warn(contract_msg, TimingContractWarning,
                              stacklevel=3)
        else:
            k = self._e_count
            coll = self._collapse(k, size_mb)
            R = np.minimum(self._e_cap / coll, k * cap)
            drain = self._e_lat_sum / k + k * size_mb / R
            floor = self._e_lat_max + size_mb / np.minimum(cap, self._e_cap)
            per_entry = np.maximum(drain, floor)
            per_slot = np.zeros(self.n_slots)
            np.maximum.at(per_slot, self._e_slot, per_entry)
            total = float(per_slot.sum())
        # per-flow bottleneck estimate (initial fair share, capped)
        k = self._e_count
        share = (self._e_cap / self._collapse(k, size_mb)) / k
        flow_rate = np.full(self.n_transfers, np.inf)
        np.minimum.at(flow_rate, self._i_flow, share[self._i_entry])
        flow_rate = np.minimum(flow_rate, cap)
        dur = self._f_lat + size_mb / flow_rate
        return TimingEstimate(
            total_time_s=total,
            mean_transfer_s=float(dur.mean()),
            mean_bandwidth_mbps=float((size_mb / dur).mean()),
            n_transfers=self.n_transfers,
            max_concurrency=self.max_concurrency,
            per_slot_s=per_slot,
            contract_warning=contract_msg)


def estimate_timing(plan, network, bytes_per_payload: float) -> TimingEstimate:
    """Analytic round timing of a communication plan on a network model.

    ``plan`` is a compiled :class:`~repro_torch.core.plan.SlotPlan` or a live
    :class:`~repro_torch.core.plan.CommPolicy`; ``network`` anything
    :func:`as_network_model` accepts (preset name, :class:`NetworkSpec`,
    :class:`CompiledNetwork`, :class:`~repro_torch.core.netsim.TestbedSpec`);
    ``bytes_per_payload`` the wire bytes of one send (codec-encoded,
    ``payload_fraction`` applied — i.e. exactly what the fluid simulator
    moves per flow). Reuse a :class:`TimingProfile` directly when sweeping
    many payload sizes over one plan.
    """
    from .plan import CommPolicy  # local: plan does not import network

    if isinstance(plan, CommPolicy):
        profile = TimingProfile.from_policy(plan, network)
    else:
        profile = TimingProfile.from_plan(plan, network)
    return profile.estimate(bytes_per_payload / 1e6)


# ---------------------------------------------------------------------------
# Steady-state throughput (the event engine's analytic contract)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ThroughputEstimate:
    """Analytic steady-state throughput of an asynchronously-pipelined plan.

    ``fill_latency_s`` is the pipeline-fill time: admission of round 0 to
    its completion (one full round through the store-and-forward underlay,
    mean compute included). ``steady_period_s`` is the predicted
    inter-round completion gap once the ``max_staleness + 1``-deep pipeline
    is full; ``rounds_per_s`` its reciprocal. The two structural bounds the
    period is derived from are exposed for inspection: the busiest link's
    serialized per-round demand and the slowest node's serial span.
    """

    rounds_per_s: float
    steady_period_s: float
    fill_latency_s: float
    bottleneck_busy_s: float  # max over links of Σ size/capacity per round
    node_span_s: float  # max over nodes of compute + own-clock round work


def estimate_throughput(plan, network, bytes_per_payload: float,
                        max_staleness: int = 0,
                        compute_time_s: float = 0.0,
                        compute_jitter_s: float = 0.0) -> ThroughputEstimate:
    """Steady-state rounds/sec of a plan pipelined on the event engine.

    Same calling convention as :func:`estimate_timing` (``plan`` is a live
    policy or compiled plan, ``bytes_per_payload`` the wire bytes of one
    send), plus the async knobs of the event executor. The form walks
    *one* round through the discrete-event link model (the pipeline fill),
    then takes the steady-state period as the binding structural bound:

    * ``max_staleness = 0`` — the barrier: every round repeats the fill,
      so the period *is* the single-round makespan;
    * ``max_staleness >= 1`` — rounds overlap; the period is bounded below
      by the busiest link's per-round serialized demand, the slowest
      node's serial span (a node's rounds chain on its own clock), and the
      admission window ``fill / (max_staleness + 1)`` — the max of the
      three is the estimate.

    Compute jitter enters at its expectation (``jitter / 2``); the
    contract against multi-round engine runs is the same ±15% the timing
    model carries against the fluid simulator.
    """
    from .events import AsyncEventEngine, plan_slots  # local: engine layer

    net = as_compiled_network(network, n=plan.n)
    slots = plan_slots(plan)
    size_mb = bytes_per_payload / 1e6
    n = net.n
    compute = np.full(n, compute_time_s + compute_jitter_s / 2.0)
    eng = AsyncEventEngine()
    eng.add_round(range(n), net, slots, size_mb, compute)
    (rt,) = eng.run()
    fill = rt.completed_s
    link_busy = max(eng.link_busy.values(), default=0.0)
    span = float(eng.node_spans(0).max()) if n else 0.0
    if max_staleness <= 0:
        period = fill
    else:
        period = max(link_busy, span, fill / (max_staleness + 1))
    return ThroughputEstimate(
        rounds_per_s=(1.0 / period if period > 0 else float("inf")),
        steady_period_s=period, fill_latency_s=fill,
        bottleneck_busy_s=link_busy, node_span_s=span)


# ---------------------------------------------------------------------------
# Network-aware slot length (paper III-C, on the physical model)
# ---------------------------------------------------------------------------


def slot_length_for_network(
    g: Graph, colors: np.ndarray, network, model_size_mb: float
) -> float:
    """The moderator's slot length derived from the network model.

    The paper's formula extrapolates a ping measurement to the model size;
    with a declared underlay the moderator can do better: the slot must
    cover the slowest same-colored multicast, which the analytic model
    gives directly — max over colors of the bottleneck slot time when that
    color's nodes each send to all their schedule neighbours.
    """
    from .plan import MstExchangePolicy  # local: avoid import cycle

    net = as_compiled_network(network, n=g.n)
    profile = TimingProfile.from_policy(
        MstExchangePolicy(g, np.asarray(colors)), net)
    est = profile.estimate(model_size_mb)
    if est.per_slot_s is None or est.per_slot_s.size == 0:
        return 0.0
    return float(est.per_slot_s.max())
