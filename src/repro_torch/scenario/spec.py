"""Declarative scenario specification: the port's copy of
``repro.scenario.spec``.

A :class:`ScenarioSpec` declares one experiment: the overlay (a generated
:class:`~repro_torch.core.graph.TopologySpec`, dense or sparse, or an
explicit cost matrix such as an optimized working overlay), the underlay
preset, the
protocol and its segments, the payload (MB, a Table II code or an
architecture name), the wire codec, the rounds and their churn schedule,
link failures, the asynchronous-execution knobs, the executor requirements
and an optional overlay optimizer. It carries every field of the
reference's spec, with the same defaults, validation and ``to_dict``, so a
sweep's cells expand and serialize as the reference's do. What the port
reads of it:

* the trainer and its session read the protocol, codec, rounds, churn,
  ``n_segments`` and the overlay, as the reference's session does;
* the host executors (:mod:`repro_torch.scenario.executors`) also read the
  payload, the MST / coloring algorithms and the underlay
  (:meth:`ScenarioSpec.testbed`: a preset name, a
  :class:`~repro_torch.core.network.NetworkSpec` or a
  :class:`~repro_torch.core.netsim.TestbedSpec`; None derives the paper
  testbed from the overlay), whose round times fill the rounds' timing
  fields and the totals' ``time_s``; the ``engine`` and ``event`` executors
  the link failures, and ``event`` the staleness window, the straggler
  compute and its jitter, and ``record_events``;
* the ``device`` executor reads what the session reads and the payload.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..compress.codec import CODEC_NAMES, Codec, make_codec
from ..core.graph import Graph, TopologySpec, make_topology
from ..core.netsim import SimResult, TestbedSpec
from ..core.network import NETWORK_PRESETS, NetworkSpec, get_preset
from ..opt import OptimizerSpec

# Protocol names a scenario may declare (everything make_policy knows).
SCENARIO_PROTOCOLS = (
    "dissemination", "mosgu", "segmented", "segmented_gossip", "flooding",
    "tree_allreduce", "broadcast_exchange", "mosgu_exchange",
)

CHURN_ACTIONS = ("leave", "rejoin")

# Executor capability flags a spec may require (the reference's set).
CAPABILITY_FLAGS = ("supports_drops", "provides_timing", "provides_numerics",
                    "moves_payloads", "counting_only", "supports_staleness")

# scenario protocol name -> gossip mode of repro_torch.dfl.collectives
GOSSIP_MODES = {
    "dissemination": "dissemination",
    "mosgu": "dissemination",
    "segmented": "segmented",
    "segmented_gossip": "segmented",
    "tree_allreduce": "tree_allreduce",
    "flooding": "flooding",
}


def resolve_gossip_mode(protocol: str) -> str:
    """The collective mode for a scenario protocol; the per-round exchange
    units (``broadcast_exchange``, ``mosgu_exchange``) have none."""
    try:
        return GOSSIP_MODES[protocol]
    except KeyError:
        raise ValueError(f"scenario protocol {protocol!r} has no gossip mode; "
                         f"known: {sorted(GOSSIP_MODES)}") from None


def resolve_payload_mb(payload: Union[float, int, str]) -> float:
    """A payload declaration in on-wire MB: a size in MB, a Table II code or
    name (``"b0"``, ``"EfficientNet-B0"``), or an architecture name
    (``param_count x 2`` bytes, bf16 on the wire)."""
    if isinstance(payload, (int, float)) and not isinstance(payload, bool):
        mb = float(payload)
        if mb <= 0:
            raise ValueError(f"payload size must be positive, got {mb}")
        return mb
    name = str(payload)
    from ..configs.paper_payloads import PAPER_PAYLOADS

    if name in PAPER_PAYLOADS:
        return PAPER_PAYLOADS[name].capacity_mb
    for p in PAPER_PAYLOADS.values():
        if p.name == name:
            return p.capacity_mb
    from ..configs import get_arch, list_archs

    if name in list_archs():
        return get_arch(name).param_count() * 2 / 1e6
    raise ValueError(
        f"unknown payload {payload!r}: expected MB, a paper payload code "
        f"({sorted(PAPER_PAYLOADS)}), or an arch name ({list_archs()})")


@dataclass(frozen=True)
class ChurnEvent:
    """A membership change pinned to a round (applied before the round runs)."""

    round: int
    action: str  # "leave" | "rejoin"
    node: int

    def to_dict(self) -> Dict[str, Any]:
        return {"round": self.round, "action": self.action, "node": self.node}


@dataclass(frozen=True)
class ScenarioSpec:
    """One declared experiment (the reference's fields and defaults)."""

    name: str = "custom"
    # a TopologySpec or an explicit symmetric cost matrix (n x n)
    overlay: Union[TopologySpec, np.ndarray, Sequence[Sequence[float]]] = field(
        default_factory=lambda: TopologySpec(kind="erdos_renyi"))
    protocol: str = "dissemination"
    n_segments: int = 4
    payload: Union[float, str] = 21.2  # MB | paper payload code | arch name
    codec: str = "fp32"
    rounds: int = 1
    churn: Tuple[ChurnEvent, ...] = ()
    # a preset name (sized to the overlay's n), a NetworkSpec or a TestbedSpec;
    # None = the paper testbed derived from the overlay
    underlay: Optional[Union[TestbedSpec, NetworkSpec, str]] = None
    drop_rate: float = 0.0  # transient link-failure probability per transfer
    drop_seed: int = 0
    max_staleness: int = 0  # extra rounds in flight (the event executor's)
    record_events: bool = False
    compute_time_s: float = 0.0  # per-node compute before a round's first send
    compute_jitter_s: float = 0.0
    jitter_seed: int = 0
    require: Tuple[str, ...] = ()  # executor capabilities, beyond the implied ones
    mst_algorithm: str = "prim"
    coloring_algorithm: str = "bfs"
    optimizer: Optional[OptimizerSpec] = None
    executors: Tuple[str, ...] = ("plan", "engine", "netsim")
    description: str = ""

    # -- derived views -------------------------------------------------------
    @property
    def n(self) -> int:
        if isinstance(self.overlay, TopologySpec):
            return self.overlay.n
        return int(np.asarray(self.overlay).shape[0])

    def overlay_graph(self) -> Graph:
        """The declared overlay as a concrete cost graph (deterministic): a
        :class:`Graph`, or a :class:`~repro_torch.core.sparse.CSRGraph` for
        the sparse topology kinds."""
        if isinstance(self.overlay, TopologySpec):
            return make_topology(self.overlay)
        return Graph(np.asarray(self.overlay, dtype=np.float64))

    def testbed(self) -> Union[TestbedSpec, NetworkSpec]:
        """The physical underlay: the explicit spec, a preset sized to the
        overlay, or, when omitted, derived from the overlay
        (:meth:`TestbedSpec.from_overlay`), so subnet layout and cost model
        are one source."""
        if isinstance(self.underlay, str):
            return get_preset(self.underlay, self.n)
        if self.underlay is not None:
            return self.underlay
        if isinstance(self.overlay, TopologySpec):
            return TestbedSpec.from_overlay(self.overlay)
        return TestbedSpec(n=self.n)

    def payload_mb(self) -> float:
        return resolve_payload_mb(self.payload)

    def codec_obj(self) -> Optional[Codec]:
        """The wire codec; ``None`` for the raw-fp32 baseline."""
        c = make_codec(self.codec)
        return None if c.name == "fp32" else c

    def replace(self, **changes) -> "ScenarioSpec":
        """Field update that re-validates, so a sweep cell cannot carry an
        invalid combination."""
        return dataclasses.replace(self, **changes).validate()

    # -- validation ----------------------------------------------------------
    def validate(self) -> "ScenarioSpec":
        if self.protocol not in SCENARIO_PROTOCOLS:
            raise ValueError(
                f"unknown protocol {self.protocol!r}; known: {SCENARIO_PROTOCOLS}")
        if self.rounds < 1:
            raise ValueError("a scenario needs at least one round")
        if self.n_segments < 1:
            raise ValueError("n_segments must be >= 1")
        if not (0.0 <= self.drop_rate < 1.0):
            raise ValueError("drop_rate must be in [0, 1)")
        if self.max_staleness < 0:
            raise ValueError("max_staleness must be >= 0")
        if not isinstance(self.record_events, bool):
            raise ValueError("record_events must be a bool")
        if self.compute_time_s < 0:
            raise ValueError("compute_time_s must be >= 0")
        if self.compute_jitter_s < 0:
            raise ValueError("compute_jitter_s must be >= 0")
        for flag in self.require:
            if flag not in CAPABILITY_FLAGS:
                raise ValueError(
                    f"spec.require names unknown capability {flag!r}; "
                    f"known: {CAPABILITY_FLAGS}")
        try:
            make_codec(self.codec)
        except ValueError:
            raise ValueError(
                f"unknown codec {self.codec!r}; known: {CODEC_NAMES}") from None
        if isinstance(self.underlay, str) and self.underlay not in NETWORK_PRESETS:
            raise ValueError(
                f"unknown network preset {self.underlay!r}; known: "
                f"{sorted(NETWORK_PRESETS)}")
        if isinstance(self.underlay, NetworkSpec):
            self.underlay.validate()
        if isinstance(self.optimizer, dict):
            object.__setattr__(self, "optimizer", OptimizerSpec.from_dict(self.optimizer))
        if self.optimizer is not None:
            self.optimizer.validate()
        n = self.n
        for ev in self.churn:
            if ev.action not in CHURN_ACTIONS:
                raise ValueError(f"unknown churn action {ev.action!r}")
            if not (0 <= ev.round < self.rounds):
                raise ValueError(
                    f"churn event {ev} outside round range [0, {self.rounds})")
            if not (0 <= ev.node < n):
                raise ValueError(f"churn event {ev} names node outside [0, {n})")
        return self

    # -- serialization -------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        if isinstance(self.overlay, TopologySpec):
            overlay: Any = {"type": "TopologySpec",
                            **{f: getattr(self.overlay, f)
                               for f in self.overlay.__dataclass_fields__}}
        else:
            overlay = {"type": "cost_matrix", "adj": np.asarray(self.overlay).tolist()}
        if self.underlay is None or isinstance(self.underlay, str):
            underlay: Any = self.underlay
        elif isinstance(self.underlay, NetworkSpec):
            underlay = self.underlay.to_dict()
        else:
            underlay = dataclasses.asdict(self.underlay)
        d = {
            "name": self.name,
            "overlay": overlay,
            "underlay": underlay,
            "protocol": self.protocol,
            "n_segments": self.n_segments,
            "payload": self.payload,
            "payload_mb": self.payload_mb(),
            "codec": self.codec,
            "rounds": self.rounds,
            "churn": [ev.to_dict() for ev in self.churn],
            "drop_rate": self.drop_rate,
            "drop_seed": self.drop_seed,
            "max_staleness": self.max_staleness,
            "record_events": self.record_events,
            "compute_time_s": self.compute_time_s,
            "compute_jitter_s": self.compute_jitter_s,
            "jitter_seed": self.jitter_seed,
            "require": list(self.require),
            "mst_algorithm": self.mst_algorithm,
            "coloring_algorithm": self.coloring_algorithm,
            "description": self.description,
        }
        if self.optimizer is not None:  # emitted only when set, as the reference
            d["optimizer"] = self.optimizer.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ScenarioSpec":
        """Reload a :meth:`to_dict` payload (JSON lists back to tuples; an
        explicit cost matrix reloads to the identical matrix)."""
        ov = d["overlay"]
        if isinstance(ov, dict) and ov.get("type") == "TopologySpec":
            kw = {k: v for k, v in ov.items() if k in TopologySpec.__dataclass_fields__}
            for key in ("intra_cost_ms", "inter_cost_ms"):
                if isinstance(kw.get(key), list):
                    kw[key] = tuple(kw[key])
            overlay: Any = TopologySpec(**kw)
        elif isinstance(ov, dict):
            overlay = np.asarray(ov["adj"], dtype=np.float64)
        else:
            overlay = np.asarray(ov, dtype=np.float64)
        und = d.get("underlay")
        underlay: Any
        if und is None or isinstance(und, str):
            underlay = und
        elif und.get("type") == "NetworkSpec":
            ukw = {k: v for k, v in und.items() if k in NetworkSpec.__dataclass_fields__}
            if ukw.get("router_edges") is not None:
                ukw["router_edges"] = tuple(tuple(e) for e in ukw["router_edges"])
            for key in ("access_range", "node_ids"):
                if ukw.get(key) is not None:
                    ukw[key] = tuple(ukw[key])
            underlay = NetworkSpec(**ukw)
        else:
            ukw = {k: v for k, v in und.items() if k in TestbedSpec.__dataclass_fields__}
            if ukw.get("node_ids") is not None:
                ukw["node_ids"] = tuple(ukw["node_ids"])
            underlay = TestbedSpec(**ukw)
        opt = d.get("optimizer")
        return cls(
            name=d.get("name", "custom"),
            overlay=overlay,
            protocol=d.get("protocol", "dissemination"),
            n_segments=d.get("n_segments", 4),
            payload=d.get("payload", 21.2),
            codec=d.get("codec", "fp32"),
            rounds=d.get("rounds", 1),
            churn=tuple(ChurnEvent(**ev) for ev in d.get("churn", ())),
            underlay=underlay,
            drop_rate=d.get("drop_rate", 0.0),
            drop_seed=d.get("drop_seed", 0),
            max_staleness=d.get("max_staleness", 0),
            record_events=d.get("record_events", False),
            compute_time_s=d.get("compute_time_s", 0.0),
            compute_jitter_s=d.get("compute_jitter_s", 0.0),
            jitter_seed=d.get("jitter_seed", 0),
            require=tuple(d.get("require", ())),
            mst_algorithm=d.get("mst_algorithm", "prim"),
            coloring_algorithm=d.get("coloring_algorithm", "bfs"),
            optimizer=OptimizerSpec.from_dict(opt) if opt else None,
            description=d.get("description", ""),
        ).validate()


@dataclass
class RoundReport:
    """What one communication round counted and, on the ``plan``,
    ``netsim`` and ``event`` executors, how long it took on the underlay;
    on the ``device`` executor, whether the round held the FedAvg."""

    round: int
    protocol: str
    members: List[int]  # healthy physical node ids during the round
    moderator: int
    n_slots: int
    transmissions: int  # attempted transfers (retransmissions included)
    bytes_mb: float  # raw payload bytes moved, MB (payload_fraction applied)
    bytes_on_wire_mb: float = 0.0  # after the wire codec
    drops: int = 0
    churn_applied: List[Dict[str, Any]] = field(default_factory=list)
    # timing on the underlay (None where an executor provides none)
    total_time_s: Optional[float] = None
    mean_transfer_s: Optional[float] = None
    mean_bandwidth_mbps: Optional[float] = None
    max_concurrency: Optional[int] = None
    # the event executor's virtual clock: when the staleness window admitted
    # the round and when its last delivery landed (None elsewhere); its
    # churn entries carry ``applied_at_s``, the admission time
    admitted_at_s: Optional[float] = None
    completed_at_s: Optional[float] = None
    # the device executor's: did the collective produce the FedAvg mean?
    numerics_ok: Optional[bool] = None

    def to_dict(self) -> Dict[str, Any]:
        return {k: v for k, v in dataclasses.asdict(self).items() if v is not None}


@dataclass
class ScenarioResult:
    """Aggregate, JSON-serializable outcome of one scenario run."""

    scenario: str
    executor: str
    protocol: str
    payload_mb: float
    rounds: List[RoundReport]
    spec: Dict[str, Any] = field(default_factory=dict)
    # the run's RunReport (repro_torch.obs.RunReport.to_dict()), attached only
    # when a recorder was active, so to_dict() keeps its shape otherwise
    report: Optional[Dict[str, Any]] = None
    # the fluid simulator's raw results (netsim executor only; not serialized)
    sim_results: List[SimResult] = field(default_factory=list, repr=False)

    @property
    def total_transmissions(self) -> int:
        return sum(r.transmissions for r in self.rounds)

    @property
    def total_bytes_mb(self) -> float:
        return sum(r.bytes_mb for r in self.rounds)

    @property
    def total_bytes_on_wire_mb(self) -> float:
        return sum(r.bytes_on_wire_mb for r in self.rounds)

    @property
    def total_slots(self) -> int:
        return sum(r.n_slots for r in self.rounds)

    @property
    def total_drops(self) -> int:
        return sum(r.drops for r in self.rounds)

    @property
    def total_time_s(self) -> Optional[float]:
        times = [r.total_time_s for r in self.rounds if r.total_time_s is not None]
        return sum(times) if times else None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "scenario": self.scenario,
            "executor": self.executor,
            "protocol": self.protocol,
            "payload_mb": self.payload_mb,
            "totals": {
                "rounds": len(self.rounds),
                "transmissions": self.total_transmissions,
                "bytes_mb": round(self.total_bytes_mb, 6),
                "bytes_on_wire_mb": round(self.total_bytes_on_wire_mb, 6),
                "slots": self.total_slots,
                "drops": self.total_drops,
                "time_s": (None if self.total_time_s is None
                           else round(self.total_time_s, 6)),
            },
            "rounds_detail": [r.to_dict() for r in self.rounds],
            "spec": self.spec,
            **({"report": self.report} if self.report is not None else {}),
        }


def applicable_churn(churn: Sequence[ChurnEvent], round_idx: int,
                     members: Sequence[int], n_limit: Optional[int] = None
                     ) -> List[ChurnEvent]:
    """This round's feasible churn events, evaluated in order against the
    evolving membership: a leave must keep at least 2 healthy nodes, a
    rejoin must name an absent node, and ``n_limit`` (a session's node
    count) bounds the node ids."""
    current = set(members)
    applied: List[ChurnEvent] = []
    for ev in churn:
        if ev.round != round_idx or (n_limit is not None and not 0 <= ev.node < n_limit):
            continue
        if ev.action == "leave" and ev.node in current and len(current) > 2:
            current.discard(ev.node)
            applied.append(ev)
        elif ev.action == "rejoin" and ev.node not in current:
            current.add(ev.node)
            applied.append(ev)
    return applied

