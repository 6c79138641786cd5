"""Declarative scenario specification: the port's copy of
``repro.scenario.spec``.

A :class:`ScenarioSpec` declares one experiment: the overlay (a generated
:class:`~repro_torch.core.graph.TopologySpec`), the underlay preset, the
protocol and its segments, the payload (MB, a Table II code or an
architecture name), the wire codec, the rounds and their churn schedule,
link failures, the asynchronous-execution knobs, the executor requirements
and an optional overlay optimizer. It carries every field of the
reference's spec, with the same defaults, validation and ``to_dict``, so a
sweep's cells expand and serialize as the reference's do. What the port
reads of it:

* the trainer and its session read the protocol, codec, rounds, churn,
  ``n_segments`` and the overlay, as the reference's session does;
* the counting executor (:mod:`repro_torch.scenario.executors`) also reads
  the payload and the MST / coloring algorithms;
* the device runner (:mod:`repro_torch.scenario.runner`) reads what the
  session reads and the payload.

Not ported: explicit cost-matrix overlays and ``NetworkSpec`` /
``TestbedSpec`` underlays (an underlay is one of the four preset names or
``None``); the timing that an underlay feeds (``ScenarioResult`` totals
carry ``time_s`` None).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from ..compress.codec import CODEC_NAMES, Codec, make_codec
from ..core.graph import Graph, TopologySpec, make_topology
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

# The reference's underlay presets (``repro.core.network.NETWORK_PRESETS``),
# by name only: the port has no network model.
NETWORK_PRESETS = ("paper_lan", "wan", "edge", "congested")

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
    overlay: TopologySpec = field(default_factory=lambda: TopologySpec(kind="erdos_renyi"))
    protocol: str = "dissemination"
    n_segments: int = 4
    payload: Union[float, str] = 21.2  # MB | paper payload code | arch name
    codec: str = "fp32"
    rounds: int = 1
    churn: Tuple[ChurnEvent, ...] = ()
    underlay: Optional[str] = None  # a NETWORK_PRESETS name; None = from the overlay
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
        return self.overlay.n

    def overlay_graph(self) -> Graph:
        """The declared overlay as a concrete cost graph (deterministic)."""
        return make_topology(self.overlay)

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
        if not isinstance(self.overlay, TopologySpec):
            raise ValueError("the port's scenarios take a TopologySpec overlay; explicit "
                             "cost-matrix overlays are not ported")
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
        if self.underlay is not None and self.underlay not in NETWORK_PRESETS:
            raise ValueError(
                f"unknown network preset {self.underlay!r}; known: "
                f"{sorted(NETWORK_PRESETS)} (NetworkSpec underlays are not ported)")
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
        d = {
            "name": self.name,
            "overlay": {"type": "TopologySpec",
                        **{f: getattr(self.overlay, f)
                           for f in self.overlay.__dataclass_fields__}},
            "underlay": self.underlay,
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
        """Reload a :meth:`to_dict` payload (JSON lists back to tuples)."""
        ov = d["overlay"]
        if not (isinstance(ov, dict) and ov.get("type") == "TopologySpec"):
            raise ValueError("the port's scenarios take a TopologySpec overlay")
        kw = {k: v for k, v in ov.items() if k in TopologySpec.__dataclass_fields__}
        for key in ("intra_cost_ms", "inter_cost_ms"):
            if isinstance(kw.get(key), list):
                kw[key] = tuple(kw[key])
        opt = d.get("optimizer")
        return cls(
            name=d.get("name", "custom"),
            overlay=TopologySpec(**kw),
            protocol=d.get("protocol", "dissemination"),
            n_segments=d.get("n_segments", 4),
            payload=d.get("payload", 21.2),
            codec=d.get("codec", "fp32"),
            rounds=d.get("rounds", 1),
            churn=tuple(ChurnEvent(**ev) for ev in d.get("churn", ())),
            underlay=d.get("underlay"),
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
    """What one communication round counted (the reference's counting
    fields; its timing and numerics fields stay None on the plan
    executor and are not carried)."""

    round: int
    protocol: str
    members: List[int]  # healthy physical node ids during the round
    moderator: int
    n_slots: int
    transmissions: int
    bytes_mb: float  # raw payload bytes moved, MB (payload_fraction applied)
    bytes_on_wire_mb: float = 0.0  # after the wire codec
    drops: int = 0
    churn_applied: List[Dict[str, Any]] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclass
class ScenarioResult:
    """Aggregate, JSON-serializable outcome of one scenario run."""

    scenario: str
    executor: str
    protocol: str
    payload_mb: float
    rounds: List[RoundReport]
    spec: Dict[str, Any] = field(default_factory=dict)

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
                "time_s": None,  # the port has no timing model
            },
            "rounds_detail": [r.to_dict() for r in self.rounds],
            "spec": self.spec,
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

