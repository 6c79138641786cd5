"""The fields of a scenario that the gossip round reads, and the scenarios
this slice runs.

A trimmed counterpart of ``repro.scenario.spec.ScenarioSpec`` and its
registry: overlay, protocol, segments, payload, codec, rounds and churn.
The payload is carried as its size in MB (the registry resolves paper
payload codes and architecture names to it); the scenario values below are
copies of the registry entries of the same names.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

from ..compress.codec import Codec, make_codec
from ..core.graph import Graph, TopologySpec, make_topology

CHURN_ACTIONS = ("leave", "rejoin")

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
    try:
        return GOSSIP_MODES[protocol]
    except KeyError:
        raise ValueError(f"scenario protocol {protocol!r} has no gossip mode; "
                         f"known: {sorted(GOSSIP_MODES)}") from None


@dataclass(frozen=True)
class ChurnEvent:
    """A membership change pinned to a round (applied before the round runs)."""

    round: int
    action: str  # "leave" | "rejoin"
    node: int


@dataclass(frozen=True)
class ScenarioSpec:
    name: str
    overlay: TopologySpec
    protocol: str = "dissemination"
    n_segments: int = 4
    payload_mb: float = 21.2
    codec: str = "fp32"
    rounds: int = 1
    churn: Tuple[ChurnEvent, ...] = ()

    @property
    def n(self) -> int:
        return self.overlay.n

    def overlay_graph(self) -> Graph:
        return make_topology(self.overlay)

    def codec_obj(self) -> Optional[Codec]:
        """The wire codec; ``None`` for the raw-fp32 baseline."""
        c = make_codec(self.codec)
        return None if c.name == "fp32" else c

    def replace(self, **changes) -> "ScenarioSpec":
        return replace(self, **changes)

    def validate(self) -> "ScenarioSpec":
        resolve_gossip_mode(self.protocol)
        make_codec(self.codec)
        if self.rounds < 1 or self.n_segments < 1 or self.payload_mb <= 0:
            raise ValueError(f"scenario {self.name!r}: rounds, n_segments and "
                             "payload_mb must be positive")
        for ev in self.churn:
            if ev.action not in CHURN_ACTIONS:
                raise ValueError(f"unknown churn action {ev.action!r}")
            if not (0 <= ev.round < self.rounds and 0 <= ev.node < self.n):
                raise ValueError(f"churn event {ev} outside the scenario")
        return self


def applicable_churn(churn: Sequence[ChurnEvent], round_idx: int,
                     members: Sequence[int]) -> List[ChurnEvent]:
    """This round's feasible churn events, evaluated in order against the
    evolving membership: a leave must keep at least 2 healthy nodes, a
    rejoin must name an absent node."""
    current = set(members)
    applied: List[ChurnEvent] = []
    for ev in churn:
        if ev.round != round_idx:
            continue
        if ev.action == "leave" and ev.node in current and len(current) > 2:
            current.discard(ev.node)
            applied.append(ev)
        elif ev.action == "rejoin" and ev.node not in current:
            current.add(ev.node)
            applied.append(ev)
    return applied


def membership_by_round(spec: ScenarioSpec) -> List[Tuple[int, ...]]:
    """The sorted healthy members of every round, churn applied first."""
    members = set(range(spec.n))
    out: List[Tuple[int, ...]] = []
    for r in range(spec.rounds):
        for ev in applicable_churn(spec.churn, r, sorted(members)):
            (members.discard if ev.action == "leave" else members.add)(ev.node)
        if len(members) < 2:
            raise ValueError(f"scenario {spec.name!r} dropped below 2 nodes")
        out.append(tuple(sorted(members)))
    return out


SCENARIOS: Dict[str, ScenarioSpec] = {s.name: s.validate() for s in (
    # the paper's Tables III-V cell: MOSGU dissemination of EfficientNet-B0
    ScenarioSpec(name="paper_table3",
                 overlay=TopologySpec(kind="erdos_renyi", n=10, seed=3),
                 protocol="mosgu", payload_mb=21.2),
    # the same cell under the int8 wire
    ScenarioSpec(name="quantized_table3",
                 overlay=TopologySpec(kind="erdos_renyi", n=10, seed=3),
                 protocol="mosgu", payload_mb=21.2, codec="int8"),
    # top-k sparsified dissemination of MobileNetV2, three rounds
    ScenarioSpec(name="topk_sweep",
                 overlay=TopologySpec(kind="watts_strogatz", n=10, seed=4),
                 protocol="dissemination", payload_mb=14.0, codec="topk", rounds=3),
    # churn-masked tree all-reduce of smollm-360m (bf16 bytes on the wire)
    ScenarioSpec(name="mesh_smoke",
                 overlay=TopologySpec(kind="complete", n=4, seed=0),
                 protocol="tree_allreduce", payload_mb=723.64032, rounds=2,
                 churn=(ChurnEvent(1, "leave", 3),)),
    # leave/rejoin churn, including the moderator at round 2
    ScenarioSpec(name="churn_storm",
                 overlay=TopologySpec(kind="watts_strogatz", n=12, seed=2),
                 protocol="dissemination", payload_mb=14.0, rounds=6,
                 churn=(ChurnEvent(1, "leave", 3), ChurnEvent(2, "leave", 2),
                        ChurnEvent(3, "leave", 7), ChurnEvent(4, "rejoin", 3),
                        ChurnEvent(5, "rejoin", 2))),
)}


def get(name: str) -> ScenarioSpec:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise ValueError(f"unknown scenario {name!r}; known: {sorted(SCENARIOS)}") from None
