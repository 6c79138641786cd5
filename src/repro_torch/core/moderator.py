"""Moderator logic (paper III-A): connectivity management and rotation.

The port's copy of ``repro.core.moderator`` (numpy; ``tests/test_torch_session.py``
holds it to the original).

A rotating participant collects per-node cost reports, symmetrizes them into
the adjacency matrix, runs MST + coloring + slot-length computation, and
distributes the result. Recomputation happens only on churn; otherwise the
moderator merely custodies the connection table until handover. Moderator
succession is decided by a vote aggregated by the current moderator.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .graph import Graph, build_mst, color_graph, slot_length_for_colors


@dataclass
class ConnectivityReport:
    """What each node sends the moderator: its id, address and measured costs."""

    node_id: int
    address: str
    costs_ms: Dict[int, float]  # neighbour -> measured ping (ms)


@dataclass
class SchedulePacket:
    """What the moderator broadcasts back to every node.

    ``protocol``/``n_segments`` name the communication-plan policy
    (:mod:`repro.core.plan`) every node must instantiate for the round, so a
    protocol switch (e.g. dissemination → segmented gossip) is just a new
    packet — no node-side code changes.
    """

    version: int
    colors: np.ndarray
    neighbor_table: Dict[int, List[int]]  # MST adjacency per node
    slot_length_s: float
    moderator: int
    protocol: str = "dissemination"
    n_segments: int = 1


class Moderator:
    """Holds the full connection table; recomputes the schedule on churn."""

    def __init__(
        self,
        moderator_id: int,
        mst_algorithm: str = "prim",
        coloring_algorithm: str = "bfs",
        ping_size_bytes: float = 64.0,
        protocol: str = "dissemination",
        n_segments: int = 1,
    ) -> None:
        self.moderator_id = moderator_id
        self.mst_algorithm = mst_algorithm
        self.coloring_algorithm = coloring_algorithm
        self.ping_size_bytes = ping_size_bytes
        self.protocol = protocol
        self.n_segments = n_segments
        self.reports: Dict[int, ConnectivityReport] = {}
        self.addresses: Dict[int, str] = {}
        self.version = 0
        self._cached: Optional[SchedulePacket] = None
        self._dirty = True

    # -- membership / churn --------------------------------------------------
    def receive_report(self, report: ConnectivityReport) -> None:
        self.reports[report.node_id] = report
        self.addresses[report.node_id] = report.address
        self._dirty = True

    def remove_node(self, node_id: int) -> None:
        """A node left; drop it and all references to it."""
        self.reports.pop(node_id, None)
        self.addresses.pop(node_id, None)
        for rep in self.reports.values():
            rep.costs_ms.pop(node_id, None)
        self._dirty = True

    @property
    def members(self) -> List[int]:
        return sorted(self.reports)

    # -- graph computations (paper III-A "essential graph-related computations")
    def build_graph(self) -> Tuple[Graph, Dict[int, int]]:
        """Adjacency matrix over a dense reindexing of current members."""
        members = self.members
        index = {nid: i for i, nid in enumerate(members)}
        reports = {
            index[nid]: {index[v]: c for v, c in rep.costs_ms.items() if v in index}
            for nid, rep in self.reports.items()
        }
        return Graph.from_cost_reports(len(members), reports), index

    def compute_schedule(self, model_size_mb: float) -> SchedulePacket:
        """Recompute MST + coloring + slot length iff the network changed."""
        if not self._dirty and self._cached is not None:
            return self._cached
        g, index = self.build_graph()
        if not g.is_connected():
            raise ValueError("reported topology is disconnected")
        mst = build_mst(g, self.mst_algorithm)
        colors = color_graph(mst, self.coloring_algorithm)
        slot = slot_length_for_colors(g, colors, model_size_mb, self.ping_size_bytes)
        inv = {i: nid for nid, i in index.items()}
        table = {inv[u]: [inv[v] for v in mst.neighbors(u)] for u in range(mst.n)}
        self.version += 1
        packet = SchedulePacket(
            version=self.version,
            colors=colors,
            neighbor_table=table,
            slot_length_s=slot,
            moderator=self.moderator_id,
            protocol=self.protocol,
            n_segments=self.n_segments,
        )
        self._cached = packet
        self._dirty = False
        return packet

    # -- rotation (paper III-A: vote aggregated by current moderator) --------
    def elect_next(self, votes: Dict[int, int]) -> int:
        """Tally votes (voter -> candidate); majority wins, ties break low-id."""
        tally: Dict[int, int] = {}
        for voter, candidate in votes.items():
            if candidate in self.reports and voter in self.reports:
                tally[candidate] = tally.get(candidate, 0) + 1
        if not tally:
            # round-robin fallback
            members = self.members
            i = members.index(self.moderator_id) if self.moderator_id in members else -1
            return members[(i + 1) % len(members)]
        best = max(tally.values())
        return min(c for c, t in tally.items() if t == best)

    def handover(self, new_moderator: int) -> "Moderator":
        """Forward the full connection table to the next moderator."""
        nxt = Moderator(
            new_moderator, self.mst_algorithm, self.coloring_algorithm,
            self.ping_size_bytes, self.protocol, self.n_segments,
        )
        nxt.reports = {k: ConnectivityReport(v.node_id, v.address, dict(v.costs_ms))
                       for k, v in self.reports.items()}
        nxt.addresses = dict(self.addresses)
        nxt.version = self.version
        nxt._cached = self._cached
        nxt._dirty = self._dirty
        return nxt
