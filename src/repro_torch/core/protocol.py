"""MOSGU orchestration facade (the port's copy of ``repro.core.protocol``).

Ties the four paper stages together for host-side use:
  M  — manage connectivity   (Moderator, cost reports)
  O  — optimize connectivity (MST)
  S  — schedule              (coloring + slot length + compiled plan)
  GU — gossip & update       (queue engine / compiled plan execution)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

from .graph import Graph, build_mst, color_graph, slot_length_for_colors
from .gossip import GossipEngine, fedavg
from .moderator import ConnectivityReport, Moderator
from .plan import CommPolicy, make_policy
from .schedule import (
    compile_dissemination,
    compile_flooding,
    compile_segmented,
    compile_tree_allreduce,
)


@dataclass
class MOSGUConfig:
    mst_algorithm: str = "prim"
    coloring_algorithm: str = "bfs"
    ping_size_bytes: float = 64.0
    gossip_mode: str = "dissemination"  # dissemination | tree_allreduce | segmented
    root: int = 0
    n_segments: int = 4  # segmented-gossip split factor


class MOSGUProtocol:
    """Full protocol instance over a known topology (host-side simulation)."""

    def __init__(self, overlay: Graph, config: Optional[MOSGUConfig] = None) -> None:
        self.config = config or MOSGUConfig()
        self.overlay = overlay
        # M: a random node is selected to serve as the moderator (paper III-A).
        self.moderator = Moderator(
            0,
            self.config.mst_algorithm,
            self.config.coloring_algorithm,
            self.config.ping_size_bytes,
        )
        for u in range(overlay.n):
            self.moderator.receive_report(
                ConnectivityReport(
                    node_id=u,
                    address=f"10.0.{u // 8}.{u % 8 + 1}",
                    costs_ms={v: float(overlay.adj[u, v]) for v in overlay.neighbors(u)},
                )
            )
        self._recompute()

    # -- O + S ----------------------------------------------------------------
    def _recompute(self) -> None:
        g, _ = self.moderator.build_graph()
        self.graph = g
        self.mst = build_mst(g, self.config.mst_algorithm, self.config.root)
        self.colors = color_graph(self.mst, self.config.coloring_algorithm, self.config.root)
        if self.config.gossip_mode == "tree_allreduce":
            self.plan = compile_tree_allreduce(self.mst, self.colors, self.config.root)
        elif self.config.gossip_mode in ("segmented", "segmented_gossip"):
            self.plan = compile_segmented(self.mst, self.colors,
                                          self.config.n_segments)
        else:
            self.plan = compile_dissemination(self.mst, self.colors)
        self.flooding_plan = compile_flooding(self.graph)

    def slot_length_s(self, model_size_mb: float) -> float:
        return slot_length_for_colors(
            self.graph, self.colors, model_size_mb, self.config.ping_size_bytes
        )

    def build_policy(self, name: Optional[str] = None) -> CommPolicy:
        """The configured (or named) protocol as a communication-plan policy."""
        return make_policy(
            name or self.config.gossip_mode,
            self.graph,
            mst=self.mst,
            colors=self.colors,
            n_segments=self.config.n_segments,
            root=self.config.root,
        )

    # -- GU ---------------------------------------------------------------------
    def run_round(
        self,
        round_idx: int,
        payloads: Optional[Sequence[Any]] = None,
        combine: Callable[[List[Any]], Any] = fedavg,
        drop_fn: Optional[Callable[[int, int, int], bool]] = None,
    ) -> Dict[str, Any]:
        """Execute one gossip round with live queues; return stats + aggregates.

        Runs the configured gossip mode (dissemination or segmented — for
        segmented, ``payloads[u]`` must be a list of ``n_segments`` pieces and
        aggregates come back per segment). ``combine`` defaults to
        :func:`~repro_torch.core.gossip.fedavg` (the mix kernel on CUDA
        payloads). ``tree_allreduce`` is a device
        collective with no store-and-forward queue semantics, so its rounds
        fall back to dissemination here; its compiled-plan statistics live in
        ``self.plan`` / :meth:`round_traffic`.
        """
        policy = (self.build_policy()
                  if self.config.gossip_mode in ("segmented", "segmented_gossip")
                  else None)
        engine = GossipEngine(self.mst, self.colors, drop_fn=drop_fn, policy=policy)
        n_slots = engine.run_round(round_idx, payloads)
        out: Dict[str, Any] = {
            "n_slots": n_slots,
            "transmissions": sum(len(r.sends) for r in engine.reports),
            "drops": sum(len(r.dropped) for r in engine.reports),
        }
        if payloads is not None:
            out["aggregates"] = engine.aggregate(combine)
        return out

    # -- churn + rotation -------------------------------------------------------
    def node_leaves(self, node_id: int) -> None:
        self.moderator.remove_node(node_id)
        self._recompute()

    def node_joins(self, node_id: int, costs_ms: Dict[int, float], address: str = "") -> None:
        self.moderator.receive_report(
            ConnectivityReport(node_id, address or f"10.9.0.{node_id}", costs_ms)
        )
        for nid, c in costs_ms.items():
            if nid in self.moderator.reports:
                self.moderator.reports[nid].costs_ms[node_id] = c
        self._recompute()

    def rotate_moderator(self, votes: Dict[int, int]) -> int:
        nxt = self.moderator.elect_next(votes)
        self.moderator = self.moderator.handover(nxt)
        return nxt

    # -- accounting ---------------------------------------------------------------
    def round_traffic(self, model_bytes: float) -> Dict[str, float]:
        """Bytes on the wire per communication round, gossip vs flooding."""
        return {
            "gossip_bytes": self.plan.bytes_on_wire(model_bytes),
            "flooding_bytes": self.flooding_plan.bytes_on_wire(model_bytes),
            "gossip_slots": float(self.plan.n_slots),
            "flooding_rounds": float(self.flooding_plan.n_slots),
            "gossip_transmissions": float(self.plan.total_transmissions()),
            "flooding_transmissions": float(self.flooding_plan.total_transmissions()),
        }
