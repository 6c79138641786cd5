"""DFL session of the port (``repro.dfl.session``): the paper's M-step around
a :class:`~repro_torch.dfl.trainer.DFLTrainer`.

* Each communication round the moderator role rotates (paper III-A: votes
  tallied by the current moderator).
* Node churn (leave / rejoin, by hand or scheduled by a scenario's churn
  events) marks the connection table dirty; the next round the moderator
  recomputes MST, coloring and slot plan (:func:`plan_for_members`), and the
  trainer gossips over the new plan. The JAX session recompiles its step
  there; eager PyTorch has nothing to recompile.
* On a mesh (``MeshDFLTrainer``) the plans run over the mesh's nodes, inter-pod
  links priced over its "pod" axis, as the JAX session's
  ``_plan_for_members(mesh, node_axes, ...)``; the new plan keeps the
  rank's place among them.
* A leaving node's replica does not vanish from the node axis; it is masked
  out of the gossip graph: the MST spans only the healthy members, the
  FedAvg divides by their count, and masked nodes keep training locally,
  keeping their own parameters through every gossip round until they
  rejoin.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Callable, Dict, Iterable, List, Optional, Set

import numpy as np

from ..core.graph import Graph, build_mst, color_graph
from ..core.moderator import ConnectivityReport, Moderator
from ..core.plan import SegmentedGossipPolicy, compile_policy
from ..core.schedule import compile_dissemination, compile_tree_allreduce, plan_to_perm_steps
from .collectives import GossipPlan, make_node_graph, mixing_matchings, reduce_step_count
from .trainer import DFLTrainer

if TYPE_CHECKING:  # the scenario package imports this module
    from ..scenario.spec import ChurnEvent, ScenarioSpec


def plan_for_members(n_nodes: int, members: Iterable[int], n_segments: int = 4,
                     full_graph: Optional[Graph] = None, n_pods: int = 1) -> GossipPlan:
    """GossipPlan over the ``members`` of ``n_nodes`` physical nodes.

    The MST and coloring run on the healthy subgraph of ``full_graph`` (the
    scenario's overlay; by default :func:`make_node_graph`); slot endpoints
    are relabelled to physical ids while payload ids stay subgraph rows,
    which ``node_slot`` maps (-1 = masked out of the round).
    """
    full = full_graph if full_graph is not None else make_node_graph(n_nodes, n_pods)
    if full.n != n_nodes:
        raise ValueError(f"full_graph has {full.n} nodes, expected {n_nodes}")
    members_sorted = sorted(members)
    sub = Graph(full.adj[np.ix_(members_sorted, members_sorted)])
    mst_sub = build_mst(sub, "prim")
    colors_sub = color_graph(mst_sub, "bfs")
    n_phys = full.n
    adj = np.zeros((n_phys, n_phys))
    for u, v, c in mst_sub.edges():
        pu, pv = members_sorted[u], members_sorted[v]
        adj[pu, pv] = adj[pv, pu] = c
    mst_phys = Graph(adj)
    colors_phys = -np.ones(n_phys, dtype=np.int64)
    node_slot = -np.ones(n_phys, dtype=np.int32)
    for i, nid in enumerate(members_sorted):
        colors_phys[nid] = colors_sub[i]
        node_slot[nid] = i

    def relabel(plan):
        for slot in plan.slots:
            slot.sends = [(members_sorted[s], members_sorted[d], p)
                          for (s, d, p) in slot.sends]
        plan.n = n_phys
        plan.colors = colors_phys
        return plan

    diss = relabel(compile_dissemination(mst_sub, colors_sub))
    tree = relabel(compile_tree_allreduce(mst_sub, colors_sub))
    seg = None
    if mst_sub.n > 1:
        seg = relabel(compile_policy(
            SegmentedGossipPolicy(mst_sub, colors_sub, segments=n_segments)))
    return GossipPlan(
        n_nodes=len(members_sorted),
        mst=mst_phys,
        colors=colors_phys,
        dissemination=diss,
        tree=tree,
        diss_steps=plan_to_perm_steps(diss),
        tree_steps=plan_to_perm_steps(tree),
        n_tree_reduce_steps=reduce_step_count(tree),
        mixing_matchings=mixing_matchings(mst_phys),
        segmented=seg,
        seg_steps=plan_to_perm_steps(seg) if seg is not None else [],
        n_segments=n_segments,
        node_slot=node_slot,
        phys_n_nodes=n_phys,
    )


@dataclass
class DFLSession:
    """Training session with moderator rotation and churn handling.

    ``scenario`` makes churn declarative: the spec's leave / rejoin events
    fire at their rounds inside :meth:`train_round`."""

    trainer: DFLTrainer
    moderator: Moderator = None  # type: ignore[assignment]
    round_idx: int = 0
    members: Set[int] = field(default_factory=set)
    scenario: Optional["ScenarioSpec"] = None
    _dirty: bool = True

    def __post_init__(self) -> None:
        self.members = set(range(self.trainer.n_nodes))
        self.moderator = Moderator(0)
        self._report_all()

    # -- M: manage connectivity ------------------------------------------------
    def _report_all(self) -> None:
        g = make_node_graph(self.trainer.n_nodes, self._n_pods())
        for u in sorted(self.members):
            costs = {v: float(g.adj[u, v]) for v in sorted(self.members) if v != u}
            self.moderator.receive_report(ConnectivityReport(u, f"node{u}", costs))
        self._dirty = True

    def node_leaves(self, node_id: int) -> None:
        if node_id not in self.members or len(self.members) <= 2:
            raise ValueError("cannot drop below 2 healthy nodes")
        self.members.discard(node_id)
        self.moderator.remove_node(node_id)
        self._dirty = True

    def node_rejoins(self, node_id: int) -> None:
        self.members.add(node_id)
        self._report_all()

    def apply_scheduled_churn(self) -> List["ChurnEvent"]:
        """Fire the scenario's churn events pinned to the current round;
        events that cannot fire (a node id past the session's nodes, a leave
        below 2 healthy nodes, a redundant leave or rejoin) are skipped with
        a warning."""
        if self.scenario is None:
            return []
        from ..scenario.spec import applicable_churn

        n = self.trainer.n_nodes
        applied = applicable_churn(self.scenario.churn, self.round_idx, sorted(self.members),
                                   n_limit=n)
        for ev in self.scenario.churn:
            if ev.round == self.round_idx and ev not in applied:
                warnings.warn(f"scenario {self.scenario.name!r}: churn event {ev} skipped "
                              f"({n} nodes, healthy={sorted(self.members)})", stacklevel=2)
        for ev in applied:
            if ev.action == "leave":
                self.node_leaves(ev.node)
            else:
                self.node_rejoins(ev.node)
        return applied

    def rotate_moderator(self, votes: Optional[Dict[int, int]] = None) -> int:
        votes = votes or {u: (self.round_idx + 1) % max(len(self.members), 1)
                          for u in self.members}
        nxt = self.moderator.elect_next(votes)
        self.moderator = self.moderator.handover(nxt)
        return nxt

    def _n_pods(self) -> int:
        nodes = self.trainer.plan.nodes
        return nodes.n_pods if nodes is not None else 1

    # -- O/S: replan on churn ------------------------------------------------------
    def _ensure_plan(self) -> None:
        if not self._dirty:
            return
        n = self.trainer.n_nodes
        n_segments, full_graph = 4, None
        if self.scenario is not None:
            n_segments = self.scenario.n_segments
            if self.scenario.n == n:
                # the declared overlay maps 1:1 onto the nodes: gossip the
                # scenario's schedule, not the default cost model
                full_graph = self.scenario.overlay_graph()
        nodes = self.trainer.plan.nodes  # between ranks: this rank's node on the mesh
        self.trainer.plan = plan_for_members(n, self.members, n_segments=n_segments,
                                             full_graph=full_graph, n_pods=self._n_pods())
        self.trainer.plan.nodes = nodes
        self._dirty = False

    # -- GU: one communication round --------------------------------------------
    def train_round(self, state, batch, local_steps: int = 1):
        """This round's scheduled churn, a replan if membership changed,
        ``local_steps`` steps (each with gossip when the interval is 1),
        then the moderator rotates.

        With a recorder installed (``obs``) the round records the JAX
        session's spans, with the same names, categories, track and args:
        ``plan:recompile`` (round, members) around a replan and
        ``train:step`` (round, gossip) around each step. They are host-clock
        spans. The step reads the nodes' losses to the host after their
        backward (a device synchronization inside the step) but does not
        synchronize before its span closes, and none is added: on the card
        the optimizer's and the gossip round's kernels may still run when a
        ``train:step`` span ends, and the next step's first host read waits
        for them inside its own span."""
        from .. import obs

        rec = obs.get()
        self.apply_scheduled_churn()
        if self._dirty:
            with rec.span("plan:recompile", cat="plan", track="train",
                          round=self.round_idx, members=len(self.members)):
                self._ensure_plan()
        metrics = None
        for _ in range(local_steps):
            # the gossip exchange runs inside the step (when the interval is
            # 1), so the step span covers both; the args mark it
            with rec.span("train:step", cat="train", track="train",
                          round=self.round_idx, gossip=True):
                state, metrics = self.trainer.train_step(state, batch)
        self.round_idx += 1
        self.rotate_moderator()
        return state, metrics


def run_scenario_rounds(session: DFLSession, state, batch,
                        make_batch: Optional[Callable[[], Any]] = None,
                        log: Callable[[str], None] = print,
                        on_round: Optional[Callable[[int, Any], None]] = None):
    """Drive a session for its scenario's round count (churn fires inside
    :meth:`DFLSession.train_round`); ``on_round(i, metrics)`` runs right
    after round i."""
    rounds = session.scenario.rounds if session.scenario is not None else 1
    metrics = None
    for i in range(rounds):
        state, metrics = session.train_round(state, batch)
        if on_round is not None:
            on_round(i, metrics)
        if make_batch is not None:
            batch = make_batch()
        log(f"round {i + 1:3d} loss={float(metrics['loss']):.4f} "
            f"members={sorted(session.members)} "
            f"moderator={session.moderator.moderator_id}")
    return state, metrics
