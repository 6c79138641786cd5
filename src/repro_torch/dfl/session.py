"""Churn masking: the gossip plan over a subset of the physical nodes.

The port of ``repro.dfl.session._plan_for_members``. A leaving node's
replica does not vanish from the node axis; it is masked out of the gossip
graph: the MST spans only the healthy members, the FedAvg divides by their
count, and masked nodes keep their own params.
"""
from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

from ..core.graph import Graph, build_mst, color_graph
from ..core.plan import SegmentedGossipPolicy, compile_policy
from ..core.schedule import compile_dissemination, compile_tree_allreduce, plan_to_perm_steps
from .collectives import GossipPlan, make_node_graph, mixing_matchings, reduce_step_count


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
