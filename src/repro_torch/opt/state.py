"""Incremental overlay search state: exact MST + coloring under edit batches
(the port's copy of ``repro.opt.state``).

The optimizer explores *edge subsets* of a fixed universe overlay (the
scenario's declared topology). Scoring a candidate edit must never rebuild
the plan from scratch — the whole point of the subsystem is that the
analytic oracle runs at counting speed, so plan maintenance has to keep up.
:class:`SearchState` maintains the working edge set and its member MST +
Jones–Plassmann coloring with the same exactness argument the churn
replanner (:mod:`repro_torch.core.replan`) uses:

* Edges live in the universe's ``(w, u, v)``-sorted order, so a *universe
  edge index* is a position in the total order and index-sorted arrays are
  weight-sorted arrays. The MST is unique under that order (Borůvka equals
  Kruskal), which makes "patched" and "rebuilt" the same edge set, not
  merely the same weight.
* **Removal batch.** Every surviving tree edge stays in the new MST (it was
  the minimum edge across some cut, and shrinking the edge set cannot
  introduce a cheaper crossing). Only working edges *crossing* the
  surviving components are candidates; seeding
  :func:`~repro_torch.core.sparse.mst_edge_selection` with the survivors'
  component labels completes the forest exactly.
* **Addition batch.** The new MST is a subset of ``T ∪ A`` (cycle
  property: an excluded working edge was heaviest on its tree cycle and
  stays heaviest), and every tree edge ordered before the cheapest added
  edge is safe — Kruskal accepts it against a subset of the constraints it
  already survived. Borůvka runs only on the suffix, seeded with the safe
  prefix's components (the replanner's join rule).
* **Coloring.** Jones–Plassmann priorities depend only on ``(n, seed)`` —
  :class:`~repro_torch.core.replan.SparsePlanner` draws its rank permutation
  before looking at any edge — so recoloring the candidate tree with the
  compacted member ranks reproduces exactly what a from-scratch
  ``SparsePlanner(working_csr, seed).plan(members)`` would emit.
  ``plan_equal`` between the incrementally-maintained state and a scratch
  rebuild is a pinned property of the reference, and the port's states
  equal the reference's.

Candidate evaluation is pure (:meth:`SearchState.try_edit` returns a
:class:`Candidate` without mutating the state), so a search strategy can
score many moves and commit one.
"""
from __future__ import annotations

import hashlib
from typing import Optional, Sequence, Tuple

import numpy as np

from ..core.graph import Graph
from ..core.replan import MemberPlan, SparsePlanner, _compact_rank
from ..core.sparse import (
    CSRGraph,
    color_priority_greedy,
    mst_edge_selection,
    union_edges,
)

__all__ = ["Candidate", "SearchState"]


class Candidate:
    """One scored-but-uncommitted edit: the resulting plan plus lazy views.

    ``plan`` is the exact :class:`~repro_torch.core.replan.MemberPlan` of the
    edited working set; :meth:`member_subgraph` materializes the edited
    member-induced working CSR (what flooding-family objectives score).
    """

    __slots__ = ("plan", "tree_idx", "remove", "add", "_state")

    def __init__(self, state: "SearchState", plan: MemberPlan,
                 tree_idx: np.ndarray, remove: np.ndarray,
                 add: np.ndarray) -> None:
        self._state = state
        self.plan = plan
        self.tree_idx = tree_idx
        self.remove = remove
        self.add = add

    def member_subgraph(self) -> CSRGraph:
        """The edited working overlay restricted to members (member index
        space, ascending member order — the moderator subgraph rule)."""
        st = self._state
        live = st.live_member_edges()
        if len(self.remove):
            live = live[~np.isin(live, self.remove)]
        if len(self.add):
            live = np.sort(np.r_[live, self.add])
        mem = st.members
        u = np.searchsorted(mem, st.eu[live])
        v = np.searchsorted(mem, st.ev[live])
        return CSRGraph.from_edge_arrays(len(mem), u, v, st.ew[live])


class SearchState:
    """The optimizer's working overlay: a live edge subset of a universe
    :class:`~repro_torch.core.sparse.CSRGraph`, with its member MST + coloring
    maintained exactly under edit batches (never rebuilt from scratch)."""

    def __init__(self, universe: CSRGraph, members: Optional[Sequence[int]]
                 = None, seed: int = 0, max_degree: int = 0,
                 active: Optional[np.ndarray] = None) -> None:
        self.universe = universe
        self.n = universe.n
        self.seed = int(seed)
        self.max_degree = int(max_degree)
        self.eu, self.ev, self.ew = universe.sorted_edges()
        self.n_edges = len(self.eu)
        if members is None:
            members = np.arange(self.n, dtype=np.int64)
        self.members = np.asarray(sorted(members), dtype=np.int64)
        if active is None:
            active = np.ones(self.n_edges, dtype=bool)
        self.active = np.asarray(active, dtype=bool).copy()
        # JP priorities: the SparsePlanner convention — a permutation of
        # (n, seed) alone, so a scratch planner over any working edge set
        # reproduces our colors (the plan_equal contract)
        self.rank = np.random.default_rng(self.seed).permutation(
            self.n).astype(np.int64)
        self.degree = np.zeros(self.n, dtype=np.int64)
        np.add.at(self.degree, self.eu[self.active], 1)
        np.add.at(self.degree, self.ev[self.active], 1)
        # (lo*n + hi) -> universe edge index lookup, built lazily for the
        # churn replan round-trip
        self._key_order: Optional[np.ndarray] = None
        self._sorted_keys: Optional[np.ndarray] = None
        self._incident_indptr: Optional[np.ndarray] = None
        self._incident_idx: Optional[np.ndarray] = None
        self._live_member: Optional[np.ndarray] = None
        self._plan: Optional[MemberPlan] = None
        self.tree_idx = self._initial_tree()

    # -- initial build -------------------------------------------------------
    def _initial_tree(self) -> np.ndarray:
        cand = self.live_member_edges()
        sel = mst_edge_selection(self.n, self.eu[cand], self.ev[cand])
        if len(sel) != len(self.members) - 1:
            raise ValueError(
                "working member subgraph is disconnected; MST undefined")
        return cand[sel]

    # -- views ---------------------------------------------------------------
    def live_member_edges(self) -> np.ndarray:
        """Active universe edge indices with both endpoints in the member
        set, ascending (= the (w, u, v) total order), cached per commit."""
        if self._live_member is None:
            mask = np.zeros(self.n, dtype=bool)
            mask[self.members] = True
            self._live_member = np.flatnonzero(
                self.active & mask[self.eu] & mask[self.ev])
        return self._live_member

    def plan(self) -> MemberPlan:
        """The current working set's exact member plan (tree + colors)."""
        if self._plan is None:
            self._plan = self._finish(self.tree_idx)
        return self._plan

    def _finish(self, tree_idx: np.ndarray) -> MemberPlan:
        mem = self.members
        tu, tv, tw = self.eu[tree_idx], self.ev[tree_idx], self.ew[tree_idx]
        mu = np.searchsorted(mem, tu)
        mv = np.searchsorted(mem, tv)
        tcsr = CSRGraph.from_edge_arrays(len(mem), mu, mv, tw)
        lrank = _compact_rank(self.rank[mem])
        colors = color_priority_greedy(tcsr.indptr, tcsr.indices, lrank)
        return MemberPlan(mem, tu, tv, tw, colors, tcsr)

    def working_csr(self) -> CSRGraph:
        """The full working overlay (all nodes) as a CSR graph."""
        live = np.flatnonzero(self.active)
        return CSRGraph.from_edge_arrays(
            self.n, self.eu[live], self.ev[live], self.ew[live])

    def member_subgraph(self) -> CSRGraph:
        """The working overlay restricted to members, member index space."""
        live = self.live_member_edges()
        mem = self.members
        u = np.searchsorted(mem, self.eu[live])
        v = np.searchsorted(mem, self.ev[live])
        return CSRGraph.from_edge_arrays(len(mem), u, v, self.ew[live])

    def working_matrix(self) -> np.ndarray:
        """The working overlay as a dense symmetric cost matrix — the
        serializable artifact an optimized :class:`ScenarioSpec` carries."""
        adj = np.zeros((self.n, self.n))
        live = np.flatnonzero(self.active)
        adj[self.eu[live], self.ev[live]] = self.ew[live]
        adj[self.ev[live], self.eu[live]] = self.ew[live]
        return adj

    def working_graph(self) -> Graph:
        return Graph(self.working_matrix())

    def fingerprint(self) -> str:
        """Deterministic identity of (members, working edge set): the
        optimizer-determinism contract is 'same spec -> same fingerprint'."""
        h = hashlib.sha256()
        h.update(np.ascontiguousarray(self.members).tobytes())
        h.update(np.flatnonzero(self.active).tobytes())
        h.update(np.ascontiguousarray(self.ew[self.active]).tobytes())
        return h.hexdigest()

    def incident_edges(self, v: int) -> np.ndarray:
        """All universe edge indices touching node ``v`` (active or not)."""
        if self._incident_indptr is None:
            both = np.r_[self.eu, self.ev]
            idx = np.r_[np.arange(self.n_edges, dtype=np.int64),
                        np.arange(self.n_edges, dtype=np.int64)]
            order = np.argsort(both, kind="stable")
            counts = np.bincount(both, minlength=self.n)
            self._incident_indptr = np.zeros(self.n + 1, dtype=np.int64)
            np.cumsum(counts, out=self._incident_indptr[1:])
            self._incident_idx = idx[order]
        lo = int(self._incident_indptr[v])
        hi = int(self._incident_indptr[v + 1])
        return self._incident_idx[lo:hi]

    # -- edit scoring --------------------------------------------------------
    def try_edit(self, remove: Sequence[int],
                 add: Sequence[int]) -> Optional[Candidate]:
        """Score an edit batch: remove then add the given universe edges.

        Returns the exact resulting :class:`Candidate` (tree + colors),
        or ``None`` when the edit disconnects the members or violates the
        degree cap. The state itself is untouched — :meth:`commit` applies
        an accepted candidate.
        """
        remove = np.asarray(remove, dtype=np.int64)
        add = np.asarray(add, dtype=np.int64)
        if len(remove) and not self.active[remove].all():
            raise ValueError("removing an edge that is not active")
        if len(add) and self.active[add].any():
            raise ValueError("adding an edge that is already active")
        if self.max_degree > 0 and len(add):
            deg = self.degree.copy()
            if len(remove):
                np.add.at(deg, self.eu[remove], -1)
                np.add.at(deg, self.ev[remove], -1)
            np.add.at(deg, self.eu[add], 1)
            np.add.at(deg, self.ev[add], 1)
            touched = np.r_[self.eu[add], self.ev[add]]
            if (deg[touched] > self.max_degree).any():
                return None
        mmask = np.zeros(self.n, dtype=bool)
        mmask[self.members] = True
        add = add[mmask[self.eu[add]] & mmask[self.ev[add]]] if len(add) \
            else add

        # removal batch: survivors stay; reconnect across their components
        # from the crossing working edges only (never a full rebuild)
        rem_in_tree = np.intersect1d(self.tree_idx, remove)
        if len(rem_in_tree):
            surv = self.tree_idx[~np.isin(self.tree_idx, rem_in_tree)]
            parent = union_edges(self.n, self.eu[surv], self.ev[surv])
            pool = self.live_member_edges()
            if len(remove):
                pool = pool[~np.isin(pool, remove)]
            cross = pool[parent[self.eu[pool]] != parent[self.ev[pool]]]
            sel = mst_edge_selection(self.n, self.eu[cross], self.ev[cross],
                                     parent=parent)
            tree1 = np.sort(np.r_[surv, cross[sel]])
        else:
            tree1 = self.tree_idx

        # addition batch: MST(W ∪ A) ⊆ T ∪ A; prefix below the cheapest
        # added edge is safe, Borůvka runs on the suffix only
        if len(add):
            add = np.sort(add)
            combined = np.sort(np.r_[tree1, add])
            p = int(np.searchsorted(combined, add[0]))
            parent = union_edges(self.n, self.eu[combined[:p]],
                                 self.ev[combined[:p]])
            sel = p + mst_edge_selection(
                self.n, self.eu[combined[p:]], self.ev[combined[p:]],
                parent=parent)
            tree2 = np.r_[combined[:p], combined[sel]]
        else:
            tree2 = tree1

        if len(tree2) != len(self.members) - 1:
            return None  # the edit disconnects the members
        return Candidate(self, self._finish(tree2), tree2, remove, add)

    def commit(self, cand: Candidate) -> None:
        """Apply an accepted candidate to the state."""
        if len(cand.remove):
            self.active[cand.remove] = False
            np.add.at(self.degree, self.eu[cand.remove], -1)
            np.add.at(self.degree, self.ev[cand.remove], -1)
        if len(cand.add):
            self.active[cand.add] = True
            np.add.at(self.degree, self.eu[cand.add], 1)
            np.add.at(self.degree, self.ev[cand.add], 1)
        self.tree_idx = cand.tree_idx
        self._plan = cand.plan
        self._live_member = None

    # -- snapshots ------------------------------------------------------------
    def snapshot(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """A cheap copy of (active mask, degrees, tree) — what annealing
        needs to rewind to its best-seen working set."""
        return (self.active.copy(), self.degree.copy(),
                self.tree_idx.copy())

    def restore(self, snap: Tuple[np.ndarray, np.ndarray, np.ndarray]
                ) -> None:
        """Rewind to a :meth:`snapshot` (members must be unchanged)."""
        active, degree, tree_idx = snap
        self.active = active.copy()
        self.degree = degree.copy()
        self.tree_idx = tree_idx.copy()
        self._live_member = None
        self._plan = None

    # -- churn ---------------------------------------------------------------
    def set_members(self, members: Sequence[int]) -> None:
        """Churn warm start: move to a new member set by *replanning* the
        carried working overlay (:meth:`SparsePlanner.replan` — the same
        incremental leave/join repair the scenario cache uses), keeping the
        working edge set intact for the neighbourhood re-optimization."""
        prev = self.plan()
        planner = SparsePlanner(self.working_csr(), seed=self.seed)
        new_plan = planner.replan(prev, members)
        self.members = new_plan.members
        self.tree_idx = self._edge_indices(new_plan.tree_u, new_plan.tree_v)
        # replan's plan carries its patched adjacency; re-wrap so the next
        # replan (if any) starts from a clean lazy adjacency in *our* space
        self._plan = MemberPlan(new_plan.members, new_plan.tree_u,
                                new_plan.tree_v, new_plan.tree_w,
                                new_plan.colors)
        self._live_member = None

    def _edge_indices(self, u: np.ndarray, v: np.ndarray) -> np.ndarray:
        """Universe edge indices of the given (u, v) pairs, ascending."""
        if self._key_order is None:
            keys = (np.minimum(self.eu, self.ev) * np.int64(self.n)
                    + np.maximum(self.eu, self.ev))
            self._key_order = np.argsort(keys, kind="stable")
            self._sorted_keys = keys[self._key_order]
        q = (np.minimum(u, v) * np.int64(self.n) + np.maximum(u, v))
        pos = np.searchsorted(self._sorted_keys, q)
        if (pos >= len(self._sorted_keys)).any() or \
                (self._sorted_keys[pos] != q).any():
            raise ValueError("edge pair not in the universe overlay")
        return np.sort(self._key_order[pos])

    def affected_nodes(self, changed: Sequence[int],
                       radius: int = 2) -> np.ndarray:
        """BFS ball of ``radius`` hops around ``changed`` over the working
        overlay — the neighbourhood churn re-optimization restricts its
        moves to."""
        csr = self.working_csr()
        seen = np.zeros(self.n, dtype=bool)
        frontier = np.asarray(
            [c for c in changed if 0 <= c < self.n], dtype=np.int64)
        seen[frontier] = True
        for _ in range(radius):
            if not len(frontier):
                break
            nxt = []
            for v in frontier.tolist():
                nxt.append(csr.neighbors(v))
            frontier = np.unique(np.concatenate(nxt)) if nxt else frontier[:0]
            frontier = frontier[~seen[frontier]]
            seen[frontier] = True
        return np.flatnonzero(seen)
