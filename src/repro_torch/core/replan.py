"""Incremental churn re-planning over sparse overlays (the port's copy of
``repro.core.replan``, numpy only: its plans equal the reference's field for
field).

A churn epoch changes a handful of members, yet the moderator pipeline
historically rebuilt the whole plan: induced subgraph -> MST -> coloring.
:class:`SparsePlanner` patches the previous epoch's :class:`MemberPlan`
instead, with *exactly* the from-scratch result (pinned by tests):

* **MST repair.** Edges are totally ordered by ``(w, u, v)`` (the
  :mod:`repro_torch.core.sparse` convention), which makes the MST unique even
  under cost ties — so "patched" and "rebuilt" are comparable edge sets,
  not merely equal weights. Invariants used:

  - *leave(v)*: every surviving tree edge stays in the new MST (any
    non-tree edge inside a surviving component is still the heaviest on
    its tree cycle), so only the overlay edges *crossing* the components
    v's removal split off are candidates. Leaves are processed one at a
    time: removing one tree vertex separates its neighbours pairwise, so
    a lockstep BFS from them that stops when one growth remains finds
    the small sides without walking the big one; candidates are gathered
    from the small sides' overlay rows only — never a full edge scan —
    deduplicated, and reconnected by Borůvka in compact component space
    (candidate order preserved, so cost ties break identically).
  - *join(v)*: the new MST is a subset of ``T ∪ E_v`` (cycle property:
    a non-tree edge not touching v was heaviest on a v-free cycle and
    stays out), and every tree edge cheaper than v's cheapest edge is
    safe (Kruskal processes it first, and tree edges alone never form a
    cycle) — so Borůvka runs only on the suffix above that threshold,
    seeded with the safe prefix's components.

  A combined delta may pass through a spanning *forest* mid-repair (the
  survivors alone disconnected, a join reconnecting them); connectivity
  is enforced once, after the whole delta.

* **Local recoloring.** Jones–Plassmann output equals the sequential
  greedy coloring in priority order, and priorities are keyed to *stable
  overlay node ids* — so a change can only propagate from a changed
  vertex to later-priority neighbours. A worklist processed in priority
  order, seeded with the vertices whose tree neighbourhood changed,
  reproduces the from-scratch coloring exactly while touching only the
  affected region.

* **No per-epoch rebuild.** The plan carries its tree adjacency as a
  CSR-style (indptr, dst) pair in overlay-id space; deletes tombstone
  dst entries in place (-1, skipped by every reader) and inserts refill
  the holes, so a repair costs O(degree) — no O(|tree|) compress, no
  indptr shift — with a single hole-sweeping compaction once tombstones
  exceed a quarter of the array. Tree-array edits are deferred likewise:
  the leave loop batches removed and repair edges into one compress +
  one weight-keyed merge into the (w, u, v)-sorted edge list (full
  lexsort only on an exact weight collision). Colors live in a
  full-size overlay array, and the member-index CSR that ``make_policy``
  consumes is built lazily, so a replan never pays the O(n log n)
  reindex+sort the from-scratch path does.

The planner is cached per overlay by the scenario
:class:`~repro_torch.scenario.cache.PlanCache` (stage ``member_plan``), which
counts incremental vs full builds (``replan_incremental`` /
``replan_full``).
"""
from __future__ import annotations

import heapq
from collections import deque
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import numpy as np

from .sparse import (
    CSRGraph,
    color_priority_greedy,
    mst_edge_selection,
    union_edges,
)

__all__ = ["MemberPlan", "SparsePlanner", "plan_equal"]


def _compact_rank(global_rank: np.ndarray) -> np.ndarray:
    """Order-preserving 0..m-1 ranks from arbitrary unique priority keys."""
    order = np.argsort(global_rank, kind="stable")
    out = np.empty(len(global_rank), dtype=np.int64)
    out[order] = np.arange(len(global_rank), dtype=np.int64)
    return out


@dataclass
class MemberPlan:
    """One membership epoch's plan: MST edges in overlay-id space + colors.

    ``tree_u/tree_v/tree_w`` are sorted by the (w, u, v) total order (the
    invariant every repair step preserves), ``colors[i]`` colors
    ``members[i]``; :meth:`member_mst` yields the member-index CSR tree and
    colors that ``make_policy`` consumes. ``adj_indptr/adj_dst`` are the
    tree's directed edges as a CSR over overlay ids — the O(1)-slice
    neighbourhood index the incremental replanner patches in place of a
    full CSR rebuild.
    """

    members: np.ndarray  # sorted overlay ids
    tree_u: np.ndarray  # overlay ids, (w, u, v)-sorted
    tree_v: np.ndarray
    tree_w: np.ndarray
    colors: np.ndarray  # aligned with members
    _tree_csr: Optional[CSRGraph] = field(default=None, repr=False,
                                          compare=False)
    adj_indptr: Optional[np.ndarray] = field(default=None, repr=False,
                                             compare=False)
    adj_dst: Optional[np.ndarray] = field(default=None, repr=False,
                                          compare=False)

    @property
    def n_members(self) -> int:
        return int(len(self.members))

    @property
    def n_colors(self) -> int:
        return int(self.colors.max()) + 1 if len(self.colors) else 0

    def tree_cost(self) -> float:
        return float(self.tree_w.sum())

    def member_mst(self) -> Tuple[CSRGraph, np.ndarray]:
        """(member-index MST as a CSRGraph, colors) — the policy inputs."""
        if self._tree_csr is None:
            mu = np.searchsorted(self.members, self.tree_u)
            mv = np.searchsorted(self.members, self.tree_v)
            self._tree_csr = CSRGraph.from_edge_arrays(
                self.n_members, mu, mv, self.tree_w)
        return self._tree_csr, self.colors

    def adjacency(self, n: int) -> Tuple[np.ndarray, np.ndarray]:
        """The (indptr, dst) tree adjacency over n overlay ids, built on
        first use."""
        if self.adj_indptr is None:
            src = np.r_[self.tree_u, self.tree_v]
            dst = np.r_[self.tree_v, self.tree_u]
            order = np.argsort(src, kind="stable")
            counts = np.bincount(src, minlength=n)
            self.adj_indptr = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(counts, out=self.adj_indptr[1:])
            self.adj_dst = dst[order]
        return self.adj_indptr, self.adj_dst


def plan_equal(a: MemberPlan, b: MemberPlan) -> bool:
    """Plan equivalence: same members, same MST edge set, same colors."""
    return (np.array_equal(a.members, b.members)
            and np.array_equal(a.tree_u, b.tree_u)
            and np.array_equal(a.tree_v, b.tree_v)
            and np.allclose(a.tree_w, b.tree_w)
            and np.array_equal(a.colors, b.colors))


def _adj_delete(indptr: np.ndarray, dst: np.ndarray,
                us, vs) -> Tuple[np.ndarray, np.ndarray]:
    """Tombstone the directed entries (u -> v) in place: one O(deg) row
    scan per entry, *no* O(E) compress and no indptr shift. Holes (-1) are
    skipped by every consumer, refilled by :func:`_adj_insert`, and swept
    by :func:`_compact_adjacency` when they pile up."""
    if not isinstance(us, list):
        us, vs = np.asarray(us).tolist(), np.asarray(vs).tolist()
    for a, b in zip(us, vs):
        sl, sr = int(indptr[a]), int(indptr[a + 1])
        dst[sl + dst[sl:sr].tolist().index(b)] = -1
    return indptr, dst


def _adj_insert(indptr: np.ndarray, dst: np.ndarray,
                us: np.ndarray, vs: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Insert directed entries, filling a tombstone hole in the row when
    one exists (the common case: a repair edge lands where a deleted edge
    just left) and growing the array with ``np.insert`` otherwise.

    The grow path's positions index the *original* dst array, which is
    exactly ``np.insert``'s contract — but when empty rows sit between two
    target rows their end positions coincide, and ``np.insert`` places
    same-position values in argument order. Sorting the pairs by row first
    makes that order the row order."""
    if not isinstance(us, list):
        us, vs = np.asarray(us).tolist(), np.asarray(vs).tolist()
    rem_u, rem_v = [], []
    for a, b in zip(us, vs):
        sl, sr = int(indptr[a]), int(indptr[a + 1])
        row = dst[sl:sr].tolist()
        if -1 in row:
            dst[sl + row.index(-1)] = b
        else:
            rem_u.append(a)
            rem_v.append(b)
    if rem_u:
        ru = np.asarray(rem_u, dtype=np.int64)
        rv = np.asarray(rem_v, dtype=np.int64)
        order = np.argsort(ru, kind="stable")
        ru, rv = ru[order], rv[order]
        pos = indptr[ru + 1]
        shift = np.zeros(len(indptr), dtype=np.int64)
        np.add.at(shift, ru + 1, 1)
        return indptr + np.cumsum(shift), np.insert(dst, pos, rv)
    return indptr, dst


def _compact_adjacency(indptr: np.ndarray, dst: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Sweep tombstone holes out of a patched adjacency — one O(E) pass —
    leaving one slack hole per occupied row so the next inserts keep
    hole-filling instead of growing the array."""
    n = len(indptr) - 1
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    keep = dst >= 0
    rows, vals = rows[keep], dst[keep]
    counts = np.bincount(rows, minlength=n)
    out = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts + (counts > 0), out=out[1:])
    packed = np.full(int(out[-1]), -1, dtype=np.int64)
    start = np.cumsum(counts) - counts
    packed[out[rows] + (np.arange(len(rows)) - start[rows])] = vals
    return out, packed


def _merge_sorted_edges(tu, tv, tw, cu, cv, cw):
    """Merge new edges (themselves (w, u, v)-sorted) into the sorted tree.

    Weight-keyed insertion positions are exact unless a new edge's weight
    collides with an existing tree weight — then (u, v) tie-breaking
    matters and we fall back to one full lexsort.
    """
    if len(cu) == 0:
        return tu, tv, tw
    if len(tw) == 0:
        return cu, cv, cw
    pos = np.searchsorted(tw, cw, "left")
    hit = pos < len(tw)
    if np.any(tw[np.minimum(pos, len(tw) - 1)][hit] == cw[hit]):
        order = np.lexsort((np.r_[tv, cv], np.r_[tu, cu], np.r_[tw, cw]))
        return (np.r_[tu, cu][order], np.r_[tv, cv][order],
                np.r_[tw, cw][order])
    return (np.insert(tu, pos, cu), np.insert(tv, pos, cv),
            np.insert(tw, pos, cw))


class SparsePlanner:
    """MST + Jones–Plassmann planning over one sparse overlay, with
    exact incremental re-planning across membership deltas."""

    def __init__(self, overlay: CSRGraph, seed: int = 0) -> None:
        self.overlay = overlay
        # JP priorities keyed to stable overlay ids: survivors keep their
        # priority across epochs, the property incremental recoloring needs
        self.rank = np.random.default_rng(seed).permutation(
            overlay.n).astype(np.int64)

    # -- full build ----------------------------------------------------------
    def plan(self, members: Sequence[int]) -> MemberPlan:
        """From-scratch plan: Borůvka over the membership-filtered presorted
        overlay edges (filtering preserves sort order — no re-sort), then
        Jones–Plassmann on the tree."""
        mem = np.asarray(sorted(members), dtype=np.int64)
        eu, ev, ew = self.overlay.sorted_edges()
        mask = np.zeros(self.overlay.n, dtype=bool)
        mask[mem] = True
        keep = np.flatnonzero(mask[eu] & mask[ev])
        sel = mst_edge_selection(self.overlay.n, eu[keep], ev[keep])
        if len(sel) != len(mem) - 1:
            raise ValueError("member subgraph is disconnected; MST undefined")
        chosen = keep[sel]
        return self._finish_full(mem, eu[chosen], ev[chosen], ew[chosen])

    # -- incremental build ---------------------------------------------------
    def replan(self, prev: MemberPlan, members: Sequence[int]) -> MemberPlan:
        """Patch ``prev`` to the new member set — identical output to
        :meth:`plan` (``plan_equal`` with the from-scratch build)."""
        mem = np.asarray(sorted(members), dtype=np.int64)
        n = self.overlay.n
        cur = np.zeros(n, dtype=bool)
        cur[prev.members] = True
        mm = np.zeros(n, dtype=bool)
        mm[mem] = True
        leaves = prev.members[~mm[prev.members]]
        joins = mem[~cur[mem]]
        if not len(leaves) and not len(joins):
            return MemberPlan(mem, prev.tree_u, prev.tree_v, prev.tree_w,
                              prev.colors, prev._tree_csr,
                              prev.adj_indptr, prev.adj_dst)
        tu, tv, tw = prev.tree_u, prev.tree_v, prev.tree_w
        adj_indptr, adj_dst = prev.adjacency(n)
        adj_dst = adj_dst.copy()  # tombstone patches mutate in place
        # > half holes (the per-row slack alone stays under a third)
        if np.count_nonzero(adj_dst < 0) * 2 > len(adj_dst) + 256:
            adj_indptr, adj_dst = _compact_adjacency(adj_indptr, adj_dst)
        dirty: set = set()

        # The leave loop defers its tree-array edits: removed-leaf edges
        # and selected repair edges accumulate and land in one compress +
        # one merge (``flush``), instead of three O(|tree|) rewrites per
        # leaf. Only the rare walk-budget fallback needs the arrays
        # mid-loop, and it flushes first.
        processed: list = []
        pend_u: list = []
        pend_v: list = []
        pend_w: list = []

        def flush():
            nonlocal tu, tv, tw
            if processed:
                dead = np.isin(tu, processed) | np.isin(tv, processed)
                if dead.any():
                    tu, tv, tw = tu[~dead], tv[~dead], tw[~dead]
                processed.clear()
            if pend_u:
                cu = np.asarray(pend_u, dtype=np.int64)
                cv = np.asarray(pend_v, dtype=np.int64)
                cw = np.asarray(pend_w)
                order = np.lexsort((cv, cu, cw))
                tu, tv, tw = _merge_sorted_edges(
                    tu, tv, tw, cu[order], cv[order], cw[order])
                pend_u.clear()
                pend_v.clear()
                pend_w.clear()

        for r in leaves:
            # one leave at a time: in a tree, removing r separates its
            # neighbours pairwise, so the lockstep walk's stop-at-one-
            # active rule identifies the big side without exploring it
            r = int(r)
            cur[r] = False
            row = adj_dst[int(adj_indptr[r]):int(adj_indptr[r + 1])]
            nbrs = row[row >= 0]
            if not len(nbrs):
                continue
            nl = nbrs.tolist()
            dirty.update(nl)
            adj_indptr, adj_dst = _adj_delete(
                adj_indptr, adj_dst, [r] * len(nl) + nl, nl + [r] * len(nl))
            processed.append(r)
            if pend_u:  # repair edges of earlier leaves may touch r
                for i in range(len(pend_u) - 1, -1, -1):
                    if pend_u[i] == r or pend_v[i] == r:
                        del pend_u[i], pend_v[i], pend_w[i]
            if len(nbrs) == 1:
                continue  # a tree leaf: the forest is unchanged elsewhere
            cu = cv = cw = np.empty(0, dtype=np.int64)
            walked = self._split_components(adj_indptr, adj_dst, nbrs)
            if walked is None:
                # walk budget blown (a big balanced split): vectorized
                # full labeling instead
                flush()
                labels = union_edges(n, tu, tv)
                cu, cv, cw = self._leave_candidates(cur, labels)
                if len(cu):
                    sel = mst_edge_selection(n, cu, cv, parent=labels)
                    cu, cv, cw = cu[sel], cv[sel], cw[sel]
            else:
                lab, small, main = walked
                cu, cv, cw = self._gather_crossing(cur, lab, small, main)
                if len(cu):
                    # reconnect in compact component space; keeping the
                    # (w, u, v) candidate order keeps tie-breaks exact
                    ku = np.where(lab[cu] >= 0, lab[cu], main)
                    kv = np.where(lab[cv] >= 0, lab[cv], main)
                    _, inv = np.unique(np.r_[ku, kv], return_inverse=True)
                    sel = mst_edge_selection(
                        int(inv.max()) + 1, inv[:len(cu)], inv[len(cu):])
                    cu, cv, cw = cu[sel], cv[sel], cw[sel]
            if len(cu):
                # a disconnected surviving forest is fine mid-delta — a
                # join in the same delta may reconnect it; the spanning
                # check runs once, after the whole delta
                ul, vl = cu.tolist(), cv.tolist()
                dirty.update(ul)
                dirty.update(vl)
                adj_indptr, adj_dst = _adj_insert(
                    adj_indptr, adj_dst, ul + vl, vl + ul)
                pend_u.extend(ul)
                pend_v.extend(vl)
                pend_w.extend(cw.tolist())
        flush()

        for j in joins:
            j = int(j)
            nb = self.overlay.neighbors(j)
            wv = self.overlay.neighbor_costs(j)
            inm = cur[nb]
            nb, wv = nb[inm], wv[inm]
            if nb.size == 0:
                # no edge to the members *yet* — a later join in this delta
                # may connect it; the final spanning check decides
                cur[j] = True
                dirty.add(j)
                continue
            lo = np.minimum(j, nb).astype(np.int64)
            hi = np.maximum(j, nb).astype(np.int64)
            vord = np.lexsort((hi, lo, wv))
            lo, hi, wv = lo[vord], hi[vord], wv[vord]
            pos = np.searchsorted(tw, wv, "left")
            inb = pos < len(tw)
            if len(tw) and np.any(
                    tw[np.minimum(pos, len(tw) - 1)][inb] == wv[inb]):
                order = np.lexsort((np.r_[tv, hi], np.r_[tu, lo],
                                    np.r_[tw, wv]))
                au = np.r_[tu, lo][order]
                av = np.r_[tv, hi][order]
                aw = np.r_[tw, wv][order]
                isv = np.r_[np.zeros(len(tu), dtype=bool),
                            np.ones(len(lo), dtype=bool)][order]
            else:
                au = np.insert(tu, pos, lo)
                av = np.insert(tv, pos, hi)
                aw = np.insert(tw, pos, wv)
                isv = np.insert(np.zeros(len(tu), dtype=bool), pos, True)
            # tree edges below v's cheapest edge are safe (Kruskal accepts
            # them before any v-edge, and tree edges alone are acyclic)
            p = int(np.flatnonzero(isv)[0])
            parent = union_edges(n, au[:p], av[:p])
            sel = p + mst_edge_selection(n, au[p:], av[p:], parent=parent)
            keep = np.zeros(len(au), dtype=bool)
            keep[:p] = True
            keep[sel] = True
            # displaced tree edges (dropped) and accepted v-edges (kept)
            # change neighbourhoods — i.e. suffix edges where keep == isv
            changed = np.flatnonzero(keep[p:] == isv[p:]) + p
            dirty.add(j)
            dirty.update(int(x) for x in au[changed])
            dirty.update(int(x) for x in av[changed])
            dropped = changed[~isv[changed]]
            accepted = changed[isv[changed]]
            if len(dropped):
                adj_indptr, adj_dst = _adj_delete(
                    adj_indptr, adj_dst, np.r_[au[dropped], av[dropped]],
                    np.r_[av[dropped], au[dropped]])
            if len(accepted):
                adj_indptr, adj_dst = _adj_insert(
                    adj_indptr, adj_dst, np.r_[au[accepted], av[accepted]],
                    np.r_[av[accepted], au[accepted]])
            tu, tv, tw = au[keep], av[keep], aw[keep]
            cur[j] = True

        if len(tw) != len(mem) - 1:
            raise ValueError("member subgraph is disconnected; MST undefined")
        colors_full = np.full(n, -1, dtype=np.int64)
        colors_full[prev.members] = prev.colors
        colors_full[leaves] = -1
        dirty.difference_update(int(x) for x in leaves)
        dirty.update(int(x) for x in joins)
        self._recolor(adj_indptr, adj_dst, colors_full, dirty)
        return MemberPlan(mem, tu, tv, tw, colors_full[mem],
                          None, adj_indptr, adj_dst)

    # -- repair helpers ------------------------------------------------------
    def _split_components(self, adj_indptr: np.ndarray, adj_dst: np.ndarray,
                          seeds: np.ndarray):
        """Label the components a single removal split off, by lockstep BFS
        from the removed vertex's tree neighbours.

        In a tree the neighbours end up in pairwise-distinct components, so
        the regions never merge; growing them in lockstep and stopping as
        soon as a single growth stays active explores only the small sides
        — the survivor is designated *main* and never fully walked.
        Returns ``(lab, small, main)`` with ``lab[v]`` the seed of v's
        component (-1 = unvisited, i.e. main), ``small`` the visited
        non-main vertices, ``main`` the main seed — or ``None`` when the
        walk exceeds its vertex budget (a big balanced split; the caller
        falls back to the vectorized full labeling).
        """
        n = self.overlay.n
        budget = 1024
        lab = np.full(n, -1, dtype=np.int64)
        groups = []
        for s in seeds:
            s = int(s)
            lab[s] = s
            groups.append((s, deque([s]), [s]))
        active = list(groups)
        visited = len(groups)
        ip = adj_indptr
        while len(active) > 1:
            if visited > budget:
                return None
            still = []
            for g in active:
                s, q, verts = g
                if not q:
                    continue
                x = q.popleft()
                for v in adj_dst[int(ip[x]):int(ip[x + 1])].tolist():
                    if v >= 0 and lab[v] < 0:
                        lab[v] = s
                        verts.append(v)
                        q.append(v)
                        visited += 1
                if q:
                    still.append(g)
            active = still
        if active:
            main = active[0][0]
        else:
            main = max(groups, key=lambda g: len(g[2]))[0]
        small = []
        for s, _, verts in groups:
            if s != main:
                small.extend(verts)
        return lab, np.asarray(sorted(small), dtype=np.int64), main

    def _member_rows(self, verts: np.ndarray):
        """Concatenated overlay CSR rows of ``verts`` as (src, dst, w)."""
        ip, idx, w = (self.overlay.indptr, self.overlay.indices,
                      self.overlay.data)
        cnt = (ip[verts + 1] - ip[verts]).astype(np.int64)
        flat = np.repeat(ip[verts], cnt) + (
            np.arange(int(cnt.sum()), dtype=np.int64)
            - np.repeat(np.cumsum(cnt) - cnt, cnt))
        return np.repeat(verts, cnt), idx[flat].astype(np.int64), w[flat]

    def _dedup_sort(self, su, sv, sw):
        """Canonicalize, dedup (an edge between two small components is
        seen from both sides) and (w, u, v)-sort candidate edges."""
        lo, hi = np.minimum(su, sv), np.maximum(su, sv)
        _, first = np.unique(lo * self.overlay.n + hi, return_index=True)
        lo, hi, sw = lo[first], hi[first], sw[first]
        order = np.lexsort((hi, lo, sw))
        return lo[order], hi[order], sw[order]

    def _gather_crossing(self, cur: np.ndarray, lab: np.ndarray,
                         small: np.ndarray, main: int):
        """Crossing candidates from walk labels (-1 = main component)."""
        if not len(small):
            return (np.empty(0, np.int64),) * 3
        su, sv, sw = self._member_rows(small)
        eff = np.where(lab[sv] >= 0, lab[sv], main)
        keep = cur[sv] & (lab[su] != eff)
        return self._dedup_sort(su[keep], sv[keep], sw[keep])

    def _leave_candidates(self, cur: np.ndarray, labels: np.ndarray):
        """Overlay edges crossing the surviving forest's components, in the
        (w, u, v) total order, from a full ``union_edges`` labeling.

        Every crossing edge touches a *non-main* component, so only the
        split-off members' overlay rows are gathered — O(|small| * degree)
        instead of a full O(E) scan.
        """
        survivors = np.flatnonzero(cur)
        if not len(survivors):
            return (np.empty(0, np.int64),) * 3
        counts = np.bincount(labels[survivors], minlength=len(labels))
        main = int(counts.argmax())
        small = survivors[labels[survivors] != main]
        if not len(small):
            return (np.empty(0, np.int64),) * 3
        su, sv, sw = self._member_rows(small)
        keep = cur[sv] & (labels[su] != labels[sv])
        return self._dedup_sort(su[keep], sv[keep], sw[keep])

    # -- shared tails --------------------------------------------------------
    def _finish_full(self, mem: np.ndarray, tu: np.ndarray, tv: np.ndarray,
                     tw: np.ndarray) -> MemberPlan:
        m = len(mem)
        mu = np.searchsorted(mem, tu)
        mv = np.searchsorted(mem, tv)
        tcsr = CSRGraph.from_edge_arrays(m, mu, mv, tw)
        lrank = _compact_rank(self.rank[mem])
        colors = color_priority_greedy(tcsr.indptr, tcsr.indices, lrank)
        n = self.overlay.n
        # one slack hole per member row: the first repair insert into a row
        # hole-fills instead of growing the array
        deg = np.diff(tcsr.indptr)
        counts = np.zeros(n + 1, dtype=np.int64)
        counts[mem + 1] = deg + 1
        adj_indptr = np.cumsum(counts)
        adj_dst = np.full(int(adj_indptr[-1]), -1, dtype=np.int64)
        flat = np.repeat(adj_indptr[mem], deg) + (
            np.arange(int(deg.sum()), dtype=np.int64)
            - np.repeat(np.cumsum(deg) - deg, deg))
        adj_dst[flat] = mem[tcsr.indices]
        return MemberPlan(mem, tu, tv, tw, colors, tcsr, adj_indptr, adj_dst)

    def _recolor(self, adj_indptr: np.ndarray, adj_dst: np.ndarray,
                 colors: np.ndarray, seeds) -> None:
        """Priority-order worklist recoloring, in place over the full-size
        overlay color array — exact JP output.

        A vertex's canonical color is the mex over its *earlier-ranked*
        tree neighbours; processing pending vertices in rank order keeps
        every earlier vertex final, and a change pushes only later
        neighbours. Global ranks order members exactly like the compact
        ranks the full build uses (restriction preserves order)."""
        rank = self.rank
        heap = [(int(rank[u]), int(u)) for u in seeds]
        heapq.heapify(heap)
        pending = {int(u) for u in seeds}
        while heap:
            ru, u = heapq.heappop(heap)
            if u not in pending:
                continue
            pending.discard(u)
            nb = [v for v in
                  adj_dst[int(adj_indptr[u]):int(adj_indptr[u + 1])].tolist()
                  if v >= 0]
            used = {int(colors[v]) for v in nb
                    if rank[v] < ru and colors[v] >= 0}
            c = 0
            while c in used:
                c += 1
            if c != colors[u]:
                colors[u] = c
                for v in nb:
                    if rank[v] > ru and v not in pending:
                        pending.add(v)
                        heapq.heappush(heap, (int(rank[v]), v))
