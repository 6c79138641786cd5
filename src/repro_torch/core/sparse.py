"""Sparse overlay substrate: CSR graphs and frontier-vectorized kernels (the
port's copy of ``repro.core.sparse``, numpy only, equal to it array for array).

The moderator pipeline (cost reports -> MST -> coloring -> slot schedule,
paper III-A/C) is re-planned on every churn epoch, and the dense
:class:`repro_torch.core.graph.Graph` caps it at a few thousand nodes: the
adjacency matrix alone is O(n^2) and Prim/Kruskal/BFS walk edges in Python.
This module stores overlays in compressed-sparse-row form (the sklearn
``sparsetools`` idiom) and implements the planning kernels as numpy
frontier passes, so the whole pipeline costs O(E) memory and
O(E log n) vectorized work:

* :func:`union_edges` — connected components by hooking + pointer jumping
  (Shiloach–Vishkin), ~log n passes of pure array ops; shared with the
  dense :meth:`Graph.is_connected`.
* :func:`mst_boruvka_csr` — Borůvka where each pass selects every
  component's cheapest outgoing edge with one segment-min
  (``np.minimum.at`` over component labels), so the per-pass cost is O(E)
  and ~log n passes suffice.  Edges are compared by the total order
  ``(w, u, v)``, which makes the MST *unique* and the kernel deterministic
  even under cost ties — the property the incremental churn replanner
  (:mod:`repro_torch.core.replan`) relies on.
* :func:`color_priority_greedy` — Jones–Plassmann coloring: a vertex
  colors itself once it is the highest-priority uncolored vertex in its
  neighbourhood, taking the smallest color absent among already-colored
  neighbours (a vectorized mex).  The output is *identical* to the
  sequential greedy coloring in priority order, which is what lets churn
  re-planning recolor only the affected vertices and still reproduce the
  from-scratch result bit-for-bit.

Construction never materializes a dense matrix: :meth:`CSRGraph.from_edge_
arrays` builds from edge lists, :meth:`CSRGraph.from_cost_reports` from
k-NN style per-node cost dicts (averaging the two directions, like the
dense constructor), and the sparse generators in
:func:`repro_torch.core.graph.make_topology` emit edge arrays directly.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "CSRGraph",
    "union_edges",
    "connected_components",
    "mst_boruvka_csr",
    "mst_edge_selection",
    "color_priority_greedy",
    "color_jones_plassmann",
    "color_greedy_csr",
    "color_bfs_csr",
]

_BIG = np.iinfo(np.int64).max


def _flatten(parent: np.ndarray) -> np.ndarray:
    """Full pointer jumping: parent[i] becomes the root of i's tree."""
    while True:
        gp = parent[parent]
        if np.array_equal(gp, parent):
            return parent
        parent = gp


def union_edges(n: int, eu: np.ndarray, ev: np.ndarray,
                parent: Optional[np.ndarray] = None) -> np.ndarray:
    """Component labels after unioning every edge (u, v).

    Hooking + pointer jumping: each pass hooks every still-split edge's
    smaller root under the larger and flattens, halving the number of live
    components, so ~log n passes of O(E) array ops. ``parent`` seeds the
    initial partition (flattened or not); labels are canonical roots
    (every component is labelled by one of its member indices).
    """
    if parent is None:
        parent = np.arange(n, dtype=np.int64)
    else:
        parent = _flatten(np.asarray(parent, dtype=np.int64).copy())
    if len(eu) == 0:
        return parent
    eu = np.asarray(eu, dtype=np.int64)
    ev = np.asarray(ev, dtype=np.int64)
    while True:
        ru, rv = parent[eu], parent[ev]
        split = ru != rv
        if not split.any():
            return parent
        lo = np.minimum(ru[split], rv[split])
        hi = np.maximum(ru[split], rv[split])
        # deterministic hook: every high root adopts the smallest low root
        # seen this pass (minimum.at resolves races the same way every run)
        target = np.full(n, _BIG, dtype=np.int64)
        np.minimum.at(target, hi, lo)
        hooked = target < _BIG
        parent[hooked] = target[hooked]
        parent = _flatten(parent)


def connected_components(n: int, eu: np.ndarray,
                         ev: np.ndarray) -> Tuple[int, np.ndarray]:
    """(component count, root label per vertex) for an edge-array graph."""
    labels = union_edges(n, eu, ev)
    return int(np.unique(labels).size), labels


def mst_edge_selection(n: int, eu: np.ndarray, ev: np.ndarray,
                       parent: Optional[np.ndarray] = None) -> np.ndarray:
    """Vectorized Borůvka over edges *presorted* by the (w, u, v) total order.

    Returns the ascending indices (into the presorted arrays) of the
    selected spanning-forest edges.  ``parent`` seeds the component
    partition — the incremental replanner passes the surviving-forest
    labels so only the churn-affected components pay for reconnection.

    Each pass: flatten labels, mask cross-component edges, take every
    component's first cross edge in sort order (= its cheapest under the
    total order) via one ``minimum.at`` segment-min, hook along those
    edges breaking the 2-cycles (mutual cheapest edges are shared, so
    cycles have length exactly 2), and pointer-jump.  Components halve
    per pass -> ~log n passes, no per-edge Python.
    """
    eu = np.asarray(eu, dtype=np.int64)
    ev = np.asarray(ev, dtype=np.int64)
    if parent is None:
        parent = np.arange(n, dtype=np.int64)
    else:
        parent = np.asarray(parent, dtype=np.int64).copy()
    ne = len(eu)
    chosen = []
    while True:
        parent = _flatten(parent)
        ru, rv = parent[eu], parent[ev]
        cross = np.flatnonzero(ru != rv)
        if cross.size == 0:
            break
        # segment-min: first (= cheapest) cross edge per component root
        best = np.full(n, ne, dtype=np.int64)
        np.minimum.at(best, ru[cross], cross)
        np.minimum.at(best, rv[cross], cross)
        roots = np.flatnonzero(best < ne)
        e = best[roots]
        other = np.where(ru[e] == roots, rv[e], ru[e])
        chosen.append(np.unique(e))
        # hook each root along its own chosen edge; a 2-cycle means the two
        # roots picked the same edge — keep the smaller id as the root
        parent[roots] = other
        back = parent[parent[roots]] == roots
        keep = roots[back & (roots < parent[roots])]
        parent[keep] = keep
    if not chosen:
        return np.empty(0, dtype=np.int64)
    return np.sort(np.concatenate(chosen))


def _segment_reduce(ufunc_at, values: np.ndarray, idx: np.ndarray,
                    n: int, fill) -> np.ndarray:
    out = np.full(n, fill, dtype=values.dtype)
    ufunc_at(out, idx, values)
    return out


def _mex_over_colored_neighbors(winners: np.ndarray, indptr: np.ndarray,
                                indices: np.ndarray,
                                colors: np.ndarray) -> np.ndarray:
    """Per winner, the smallest color absent among its colored neighbours."""
    deg = indptr[winners + 1] - indptr[winners]
    total = int(deg.sum())
    mex = np.zeros(len(winners), dtype=np.int64)
    if total == 0:
        return mex
    src_pos = np.repeat(np.arange(len(winners), dtype=np.int64), deg)
    local = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(deg) - deg, deg)
    nb = indices[np.repeat(indptr[winners], deg) + local]
    c = colors[nb]
    ok = c >= 0
    if not ok.any():
        return mex
    ws, wc = src_pos[ok], c[ok]
    # unique (winner, color) pairs sorted by winner then color; within each
    # winner the mex is the first rank where the sorted colors skip a value
    span = int(wc.max()) + 2
    keys = np.unique(ws * span + wc)
    gs, gc = keys // span, keys % span
    starts = np.flatnonzero(np.r_[True, gs[1:] != gs[:-1]])
    counts = np.diff(np.r_[starts, len(gs)])
    rank = np.arange(len(gs), dtype=np.int64) - np.repeat(starts, counts)
    mex[gs[starts]] = counts  # all of 0..count-1 present -> mex = count
    gap = gc != rank
    if gap.any():
        np.minimum.at(mex, gs[gap], rank[gap])
    return mex


def color_priority_greedy(indptr: np.ndarray, indices: np.ndarray,
                          rank: np.ndarray) -> np.ndarray:
    """Greedy coloring in ``rank`` order, as parallel Jones–Plassmann rounds.

    ``rank`` is a permutation position per vertex (lower colors earlier).
    Each round, every uncolored vertex whose rank beats all its uncolored
    neighbours takes its mex simultaneously — for random ranks that is
    O(log n) expected rounds of O(E) array work, and the result equals the
    *sequential* greedy coloring in rank order exactly (a vertex's color
    depends only on earlier-ranked neighbours, all final by its round).
    """
    n = len(indptr) - 1
    colors = np.full(n, -1, dtype=np.int64)
    deg = np.diff(indptr)
    src = np.repeat(np.arange(n, dtype=np.int64), deg)
    rank = np.asarray(rank, dtype=np.int64)
    big = np.int64(n + 1)
    while True:
        unc = colors < 0
        rem = np.flatnonzero(unc)
        if rem.size == 0:
            return colors
        r_dst = np.where(unc[indices], rank[indices], big)
        nb_min = _segment_reduce(np.minimum.at, r_dst, src, n, big)
        win = rem[rank[rem] < nb_min[rem]]
        # nonempty: the globally lowest-ranked uncolored vertex always wins
        colors[win] = _mex_over_colored_neighbors(win, indptr, indices, colors)


def color_jones_plassmann(g: "CSRGraph", seed: int = 0,
                          rank: Optional[np.ndarray] = None) -> np.ndarray:
    """Jones–Plassmann coloring with seeded random priorities.

    ``rank`` overrides the random permutation — the churn replanner keys it
    to *stable original node ids* so surviving vertices keep their
    priorities across membership epochs and local recoloring reproduces
    the from-scratch output.
    """
    if rank is None:
        rank = np.random.default_rng(seed).permutation(g.n).astype(np.int64)
    return color_priority_greedy(g.indptr, g.indices, rank)


def color_greedy_csr(g: "CSRGraph") -> np.ndarray:
    """Vectorized greedy coloring in vertex-id order (rank = identity)."""
    return color_priority_greedy(g.indptr, g.indices,
                                 np.arange(g.n, dtype=np.int64))


def color_bfs_csr(g: "CSRGraph", root: int = 0) -> np.ndarray:
    """Frontier-vectorized BFS level parity — 2 colors on any tree/bipartite
    graph (paper III-C); falls back to a greedy repair on odd cycles."""
    n = g.n
    colors = np.full(n, -1, dtype=np.int64)
    frontier = np.array([root], dtype=np.int64)
    colors[root] = 0
    level = 0
    while frontier.size:
        level += 1
        deg = g.indptr[frontier + 1] - g.indptr[frontier]
        total = int(deg.sum())
        local = np.arange(total, dtype=np.int64) - np.repeat(
            np.cumsum(deg) - deg, deg)
        nb = g.indices[np.repeat(g.indptr[frontier], deg) + local]
        nxt = np.unique(nb[colors[nb] < 0])
        colors[nxt] = level % 2
        frontier = nxt
    if (colors < 0).any():  # disconnected: restart parity per component
        for r in np.flatnonzero(colors < 0):
            if colors[r] < 0:
                sub = color_bfs_csr_from(g, int(r))
                mask = sub >= 0
                colors[mask] = sub[mask]
    from .graph import is_proper_coloring  # local: avoid import cycle
    if not is_proper_coloring(g, colors):
        # odd cycle somewhere: parity is not proper — repair greedily in
        # BFS-level order (still deterministic)
        order = np.argsort(colors * n + np.arange(n), kind="stable")
        rank = np.empty(n, dtype=np.int64)
        rank[order] = np.arange(n)
        colors = color_priority_greedy(g.indptr, g.indices, rank)
    return colors


def color_bfs_csr_from(g: "CSRGraph", root: int) -> np.ndarray:
    """BFS parity of ``root``'s component only (-1 elsewhere)."""
    n = g.n
    colors = np.full(n, -1, dtype=np.int64)
    frontier = np.array([root], dtype=np.int64)
    colors[root] = 0
    level = 0
    while frontier.size:
        level += 1
        deg = g.indptr[frontier + 1] - g.indptr[frontier]
        total = int(deg.sum())
        local = np.arange(total, dtype=np.int64) - np.repeat(
            np.cumsum(deg) - deg, deg)
        nb = g.indices[np.repeat(g.indptr[frontier], deg) + local]
        nxt = np.unique(nb[colors[nb] < 0])
        colors[nxt] = level % 2
        frontier = nxt
    return colors


@dataclass
class CSRGraph:
    """Symmetric weighted graph in CSR form (both directions stored).

    ``indices[indptr[u]:indptr[u+1]]`` are u's neighbours (ascending) and
    ``data`` the matching edge costs — the representation every kernel in
    this module consumes, and the drop-in sparse counterpart of
    :class:`repro_torch.core.graph.Graph` for the planning pipeline
    (``build_mst`` / ``color_graph`` dispatch on it).
    """

    n: int
    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray
    _sorted_edges: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = \
        field(default=None, repr=False, compare=False)

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_edge_arrays(cls, n: int, u, v, w,
                         symmetrize: bool = True) -> "CSRGraph":
        """Build from parallel edge arrays; duplicates keep the last cost.

        With ``symmetrize`` each (u, v, w) also files (v, u, w) — pass
        False when the arrays already carry both directions.
        """
        u = np.asarray(u, dtype=np.int64)
        v = np.asarray(v, dtype=np.int64)
        w = np.asarray(w, dtype=np.float64)
        if (u == v).any():
            raise ValueError("self-loops are not allowed")
        if len(u) and (min(u.min(), v.min()) < 0 or max(u.max(), v.max()) >= n):
            raise ValueError("edge endpoint out of range")
        if symmetrize:
            u, v = np.concatenate([u, v]), np.concatenate([v, u])
            w = np.concatenate([w, w])
        order = np.lexsort((v, u))
        u, v, w = u[order], v[order], w[order]
        if len(u):
            # duplicate (u, v) filings collapse to the final one: a position
            # whose successor repeats the same pair is dropped
            drop = np.r_[(u[1:] == u[:-1]) & (v[1:] == v[:-1]), False]
            u, v, w = u[~drop], v[~drop], w[~drop]
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(indptr, u + 1, 1)
        np.cumsum(indptr, out=indptr)
        return cls(n, indptr, v, w)

    @classmethod
    def from_edges(cls, n: int,
                   edges: Iterable[Tuple[int, int, float]]) -> "CSRGraph":
        es = list(edges)
        if not es:
            return cls(n, np.zeros(n + 1, dtype=np.int64),
                       np.empty(0, dtype=np.int64), np.empty(0))
        u, v, w = (np.asarray(x) for x in zip(*es))
        return cls.from_edge_arrays(n, u, v, w)

    @classmethod
    def from_cost_reports(cls, n: int,
                          reports: Dict[int, Dict[int, float]]) -> "CSRGraph":
        """k-NN style cost reports -> CSR, averaging the two directions
        (the dense :meth:`Graph.from_cost_reports` rule) — no dense matrix."""
        us, vs, ws = [], [], []
        for u, costs in reports.items():
            for v, c in costs.items():
                us.append(u)
                vs.append(v)
                ws.append(float(c))
        if not us:
            return cls(n, np.zeros(n + 1, dtype=np.int64),
                       np.empty(0, dtype=np.int64), np.empty(0))
        u = np.asarray(us, dtype=np.int64)
        v = np.asarray(vs, dtype=np.int64)
        w = np.asarray(ws, dtype=np.float64)
        lo, hi = np.minimum(u, v), np.maximum(u, v)
        key = lo * np.int64(n) + hi
        order = np.argsort(key, kind="stable")
        key, w = key[order], w[order]
        uk, start = np.unique(key, return_index=True)
        counts = np.diff(np.r_[start, len(key)])
        avg = np.add.reduceat(np.r_[w, 0.0], start) / counts
        return cls.from_edge_arrays(n, uk // n, uk % n, avg)

    @classmethod
    def from_dense(cls, g) -> "CSRGraph":
        """From any object with a symmetric ``adj`` matrix (``Graph``)."""
        adj = np.asarray(g.adj, dtype=np.float64)
        u, v = np.nonzero(adj)
        return cls.from_edge_arrays(adj.shape[0], u, v, adj[u, v],
                                    symmetrize=False)

    # -- queries -------------------------------------------------------------
    @property
    def n_edges(self) -> int:
        return int(len(self.indices)) // 2

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    def degree(self, u: int) -> int:
        return int(self.indptr[u + 1] - self.indptr[u])

    def neighbors(self, u: int) -> np.ndarray:
        return self.indices[self.indptr[u]:self.indptr[u + 1]]

    def neighbor_costs(self, u: int) -> np.ndarray:
        return self.data[self.indptr[u]:self.indptr[u + 1]]

    def edges_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(u, v, w) with u < v, one entry per undirected edge, CSR order."""
        deg = self.degrees
        u = np.repeat(np.arange(self.n, dtype=np.int64), deg)
        mask = u < self.indices
        return u[mask], self.indices[mask], self.data[mask]

    def edges(self):
        """Edge list [(u, v, cost)] with u < v — the dense ``Graph.edges``
        contract, for small-n interop and tests."""
        u, v, w = self.edges_arrays()
        return [(int(a), int(b), float(c)) for a, b, c in zip(u, v, w)]

    def sorted_edges(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Edge arrays presorted by the (w, u, v) total order (cached) —
        the form every Borůvka call site consumes. Filtering these arrays
        by a boolean mask preserves the order, so membership-restricted
        MSTs never re-sort."""
        if self._sorted_edges is None:
            u, v, w = self.edges_arrays()
            order = np.lexsort((v, u, w))
            self._sorted_edges = (u[order], v[order], w[order])
        return self._sorted_edges

    def total_cost(self) -> float:
        return float(self.data.sum()) / 2.0

    def is_connected(self) -> bool:
        if self.n == 0:
            return True
        u, v, _ = self.edges_arrays()
        return connected_components(self.n, u, v)[0] == 1

    def subgraph(self, members: Sequence[int]) -> "CSRGraph":
        """The induced subgraph on ``members`` (reindexed 0..m-1, ascending
        member order — the dense ``adj[np.ix_]`` rule)."""
        mem = np.asarray(sorted(members), dtype=np.int64)
        mask = np.zeros(self.n, dtype=bool)
        mask[mem] = True
        u, v, w = self.edges_arrays()
        keep = mask[u] & mask[v]
        su = np.searchsorted(mem, u[keep])
        sv = np.searchsorted(mem, v[keep])
        return CSRGraph.from_edge_arrays(len(mem), su, sv, w[keep])

    def to_dense(self):
        """Materialize as a dense :class:`repro_torch.core.graph.Graph` (small n)."""
        from .graph import Graph
        adj = np.zeros((self.n, self.n))
        deg = self.degrees
        u = np.repeat(np.arange(self.n, dtype=np.int64), deg)
        adj[u, self.indices] = self.data
        return Graph(adj)


def mst_boruvka_csr(g: CSRGraph) -> CSRGraph:
    """The MST of a connected :class:`CSRGraph`, as a CSRGraph.

    Deterministic under ties (edges totally ordered by (w, u, v)); raises
    ``ValueError`` on disconnected input like the dense MST functions.
    """
    if g.n == 0:
        raise ValueError("empty graph has no MST")
    eu, ev, ew = g.sorted_edges()
    sel = mst_edge_selection(g.n, eu, ev)
    if len(sel) != g.n - 1:
        raise ValueError("graph is disconnected; MST undefined")
    return CSRGraph.from_edge_arrays(g.n, eu[sel], ev[sel], ew[sel])
