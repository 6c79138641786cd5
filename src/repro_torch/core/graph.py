"""Graph substrate for MOSGU: adjacency matrices, MSTs, colorings, slot
lengths, topology generators (the port's copy of ``repro.core.graph``).

Pure numpy: it runs on the *moderator*, and its outputs (MST edges, colors,
slot plans) are the static inputs of the slot plans in
:mod:`repro_torch.core.plan` and of the permutation steps the card runs.

Terminology follows the paper (Section III):
  * the network is an undirected weighted graph; weights are communication
    costs (ping latency in ms, geographic distance, or hop count),
  * the moderator averages the two directed cost reports per edge,
  * the MST removes redundant edges (III-B), BFS 2-colors it (III-C),
  * nodes sharing a color transmit in the same time slot.

Dense graphs are :class:`Graph`; the sparse topology kinds
(``SPARSE_TOPOLOGY_KINDS``) are :class:`~repro_torch.core.sparse.CSRGraph`,
and ``build_mst`` / ``color_graph`` dispatch on either.
"""
from __future__ import annotations

import heapq
from collections import deque
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from .sparse import (
    CSRGraph,
    color_bfs_csr,
    color_greedy_csr,
    color_jones_plassmann,
    connected_components,
    mst_boruvka_csr,
)

Edge = Tuple[int, int]


# ---------------------------------------------------------------------------
# Graph container
# ---------------------------------------------------------------------------


@dataclass
class Graph:
    """Undirected weighted graph backed by a dense adjacency matrix.

    ``adj[i, j] > 0`` means an edge of that cost; ``0`` means no edge.
    (Costs are latencies/distances, hence strictly positive for real links.)
    """

    adj: np.ndarray

    def __post_init__(self) -> None:
        adj = np.asarray(self.adj, dtype=np.float64)
        if adj.ndim != 2 or adj.shape[0] != adj.shape[1]:
            raise ValueError(f"adjacency must be square, got {adj.shape}")
        if not np.allclose(adj, adj.T):
            # The paper: cost reports may differ per direction; the moderator
            # symmetrizes by averaging the two reports.
            adj = (adj + adj.T) / 2.0
        np.fill_diagonal(adj, 0.0)
        if (adj < 0).any():
            raise ValueError("edge costs must be non-negative")
        self.adj = adj
        self._adjacency: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] \
            = None  # lazy CSR view; adj is never mutated in place after init

    # -- basic queries ------------------------------------------------------
    @property
    def n(self) -> int:
        return self.adj.shape[0]

    def _csr_view(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Memoized (indptr, indices, data) adjacency — one ``nonzero`` over
        the whole matrix instead of one per ``neighbors``/``edges`` call."""
        cache = self._adjacency
        if cache is None:
            rows, cols = np.nonzero(self.adj)
            indptr = np.zeros(self.n + 1, dtype=np.int64)
            if len(rows):
                indptr[1:] = np.cumsum(np.bincount(rows, minlength=self.n))
            cache = self._adjacency = (indptr, cols.astype(np.int64),
                                       self.adj[rows, cols])
        return cache

    def edges(self) -> List[Tuple[int, int, float]]:
        """All undirected edges as (u, v, cost), u < v."""
        indptr, indices, data = self._csr_view()
        u = np.repeat(np.arange(self.n, dtype=np.int64), np.diff(indptr))
        mask = u < indices
        return [(int(a), int(b), float(c))
                for a, b, c in zip(u[mask], indices[mask], data[mask])]

    def neighbors(self, u: int) -> List[int]:
        indptr, indices, _ = self._csr_view()
        return indices[indptr[u]:indptr[u + 1]].tolist()

    def degree(self, u: int) -> int:
        indptr, _, _ = self._csr_view()
        return int(indptr[u + 1] - indptr[u])

    def is_connected(self) -> bool:
        if self.n == 0:
            return True
        indptr, indices, _ = self._csr_view()
        u = np.repeat(np.arange(self.n, dtype=np.int64), np.diff(indptr))
        mask = u < indices
        return connected_components(self.n, u[mask], indices[mask])[0] == 1

    def total_cost(self) -> float:
        return float(np.triu(self.adj, k=1).sum())

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_edges(cls, n: int, edges: Iterable[Tuple[int, int, float]]) -> "Graph":
        adj = np.zeros((n, n))
        for u, v, c in edges:
            adj[u, v] = adj[v, u] = c
        return cls(adj)

    @classmethod
    def from_cost_reports(
        cls, n: int, reports: Dict[int, Dict[int, float]]
    ) -> "Graph":
        """Build from per-node directed cost reports (moderator view).

        ``reports[u][v]`` is node u's measured cost to v. The moderator
        averages the two directions when both are present (paper III-A).
        """
        adj = np.zeros((n, n))
        for u, costs in reports.items():
            for v, c in costs.items():
                if u == v:
                    continue
                if adj[v, u] > 0:  # other direction already reported
                    adj[u, v] = adj[v, u] = (adj[v, u] + c) / 2.0
                else:
                    adj[u, v] = adj[v, u] = c
        return cls(adj)


# ---------------------------------------------------------------------------
# MST algorithms (paper III-B considers Prim / Kruskal / Borůvka; picks Prim)
# ---------------------------------------------------------------------------


def mst_prim(g: Graph, root: int = 0) -> Graph:
    """Prim's algorithm, O(E + V log V) with a binary heap.

    Chosen by the paper for dense/complete graphs (III-B).
    """
    n = g.n
    if n == 0:
        return Graph(np.zeros((0, 0)))
    if not g.is_connected():
        raise ValueError("MST requires a connected graph")
    in_tree = np.zeros(n, dtype=bool)
    in_tree[root] = True
    edges_out: List[Tuple[int, int, float]] = []
    heap: List[Tuple[float, int, int]] = []
    for v in g.neighbors(root):
        heapq.heappush(heap, (g.adj[root, v], root, v))
    while heap and len(edges_out) < n - 1:
        c, u, v = heapq.heappop(heap)
        if in_tree[v]:
            continue
        in_tree[v] = True
        edges_out.append((u, v, c))
        for w in g.neighbors(v):
            if not in_tree[w]:
                heapq.heappush(heap, (g.adj[v, w], v, w))
    return Graph.from_edges(n, edges_out)


def mst_kruskal(g: Graph) -> Graph:
    """Kruskal's algorithm, O(E log E) — efficient for sparse graphs."""
    n = g.n
    if not g.is_connected():
        raise ValueError("MST requires a connected graph")
    parent = list(range(n))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    out = []
    for u, v, c in sorted(g.edges(), key=lambda e: e[2]):
        ru, rv = find(u), find(v)
        if ru != rv:
            parent[ru] = rv
            out.append((u, v, c))
            if len(out) == n - 1:
                break
    return Graph.from_edges(n, out)


def mst_boruvka(g: Graph) -> Graph:
    """Borůvka's algorithm, O(E log V)."""
    n = g.n
    if not g.is_connected():
        raise ValueError("MST requires a connected graph")
    parent = list(range(n))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    edges = g.edges()
    out: List[Tuple[int, int, float]] = []
    n_comp = n
    while n_comp > 1:
        cheapest: Dict[int, Tuple[float, int, int]] = {}
        for u, v, c in edges:
            ru, rv = find(u), find(v)
            if ru == rv:
                continue
            # tie-break deterministically by (cost, u, v)
            key = (c, u, v)
            if ru not in cheapest or key < cheapest[ru]:
                cheapest[ru] = key
            if rv not in cheapest or key < cheapest[rv]:
                cheapest[rv] = key
        if not cheapest:
            break
        for c, u, v in cheapest.values():
            ru, rv = find(u), find(v)
            if ru != rv:
                parent[ru] = rv
                out.append((u, v, c))
                n_comp -= 1
    return Graph.from_edges(n, out)


MST_ALGORITHMS = {"prim": mst_prim, "kruskal": mst_kruskal, "boruvka": mst_boruvka}


def build_mst(g: Graph, algorithm: str = "prim", root: int = 0) -> Graph:
    if isinstance(g, CSRGraph):
        # sparse fast path: every algorithm name runs the frontier-vectorized
        # Borůvka (repro_torch.core.sparse) — with distinct edge costs (generated
        # topologies, a.s.) the MST is unique, so the choice of algorithm
        # only ever affected speed, and under ties the (w, u, v) total order
        # keeps the output deterministic
        if algorithm not in MST_ALGORITHMS:
            raise ValueError(f"unknown MST algorithm {algorithm!r}")
        return mst_boruvka_csr(g)
    if algorithm == "prim":
        return mst_prim(g, root)
    try:
        return MST_ALGORITHMS[algorithm](g)
    except KeyError:
        raise ValueError(f"unknown MST algorithm {algorithm!r}") from None


# ---------------------------------------------------------------------------
# Coloring algorithms (paper III-C considers BFS / DSatur / Welsh-Powell /
# LDF; picks BFS — a tree is always 2-chromatic so BFS is optimal there)
# ---------------------------------------------------------------------------


def color_bfs(g: Graph, root: int = 0) -> np.ndarray:
    """BFS coloring, O(V+E). On a tree this yields exactly 2 colors.

    On a general (non-bipartite) graph BFS-layer parity is not a proper
    coloring, so we greedily repair conflicts — MOSGU only ever colors MSTs,
    where no repair is needed.
    """
    n = g.n
    colors = -np.ones(n, dtype=np.int64)
    for start in range(n):
        if colors[start] >= 0:
            continue
        r = root if (start == 0 and colors[root] < 0) else start
        colors[r] = 0
        dq = deque([r])
        while dq:
            u = dq.popleft()
            for v in g.neighbors(u):
                if colors[v] < 0:
                    colors[v] = 1 - colors[u] if colors[u] in (0, 1) else 0
                    dq.append(v)
    # conflict repair for non-bipartite inputs
    for u in range(n):
        used = {int(colors[v]) for v in g.neighbors(u)}
        if int(colors[u]) in used:
            c = 0
            while c in used:
                c += 1
            colors[u] = c
    return colors


def color_dsatur(g: Graph) -> np.ndarray:
    """DSatur: pick the vertex with highest saturation degree first."""
    n = g.n
    colors = -np.ones(n, dtype=np.int64)
    sat: List[set] = [set() for _ in range(n)]
    degs = [g.degree(u) for u in range(n)]
    for _ in range(n):
        # max (saturation, degree) among uncolored
        best, best_key = -1, (-1, -1)
        for u in range(n):
            if colors[u] >= 0:
                continue
            key = (len(sat[u]), degs[u])
            if key > best_key:
                best, best_key = u, key
        c = 0
        while c in sat[best]:
            c += 1
        colors[best] = c
        for v in g.neighbors(best):
            sat[v].add(c)
    return colors


def color_welsh_powell(g: Graph) -> np.ndarray:
    """Welsh-Powell: color vertices in decreasing-degree order."""
    n = g.n
    colors = -np.ones(n, dtype=np.int64)
    order = sorted(range(n), key=lambda u: -g.degree(u))
    for u in order:
        used = {int(colors[v]) for v in g.neighbors(u) if colors[v] >= 0}
        c = 0
        while c in used:
            c += 1
        colors[u] = c
    return colors


def color_ldf(g: Graph) -> np.ndarray:
    """Largest Degree First greedy coloring (paper's 'LDF')."""
    return color_welsh_powell(g)  # LDF == Welsh-Powell's ordering rule


def color_jones_plassmann_dense(g: Graph, seed: int = 0) -> np.ndarray:
    """Jones–Plassmann on a dense graph (via its CSR view) — identical to
    the sequential greedy coloring in seeded-random-priority order."""
    return color_jones_plassmann(CSRGraph.from_dense(g), seed=seed)


def color_greedy(g: Graph) -> np.ndarray:
    """Vectorized greedy coloring in vertex-id order (dense entry point)."""
    return color_greedy_csr(CSRGraph.from_dense(g))


COLORING_ALGORITHMS = {
    "bfs": color_bfs,
    "dsatur": color_dsatur,
    "welsh_powell": color_welsh_powell,
    "ldf": color_ldf,
    "jones_plassmann": color_jones_plassmann_dense,
    "greedy": color_greedy,
}

# coloring algorithms with a sparse (CSRGraph) implementation
SPARSE_COLORINGS = ("bfs", "jones_plassmann", "greedy")


def color_graph(g: Graph, algorithm: str = "bfs", root: int = 0) -> np.ndarray:
    if isinstance(g, CSRGraph):
        if algorithm == "bfs":
            return color_bfs_csr(g, root)
        if algorithm == "jones_plassmann":
            return color_jones_plassmann(g)
        if algorithm == "greedy":
            return color_greedy_csr(g)
        if algorithm in COLORING_ALGORITHMS:
            raise ValueError(
                f"coloring algorithm {algorithm!r} has no sparse "
                f"implementation; CSRGraph supports {SPARSE_COLORINGS}")
        raise ValueError(f"unknown coloring algorithm {algorithm!r}")
    if algorithm == "bfs":
        return color_bfs(g, root)
    try:
        return COLORING_ALGORITHMS[algorithm](g)
    except KeyError:
        raise ValueError(f"unknown coloring algorithm {algorithm!r}") from None


def is_proper_coloring(g: Graph, colors: np.ndarray) -> bool:
    if isinstance(g, CSRGraph):
        u, v, _ = g.edges_arrays()
        colors = np.asarray(colors)
        return bool(len(u) == 0 or (colors[u] != colors[v]).all())
    for u, v, _ in g.edges():
        if colors[u] == colors[v]:
            return False
    return True


# ---------------------------------------------------------------------------
# Slot length (paper III-C)
# ---------------------------------------------------------------------------


def slot_length_s(
    ping_max_ms: float, model_size_mb: float, ping_size_bytes: float
) -> float:
    """Paper formula: slot = ping_max × M_size × 1000 / ping_size  (seconds).

    ping_max in milliseconds, model size in MB, ping payload in bytes.
    Intuition: the ping measured `ping_size` bytes taking `ping_max` ms, so a
    `M_size` MB payload takes ping_max(ms) × (M_size·1e6 / ping_size) ≈
    ping_max × M_size × 1000 / ping_size seconds (ms→s absorbs a factor 1e3).
    """
    if ping_size_bytes <= 0:
        raise ValueError("ping payload size must be positive")
    return ping_max_ms * model_size_mb * 1000.0 / ping_size_bytes


def slot_length_for_colors(
    g: Graph,
    colors: np.ndarray,
    model_size_mb: float,
    ping_size_bytes: float = 64.0,
    network=None,
) -> float:
    """Moderator's slot computation: max ping among same-colored senders.

    For each node, its max ping to neighbours; then the max of those values
    over nodes sharing a color (the slot must cover the slowest same-slot
    transfer).

    With ``network`` (anything :func:`repro_torch.core.network.as_network_model`
    accepts) the ping extrapolation is replaced by the analytic bottleneck
    model on the declared underlay — the slot covers the slowest
    same-colored multicast including link contention, not just raw latency
    (:func:`repro_torch.core.network.slot_length_for_network`).
    """
    if network is not None:
        from .network import slot_length_for_network  # lazy: no cycle

        return slot_length_for_network(g, colors, network, model_size_mb)
    per_node_max = np.zeros(g.n)
    if isinstance(g, CSRGraph):
        src = np.repeat(np.arange(g.n, dtype=np.int64), g.degrees)
        np.maximum.at(per_node_max, src, g.data)
    else:
        for u in range(g.n):
            ns = g.neighbors(u)
            per_node_max[u] = max((g.adj[u, v] for v in ns), default=0.0)
    ping_max = 0.0
    for c in np.unique(colors):
        grp = per_node_max[colors == c]
        if grp.size:
            ping_max = max(ping_max, float(grp.max()))
    return slot_length_s(ping_max, model_size_mb, ping_size_bytes)


# ---------------------------------------------------------------------------
# Topology generators (paper IV-B: complete, Erdős–Rényi, Watts–Strogatz,
# Barabási–Albert). Deterministic given a seed; costs model the paper's
# testbed: 3 router subnets, cheap intra-subnet links, expensive inter-subnet.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TopologySpec:
    # dense kinds: complete | erdos_renyi | watts_strogatz | barabasi_albert
    # sparse kinds (CSRGraph, O(E) memory): knn | ring | torus | power_law
    kind: str
    n: int = 10
    seed: int = 0
    p: float = 0.45  # ER edge prob
    k: int = 4  # WS ring degree; also knn neighbour count / ring lattice degree
    beta: float = 0.3  # WS rewire prob
    m: int = 2  # BA attachment count; also power_law mean degree / 2
    n_subnets: int = 3
    intra_cost_ms: Tuple[float, float] = (0.4, 1.5)  # local-link ping range
    inter_cost_ms: Tuple[float, float] = (8.0, 40.0)  # router-hop ping range
    alpha: float = 2.5  # power_law degree exponent
    max_degree: int = 64  # power_law per-node degree bound

    def subnet(self, node: int) -> int:
        """Which router subnet a node lives behind (the one true mapping —
        the underlay (:class:`repro_torch.core.netsim.TestbedSpec`) derives its
        routing from this same function, so overlay edge costs and underlay
        routing can never disagree)."""
        return subnet_of(node, self.n, self.n_subnets)


def subnet_of(node: int, n: int, n_subnets: int) -> int:
    """Canonical node -> subnet assignment (contiguous equal-size blocks).

    Shared by the overlay cost model (:func:`make_topology`) and the physical
    underlay (:class:`repro_torch.core.netsim.TestbedSpec`).
    """
    return node * n_subnets // n


def _edge_cost(u: int, v: int, spec: TopologySpec, rng: np.random.Generator) -> float:
    same = spec.subnet(u) == spec.subnet(v)
    lo, hi = spec.intra_cost_ms if same else spec.inter_cost_ms
    return float(rng.uniform(lo, hi))


# ---------------------------------------------------------------------------
# Sparse generators: O(E) edge-array construction, no dense matrix. The cost
# model matches the dense kinds (subnet-aware intra/inter ping ranges) but is
# drawn vectorized, one uniform per edge in sorted (u, v) order.
# ---------------------------------------------------------------------------


def _sparse_edge_costs(u: np.ndarray, v: np.ndarray,
                       spec: TopologySpec,
                       rng: np.random.Generator) -> np.ndarray:
    """Vectorized subnet-aware costs for edge arrays (the `_edge_cost` rule)."""
    su = (u * np.int64(spec.n_subnets)) // np.int64(spec.n)
    sv = (v * np.int64(spec.n_subnets)) // np.int64(spec.n)
    same = su == sv
    r = rng.uniform(size=len(u))
    intra = spec.intra_cost_ms[0] + r * (spec.intra_cost_ms[1]
                                         - spec.intra_cost_ms[0])
    inter = spec.inter_cost_ms[0] + r * (spec.inter_cost_ms[1]
                                         - spec.inter_cost_ms[0])
    return np.where(same, intra, inter)


def _dedup_pairs(n: int, u: np.ndarray, v: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Canonical unique undirected pairs (lo < hi, sorted), loops dropped."""
    lo, hi = np.minimum(u, v), np.maximum(u, v)
    keep = lo != hi
    key = np.unique(lo[keep] * np.int64(n) + hi[keep])
    return key // n, key % n


def _stitch_components(n: int, u: np.ndarray,
                       v: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Chain the component roots so the graph is connected (the sparse
    analogue of the dense generator's consecutive-component stub links)."""
    from .sparse import union_edges  # local alias of the shared routine

    labels = union_edges(n, u, v)
    roots = np.unique(labels)
    if len(roots) > 1:
        u = np.concatenate([u, roots[:-1]])
        v = np.concatenate([v, roots[1:]])
    return u, v


def _make_sparse_topology(spec: TopologySpec) -> CSRGraph:
    rng = np.random.default_rng(spec.seed)
    n = spec.n
    if spec.kind == "ring":
        # ring lattice: each node linked to its k/2 successors (mod n)
        k = max(2, spec.k - spec.k % 2)
        base = np.arange(n, dtype=np.int64)
        u = np.repeat(base, k // 2)
        off = np.tile(np.arange(1, k // 2 + 1, dtype=np.int64), n)
        v = (u + off) % n
    elif spec.kind == "torus":
        side = int(np.sqrt(n))
        if side * side != n:
            raise ValueError(f"torus topology needs a square n, got {n}")
        base = np.arange(n, dtype=np.int64)
        row, col = base // side, base % side
        right = row * side + (col + 1) % side
        down = ((row + 1) % side) * side + col
        u = np.concatenate([base, base])
        v = np.concatenate([right, down])
    elif spec.kind == "knn":
        # geometric k-NN: seeded points in the unit square; candidates come
        # from a window in grid-cell order (spatially clustered), so the
        # search is O(n·k) with no KD-tree and no n^2 distance matrix
        k = max(1, spec.k)
        pts = rng.uniform(size=(n, 2))
        grid = max(1, int(np.sqrt(n / max(k, 1))))
        cell = (pts[:, 1] * grid).astype(np.int64) * grid \
            + (pts[:, 0] * grid).astype(np.int64)
        order = np.argsort(cell, kind="stable")
        pos = np.empty(n, dtype=np.int64)
        pos[order] = np.arange(n)
        win = max(k, 4)
        offs = np.concatenate([np.arange(-win, 0), np.arange(1, win + 1)])
        cand_pos = np.clip(pos[:, None] + offs[None, :], 0, n - 1)
        cand = order[cand_pos]
        d2 = ((pts[:, None, :] - pts[cand]) ** 2).sum(axis=2)
        d2[cand == np.arange(n)[:, None]] = np.inf  # clipped self-windows
        kk = min(k, d2.shape[1])
        nearest = np.argpartition(d2, kk - 1, axis=1)[:, :kk]
        u = np.repeat(np.arange(n, dtype=np.int64), kk)
        v = np.take_along_axis(cand, nearest, axis=1).ravel()
    elif spec.kind == "power_law":
        # Chung–Lu style: endpoints drawn with probability ∝ rank^(-1/(α-1)),
        # then per-node degree capped at spec.max_degree (drop each node's
        # excess incidences beyond the bound)
        n_draws = max(1, spec.m) * n
        wgt = np.arange(1, n + 1, dtype=np.float64) ** (-1.0 / (spec.alpha - 1))
        p = wgt / wgt.sum()
        u = rng.choice(n, size=n_draws, p=p).astype(np.int64)
        v = rng.choice(n, size=n_draws, p=p).astype(np.int64)
        u, v = _dedup_pairs(n, u, v)
        eid = np.arange(len(u), dtype=np.int64)
        inc_node = np.concatenate([u, v])
        inc_edge = np.concatenate([eid, eid])
        order = np.lexsort((inc_edge, inc_node))
        node_sorted = inc_node[order]
        starts = np.flatnonzero(np.r_[True, node_sorted[1:] != node_sorted[:-1]])
        counts = np.diff(np.r_[starts, len(node_sorted)])
        rank = np.arange(len(node_sorted)) - np.repeat(starts, counts)
        over = np.zeros(len(u), dtype=bool)
        np.logical_or.at(over, inc_edge[order], rank >= spec.max_degree)
        u, v = u[~over], v[~over]
    else:
        raise ValueError(f"unknown sparse topology kind {spec.kind!r}")
    u, v = _dedup_pairs(n, u, v)
    u, v = _stitch_components(n, u, v)
    w = _sparse_edge_costs(u, v, spec, rng)
    return CSRGraph.from_edge_arrays(n, u, v, w)


def make_topology(spec: TopologySpec) -> Graph:
    """Generate a connected topology with subnet-aware costs.

    Dense kinds return a :class:`Graph`; the sparse kinds
    (``SPARSE_TOPOLOGY_KINDS``) return a :class:`CSRGraph` built from edge
    arrays — O(E) memory, so ``n`` can reach the million-node scale.
    """
    if spec.kind in SPARSE_TOPOLOGY_KINDS:
        return _make_sparse_topology(spec)
    rng = np.random.default_rng(spec.seed)
    n = spec.n
    edges: set = set()

    def add(u: int, v: int) -> None:
        if u != v:
            edges.add((min(u, v), max(u, v)))

    if spec.kind == "complete":
        for u in range(n):
            for v in range(u + 1, n):
                add(u, v)
    elif spec.kind == "erdos_renyi":
        for u in range(n):
            for v in range(u + 1, n):
                if rng.uniform() < spec.p:
                    add(u, v)
    elif spec.kind == "watts_strogatz":
        k = max(2, spec.k - spec.k % 2)
        for u in range(n):
            for j in range(1, k // 2 + 1):
                add(u, (u + j) % n)
        # rewire
        ring = sorted(edges)
        for (u, v) in ring:
            if rng.uniform() < spec.beta:
                w = int(rng.integers(0, n))
                if w != u and (min(u, w), max(u, w)) not in edges:
                    edges.discard((u, v))
                    add(u, w)
    elif spec.kind == "barabasi_albert":
        m = spec.m
        targets = list(range(m + 1))
        for u, v in [(i, j) for i in range(m + 1) for j in range(i + 1, m + 1)]:
            add(u, v)
        repeated: List[int] = []
        for u, v in list(edges):
            repeated += [u, v]
        for u in range(m + 1, n):
            chosen: set = set()
            while len(chosen) < m:
                pick = repeated[int(rng.integers(0, len(repeated)))]
                chosen.add(pick)
            for v in chosen:
                add(u, v)
                repeated += [u, v]
            repeated += [u] * m
    else:
        raise ValueError(f"unknown topology kind {spec.kind!r}")

    # ensure connectivity: link consecutive components through cheapest stub
    g = Graph.from_edges(n, [(u, v, 1.0) for u, v in edges])
    while not g.is_connected():
        seen = {0}
        stack = [0]
        while stack:
            x = stack.pop()
            for y in g.neighbors(x):
                if y not in seen:
                    seen.add(y)
                    stack.append(y)
        outside = [u for u in range(n) if u not in seen]
        add(min(seen), outside[0])
        g = Graph.from_edges(n, [(u, v, 1.0) for u, v in edges])

    return Graph.from_edges(n, [(u, v, _edge_cost(u, v, spec, rng)) for u, v in edges])


TOPOLOGY_KINDS = ("complete", "erdos_renyi", "watts_strogatz", "barabasi_albert")
SPARSE_TOPOLOGY_KINDS = ("knn", "ring", "torus", "power_law")
