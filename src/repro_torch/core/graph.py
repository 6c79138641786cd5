"""Graph substrate: adjacency matrices, Prim's MST, BFS coloring, topologies.

A trimmed copy of ``repro.core.graph`` (dense graphs only; the CSR kinds
(``SPARSE_TOPOLOGY_KINDS``) and the alternative MST/coloring algorithms are
not on the port's path and raise by name). Pure
numpy: it runs on the moderator, and its outputs (MST edges, colors) are the
static inputs of the slot plans in :mod:`repro_torch.core.plan`.
"""
from __future__ import annotations

import heapq
from collections import deque
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np


@dataclass
class Graph:
    """Undirected weighted graph backed by a dense adjacency matrix.

    ``adj[i, j] > 0`` means an edge of that cost; ``0`` means no edge.
    """

    adj: np.ndarray

    def __post_init__(self) -> None:
        adj = np.asarray(self.adj, dtype=np.float64)
        if adj.ndim != 2 or adj.shape[0] != adj.shape[1]:
            raise ValueError(f"adjacency must be square, got {adj.shape}")
        if not np.allclose(adj, adj.T):
            # per-direction cost reports are symmetrized by averaging
            adj = (adj + adj.T) / 2.0
        np.fill_diagonal(adj, 0.0)
        if (adj < 0).any():
            raise ValueError("edge costs must be non-negative")
        self.adj = adj
        self._adjacency: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None

    @property
    def n(self) -> int:
        return self.adj.shape[0]

    def _csr_view(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Memoized (indptr, indices, data) adjacency, neighbours ascending."""
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
        """All undirected edges as (u, v, cost), u < v, row-major order."""
        indptr, indices, data = self._csr_view()
        u = np.repeat(np.arange(self.n, dtype=np.int64), np.diff(indptr))
        mask = u < indices
        return [(int(a), int(b), float(c))
                for a, b, c in zip(u[mask], indices[mask], data[mask])]

    def neighbors(self, u: int) -> List[int]:
        indptr, indices, _ = self._csr_view()
        return indices[indptr[u]:indptr[u + 1]].tolist()

    def is_connected(self) -> bool:
        if self.n == 0:
            return True
        seen = np.zeros(self.n, dtype=bool)
        seen[0] = True
        stack = [0]
        while stack:
            for v in self.neighbors(stack.pop()):
                if not seen[v]:
                    seen[v] = True
                    stack.append(v)
        return bool(seen.all())

    @classmethod
    def from_edges(cls, n: int, edges: Iterable[Tuple[int, int, float]]) -> "Graph":
        adj = np.zeros((n, n))
        for u, v, c in edges:
            adj[u, v] = adj[v, u] = c
        return cls(adj)

    @classmethod
    def from_cost_reports(cls, n: int, reports: Dict[int, Dict[int, float]]) -> "Graph":
        """Build from per-node directed cost reports (the moderator's view):
        ``reports[u][v]`` is node u's measured cost to v; the two directions
        are averaged when both are present (paper III-A)."""
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


def mst_prim(g: Graph, root: int = 0) -> Graph:
    """Prim's algorithm with a binary heap (the paper's choice, III-B)."""
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


def build_mst(g: Graph, algorithm: str = "prim") -> Graph:
    if algorithm != "prim":
        raise ValueError(f"the port implements the 'prim' MST only, got {algorithm!r}")
    return mst_prim(g)


def color_bfs(g: Graph, root: int = 0) -> np.ndarray:
    """BFS coloring; on a tree this yields exactly 2 colors. Conflicts on a
    non-bipartite input are repaired greedily (MSTs never need it)."""
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
    for u in range(n):
        used = {int(colors[v]) for v in g.neighbors(u)}
        if int(colors[u]) in used:
            c = 0
            while c in used:
                c += 1
            colors[u] = c
    return colors


def color_graph(g: Graph, algorithm: str = "bfs") -> np.ndarray:
    if algorithm != "bfs":
        raise ValueError(f"the port implements the 'bfs' coloring only, got {algorithm!r}")
    return color_bfs(g)


def slot_length_s(ping_max_ms: float, model_size_mb: float, ping_size_bytes: float) -> float:
    """Paper formula: slot = ping_max x M_size x 1000 / ping_size (seconds),
    ping_max in ms, the model size in MB, the ping payload in bytes."""
    if ping_size_bytes <= 0:
        raise ValueError("ping payload size must be positive")
    return ping_max_ms * model_size_mb * 1000.0 / ping_size_bytes


def slot_length_for_colors(g: Graph, colors: np.ndarray, model_size_mb: float,
                           ping_size_bytes: float = 64.0) -> float:
    """The moderator's slot: the max over colors of the largest ping any
    node of that color has to a neighbour (the ping model only; the
    underlay-aware slot of the JAX package is not on the port's path)."""
    per_node_max = np.zeros(g.n)
    for u in range(g.n):
        per_node_max[u] = max((g.adj[u, v] for v in g.neighbors(u)), default=0.0)
    ping_max = 0.0
    for c in np.unique(colors):
        grp = per_node_max[colors == c]
        if grp.size:
            ping_max = max(ping_max, float(grp.max()))
    return slot_length_s(ping_max, model_size_mb, ping_size_bytes)


# ---------------------------------------------------------------------------
# Topology generators (paper IV-B), dense kinds. Deterministic given a seed;
# costs model the paper's testbed: cheap intra-subnet, expensive inter-subnet.
# ---------------------------------------------------------------------------

TOPOLOGY_KINDS = ("complete", "erdos_renyi", "watts_strogatz", "barabasi_albert")
SPARSE_TOPOLOGY_KINDS = ("knn", "ring", "torus", "power_law")


@dataclass(frozen=True)
class TopologySpec:
    """The reference's fields in its order (so ``to_dict`` matches); ``alpha``
    and ``max_degree`` only shape the sparse kinds, which the port lacks."""

    kind: str  # complete | erdos_renyi | watts_strogatz | barabasi_albert
    n: int = 10
    seed: int = 0
    p: float = 0.45  # ER edge prob
    k: int = 4  # WS ring degree
    beta: float = 0.3  # WS rewire prob
    m: int = 2  # BA attachment count
    n_subnets: int = 3
    intra_cost_ms: Tuple[float, float] = (0.4, 1.5)
    inter_cost_ms: Tuple[float, float] = (8.0, 40.0)
    alpha: float = 2.5  # power_law degree exponent
    max_degree: int = 64  # power_law per-node degree bound

    def subnet(self, node: int) -> int:
        return subnet_of(node, self.n, self.n_subnets)


def subnet_of(node: int, n: int, n_subnets: int) -> int:
    """Canonical node -> subnet assignment (contiguous equal-size blocks)."""
    return node * n_subnets // n


def _edge_cost(u: int, v: int, spec: TopologySpec, rng: np.random.Generator) -> float:
    same = spec.subnet(u) == spec.subnet(v)
    lo, hi = spec.intra_cost_ms if same else spec.inter_cost_ms
    return float(rng.uniform(lo, hi))


def make_topology(spec: TopologySpec) -> Graph:
    """Generate a connected dense topology with subnet-aware costs."""
    if spec.kind not in TOPOLOGY_KINDS:
        raise ValueError(f"unknown topology kind {spec.kind!r}; the port generates "
                         f"{TOPOLOGY_KINDS} (the sparse kinds {SPARSE_TOPOLOGY_KINDS} "
                         "are not ported)")
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
        for (u, v) in sorted(edges):
            if rng.uniform() < spec.beta:
                w = int(rng.integers(0, n))
                if w != u and (min(u, w), max(u, w)) not in edges:
                    edges.discard((u, v))
                    add(u, w)
    else:  # barabasi_albert: the set's iteration order decides the seed list
        m = spec.m
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

    # ensure connectivity: link consecutive components through a stub edge
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
