"""The port's sparse planner against the JAX package's, on the CPU.

* ``make_topology`` of every sparse kind gives the reference's CSR arrays
  and costs, over several seeds and sizes.
* Every MST algorithm, dense (Prim, Kruskal, Borůvka) and CSR (the
  vectorized Borůvka behind every name), gives the reference's edge set
  and total cost; every coloring algorithm gives identical colors.
* The CSR substrate (``union_edges``, ``connected_components``,
  ``mst_edge_selection``, the constructors, ``subgraph`` / ``to_dense``)
  equals the reference's array for array.
* ``SparsePlanner.plan`` and ``.replan`` over the reference test's churn
  sequences give ``MemberPlan``s equal field for field (the carried
  tombstoned adjacency too), and the port's replan equals its own
  from-scratch plan.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import graph as jg  # noqa: E402
from repro.core import replan as jr  # noqa: E402
from repro.core import sparse as js  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.core import replan as tr  # noqa: E402
from repro_torch.core import sparse as ts  # noqa: E402

SPARSE_KINDS = ("knn", "ring", "torus", "power_law")
DENSE_KINDS = ("complete", "erdos_renyi", "watts_strogatz", "barabasi_albert")
# torus needs a square n
SIZES = ((100, 0, 4), (144, 3, 6), (400, 11, 8))


def _pair(kind, n, seed, **kw):
    return (tg.make_topology(tg.TopologySpec(kind=kind, n=n, seed=seed, **kw)),
            jg.make_topology(jg.TopologySpec(kind=kind, n=n, seed=seed, **kw)))


def _csr_equal(a, b):
    assert type(a).__name__ == type(b).__name__ == "CSRGraph"
    assert a.n == b.n
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert getattr(a, f).dtype == getattr(b, f).dtype


def _plan_fields_equal(a, b):
    for f in ("members", "tree_u", "tree_v", "tree_w", "colors"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    if b.adj_indptr is None:
        assert a.adj_indptr is None
    else:
        np.testing.assert_array_equal(a.adj_indptr, b.adj_indptr)
        np.testing.assert_array_equal(a.adj_dst, b.adj_dst)


@pytest.mark.parametrize("n,seed,k", SIZES)
@pytest.mark.parametrize("kind", SPARSE_KINDS)
def test_sparse_topologies_match_the_reference(kind, n, seed, k):
    ours, theirs = _pair(kind, n, seed, k=k)
    _csr_equal(ours, theirs)
    assert ours.is_connected() and ours.n_edges == theirs.n_edges
    for a, b in zip(ours.sorted_edges(), theirs.sorted_edges()):
        np.testing.assert_array_equal(a, b)


def test_torus_rejects_a_non_square_n():
    with pytest.raises(ValueError, match="torus topology needs a square n, got 10"):
        tg.make_topology(tg.TopologySpec(kind="torus", n=10))


@pytest.mark.parametrize("kind", DENSE_KINDS)
@pytest.mark.parametrize("algorithm", ("prim", "kruskal", "boruvka"))
def test_dense_msts_match_the_reference(kind, algorithm):
    ours, theirs = _pair(kind, 24, 3)
    a, b = tg.build_mst(ours, algorithm), jg.build_mst(theirs, algorithm)
    np.testing.assert_array_equal(a.adj, b.adj)
    assert a.total_cost() == b.total_cost()
    # the CSR Borůvka of the same graph: the same tree under the total order
    c = ts.mst_boruvka_csr(ts.CSRGraph.from_dense(ours))
    _csr_equal(c, js.mst_boruvka_csr(js.CSRGraph.from_dense(theirs)))
    assert c.total_cost() == pytest.approx(a.total_cost())


@pytest.mark.parametrize("kind", SPARSE_KINDS)
@pytest.mark.parametrize("algorithm", ("prim", "kruskal", "boruvka"))
def test_csr_msts_match_the_reference(kind, algorithm):
    ours, theirs = _pair(kind, 121 if kind == "torus" else 130, 2, k=5)
    a, b = tg.build_mst(ours, algorithm), jg.build_mst(theirs, algorithm)
    _csr_equal(a, b)
    assert a.n_edges == ours.n - 1 and a.is_connected()
    with pytest.raises(ValueError, match="unknown MST algorithm 'nope'"):
        tg.build_mst(ours, "nope")


@pytest.mark.parametrize("algorithm", sorted(jg.COLORING_ALGORITHMS))
@pytest.mark.parametrize("kind", ("erdos_renyi", "barabasi_albert"))
def test_dense_colorings_match_the_reference(algorithm, kind):
    assert sorted(tg.COLORING_ALGORITHMS) == sorted(jg.COLORING_ALGORITHMS)
    ours, theirs = _pair(kind, 30, 5)
    for g, h in ((ours, theirs), (tg.mst_prim(ours), jg.mst_prim(theirs))):
        got, want = tg.color_graph(g, algorithm), jg.color_graph(h, algorithm)
        np.testing.assert_array_equal(got, want)
        assert tg.is_proper_coloring(g, got)


@pytest.mark.parametrize("algorithm", ("bfs", "jones_plassmann", "greedy", "dsatur"))
@pytest.mark.parametrize("kind", SPARSE_KINDS)
def test_csr_colorings_match_the_reference(algorithm, kind):
    ours, theirs = _pair(kind, 144, 4, k=6)
    if algorithm not in tg.SPARSE_COLORINGS:
        with pytest.raises(ValueError, match="has no sparse implementation"):
            tg.color_graph(ours, algorithm)
        return
    for g, h in ((ours, theirs), (tg.build_mst(ours, "boruvka"), jg.build_mst(theirs, "boruvka"))):
        got = tg.color_graph(g, algorithm)
        np.testing.assert_array_equal(got, jg.color_graph(h, algorithm))
        assert tg.is_proper_coloring(g, got)
    for seed in (0, 7):
        np.testing.assert_array_equal(ts.color_jones_plassmann(ours, seed=seed),
                                      js.color_jones_plassmann(theirs, seed=seed))


def test_csr_substrate_matches_the_reference():
    rng = np.random.default_rng(3)
    n = 60
    u, v = rng.integers(0, n, 150), rng.integers(0, n, 150)
    keep = u != v
    u, v, w = u[keep], v[keep], rng.uniform(0.1, 9.0, keep.sum())
    np.testing.assert_array_equal(ts.union_edges(n, u, v), js.union_edges(n, u, v))
    cu, lu = ts.connected_components(n, u, v)
    cj, lj = js.connected_components(n, u, v)
    assert cu == cj
    np.testing.assert_array_equal(lu, lj)
    a = ts.CSRGraph.from_edge_arrays(n, u, v, w)
    b = js.CSRGraph.from_edge_arrays(n, u, v, w)
    _csr_equal(a, b)
    eu, ev, _ = a.sorted_edges()
    np.testing.assert_array_equal(ts.mst_edge_selection(n, eu, ev),
                                  js.mst_edge_selection(n, *b.sorted_edges()[:2]))
    edges = [(int(x), int(y), float(c)) for x, y, c in zip(u, v, w)]
    _csr_equal(ts.CSRGraph.from_edges(n, edges), js.CSRGraph.from_edges(n, edges))
    reports = {}
    for x, y, c in edges:
        reports.setdefault(x, {})[y] = c
    _csr_equal(ts.CSRGraph.from_cost_reports(n, reports),
               js.CSRGraph.from_cost_reports(n, reports))
    members = sorted(rng.choice(n, 40, replace=False).tolist())
    _csr_equal(a.subgraph(members), b.subgraph(members))
    np.testing.assert_array_equal(a.to_dense().adj, b.to_dense().adj)
    assert a.is_connected() == b.is_connected()
    rank = rng.permutation(n).astype(np.int64)
    np.testing.assert_array_equal(ts.color_priority_greedy(a.indptr, a.indices, rank),
                                  js.color_priority_greedy(b.indptr, b.indices, rank))
    np.testing.assert_array_equal(ts.color_greedy_csr(a), js.color_greedy_csr(b))
    np.testing.assert_array_equal(ts.color_bfs_csr_from(a, 5), js.color_bfs_csr_from(b, 5))


def _churned(rng, n, members):
    """One random churn delta over ``members`` (the reference test's draws)."""
    cur = set(members)
    n_leave = int(rng.integers(0, max(2, len(cur) // 4)))
    leaves = rng.choice(sorted(cur), size=min(n_leave, len(cur) - 3), replace=False)
    cur -= set(int(x) for x in leaves)
    outside = sorted(set(range(n)) - cur)
    n_join = int(rng.integers(0, max(2, n // 4)))
    if outside and n_join:
        joins = rng.choice(outside, size=min(n_join, len(outside)), replace=False)
        cur |= set(int(x) for x in joins)
    return sorted(cur)


def _reference_sequences():
    """The reference test's churn sequences
    (``tests/test_sparse.py::TestReplan``): one ``default_rng(7)`` stream
    drawing each trial's size and four churn deltas, which depend on the
    draws alone, never on the planner's outcome."""
    rng = np.random.default_rng(7)
    out = []
    for trial in range(6):
        kind = ("knn", "ring", "power_law")[trial % 3]
        n = int(rng.integers(30, 100))
        members, seq = list(range(n)), []
        for _ in range(4):
            members = _churned(rng, n, members)
            seq.append(members)
        out.append((kind, n, trial, seq))
    return out


SEQUENCES = _reference_sequences()


@pytest.mark.parametrize("kind,n,trial,seq", SEQUENCES,
                         ids=[f"trial{s[2]}-{s[0]}-n{s[1]}" for s in SEQUENCES])
def test_plan_and_replan_match_the_reference_over_churn(kind, n, trial, seq):
    ours, theirs = _pair(kind, n, trial, k=6)
    pl, pj = tr.SparsePlanner(ours, seed=trial), jr.SparsePlanner(theirs, seed=trial)
    plan, ref = pl.plan(range(n)), pj.plan(range(n))
    _plan_fields_equal(plan, ref)
    for members in seq:
        try:
            scratch = pj.plan(members)
        except ValueError:
            with pytest.raises(ValueError, match="disconnected"):
                pl.plan(members)
            with pytest.raises(ValueError, match="disconnected"):
                pl.replan(plan, members)
            continue
        _plan_fields_equal(pl.plan(members), scratch)
        plan, ref = pl.replan(plan, members), pj.replan(ref, members)
        _plan_fields_equal(plan, ref)
        assert tr.plan_equal(plan, pl.plan(members))
        mst, colors = plan.member_mst()
        want_mst, want_colors = ref.member_mst()
        _csr_equal(mst, want_mst)
        np.testing.assert_array_equal(colors, want_colors)


def test_leave_then_rejoin_round_trips_as_the_reference():
    ours, theirs = _pair("knn", 60, 0, k=6)
    pl, pj = tr.SparsePlanner(ours), jr.SparsePlanner(theirs)
    full = pl.plan(range(60))
    members = [m for m in range(60) if m not in (3, 17, 31)]
    shrunk, want = pl.replan(full, members), pj.replan(pj.plan(range(60)), members)
    _plan_fields_equal(shrunk, want)
    back = pl.replan(shrunk, range(60))
    _plan_fields_equal(back, pj.replan(want, range(60)))
    assert tr.plan_equal(back, full)
    again = pl.replan(back, range(60))
    assert tr.plan_equal(again, back)
    assert tr._compact_rank(np.array([30, 10, 20])).tolist() == \
        jr._compact_rank(np.array([30, 10, 20])).tolist() == [2, 0, 1]


def test_replan_compacts_a_holey_adjacency_as_the_reference():
    # many leaves, then rejoins: the tombstone sweep and the grow path run
    ours, theirs = _pair("power_law", 200, 5)
    pl, pj = tr.SparsePlanner(ours, seed=2), jr.SparsePlanner(theirs, seed=2)
    rng = np.random.default_rng(9)
    members = list(range(200))
    plan, ref = pl.plan(members), pj.plan(members)
    for _ in range(6):
        members = _churned(rng, 200, members)
        try:
            ref = pj.replan(ref, members)
        except ValueError:
            continue
        plan = pl.replan(plan, members)
        _plan_fields_equal(plan, ref)
