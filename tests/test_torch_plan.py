"""The port's control-plane copy against the JAX package's, in-process.

For the overlays of the slice's scenarios, with and without a churned
member, ``plan_for_members`` must lower to the same permutation steps
(``perm``, ``send_payload``, ``recv_payload``), buffer rows and
transmission counts as ``repro.dfl.session._plan_for_members``. A stub with
``.shape`` stands in for the JAX mesh.
"""
import types

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core.graph import TopologySpec as JaxTopologySpec  # noqa: E402
from repro.core.graph import make_topology as jax_make_topology  # noqa: E402
from repro.dfl.collectives import GossipPlan as JaxGossipPlan  # noqa: E402
from repro.dfl.session import _plan_for_members  # noqa: E402
from repro.scenario import scenarios  # noqa: E402
from repro_torch.core.graph import make_topology  # noqa: E402
from repro_torch.dfl.collectives import GossipPlan  # noqa: E402
from repro_torch.dfl.session import plan_for_members  # noqa: E402
from repro_torch.scenario import SCENARIOS  # noqa: E402

NAMES = ("paper_table3", "quantized_table3", "topk_sweep", "mesh_smoke", "churn_storm")


def _mesh(n, pods=1):
    shape = {"data": n} if pods == 1 else {"pod": pods, "data": n // pods}
    return types.SimpleNamespace(shape=shape)


def _assert_steps_equal(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.perm == b.perm
        np.testing.assert_array_equal(a.send_payload, b.send_payload)
        np.testing.assert_array_equal(a.recv_payload, b.recv_payload)


def _assert_plans_equal(ours, theirs):
    assert ours.n_nodes == theirs.n_nodes
    np.testing.assert_array_equal(ours.colors, theirs.colors)
    np.testing.assert_array_equal(ours.mst.adj, theirs.mst.adj)
    for a, b in ((ours.dissemination, theirs.dissemination), (ours.tree, theirs.tree)):
        assert a.n_slots == b.n_slots
        assert a.total_transmissions() == b.total_transmissions()
        assert [s.sends for s in a.slots] == [s.sends for s in b.slots]
    assert (ours.segmented is None) == (theirs.segmented is None)
    if ours.segmented is not None:
        assert ours.segmented.total_transmissions() == theirs.segmented.total_transmissions()
        assert ours.segmented.payload_fraction == theirs.segmented.payload_fraction
    _assert_steps_equal(ours.diss_steps, theirs.diss_steps)
    _assert_steps_equal(ours.tree_steps, theirs.tree_steps)
    _assert_steps_equal(ours.seg_steps, theirs.seg_steps)
    assert ours.n_tree_reduce_steps == theirs.n_tree_reduce_steps
    assert ours.mixing_matchings == theirs.mixing_matchings
    if theirs.node_slot is None:
        assert ours.node_slot is None
    else:
        np.testing.assert_array_equal(ours.node_slot, theirs.node_slot)


@pytest.mark.parametrize("name", NAMES)
def test_overlay_matches_jax(name):
    spec = scenarios.get(name)
    ours = make_topology(SCENARIOS[name].overlay)
    np.testing.assert_array_equal(ours.adj, jax_make_topology(spec.overlay).adj)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("churned", (None, 0, 3))
def test_plan_for_members_matches_jax(name, churned):
    spec = scenarios.get(name)
    overlay = spec.overlay_graph()
    members = set(range(spec.n)) - ({churned} if churned is not None else set())
    theirs = _plan_for_members(_mesh(spec.n), ("data",), members,
                               n_segments=spec.n_segments, full_graph=overlay)
    ours = plan_for_members(spec.n, members, n_segments=spec.n_segments,
                            full_graph=make_topology(SCENARIOS[name].overlay))
    _assert_plans_equal(ours, theirs)
    assert ours.phys_n_nodes == theirs.phys_n_nodes


@pytest.mark.parametrize("n,pods", [(1, 1), (2, 1), (4, 1), (8, 1), (4, 2), (8, 2)])
def test_gossip_plan_build_matches_jax(n, pods):
    axes = ("data",) if pods == 1 else ("pod", "data")
    theirs = JaxGossipPlan.build(_mesh(n, pods), axes, n_segments=3)
    ours = GossipPlan.build(n, n_segments=3, n_pods=pods)
    _assert_plans_equal(ours, theirs)


@pytest.mark.parametrize("kind,n,seed", [("complete", 5, 1), ("erdos_renyi", 12, 7),
                                         ("erdos_renyi", 30, 2), ("watts_strogatz", 16, 9)])
def test_generated_topologies_match_jax(kind, n, seed):
    from repro_torch.core.graph import TopologySpec

    ours = make_topology(TopologySpec(kind=kind, n=n, seed=seed, p=0.2))
    theirs = jax_make_topology(JaxTopologySpec(kind=kind, n=n, seed=seed, p=0.2))
    np.testing.assert_array_equal(ours.adj, theirs.adj)


def test_unported_algorithms_raise():
    """Names neither package knows raise by name; the algorithms the port
    once lacked (Kruskal, DSatur, the sparse kinds) now give the
    reference's outputs."""
    from repro.core.graph import build_mst as jax_build_mst
    from repro.core.graph import color_graph as jax_color_graph
    from repro_torch.core.graph import TopologySpec, build_mst, color_graph

    g = make_topology(TopologySpec(kind="complete", n=4))
    with pytest.raises(ValueError, match="unknown MST algorithm 'kruskal2'"):
        build_mst(g, "kruskal2")
    with pytest.raises(ValueError, match="unknown coloring algorithm 'dsatur2'"):
        color_graph(g, "dsatur2")
    with pytest.raises(ValueError, match="unknown topology kind 'knn2'"):
        make_topology(TopologySpec(kind="knn2", n=4))
    jg = jax_make_topology(JaxTopologySpec(kind="complete", n=4))
    np.testing.assert_array_equal(build_mst(g, "kruskal").adj, jax_build_mst(jg, "kruskal").adj)
    np.testing.assert_array_equal(color_graph(g, "dsatur"), jax_color_graph(jg, "dsatur"))
    knn = make_topology(TopologySpec(kind="knn", n=4))
    np.testing.assert_array_equal(knn.indices, jax_make_topology(
        JaxTopologySpec(kind="knn", n=4)).indices)
