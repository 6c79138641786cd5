"""Topology playground (``examples/topology_playground.py``, ported): how
MST+coloring behave across the paper's four graph families, at the paper's
N=10 and at N=32 nodes — plus the protocol matrix of the
communication-plan IR, the vectorized engine at sweep scale (N=1000), the
scenario and sweep front doors, and the underlay presets.

  PYTHONPATH=src python -m repro_torch.examples.topology_playground [--device cpu]

Everything but the queue engine's churn_storm run is host numpy; that run
moves its payloads on the card unless ``--device cpu``.
"""
import argparse
import time
from typing import List, Optional

from .. import resolve_device
from ..core import (
    TopologySpec,
    build_mst,
    color_graph,
    compile_dissemination,
    compile_flooding,
    compile_segmented,
    compile_tree_allreduce,
    make_policy,
    make_topology,
    measure_policy,
)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)

    print(f"{'topology':18s} {'N':>3s} {'edges':>6s} {'MST-cost':>9s} "
          f"{'slots':>6s} {'diss-tx':>8s} {'flood-tx':>9s} {'tree-tx':>8s} "
          f"{'seg-tx':>7s} {'seg-slots':>9s}")
    for kind in ("complete", "erdos_renyi", "watts_strogatz", "barabasi_albert"):
        for n in (10, 32):
            g = make_topology(TopologySpec(kind=kind, n=n, seed=1))
            mst = build_mst(g)
            colors = color_graph(mst)
            diss = compile_dissemination(mst, colors)
            tree = compile_tree_allreduce(mst, colors)
            flood = compile_flooding(g)
            seg = compile_segmented(mst, colors, n_segments=4)
            print(f"{kind:18s} {n:3d} {len(g.edges()):6d} "
                  f"{mst.total_cost():9.2f} {diss.n_slots:6d} "
                  f"{diss.total_transmissions():8d} "
                  f"{flood.total_transmissions():9d} "
                  f"{tree.total_transmissions():8d} "
                  f"{seg.total_transmissions():7d} "
                  f"{seg.n_slots:9d}")
    print("\n(diss-tx is always N(N-1) — the MST removes every redundant "
          "transmission; flooding repeats each model on every overlay edge; "
          "segmented gossip ships 4x the transfers at 1/4 the bytes each — "
          "same total traffic, pipelined into shorter transfers.)")

    # every protocol is one IR policy; the registry builds them all
    g = make_topology(TopologySpec(kind="erdos_renyi", n=10, seed=1))
    print("\nprotocol matrix on ER(10) (one policy each, reference executor):")
    for name in ("flooding", "dissemination", "segmented", "tree_allreduce"):
        stats = measure_policy(make_policy(name, g))
        print(f"  {name:15s} slots={stats['n_slots']:4d} "
              f"tx={stats['transmissions']:5d} "
              f"peak-concurrency={stats['max_concurrent_sends']:4d}")

    # vectorized slot advance: the same policy at topology-sweep scale
    g1k = make_topology(TopologySpec(kind="watts_strogatz", n=1000, seed=1))
    t0 = time.monotonic()
    stats = measure_policy(make_policy("dissemination", g1k))
    dt = time.monotonic() - t0
    print(f"\nvectorized engine, N=1000 watts_strogatz: "
          f"{stats['transmissions']} transmissions over {stats['n_slots']} "
          f"slots simulated in {dt:.2f}s")

    # MST algorithms agree; colorings are 2-chromatic
    g = make_topology(TopologySpec(kind="erdos_renyi", n=24, seed=7))
    costs = {a: build_mst(g, a).total_cost() for a in ("prim", "kruskal", "boruvka")}
    print("\nMST algorithm agreement on ER(24):", costs)
    print("BFS colors used:", sorted(set(color_graph(build_mst(g)).tolist())))

    # the declarative front door: a scenario is declared once (overlay +
    # derived underlay + protocol + payload + churn) and runs on any executor
    from ..scenario import executors, scenarios
    from ..scenario.executors import EngineExecutor

    print(f"\nscenario registry: {scenarios.names()}")
    cs = None
    runners = {"netsim": executors.get("netsim"), "engine": EngineExecutor(device=dev)}
    for name, executor in (("paper_table3", "netsim"), ("churn_storm", "engine")):
        res = runners[executor].execute(scenarios.get(name))
        if name == "churn_storm":
            cs = res
        t = "" if res.total_time_s is None else f" sim-time={res.total_time_s:.1f}s"
        print(f"  {name:18s} [{executor}] rounds={len(res.rounds)} "
              f"tx={res.total_transmissions} "
              f"bytes={res.total_bytes_mb:.0f}MB drops={res.total_drops}{t}")
    print("  churn_storm membership per round:",
          [len(r.members) for r in cs.rounds],
          "| moderators:", [r.moderator for r in cs.rounds])

    # the sweep front door: a whole experiment grid is one call — here the
    # paper's Tables III-V grid (topology x payload x protocol, 32 cells) on
    # the batched counting executor, with one MST/coloring per topology
    from ..scenario import run_sweep

    print(f"\nsweep registry: {scenarios.sweep_names()}")
    t0 = time.monotonic()
    table3 = run_sweep(scenarios.get_sweep("table3_full"), executor="plan")
    dt = time.monotonic() - t0
    cache = table3.cache_stats
    print(f"table3_full: {len(table3.cells)} cells in {dt:.2f}s "
          f"({cache['unique_policies']} unique plans, "
          f"{cache['policy_hits']} cache hits)")
    for proto, m in table3.marginals()["protocol"].items():
        print(f"  {proto:20s} mean-tx={m['mean_transmissions']:6.1f} "
              f"mean-wire={m['mean_bytes_on_wire_mb']:8.1f}MB "
              f"over {m['cells']} cells")

    # the underlay front door: the same overlay + schedule timed on
    # different physical networks via the analytic model (plan executor) —
    # the paper's model-size-vs-transfer-time question, per network preset
    from ..core.network import NETWORK_PRESETS
    from ..scenario import ScenarioSpec, SweepSpec

    payloads = ("v3s", "v2", "b0", "v3l", "b1", "b2", "b3")
    curve = run_sweep(SweepSpec(
        name="underlay_curves",
        base=ScenarioSpec(
            overlay=TopologySpec(kind="erdos_renyi", n=10, seed=3),
            protocol="mosgu", rounds=1),
        grid={"underlay": ("paper_lan", "wan"), "payload": payloads}),
        executor="plan")
    print(f"\nunderlay presets: {sorted(NETWORK_PRESETS)}")
    print("round time (s) by payload, analytic timing on the plan executor:")
    times = {c.coords["underlay"]: {} for c in curve.cells}
    for c in curve.cells:
        times[c.coords["underlay"]][c.coords["payload"]] = \
            c.result.total_time_s
    print(f"  {'payload':8s} " + " ".join(f"{p:>7s}" for p in payloads))
    for preset, row in times.items():
        print(f"  {preset:8s} " + " ".join(f"{row[p]:7.1f}" for p in payloads))
    slow = [p for p in payloads if times["wan"][p] <= times["paper_lan"][p]]
    assert not slow, f"WAN should be slower than the paper LAN: {slow}"
    print("  (the WAN's chained 8 MB/s trunks + 1.2s hop latency dominate "
          "as the model grows — the paper's latency-vs-size correlation, "
          "reproduced per underlay at counting speed)")


if __name__ == "__main__":
    main()
