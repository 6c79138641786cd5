"""Quickstart (``examples/quickstart.py``, ported): the paper's MOSGU
pipeline on a 10-node testbed, end to end.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Covers: M (moderator + cost reports) -> O (MST) -> S (coloring + slots) ->
GU (a gossip round through the FIFO queue engine, the nodes' payloads
tensors on the card unless ``--device cpu``, averaged by
:func:`~repro_torch.core.gossip.fedavg`), then the comparison against
flooding broadcast that Tables III-V make, and a churn round.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..configs.paper_payloads import PAPER_PAYLOADS
from ..core import MOSGUProtocol, TopologySpec, make_topology
from ..core.netsim import TestbedSpec, compare_protocols


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)

    # ---- build the overlay the paper uses: 10 nodes, subnet-aware costs
    overlay = make_topology(TopologySpec(kind="watts_strogatz", n=10, seed=3))
    proto = MOSGUProtocol(overlay)

    print("=== O: minimum spanning tree (Prim) ===")
    for u, v, c in proto.mst.edges():
        print(f"  {u} -- {v}  cost={c:.2f}ms")

    print("\n=== S: BFS 2-coloring ===")
    print("  colors:", proto.colors.tolist())
    print(f"  slot length for EfficientNet-B0 (21.2MB): "
          f"{proto.slot_length_s(21.2):.1f}s (paper III-C formula)")

    print("\n=== GU: one gossip round (every node shares its model) ===")
    payloads = [{"w": torch.full((4,), float(u), device=dev)} for u in range(10)]
    out = proto.run_round(0, payloads)
    print(f"  slots used:       {out['n_slots']}")
    print(f"  transmissions:    {out['transmissions']} "
          f"(optimal N(N-1) = {10*9}; flooding would need "
          f"{proto.flooding_plan.total_transmissions()})")
    agg = out["aggregates"][0]
    print(f"  FedAvg at node 0: {float(agg['w'][0]):.2f} (expected {np.mean(range(10)):.2f})")

    print("\n=== vs flooding broadcast on the testbed simulator ===")
    for code in ("v3s", "b0", "b3"):
        p = PAPER_PAYLOADS[code]
        r = compare_protocols("watts_strogatz", p.capacity_mb, seed=3,
                              spec=TestbedSpec())
        b, m = r["broadcast"], r["mosgu"]
        print(f"  {p.name:24s} ({p.capacity_mb:5.1f}MB): "
              f"bandwidth {b.mean_bandwidth_mbps:.2f} -> {m.mean_bandwidth_mbps:.2f} MB/s "
              f"({m.mean_bandwidth_mbps/b.mean_bandwidth_mbps:.1f}x), "
              f"round {b.total_time_s:.1f}s -> {m.total_time_s:.1f}s "
              f"({b.total_time_s/m.total_time_s:.1f}x)")

    print("\n=== churn: node 7 leaves, moderator recomputes ===")
    proto.node_leaves(7)
    out = proto.run_round(1)
    print(f"  new round over 9 nodes: {out['transmissions']} transmissions "
          f"(= 9*8 = {9*8})")


if __name__ == "__main__":
    main()
