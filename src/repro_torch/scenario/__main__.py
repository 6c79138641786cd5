"""Run a scenario's gossip rounds: ``python -m repro_torch.scenario
--scenario quantized_table3 [--device cpu] [--proxy-elems 4]``.

Prints one JSON line per round. Without ``--device cpu`` it runs on the
card (and fails when there is none).
"""
from __future__ import annotations

import argparse
import json

import torch

from .runner import run_scenario
from .registry import SCENARIOS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", required=True, choices=sorted(SCENARIOS))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--proxy-elems", type=int, default=None,
                    help="f32 elements per node (default: the payload's full size)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    run = run_scenario(args.scenario, device=args.device,
                       proxy_elems=args.proxy_elems, seed=args.seed)
    if run.device.startswith("cuda"):
        print(f"# device: {torch.cuda.get_device_name(0)}")
    for r in run.rounds:
        print(json.dumps({"scenario": run.scenario, "elems_per_node": run.elems_per_node,
                          **r.to_dict()}))
    ok = all(r.finite and r.numerics_ok is not False for r in run.rounds)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
