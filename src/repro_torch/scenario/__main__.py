"""Run a scenario, or every cell of a sweep, on one executor:
``python -m repro_torch.scenario --scenario quantized_table3 [--device cpu]
[--proxy-elems 4]`` or ``--sweep codec_x_protocol``.

Prints one JSON line per round of a scenario, or per cell of a sweep. The
default executor is ``device``, which runs on the card (and fails when
there is none) unless given ``--device cpu``; ``--executor plan`` (or
``engine``, ``netsim``, ``event``) runs a host executor. ``--device`` goes
to the ``device`` and ``engine`` executors, ``--proxy-elems`` and
``--seed`` to ``device`` alone; any other executor refuses them.
"""
from __future__ import annotations

import argparse
import json

import torch

from .executors import EXECUTORS, DeviceExecutor, names
from .registry import SCENARIOS, get_sweep, sweep_names
from .runner import run_scenario
from .sweep import run_sweep

# the options each executor's constructor takes
TAKES = {"device": ("device", "proxy_elems", "seed"), "engine": ("device",)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    what = ap.add_mutually_exclusive_group(required=True)
    what.add_argument("--scenario", choices=sorted(SCENARIOS))
    what.add_argument("--sweep", choices=sweep_names())
    ap.add_argument("--executor", default="device", choices=names())
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--proxy-elems", type=int, default=None,
                    help="f32 elements per node (default: the payload's full size)")
    ap.add_argument("--seed", type=int, default=None, help="parameter seed (default 0)")
    args = ap.parse_args(argv)
    given = {k: v for k, v in (("device", args.device), ("proxy_elems", args.proxy_elems),
                               ("seed", args.seed)) if v is not None}
    takes = TAKES.get(args.executor, ())
    if refused := [k for k in given if k not in takes]:
        ap.error(f"--executor {args.executor} takes no "
                 + ", ".join("--" + k.replace("_", "-") for k in refused))
    ex = EXECUTORS[args.executor](**given)
    on_card = isinstance(ex, DeviceExecutor)
    if args.sweep:
        cells = run_sweep(get_sweep(args.sweep), executor=ex).cells
        results, runs = [c.result for c in cells], ex.runs if on_card else [None] * len(cells)
    else:
        results = [run_scenario(args.scenario, executor=ex)]
        runs = [ex.run if on_card else None]
    if on_card and runs[0].device.startswith("cuda"):
        print(f"# device: {torch.cuda.get_device_name(0)}")
    ok = True
    for i, (res, run) in enumerate(zip(results, runs)):
        card = {} if run is None else {"elems_per_node": run.elems_per_node}
        if args.sweep:
            row = {"sweep": args.sweep, "executor": res.executor, **cells[i].row(), **card}
            if run is not None:
                row.update(numerics_ok=[r.numerics_ok for r in run.rounds],
                           finite=all(r.finite for r in run.rounds),
                           device_ms=[r.device_ms for r in run.rounds],
                           peak_bytes=run.peak_bytes)
            print(json.dumps(row))
        else:
            rounds = res.rounds if run is None else run.rounds
            for r in rounds:
                print(json.dumps({"scenario": res.scenario, **card, **r.to_dict()}))
        if run is not None:
            ok = ok and all(r.finite and r.numerics_ok is not False for r in run.rounds)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
