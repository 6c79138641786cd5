"""The readings the check's limits are set from, on the card, in one process.

    python3 cardbench/calibrate.py --workload <cell> --seeds 1 2 ... \\
        [--control-seeds 1 2 3] [--faults half_batch ... --fault-seeds 1 2 3]

For each seed, the program's checked steps at the cell's own size (as a run
drives them, with no window) against the reference's: one JSON line of the
check's numbers. ``--control-seeds``: the control (the reference in fp8, see
``reference/numerics.py``) in the program's place against the reference.
``--faults``: each fault of ``faults.py`` planted in the program. The limits
in ``cardbench/cells/<cell>.json`` lie between the program's highest reading
and the lowest of the control's and the faults' (PERF.md gives both).
"""
import argparse
import gc
import json
import sys
import time

import torch

import check
import faults
import spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--detail", action="store_true", help="print each leaf's readings")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(spec.ROOT / "src"))
    w, cfg, traffic, cell = spec.cell_files(spec.benchmark(), args.workload)
    driver = spec.load_module("drivers", traffic["kind"])

    def ref(seed):
        t0 = time.perf_counter()
        out = driver.reference(cfg, traffic, seed, "cuda")
        print(f"reference of seed {seed}: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
        return out

    def program(seed, fault=None):
        trainer = driver.build(cfg, traffic, "cuda")
        if fault:
            faults.plant(fault, trainer)
        pool = driver.device_pool(cfg, traffic, seed, "cuda")
        state, rec, _ = driver.checked_steps(trainer, cfg, traffic, seed, "cuda", pool)
        out = driver.host_record(rec)
        del state, trainer, pool, rec
        gc.collect()
        torch.cuda.empty_cache()
        return out

    def show(head, got, want):
        print(json.dumps({**head, **check.readings(got, want, cell.get("leaves"))}), flush=True)
        if args.detail:
            print(json.dumps({"losses": [got["losses"], want["losses"]],
                              "node_losses": [got["node_losses"][0], want["node_losses"][0]],
                              **{key: {p: [got[key][p], want[key][p]] for p in want[key]}
                                 for key in ("first_grad", "change")},
                              "gaps": check.leaf_gaps(got, want)}), flush=True)

    head = {"cell": w["name"], "dtype": cfg["dtype"]}
    for seed in sorted(set(args.seeds) | set(args.control_seeds) | set(args.fault_seeds)):
        want = ref(seed)
        if seed in args.seeds:
            show({**head, "kind": "program", "seed": seed}, program(seed), want)
        for fault in args.faults if seed in args.fault_seeds else ():
            show({**head, "kind": "fault", "fault": fault, "seed": seed},
                 program(seed, fault), want)
        if seed in args.control_seeds:
            show({**head, "kind": "control", "seed": seed},
                 driver.reference(cfg, traffic, seed, "cuda", "fp8"), want)
        del want
    return 0


if __name__ == "__main__":
    sys.exit(main())
