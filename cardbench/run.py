"""The port's benchmark: one run of one cell.

    python3 cardbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``cardbench/``
and the program (``src/repro_torch``). The cell's traffic names a driver
(``cardbench/drivers/<kind>.py``) that sets up, times and checks the run;
each metric is read by its own reader (``cardbench/metrics/<name>.py``).
With ``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones. The last line of standard output is one
JSON object; the numbers the check compared, each beside its limit, are the
last lines of standard error and the last key of that object; before it
come ``build_s`` (the kernel library's build in this run, 0 once built) and
``setup_parts`` (set-up's seconds by stage). A run exits
with a code other than 0 and prints no result when the card is missing,
when the program is missing, or when JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole: ``repro_torch`` is not ``repro``."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "not read"


def result_line(bench, w, ctx, trace: bool, device_name: str) -> dict:
    metrics = {}
    for m in spec.metrics_for(bench, w["name"], trace):
        value = spec.load_module("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_name, "count": w["chips"],
              "memory_peak_bytes": ctx["peak_bytes"]}
    out = {"correct": ctx["correct"], "attempted": ctx["attempted"], "failed": ctx["failed"],
           "metrics": metrics, "device": device}
    rec = ctx["profile"]
    if trace:
        import profiled

        device["busy_s"] = profiled.busy_s(rec)
        device["window_s"] = profiled.span_s(rec)
        out["breakdown"] = {"device_ops": profiled.top_device_ops(rec),
                            "idle_gaps": profiled.idle_gaps(rec)}
    out["power_limit"] = power_limit()
    out["build_s"] = ctx["build_s"]
    out["setup_parts"] = ctx["setup_parts"]
    out["checked"] = {r["name"]: {"value": r["value"], "limit": r["limit"]}
                      for r in ctx["checked"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = spec.benchmark()
    w, cfg, traffic, cell = spec.cell_files(bench, args.workload)
    program = spec.ROOT / "src"
    if not (program / "repro_torch").is_dir():
        print(f"cardbench: the program is not in this checkout ({program / 'repro_torch'})",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"cardbench: {w['name']} needs {w['chips']} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(program))
    driver = spec.load_module("drivers", traffic["kind"])
    ctx = driver.run(cell, cfg, traffic, args.seed, args.seconds, bool(args.trace), T_START,
                     "cuda")
    out = result_line(bench, w, ctx, bool(args.trace), torch.cuda.get_device_name(0))
    bad = forbidden_modules()
    if bad:
        print(f"cardbench: the run loaded {bad}; the benchmark runs the port alone",
              file=sys.stderr)
        return 4
    for r in ctx["checked"]:
        print(f"checked {r['name']} {r['value']!r} limit {r['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
