"""Static-verification CLI: ``python -m repro_torch.verify``.

Examples (from the repo root, ``PYTHONPATH=src``)::

  python -m repro_torch.verify --scenario paper_table3
  python -m repro_torch.verify --sweep table3_full
  python -m repro_torch.verify --all         # the conformance gate: every
                                              # registry scenario + gated sweeps
  python -m repro_torch.verify --all --lint  # plus the determinism lint

One :class:`~repro_torch.scenario.cache.PlanCache` is shared across everything
verified in a run, so sweep cells sharing a plan verify it exactly once
(the ``verified`` stage); the exit status is non-zero when any plan fails
or any lint finding remains.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import List

from . import VerificationError, verify_scenario_plans

#: the sweeps the CI conformance gate verifies cell-by-cell
GATED_SWEEPS = ("table3_full", "async_vs_sync", "optimized_vs_mst")


def _verify_one(label: str, spec, cache, mode: str) -> bool:
    t0 = time.perf_counter()
    try:
        out = verify_scenario_plans(spec, plan_cache=cache, mode=mode)
    except VerificationError as exc:
        print(f"  {label:34s} FAIL {exc}")
        return False
    dt = time.perf_counter() - t0
    certs = out["certificates"]
    n_inv = max((len(c.invariants) for c in certs), default=0)
    if out["ok"]:
        print(f"  {label:34s} verified ✓ ({n_inv} invariants, "
              f"{out['epochs']} epoch{'s' if out['epochs'] != 1 else ''}, "
              f"{dt:.2f}s)")
        return True
    print(f"  {label:34s} FAIL [{out['invariant']}] {out['error']}")
    return False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.verify", description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", nargs="*", metavar="NAME", default=[],
                    help="registry scenario name(s) to verify")
    ap.add_argument("--sweep", nargs="*", metavar="NAME", default=[],
                    help="registry sweep name(s); every cell is verified")
    ap.add_argument("--all", action="store_true",
                    help=f"every registry scenario + the gated sweeps "
                         f"{GATED_SWEEPS}")
    ap.add_argument("--lint", action="store_true",
                    help="also run the determinism lint over src/repro_torch")
    ap.add_argument("--mode", choices=("strict", "warn"), default="warn",
                    help="'warn' reports all failures; 'strict' raises on "
                         "the first (default: warn, still exit 1 on any)")
    args = ap.parse_args(argv)

    from ..scenario import scenarios
    from ..scenario.cache import PlanCache

    scenario_names: List[str] = list(args.scenario)
    sweep_names: List[str] = list(args.sweep)
    if args.all:
        scenario_names.extend(
            n for n in scenarios.names() if n not in scenario_names)
        sweep_names.extend(
            n for n in GATED_SWEEPS if n not in sweep_names)
    if not (scenario_names or sweep_names or args.lint):
        ap.error("nothing to do: pass --scenario/--sweep/--all/--lint")

    cache = PlanCache()
    failures = 0
    if scenario_names:
        print("scenarios:")
        for name in scenario_names:
            if not _verify_one(name, scenarios.get(name), cache, args.mode):
                failures += 1
    for sweep_name in sweep_names:
        sweep = scenarios.get_sweep(sweep_name)
        cells = sweep.cells()
        print(f"sweep {sweep_name} ({len(cells)} cells):")
        for cell in cells:
            coords = ",".join(f"{k}={v}" for k, v in cell.coords.items())
            if not _verify_one(f"[{cell.index}] {coords}"[:34], cell.spec,
                               cache, args.mode):
                failures += 1
    if scenario_names or sweep_names:
        stats = cache.stats()
        print(f"plans verified: {stats['verified_misses']} "
              f"(re-use hits: {stats['verified_hits']})")

    if args.lint:
        import os

        from .lint import ALLOWLIST, filter_allowed, lint_tree, load_allowlist

        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        findings = filter_allowed(lint_tree(root), load_allowlist(ALLOWLIST))
        for f in findings:
            print(f)
        print(f"lint: {len(findings)} finding(s)")
        failures += len(findings)

    if failures:
        print(f"\nverify: {failures} failure(s)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
