"""Greedy membership descent — the ``overlay`` hillclimb, as library code
(the port's copy of ``repro.opt.membership``).

Each round scores a pool of candidate
single-member evictions by replanned MST cost through
:meth:`~repro_torch.core.replan.SparsePlanner.replan` (never a full rebuild) and
commits the best one. A configurable number of candidates per round are
also rebuilt from scratch as timed references; the rebuild both measures
the per-edit speedup the replanner buys and double-checks
:func:`~repro_torch.core.replan.plan_equal` on the way.
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Union

import numpy as np

from ..core.graph import Graph
from ..core.replan import SparsePlanner, plan_equal
from ..core.sparse import CSRGraph

__all__ = ["membership_descent"]


def membership_descent(overlay: Union[Graph, CSRGraph], *,
                       rounds: int = 4, pool: int = 32, timed_refs: int = 4,
                       seed: int = 0,
                       log: Optional[Callable[[str], None]] = None) -> dict:
    """Greedy membership hillclimb through the incremental replanner.

    Per round, ``pool`` candidate single-member evictions are scored by
    replanned MST cost (evictions that disconnect the member subgraph are
    not moves); the cheapest committed. Returns the measurement dict the
    ``overlay`` benchmark pair reports: per-edit replan vs full-rebuild
    milliseconds, the measured speedup, and the eviction trail.
    """
    planner = SparsePlanner(overlay, seed=seed)
    n = overlay.n
    members = list(range(n))
    plan = planner.plan(members)
    rng = np.random.default_rng(seed)
    replan_s = full_s = 0.0
    n_edits = n_refs = 0
    trail = []
    for r in range(rounds):
        cands = rng.choice(plan.members, size=min(pool, len(members) - 2),
                           replace=False)
        best = None
        ref_picks = set(int(x) for x in cands[:timed_refs])
        for v in cands:
            v = int(v)
            trial = [m for m in members if m != v]
            t0 = time.time()
            try:
                cand_plan = planner.replan(plan, trial)
            except ValueError:
                continue  # eviction disconnects the overlay: not a move
            replan_s += time.time() - t0
            n_edits += 1
            if v in ref_picks:
                t0 = time.time()
                ref = planner.plan(trial)
                full_s += time.time() - t0
                n_refs += 1
                assert plan_equal(cand_plan, ref)
            if best is None or cand_plan.tree_cost() < best[1].tree_cost():
                best = (v, cand_plan)
        if best is None:
            break
        members = [m for m in members if m != best[0]]
        plan = best[1]
        trail.append({"round": r, "evicted": best[0],
                      "tree_cost": round(plan.tree_cost(), 3)})
        if log is not None:
            log(f"round {r}: evicted {best[0]}, "
                f"tree cost {plan.tree_cost():.3f}")
    per_edit_replan = replan_s / max(1, n_edits)
    per_edit_full = full_s / max(1, n_refs)
    speedup = per_edit_full / per_edit_replan if per_edit_replan else 0.0
    return {
        "n": n, "rounds": len(trail), "candidates_scored": n_edits,
        "full_rebuild_refs": n_refs,
        "per_edit_replan_ms": round(per_edit_replan * 1e3, 3),
        "per_edit_full_ms": round(per_edit_full * 1e3, 3),
        "per_edit_speedup": round(speedup, 1),
        "trail": trail,
    }
