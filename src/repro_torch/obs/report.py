"""RunReport: the structured metrics snapshot attached to scenario results
(the port's copy of ``repro.obs.report``).

Where the Chrome trace answers "what happened when", the RunReport answers
"where did the bytes and the time go" in a JSON-serializable shape:

* ``bytes`` — wire/payload totals by protocol layer, from the recorder's
  ``bytes.*`` counters (``bytes.payload_mb``, ``bytes.wire_mb``, plus any
  executor-specific layers).
* ``phases`` — per-span-category timing rollup (total seconds, span count).
* ``counters`` — the delta of every recorder counter over the scenario
  (drops, retransmits, slots, cache hits/misses surfaced by the planner).
* ``gauges`` — last observed values (compression ratios, throughput).
* ``cache`` — a ``PlanCache.snapshot()`` delta when the executor ran with
  a cache attached.

Reports are built by diffing recorder state captured at ``execute()`` entry
against state at exit, so one recorder threaded through a sweep yields
clean per-cell attribution.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from .recorder import Recorder

__all__ = ["RunReport", "capture_mark", "build_report"]


class RunReport:
    """One scenario's observability rollup (plain dict in/out)."""

    __slots__ = ("bytes", "phases", "counters", "gauges", "cache")

    def __init__(self, bytes_by_layer: Dict[str, float],
                 phases: Dict[str, Dict[str, float]],
                 counters: Dict[str, float],
                 gauges: Dict[str, float],
                 cache: Optional[Dict[str, int]] = None) -> None:
        self.bytes = bytes_by_layer
        self.phases = phases
        self.counters = counters
        self.gauges = gauges
        self.cache = cache

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "bytes": self.bytes,
            "phases": self.phases,
            "counters": self.counters,
            "gauges": self.gauges,
        }
        if self.cache is not None:
            out["cache"] = self.cache
        return out

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RunReport":
        return cls(dict(d.get("bytes", {})), dict(d.get("phases", {})),
                   dict(d.get("counters", {})), dict(d.get("gauges", {})),
                   dict(d["cache"]) if "cache" in d else None)


def capture_mark(rec: Recorder,
                 cache_snapshot: Optional[Dict[str, int]] = None
                 ) -> Dict[str, Any]:
    """Snapshot recorder (and optionally cache) state at scenario entry."""
    return {
        "span_idx": len(rec.spans),
        "counters": dict(rec.counters),
        "cache": dict(cache_snapshot) if cache_snapshot is not None else None,
    }


def build_report(rec: Recorder, mark: Dict[str, Any],
                 cache_snapshot: Optional[Dict[str, int]] = None
                 ) -> RunReport:
    """Diff recorder state against ``mark`` into one scenario's RunReport."""
    base = mark["counters"]
    counters = {k: v - base.get(k, 0.0)
                for k, v in rec.counters.items()
                if v != base.get(k, 0.0)}
    bytes_by_layer = {k[len("bytes."):]: v for k, v in counters.items()
                      if k.startswith("bytes.")}

    phases: Dict[str, Dict[str, float]] = {}
    for s in rec.spans[mark["span_idx"]:]:
        row = phases.setdefault(s.cat or "uncategorized",
                                {"total_s": 0.0, "spans": 0})
        row["total_s"] += s.duration_s
        row["spans"] += 1

    cache_delta: Optional[Dict[str, int]] = None
    if cache_snapshot is not None and mark.get("cache") is not None:
        base_cache = mark["cache"]
        cache_delta = {k: v - base_cache.get(k, 0)
                       for k, v in cache_snapshot.items()
                       if v != base_cache.get(k, 0)}

    return RunReport(bytes_by_layer, phases, counters, dict(rec.gauges),
                     cache_delta)
