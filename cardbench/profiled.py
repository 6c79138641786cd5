"""Reading a ``torch.profiler`` record of a few steady steps: the device's
operations, its busy time (the union of their spans), its idle gaps and
what the host was doing in each.

A frozen copy of the port's ``chip_smoke.py::profile_step`` reading
(device events that are not user annotations; busy time as the union of
their spans inside the profiled range), for the whole range of the
profiled steps rather than one step's phases.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Tuple

Span = Tuple[str, float, float]  # (name, start us, end us)

RANGE = "cardbench:profiled"


def record(prof) -> Dict[str, object]:
    """The profiled range's span, its device operations and its host
    operations, from a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    device: List[Span] = []
    host: List[Span] = []
    span: Optional[Tuple[float, float]] = None
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            if not e.is_user_annotation and not e.name.startswith("cardbench:"):
                device.append((e.name, tr.start, tr.end))
        elif e.name == RANGE:
            span = (tr.start, tr.end)
        else:
            host.append((e.name, tr.start, tr.end))
    if span is None:
        raise RuntimeError(f"the profiler's record has no {RANGE!r} range")
    return {"span_us": span, "device": device, "host": host}


def busy_intervals(rec: Dict[str, object]) -> List[Tuple[float, float]]:
    """The device's busy time as disjoint intervals inside the span."""
    lo, hi = rec["span_us"]
    merged: List[List[float]] = []
    for _, start, end in sorted(rec["device"], key=lambda s: s[1]):
        start, end = max(start, lo), min(end, hi)
        if end <= start:
            continue
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def busy_s(rec: Dict[str, object]) -> float:
    return sum(b - a for a, b in busy_intervals(rec)) / 1e6


def span_s(rec: Dict[str, object]) -> float:
    lo, hi = rec["span_us"]
    return (hi - lo) / 1e6


def top_device_ops(rec: Dict[str, object], k: int = 10, width: int = 160) -> List[list]:
    """The k device operations (by name) that took most time, seconds."""
    total: Counter = Counter()
    for name, start, end in rec["device"]:
        total[name[:width]] += (end - start) / 1e6
    return [[name, sec] for name, sec in total.most_common(k)]


def idle_gaps(rec: Dict[str, object], k: int = 10, width: int = 160) -> List[list]:
    """The k longest idle gaps of the device inside the span, each named by
    the innermost host operation running at its middle, seconds."""
    lo, hi = rec["span_us"]
    edges = [lo]
    for a, b in busy_intervals(rec):
        edges += [a, b]
    edges.append(hi)
    gaps = [(edges[i + 1] - edges[i], edges[i], edges[i + 1])
            for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    out = []
    for length, a, b in sorted(gaps, reverse=True)[:k]:
        mid = (a + b) / 2
        inside = [(start, name) for name, start, end in rec["host"] if start <= mid <= end]
        name = max(inside)[1] if inside else "host: none recorded"
        out.append([name[:width], length / 1e6])
    return out


def kernel_s(rec: Dict[str, object], pattern) -> float:
    """Seconds of the device operations whose name matches ``pattern``."""
    return sum(end - start for name, start, end in rec["device"]
               if pattern.search(name)) / 1e6
