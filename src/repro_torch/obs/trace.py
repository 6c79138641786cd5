"""Chrome Trace Event Format export of a recorder, Perfetto's JSON dialect
(a copy of ``repro.obs.trace``).

* A recorder track named ``"group/rest"`` becomes thread ``rest`` of
  process ``group`` (tracks with no ``/`` land in the ``"run"`` process).
* Spans become ``"X"`` complete events (``ts`` / ``dur`` in microseconds).
* Counter samples (:meth:`Recorder.sample`, the overlay search's objective
  series) become ``"C"`` events.
* ``"M"`` metadata events name every process and thread.
* ``otherData`` names the span clock, which is always ``"wall"`` here.

``validate_trace`` is the strict schema check of the exported JSON.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Tuple

from .recorder import Recorder

__all__ = ["chrome_trace", "validate_trace", "write_trace"]


def _split_track(track: str) -> Tuple[str, str]:
    """``"node/3"`` → ``("node", "3")``; bare tracks → ``("run", track)``."""
    if "/" in track:
        group, rest = track.split("/", 1)
        return group, rest
    return "run", track


def chrome_trace(recorder: Recorder) -> Dict[str, Any]:
    """Render ``recorder`` as a Trace Event Format object (JSON-ready)."""
    pids: Dict[str, int] = {}
    tids: Dict[Tuple[str, str], int] = {}
    events: List[Dict[str, Any]] = []

    def ids(track: str) -> Tuple[int, int]:
        group, rest = _split_track(track)
        if group not in pids:
            pids[group] = len(pids) + 1
            events.append({"name": "process_name", "ph": "M", "pid": pids[group],
                           "tid": 0, "args": {"name": group}})
        key = (group, rest)
        if key not in tids:
            tids[key] = sum(1 for g, _ in tids if g == group) + 1
            events.append({"name": "thread_name", "ph": "M", "pid": pids[group],
                           "tid": tids[key], "args": {"name": rest}})
        return pids[group], tids[key]

    for s in recorder.spans:
        pid, tid = ids(s.track)
        ev: Dict[str, Any] = {
            "name": s.name,
            "cat": s.cat or "default",
            "ph": "X",
            "ts": s.t0 * 1e6,
            "dur": max(s.t1 - s.t0, 0.0) * 1e6,
            "pid": pid,
            "tid": tid,
        }
        if s.args:
            ev["args"] = s.args
        events.append(ev)

    for name, track, t, value in recorder.samples:
        pid, tid = ids(track)
        events.append({"name": name, "cat": "counter", "ph": "C", "ts": t * 1e6,
                       "pid": pid, "tid": tid, "args": {"value": value}})

    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"clock": "wall"},
    }


_PHASES = {"X", "C", "M"}
_META_NAMES = {"process_name", "thread_name", "process_labels",
               "process_sort_index", "thread_sort_index"}


def validate_trace(obj: Any) -> None:
    """Raise ``ValueError`` unless ``obj`` is a valid Trace Event Format
    object of the subset this exporter emits (the CI schema gate)."""
    if not isinstance(obj, dict):
        raise ValueError("trace must be a JSON object")
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("trace must have a 'traceEvents' array")
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            raise ValueError(f"{where}: event must be an object")
        ph = ev.get("ph")
        if ph not in _PHASES:
            raise ValueError(f"{where}: unknown phase {ph!r}")
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            raise ValueError(f"{where}: 'name' must be a non-empty string")
        if not isinstance(ev.get("pid"), int):
            raise ValueError(f"{where}: 'pid' must be an int")
        if not isinstance(ev.get("tid"), int):
            raise ValueError(f"{where}: 'tid' must be an int")
        if ph == "M":
            if ev["name"] not in _META_NAMES:
                raise ValueError(f"{where}: bad metadata name {ev['name']!r}")
            if not isinstance(ev.get("args"), dict):
                raise ValueError(f"{where}: metadata needs an 'args' object")
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            raise ValueError(f"{where}: 'ts' must be a non-negative number")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"{where}: 'X' event needs non-negative 'dur'")
        else:  # a counter sample
            args = ev.get("args")
            if not isinstance(args, dict) or not args or not all(
                    isinstance(v, (int, float)) for v in args.values()):
                raise ValueError(f"{where}: 'C' event needs numeric 'args'")
    try:
        json.dumps(obj, allow_nan=False)  # rejects NaN/Infinity and stray types
    except (TypeError, ValueError) as e:
        raise ValueError(f"trace is not strict JSON: {e}")


def write_trace(recorder: Recorder, path: str) -> Dict[str, Any]:
    """Export ``recorder`` to ``path`` after validating; returns the object."""
    obj = chrome_trace(recorder)
    validate_trace(obj)
    with open(path, "w") as fh:
        json.dump(obj, fh, indent=1)
    return obj
