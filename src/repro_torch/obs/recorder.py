"""The recorder of the port (``repro.obs.recorder``): wall-clock spans with
a zero-overhead off switch.

A copy of the JAX package's recorder, trimmed to what the training
launcher's ``--trace`` needs: a :class:`Recorder` collects named wall-clock
spans on named *tracks* (``time.perf_counter`` relative to the recorder's
origin, so traces start at t=0). The off switch is the module-level
:data:`NULL_RECORDER`, whose ``span`` is a shared no-op context manager:
call sites fetch the active recorder once (``rec = get()``) and open
``with rec.span(...)`` either way.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

__all__ = [
    "NULL_RECORDER",
    "NullRecorder",
    "Recorder",
    "get",
    "set_recorder",
]


class Span:
    """One recorded interval: ``[t0, t1]`` seconds on ``track``'s clock."""

    __slots__ = ("name", "cat", "track", "t0", "t1", "args")

    def __init__(self, name: str, cat: str, track: str,
                 t0: float, t1: float, args: Optional[Dict[str, Any]]) -> None:
        self.name = name
        self.cat = cat
        self.track = track
        self.t0 = t0
        self.t1 = t1
        self.args = args


class _NullSpan:
    """The shared no-op context manager the null recorder hands out."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


_NULL_SPAN = _NullSpan()


class NullRecorder:
    """Observability off: ``span`` hands out a shared no-op context
    manager; nothing allocates, nothing accumulates."""

    def span(self, name: str, cat: str = "", track: str = "main",
             **args: Any) -> _NullSpan:
        return _NULL_SPAN


class Recorder(NullRecorder):
    """Observability on: collect wall-clock spans for the trace. Not
    thread-safe: one per run."""

    def __init__(self) -> None:
        self.spans: List[Span] = []
        self._origin = time.perf_counter()

    def now(self) -> float:
        """Seconds since the recorder's origin (the wall-clock span clock)."""
        return time.perf_counter() - self._origin

    @contextmanager
    def span(self, name: str, cat: str = "", track: str = "main",
             **args: Any) -> Iterator[None]:  # type: ignore[override]
        """A wall-clock span around a ``with`` body. Nested spans on one
        track nest by containment in the trace viewer."""
        t0 = self.now()
        try:
            yield
        finally:
            self.spans.append(Span(name, cat, track, t0, self.now(),
                                   args or None))


#: The module-level off switch: the active recorder when none is installed.
NULL_RECORDER = NullRecorder()

_active: NullRecorder = NULL_RECORDER


def get() -> NullRecorder:
    """The active recorder (the null recorder unless one is installed)."""
    return _active


def set_recorder(rec: Optional[NullRecorder]) -> NullRecorder:
    """Install ``rec`` (None restores the null recorder); returns the
    previously active recorder so callers can restore it."""
    global _active
    prev = _active
    _active = rec if rec is not None else NULL_RECORDER
    return prev
