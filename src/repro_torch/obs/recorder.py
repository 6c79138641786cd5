"""The recorder of the port (``repro.obs.recorder``): spans, counters and
gauges with a zero-overhead off switch.

A copy of the JAX package's recorder: a :class:`Recorder` collects named
wall-clock spans on named *tracks* (``time.perf_counter`` relative to the
recorder's origin, so traces start at t=0), virtual-clock spans filed with
explicit timestamps (:meth:`Recorder.add_span`: the event engine's virtual
seconds), monotonic counters (:meth:`Recorder.count`), last-value gauges
(:meth:`Recorder.gauge`) and timestamped samples (:meth:`Recorder.sample`).
The off switch is the
module-level :data:`NULL_RECORDER`: every method a no-op, ``enabled``
False. Call sites fetch the active recorder once (``rec = get()``) and
either open ``with rec.span(...)`` regardless or guard their counting with
``if rec.enabled:``.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Tuple

__all__ = [
    "NULL_RECORDER",
    "NullRecorder",
    "Recorder",
    "get",
    "recording",
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

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0


class _NullSpan:
    """The shared no-op context manager the null recorder hands out."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


_NULL_SPAN = _NullSpan()


class NullRecorder:
    """Observability off: every method is a no-op, ``enabled`` is False;
    ``span`` hands out a shared no-op context manager. Nothing allocates,
    nothing accumulates."""

    enabled = False

    def span(self, name: str, cat: str = "", track: str = "main",
             **args: Any) -> _NullSpan:
        return _NULL_SPAN

    def add_span(self, name: str, t0: float, t1: float, *, track: str = "main",
                 cat: str = "", args: Optional[Dict[str, Any]] = None) -> None:
        return None

    def count(self, name: str, value: float = 1.0) -> None:
        return None

    def gauge(self, name: str, value: float) -> None:
        return None

    def sample(self, name: str, t: float, value: float, track: str = "counters") -> None:
        return None


class Recorder(NullRecorder):
    """Observability on: collect spans, counters and gauges. Not
    thread-safe: one per run."""

    enabled = True

    def __init__(self) -> None:
        self.spans: List[Span] = []
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.samples: List[Tuple[str, str, float, float]] = []
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

    def add_span(self, name: str, t0: float, t1: float, *, track: str = "main",
                 cat: str = "", args: Optional[Dict[str, Any]] = None) -> None:
        """File a span with explicit timestamps: the virtual-clock path (the
        event engine's seconds). Spans on one track share one clock."""
        self.spans.append(Span(name, cat, track, float(t0), float(t1), args))

    def count(self, name: str, value: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def sample(self, name: str, t: float, value: float, track: str = "counters") -> None:
        """One point of a timestamped counter series (the trace's ``"C"``
        events)."""
        self.samples.append((name, track, float(t), float(value)))


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


@contextmanager
def recording(rec: Recorder) -> Iterator[Recorder]:
    """Scoped install: ``with recording(Recorder()) as rec: ...``."""
    prev = set_recorder(rec)
    try:
        yield rec
    finally:
        set_recorder(prev)
