"""Observability of the port (``repro.obs``): the recorder (spans, counters,
gauges, samples), its Perfetto export, and the :class:`RunReport` an
executor attaches to a scenario result when a recorder is active, copied
from the JAX package.

    from repro_torch import obs

    rec = obs.get()  # the null recorder's span does nothing
    with rec.span("train:step", cat="train", track="train", step=i):
        ...

``launch/train.py --trace PATH`` installs a :class:`Recorder` and writes
the run's spans with :func:`write_trace` (open it in ui.perfetto.dev);
``with obs.recording(obs.Recorder()): executors.get("plan").execute(spec)``
leaves the run's counter and plan-cache deltas in ``result.report``.
"""
from .recorder import NULL_RECORDER, NullRecorder, Recorder, Span, get, recording, set_recorder
from .report import RunReport, build_report, capture_mark
from .trace import chrome_trace, validate_trace, write_trace

__all__ = [
    "NULL_RECORDER",
    "NullRecorder",
    "Recorder",
    "RunReport",
    "Span",
    "build_report",
    "capture_mark",
    "chrome_trace",
    "get",
    "recording",
    "set_recorder",
    "validate_trace",
    "write_trace",
]
