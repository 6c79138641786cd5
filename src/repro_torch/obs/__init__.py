"""Observability of the port (``repro.obs``): the recorder and its Perfetto
export, copied from the JAX package and trimmed to what ``--trace`` needs.

    from repro_torch import obs

    rec = obs.get()  # the null recorder's span does nothing
    with rec.span("train:step", cat="train", track="train", step=i):
        ...

``launch/train.py --trace PATH`` installs a :class:`Recorder` and writes
the run's spans with :func:`write_trace` (open it in ui.perfetto.dev).
"""
from .recorder import NULL_RECORDER, NullRecorder, Recorder, get, set_recorder
from .trace import chrome_trace, validate_trace, write_trace

__all__ = [
    "NULL_RECORDER",
    "NullRecorder",
    "Recorder",
    "chrome_trace",
    "get",
    "set_recorder",
    "validate_trace",
    "write_trace",
]
