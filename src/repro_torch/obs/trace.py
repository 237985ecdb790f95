"""Record tracer with deterministic output.

The part of the reference package's ``obs/trace.py`` that the execution
policy uses: a :class:`Tracer` numbers each record with a monotonic ``seq``
(no wall clock, so two same-seed runs give identical records) and writes it
to a sink. ``kernels/dispatch.py`` emits one ``dispatch`` record per
resolved decision through the process tracer installed with
:func:`set_tracer`; with none installed, tracing costs nothing.
"""
from __future__ import annotations

import threading
from typing import Any


class ListSink:
    """In-memory sink: records accumulate on ``.records``."""

    def __init__(self) -> None:
        self.records: list[dict] = []

    def write(self, record: dict) -> None:
        """Append the record."""
        self.records.append(record)


class Tracer:
    """Writes records to ``sink`` (default: a new :class:`ListSink`), each
    with its kind and a monotonic ``seq``."""

    def __init__(self, sink: Any = None) -> None:
        self.sink = sink if sink is not None else ListSink()
        self._lock = threading.Lock()
        self._seq = 0

    def emit(self, kind: str, **attrs: Any) -> dict:
        """Record one event and return it; attributes that are None are dropped."""
        record = {k: v for k, v in attrs.items() if v is not None}
        record["kind"] = kind
        with self._lock:
            record["seq"] = self._seq
            self._seq += 1
        self.sink.write(record)
        return record


_TRACER: Tracer | None = None
_TRACER_LOCK = threading.Lock()


def get_tracer() -> Tracer | None:
    """The process-wide tracer dispatch records go to (None = tracing off)."""
    return _TRACER


def set_tracer(tracer: Tracer | None) -> Tracer | None:
    """Install (or clear, with None) the process-wide tracer; returns the
    previous one so callers can restore it."""
    global _TRACER
    with _TRACER_LOCK:
        prev, _TRACER = _TRACER, tracer
    return prev
