"""Request/kernel span tracer with deterministic JSONL output (port of
``repro/obs/trace.py``).

One :class:`Tracer` records the full serve-engine request lifecycle
(``submit -> admit -> prefill -> decode tick* -> preempt/resume ->
retire``) plus per-call dispatch spans (site, impl, reason, blocks, shards)
as a flat stream of records through a pluggable sink.

Determinism contract: every record carries a **monotonic sequence number**
and the engine's **tick counter** — never wall-clock — so two same-seed
runs emit byte-identical JSONL (keys sorted, compact separators). Wall
time rides along as an extra ``wall_ms`` field only when the tracer is
constructed with ``wall_time=True``, which removes the byte-determinism
guarantee for that tracer only.

Dispatch spans come from the execution policy: ``kernels/dispatch.py``
emits a ``dispatch`` record per resolved decision through the process
tracer installed with :func:`set_tracer` (a no-op when none is installed —
the uninstrumented path stays zero-cost). Decisions are made on the host,
so instrumentation cannot perturb the computation: instrumented token
streams are bitwise identical to uninstrumented ones (tested).
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Callable, Protocol


class Sink(Protocol):
    """Destination for trace records (one dict per span/event)."""

    def write(self, record: dict) -> None:
        """Consume one record."""

    def close(self) -> None:
        """Flush and release any resources."""


class ListSink:
    """In-memory sink: records accumulate on ``.records`` (tests)."""

    def __init__(self) -> None:
        """Start with an empty record list."""
        self.records: list[dict] = []

    def write(self, record: dict) -> None:
        """Append the record."""
        self.records.append(record)

    def close(self) -> None:
        """No-op (nothing to flush)."""


class JsonlSink:
    """File sink writing one sorted-key JSON object per line.

    Sorted keys + compact separators make the byte stream a pure function
    of the record stream — the property the two-same-seed-runs determinism
    gate checks.
    """

    def __init__(self, path: str) -> None:
        """Open (truncate) ``path`` for line-buffered writing."""
        self.path = path
        self._f = open(path, "w", buffering=1)

    def write(self, record: dict) -> None:
        """Serialize the record as one JSONL line."""
        self._f.write(json.dumps(record, sort_keys=True,
                                 separators=(",", ":")) + "\n")

    def close(self) -> None:
        """Close the underlying file."""
        self._f.close()


class Tracer:
    """Emits lifecycle/dispatch records with monotonic ``seq`` numbering.

    ``wall_time=True`` adds a ``wall_ms`` field to every record (and makes
    :meth:`span` measure durations) — off by default to keep the output
    deterministic. ``clock`` is injectable for tests.
    """

    def __init__(self, sink: Sink | None = None, *, wall_time: bool = False,
                 clock: Callable[[], float] = time.perf_counter) -> None:
        """Wire the sink (default: in-memory :class:`ListSink`)."""
        self.sink: Sink = sink if sink is not None else ListSink()
        self.wall_time = wall_time
        self._clock = clock
        self._lock = threading.Lock()
        self._seq = 0
        self.kind_counts: dict[str, int] = {}

    def emit(self, kind: str, **attrs: Any) -> dict:
        """Record one event; returns the record written.

        ``attrs`` with value None are dropped so optional fields do not
        bloat the line; the caller supplies the engine tick / step counter
        as a plain attr (``tick=...``).
        """
        record = {k: v for k, v in attrs.items() if v is not None}
        record["kind"] = kind
        with self._lock:
            record["seq"] = self._seq
            self._seq += 1
            self.kind_counts[kind] = self.kind_counts.get(kind, 0) + 1
        if self.wall_time:
            record["wall_ms"] = self._clock() * 1e3
        self.sink.write(record)
        return record

    def span(self, kind: str, **attrs: Any) -> "_Span":
        """Context manager emitting one record when the block exits; with
        ``wall_time`` the record carries the block's ``dur_ms``."""
        return _Span(self, kind, attrs)

    def close(self) -> None:
        """Close the sink."""
        self.sink.close()


class _Span:
    """Context manager for :meth:`Tracer.span` (emit-on-exit)."""

    def __init__(self, tracer: Tracer, kind: str, attrs: dict) -> None:
        self._tracer = tracer
        self._kind = kind
        self.attrs = attrs
        self._t0 = 0.0

    def __enter__(self) -> "_Span":
        if self._tracer.wall_time:
            self._t0 = self._tracer._clock()
        return self

    def __exit__(self, *exc: Any) -> None:
        if self._tracer.wall_time:
            self.attrs["dur_ms"] = (self._tracer._clock() - self._t0) * 1e3
        self._tracer.emit(self._kind, **self.attrs)


_TRACER: Tracer | None = None
_TRACER_LOCK = threading.Lock()


def get_tracer() -> Tracer | None:
    """The process-wide tracer dispatch spans go to (None = tracing off)."""
    return _TRACER


def set_tracer(tracer: Tracer | None) -> Tracer | None:
    """Install (or clear, with None) the process-wide tracer; returns the
    previous one so callers can restore it."""
    global _TRACER
    with _TRACER_LOCK:
        prev, _TRACER = _TRACER, tracer
    return prev
