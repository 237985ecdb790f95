"""Request/kernel span tracer with deterministic JSONL output (port of
``repro/obs/trace.py``), and the program's spans on the profiler's clock.

One :class:`Tracer` records the full serve-engine request lifecycle
(``submit -> admit -> prefill -> decode tick* -> preempt/resume ->
retire``) plus per-call dispatch spans (site, impl, reason, blocks, shards)
as a flat stream of records through a pluggable sink.

Determinism contract: every record carries a **monotonic sequence number**
and the engine's **tick counter** — never wall-clock — so two same-seed
runs emit byte-identical JSONL (keys sorted, compact separators). Wall
time rides along as an extra ``wall_ms`` field only when the tracer is
constructed with ``wall_time=True``, which removes the byte-determinism
guarantee for that tracer only; such timed records also carry the span's
``id``, its ``parent`` and its ``start_ns``/``end_ns`` on :func:`now_ns`.

Dispatch spans come from the execution policy: ``kernels/dispatch.py``
emits a ``dispatch`` record per resolved decision through the process
tracer installed with :func:`set_tracer` (a no-op when none is installed —
the uninstrumented path stays zero-cost). Decisions are made on the host,
so instrumentation cannot perturb the computation: instrumented token
streams are bitwise identical to uninstrumented ones (tested).

The program's spans (:func:`span`, :func:`event`: ``serve.tick``,
``serve.prefill``, ``serve.decode_step``, ``serve.sample``, the request
events, ``snn.phi_apply``) have three states. Off — no tracer given and no
``torch.profiler`` recording — a call returns one shared null
context and reads no clock. With a tracer, the record goes to its sink
under the name's last part as ``kind``. While a profiler records, the span
also goes into a process-level record (:func:`profiled_spans`) with its
``name``, ``id``, ``parent`` (the enclosing span on this thread),
``start_ns``, ``end_ns`` and attributes, on the profiler's own clock
(Unix nanoseconds, as kineto stamps host events); the first span that finds
a profiler recording after one found none starts a new record, so the
record holds the latest profiled window. The spans are never
``record_function`` ranges: under CUDA those are mirrored onto the device
timeline, where they would count as device work.
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from typing import Any, Callable, Protocol

from torch.autograd import _profiler_enabled


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


_IDS = itertools.count(1)
_LOCAL = threading.local()          # .stack: ids of the open timed spans
_RECORD: list[dict] = []
_RECORDING = False                  # the last span call found a profiler on
_OFFSET_NS = time.time_ns() - time.perf_counter_ns()


def now_ns() -> int:
    """The profiler's clock: Unix nanoseconds, read from the monotonic
    counter plus an offset taken again as each record starts (kineto too
    converts its clock to Unix time as it starts), so a duration is never
    negative."""
    return time.perf_counter_ns() + _OFFSET_NS


def _recording() -> bool:
    """Whether a profiler records now; starts a new record at the first
    call that finds one after a call found none."""
    global _RECORDING, _RECORD, _OFFSET_NS
    on = _profiler_enabled()
    if on != _RECORDING:
        if on:
            if not _stack():            # no open span spans the new offset
                _OFFSET_NS = time.time_ns() - time.perf_counter_ns()
            _RECORD = []
        _RECORDING = on
    return on


def profiled_spans() -> list[dict]:
    """The spans and events of the latest profiled window, in the order
    they closed."""
    return list(_RECORD)


def _stack() -> list[int]:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


class _NullSpan:
    """The shared context of a span that nothing records."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> None:
        pass

    def set(self, **attrs: Any) -> None:
        """Drop the attributes."""


NULL_SPAN = _NullSpan()


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
        return self._write(kind, attrs, self._clock() if self.wall_time else None)

    def _write(self, kind: str, attrs: dict, wall_s: float | None) -> dict:
        record = {k: v for k, v in attrs.items() if v is not None}
        record["kind"] = kind
        with self._lock:
            record["seq"] = self._seq
            self._seq += 1
            self.kind_counts[kind] = self.kind_counts.get(kind, 0) + 1
        if wall_s is not None:
            record["wall_ms"] = wall_s * 1e3
        self.sink.write(record)
        return record

    def span(self, kind: str, **attrs: Any) -> "_Span":
        """Context manager emitting one record when the block exits; with
        ``wall_time`` the record carries the block's ``dur_ms``."""
        return span(kind, self, **attrs)

    def close(self) -> None:
        """Close the sink."""
        self.sink.close()


def span(name: str, tracer: Tracer | None = None, **attrs: Any) -> "_Span | _NullSpan":
    """A span named ``name`` (``<layer>.<what>``) around a block: into
    ``tracer`` under the name's last part, and into the profiled record
    while a profiler records; :data:`NULL_SPAN` when neither. ``.set()``
    adds attributes the block learns."""
    rec = _recording()
    if tracer is None and not rec:
        return NULL_SPAN
    return _Span(name, tracer, rec, attrs)


def event(name: str, tracer: Tracer | None = None, **attrs: Any) -> None:
    """A zero-length span: a request's submission, admission, first token
    or retirement."""
    rec = _recording()
    if tracer is None and not rec:
        return
    timed = {}
    if rec or tracer.wall_time:
        stack = _stack()
        t = now_ns()
        timed = {"id": next(_IDS), "parent": stack[-1] if stack else None,
                 "start_ns": t, "end_ns": t}
    if rec:
        _RECORD.append({"name": name, **timed, **attrs})
    if tracer is None:
        return
    kind = name.rpartition(".")[2]
    if tracer.wall_time:
        tracer._write(kind, dict(attrs, **timed), tracer._clock())
    else:
        tracer._write(kind, attrs, None)


class _Span:
    """One span of :func:`span`, written where it closes."""

    __slots__ = ("name", "tracer", "rec", "attrs", "timed", "id", "parent", "start_ns",
                 "_t0")

    def __init__(self, name: str, tracer: Tracer | None, rec: bool, attrs: dict) -> None:
        self.name = name
        self.tracer = tracer
        self.rec = rec
        self.attrs = attrs
        self.timed = rec or (tracer is not None and tracer.wall_time)

    def set(self, **attrs: Any) -> None:
        """Add attributes to the span's record."""
        self.attrs.update(attrs)

    def __enter__(self) -> "_Span":
        if self.timed:
            stack = _stack()
            self.parent = stack[-1] if stack else None
            self.id = next(_IDS)
            stack.append(self.id)
            self.start_ns = now_ns()
        if self.tracer is not None and self.tracer.wall_time:
            self._t0 = self.tracer._clock()
        return self

    def __exit__(self, *exc: Any) -> None:
        if self.timed:
            end_ns = now_ns()
            _stack().pop()
            if self.rec:
                _RECORD.append({"name": self.name, "id": self.id, "parent": self.parent,
                                "start_ns": self.start_ns, "end_ns": end_ns, **self.attrs})
        if self.tracer is None:
            return
        kind = self.name.rpartition(".")[2]
        if not self.tracer.wall_time:
            self.tracer._write(kind, self.attrs, None)
            return
        wall_s = self.tracer._clock()
        self.tracer._write(kind, dict(self.attrs, dur_ms=(wall_s - self._t0) * 1e3,
                                      id=self.id, parent=self.parent,
                                      start_ns=self.start_ns, end_ns=end_ns), wall_s)


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
