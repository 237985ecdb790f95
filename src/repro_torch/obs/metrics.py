"""Typed metrics registry: counters, gauges and fixed-bucket histograms
(port of ``repro/obs/metrics.py``).

The serving stack used to keep three hand-rolled count dicts —
``TelemetryScheduler.counts``, ``Engine.ticks``/``decoded_tokens`` and the
dispatch policy's ``_decisions`` — with no shared reset, export or label
semantics. This module is the one place all of them now live:

* every metric is **typed** (:class:`Counter` / :class:`Gauge` /
  :class:`Histogram`) and **labelled** (a fixed tuple of label names, values
  supplied per observation), so the same series a test asserts on is the
  series production exports;
* histograms use **fixed bucket edges** chosen at registration time, so
  their bucket-count vectors are deterministic functions of the observed
  values (wall-clock histograms are only populated when the caller
  explicitly enables wall-time observation);
* registries render as **Prometheus text exposition** format
  (:func:`prometheus_many`) and as a **deterministic JSON snapshot**
  (:meth:`MetricsRegistry.snapshot`, :func:`snapshot_many` — sorted keys,
  stable label ordering), and :meth:`MetricsRegistry.reset` zeroes values
  while keeping every registration (the engine-scoped reset plumbing).

Mutation is thread-safe under one lock per metric. Sums and counts are
order-independent, so metrics fed from several threads stay deterministic.
The execution policy keeps its per-site device sums on the card and folds
them in only where they are read (its reporting surface flushes first).
"""
from __future__ import annotations

import threading
from typing import Any, Iterable

#: Default histogram bucket edges (milliseconds-flavoured, but unitless):
#: fixed at import time so two runs observing the same values always produce
#: identical bucket vectors.
DEFAULT_BUCKETS: tuple[float, ...] = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
    100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0)

#: Bucket edges for tick-denominated latencies (request admit -> retire).
TICK_BUCKETS: tuple[float, ...] = (
    1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 512.0, 1024.0)


def _labelkey(labelnames: tuple[str, ...], labels: dict) -> tuple[str, ...]:
    if set(labels) != set(labelnames):
        raise ValueError(f"expected labels {labelnames}, got {tuple(labels)}")
    return tuple(str(labels[n]) for n in labelnames)


class _Metric:
    """Shared label/series bookkeeping for the three metric types."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Iterable[str] = (),
                 lock: threading.Lock | None = None) -> None:
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = lock or threading.Lock()
        self._series: dict[tuple[str, ...], Any] = {}

    def _key(self, labels: dict) -> tuple[str, ...]:
        return _labelkey(self.labelnames, labels)

    def labels_of(self, key: tuple[str, ...]) -> dict[str, str]:
        """Label dict for one series key (names zipped back onto values)."""
        return dict(zip(self.labelnames, key))

    def items(self) -> list[tuple[tuple[str, ...], Any]]:
        """All (label-values, value) series, sorted by label values."""
        with self._lock:
            return sorted(self._series.items())

    def reset(self) -> None:
        """Drop every series (the registration itself survives)."""
        with self._lock:
            self._series.clear()


class Counter(_Metric):
    """Monotonically increasing count, optionally labelled."""

    kind = "counter"

    def inc(self, n: float = 1, **labels: Any) -> None:
        """Add ``n`` (default 1) to the series selected by ``labels``."""
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0) + n

    def get(self, **labels: Any) -> float:
        """Current value of one series (0 if never incremented)."""
        key = self._key(labels)
        with self._lock:
            return self._series.get(key, 0)

    def total(self) -> float:
        """Sum over every labelled series."""
        with self._lock:
            return sum(self._series.values())


class Gauge(_Metric):
    """Last-written value, optionally labelled."""

    kind = "gauge"

    def set(self, v: float, **labels: Any) -> None:
        """Overwrite the series selected by ``labels`` with ``v``."""
        key = self._key(labels)
        with self._lock:
            self._series[key] = v

    def get(self, **labels: Any) -> float:
        """Current value of one series (0 if never set)."""
        key = self._key(labels)
        with self._lock:
            return self._series.get(key, 0)


class Histogram(_Metric):
    """Fixed-edge histogram: per-series bucket counts plus sum/count.

    Buckets are ``len(edges) + 1`` wide — values ``<= edges[i]`` land in
    bucket ``i``, anything larger in the overflow bucket. Edges are fixed at
    registration, so the bucket vector is a deterministic function of the
    observations (the CI-gating property).
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Iterable[str] = (),
                 buckets: Iterable[float] = DEFAULT_BUCKETS,
                 lock: threading.Lock | None = None) -> None:
        """Register the series shape; ``buckets`` must be ascending."""
        super().__init__(name, help, labelnames, lock)
        self.edges = tuple(float(b) for b in buckets)
        if list(self.edges) != sorted(self.edges):
            raise ValueError(f"bucket edges must ascend: {self.edges}")

    def _cell(self, key: tuple[str, ...]) -> dict:
        cell = self._series.get(key)
        if cell is None:
            cell = {"buckets": [0] * (len(self.edges) + 1),
                    "sum": 0.0, "count": 0}
            self._series[key] = cell
        return cell

    def observe(self, v: float, **labels: Any) -> None:
        """Record one value into the series selected by ``labels``."""
        key = self._key(labels)
        i = len(self.edges)
        for j, edge in enumerate(self.edges):
            if v <= edge:
                i = j
                break
        with self._lock:
            cell = self._cell(key)
            cell["buckets"][i] += 1
            cell["sum"] += float(v)
            cell["count"] += 1

    def count(self, **labels: Any) -> int:
        """Number of observations in one series."""
        key = self._key(labels)
        with self._lock:
            cell = self._series.get(key)
            return 0 if cell is None else int(cell["count"])

    def sum(self, **labels: Any) -> float:
        """Sum of observed values in one series."""
        key = self._key(labels)
        with self._lock:
            cell = self._series.get(key)
            return 0.0 if cell is None else float(cell["sum"])

    def percentile(self, p: float, **labels: Any) -> float:
        """Estimate the ``p``-th percentile from the bucket counts.

        Linear interpolation inside the bucket holding the target rank
        (bucket 0 interpolates from 0; the overflow bucket clamps to the
        last edge). The serve launcher's latency report reads its
        percentiles from here.
        """
        key = self._key(labels)
        with self._lock:
            cell = self._series.get(key)
            if cell is None or not cell["count"]:
                return 0.0
            counts = list(cell["buckets"])
        total = sum(counts)
        rank = max(1e-12, p / 100.0 * total)
        cum = 0.0
        for i, c in enumerate(counts):
            if cum + c >= rank and c:
                lo = 0.0 if i == 0 else self.edges[i - 1]
                hi = self.edges[min(i, len(self.edges) - 1)]
                return lo + (hi - lo) * ((rank - cum) / c)
            cum += c
        return self.edges[-1]


class MetricsRegistry:
    """Namespace-scoped collection of typed metrics.

    ``namespace`` prefixes every metric name in exports (``serve_``,
    ``phi_``), which is what makes engine-scoped registries mergeable into
    one exposition page without collisions (:func:`snapshot_many`).
    Re-requesting a name returns the existing metric; requesting it with a
    different type or labelset raises — the registry is the single source
    of truth for a metric's schema.
    """

    _KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}

    def __init__(self, namespace: str = "") -> None:
        """Create an empty registry; metrics register on first request."""
        self.namespace = namespace
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def full_name(self, name: str) -> str:
        """Exported name: ``<namespace>_<name>`` (or bare ``name``)."""
        return f"{self.namespace}_{name}" if self.namespace else name

    def _get_or_create(self, kind: str, name: str, help: str,
                       labelnames: Iterable[str], **kw: Any) -> Any:
        labelnames = tuple(labelnames)
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if m.kind != kind or m.labelnames != labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind} "
                        f"with labels {m.labelnames}, requested {kind} "
                        f"with {labelnames}")
                return m
            m = self._KINDS[kind](name, help, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Iterable[str] = ()) -> Counter:
        """Get-or-create a :class:`Counter` named ``name``."""
        return self._get_or_create("counter", name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Iterable[str] = ()) -> Gauge:
        """Get-or-create a :class:`Gauge` named ``name``."""
        return self._get_or_create("gauge", name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Iterable[str] = (),
                  buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
        """Get-or-create a :class:`Histogram` with fixed ``buckets``."""
        return self._get_or_create("histogram", name, help, labelnames,
                                   buckets=buckets)

    def get(self, name: str) -> _Metric | None:
        """The metric registered as ``name`` (un-namespaced), or None."""
        with self._lock:
            return self._metrics.get(name)

    def reset(self) -> None:
        """Zero every metric's series, keeping all registrations — the
        engine-scoped reset that makes back-to-back runs report identical
        counts (regression-tested)."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m.reset()

    # ------------------------------------------------------------- export --
    def snapshot(self) -> dict:
        """Deterministic JSON-able view: metric name (namespaced) ->
        ``{"type", "help", "series": [{"labels", ...value fields}]}`` with
        every level sorted."""
        out: dict[str, Any] = {}
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        for m in metrics:
            series = []
            for key, val in m.items():
                row: dict[str, Any] = {"labels": m.labels_of(key)}
                if m.kind == "histogram":
                    row.update(buckets=list(val["buckets"]),
                               sum=val["sum"], count=val["count"])
                else:
                    row["value"] = val
                series.append(row)
            entry: dict[str, Any] = {"type": m.kind, "help": m.help,
                                     "series": series}
            if m.kind == "histogram":
                entry["edges"] = list(m.edges)
            out[self.full_name(m.name)] = entry
        return out


def _prom_labels(labels: dict[str, str], extra: dict[str, str] | None = None
                 ) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    body = ",".join(f'{k}="{_escape(v)}"' for k, v in sorted(merged.items()))
    return "{" + body + "}"


def _escape(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def prometheus_many(registries: Iterable[MetricsRegistry]) -> str:
    """Render several registries (distinct namespaces) as one Prometheus
    text exposition page — the ``--metrics-out`` writer."""
    lines: list[str] = []
    for reg in registries:
        snap = reg.snapshot()
        for name, entry in snap.items():
            lines.append(f"# HELP {name} {_escape(entry['help'])}")
            lines.append(f"# TYPE {name} {entry['type']}")
            for row in entry["series"]:
                labels = row["labels"]
                if entry["type"] == "histogram":
                    cum = 0
                    for edge, n in zip(entry["edges"], row["buckets"]):
                        cum += n
                        lines.append(f"{name}_bucket"
                                     f"{_prom_labels(labels, {'le': repr(edge)})}"
                                     f" {cum}")
                    cum += row["buckets"][-1]
                    lines.append(f"{name}_bucket"
                                 f"{_prom_labels(labels, {'le': '+Inf'})} {cum}")
                    lines.append(f"{name}_sum{_prom_labels(labels)}"
                                 f" {row['sum']}")
                    lines.append(f"{name}_count{_prom_labels(labels)}"
                                 f" {row['count']}")
                else:
                    lines.append(f"{name}{_prom_labels(labels)}"
                                 f" {row['value']}")
    return "\n".join(lines) + "\n"


def snapshot_many(registries: Iterable[MetricsRegistry]) -> dict:
    """Merge several registries' snapshots into one dict — namespaces keep
    the keys disjoint (the ``--metrics-out`` JSON writer)."""
    out: dict[str, Any] = {}
    for reg in registries:
        for name, entry in reg.snapshot().items():
            if name in out:
                raise ValueError(f"metric name collision across registries: "
                                 f"{name}")
            out[name] = entry
    return out
