"""Typed metrics registry: labelled counters and gauges.

The part of the reference package's ``obs/metrics.py`` that the execution
policy feeds: every metric is typed (:class:`Counter` / :class:`Gauge`) and
labelled (a fixed tuple of label names, values supplied per observation);
a registry renders a deterministic JSON-able snapshot
(:meth:`MetricsRegistry.snapshot`, sorted keys and label order), and
:meth:`MetricsRegistry.reset` zeroes values while keeping every
registration. Mutation is thread-safe under one lock per metric.
"""
from __future__ import annotations

import threading
from typing import Any, Iterable


def _labelkey(labelnames: tuple[str, ...], labels: dict) -> tuple[str, ...]:
    if set(labels) != set(labelnames):
        raise ValueError(f"expected labels {labelnames}, got {tuple(labels)}")
    return tuple(str(labels[n]) for n in labelnames)


class _Metric:
    """Shared label/series bookkeeping of the metric types."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", labelnames: Iterable[str] = ()) -> None:
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
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

    def get(self, **labels: Any) -> float:
        """Current value of one series (0 if never written)."""
        key = self._key(labels)
        with self._lock:
            return self._series.get(key, 0)

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


class Gauge(_Metric):
    """Last-written value, optionally labelled."""

    kind = "gauge"

    def set(self, v: float, **labels: Any) -> None:
        """Overwrite the series selected by ``labels`` with ``v``."""
        key = self._key(labels)
        with self._lock:
            self._series[key] = v


class MetricsRegistry:
    """Namespace-scoped collection of typed metrics.

    ``namespace`` prefixes every metric name in the snapshot (``phi_``).
    Re-requesting a name returns the existing metric; requesting it with
    another type or labelset raises: the registry is the single source of
    truth for a metric's schema.
    """

    _KINDS = {"counter": Counter, "gauge": Gauge}

    def __init__(self, namespace: str = "") -> None:
        self.namespace = namespace
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def full_name(self, name: str) -> str:
        """Exported name: ``<namespace>_<name>`` (or bare ``name``)."""
        return f"{self.namespace}_{name}" if self.namespace else name

    def _get_or_create(self, kind: str, name: str, help: str,
                       labelnames: Iterable[str]) -> Any:
        labelnames = tuple(labelnames)
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if m.kind != kind or m.labelnames != labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind} with labels "
                        f"{m.labelnames}, requested {kind} with {labelnames}")
                return m
            m = self._KINDS[kind](name, help, labelnames)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "", labelnames: Iterable[str] = ()) -> Counter:
        """Get-or-create a :class:`Counter` named ``name``."""
        return self._get_or_create("counter", name, help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames: Iterable[str] = ()) -> Gauge:
        """Get-or-create a :class:`Gauge` named ``name``."""
        return self._get_or_create("gauge", name, help, labelnames)

    def reset(self) -> None:
        """Zero every metric's series, keeping all registrations."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m.reset()

    def snapshot(self) -> dict:
        """Deterministic JSON-able view: metric name (namespaced) ->
        ``{"type", "help", "series": [{"labels", "value"}]}``, every level
        sorted."""
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        return {self.full_name(m.name): {
                    "type": m.kind, "help": m.help,
                    "series": [{"labels": m.labels_of(key), "value": val}
                               for key, val in m.items()]}
                for m in metrics}
