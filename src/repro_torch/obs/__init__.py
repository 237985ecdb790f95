"""Unified observability layer: tracing, metrics, drift monitoring.

Three pillars, one package (port of ``repro/obs``):

* :mod:`repro_torch.obs.trace` — span tracer for the request lifecycle and
  dispatch decisions, deterministic JSONL via pluggable sinks, and the
  program's spans on the profiler's clock while a profiler records;
* :mod:`repro_torch.obs.metrics` — typed counter/gauge/histogram registry with
  Prometheus-text and JSON snapshot writers, engine-scoped namespaces and
  reset plumbing;
* :mod:`repro_torch.obs.drift` — PSI-style divergence between calibration and
  runtime pattern-usage histograms, the bank-swap trigger.

Everything here is host-side and outside the computation, so an
instrumented serve run is bitwise identical to an uninstrumented one.
"""
from repro_torch.obs.drift import DRIFT_THRESHOLD, DriftMonitor, psi, site_drift
from repro_torch.obs.metrics import (DEFAULT_BUCKETS, TICK_BUCKETS, Counter, Gauge,
                               Histogram, MetricsRegistry, prometheus_many,
                               snapshot_many)
from repro_torch.obs.trace import (JsonlSink, ListSink, Tracer, get_tracer,
                             set_tracer)

__all__ = [
    "DRIFT_THRESHOLD", "DriftMonitor", "psi", "site_drift",
    "DEFAULT_BUCKETS", "TICK_BUCKETS", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "prometheus_many", "snapshot_many",
    "JsonlSink", "ListSink", "Tracer", "get_tracer", "set_tracer",
]
