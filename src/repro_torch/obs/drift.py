"""Sparsity-drift monitoring: PSI between calibration and runtime usage
(port of ``repro/obs/drift.py``).

The Phi premise (paper §4) is that calibration-time pattern-usage
statistics predict runtime traffic: the PWP prefetcher gathers the active
slice the calibration histogram named, and the dispatch policy's
``fused_prefetch`` gate fires on that histogram's skew. When live traffic's
match distribution moves away from calibration, those choices silently go
stale — the prefetch gather streams the *wrong* slice. This module is the
sensor for that failure mode, and the trigger a bank-swap subsystem would
consume.

Both inputs already exist: the policy's calibration registry
(``register_usage``, a (T, q+1) pattern-usage histogram per site) and its
aggregated runtime match histogram (``usage_runtime``, streamed by the
prefetch pre-pass through ``_record_nnz``). The divergence score is a
**population stability index** (PSI) per K-partition row, aggregated by
max — the standard "has this distribution shifted" statistic::

    psi(p, q) = sum_i (p_i - q_i) * ln(p_i / q_i)

over the q+1 pattern bins (column q = unmatched), with additive smoothing
so empty bins stay finite. Conventional reading: < 0.1 stationary, 0.1-0.25
moderate shift, > 0.25 action required — :data:`DRIFT_THRESHOLD` defaults
to the 0.25 action line.

:class:`DriftMonitor` walks the policy's sites, publishes per-site
``drift_score`` gauges plus a ``drift_alert`` counter past the threshold,
and ``site_telemetry()`` carries the same score per row (computed by
:func:`site_drift` — one code path). Deterministic by construction: pure
numpy over two integer histograms, no wall-clock, no sampling.
"""
from __future__ import annotations

from typing import Any

import numpy as np

#: PSI above which a site counts as drifted (the standard "action" line).
DRIFT_THRESHOLD = 0.25

#: Additive smoothing mass per bin, as a fraction of each histogram's total.
PSI_EPS = 1e-4


def psi(expected: Any, observed: Any, eps: float = PSI_EPS) -> float:
    """Population stability index between two 1-D count histograms.

    Both are normalised to probabilities with additive smoothing of
    ``eps`` (fraction of total mass) per bin, so empty bins contribute a
    finite penalty instead of an infinity. Returns 0.0 when either
    histogram is empty (nothing to compare yet — not a drift signal).
    """
    p = np.asarray(expected, np.float64).ravel()
    q = np.asarray(observed, np.float64).ravel()
    if p.shape != q.shape:
        raise ValueError(f"histogram shapes differ: {p.shape} vs {q.shape}")
    if p.sum() <= 0 or q.sum() <= 0:
        return 0.0
    p = (p + eps * p.sum()) / (p.sum() * (1 + eps * p.size))
    q = (q + eps * q.sum()) / (q.sum() * (1 + eps * q.size))
    return float(np.sum((p - q) * np.log(p / q)))


def site_drift(calib: Any, runtime: Any, eps: float = PSI_EPS) -> float:
    """Drift score for one site: max per-row PSI between its calibration
    and runtime (T, q+1) histograms.

    Rows are K-partitions — each has its own pattern sub-bank, so a shift
    concentrated in one partition must not be diluted by stationary ones
    (hence max, not mean). When the shapes disagree (sharded runtime
    telemetry covers a row subset), the comparison falls back to the
    per-pattern column sums — the global pattern-popularity view.
    """
    c = np.atleast_2d(np.asarray(calib, np.float64))
    r = np.atleast_2d(np.asarray(runtime, np.float64))
    if c.shape != r.shape:
        if c.shape[-1] != r.shape[-1]:
            raise ValueError(f"pattern-bin counts differ: {c.shape} vs "
                             f"{r.shape}")
        return psi(c.sum(axis=0), r.sum(axis=0), eps)
    return max(psi(cr, rr, eps) for cr, rr in zip(c, r))


class DriftMonitor:
    """Scores every calibrated+executed site of a policy and raises alerts.

    ``check()`` publishes a ``drift_score`` gauge per site and increments
    the named ``drift_alert`` counter for sites past ``threshold`` — the
    exact metric the future bank-swap subsystem subscribes to. Sites
    without runtime telemetry yet (cold, or pure-calibration) are skipped:
    no evidence is not drift.
    """

    def __init__(self, policy: Any = None, *, threshold: float = DRIFT_THRESHOLD,
                 metrics: Any = None, prefix: str = "") -> None:
        """Bind a policy (default: the process policy), an alert threshold,
        and the registry the alert metrics land in (default: the policy's
        own registry)."""
        if policy is None:
            from repro_torch.kernels import dispatch
            policy = dispatch.get_policy()
        self.policy = policy
        self.threshold = float(threshold)
        self.prefix = prefix
        self.metrics = metrics if metrics is not None else policy.metrics

    def scores(self) -> dict[str, float]:
        """Per-site drift score for every site with both a calibration
        histogram and runtime match telemetry (sorted by site name)."""
        out: dict[str, float] = {}
        for row in self.policy.site_telemetry(self.prefix):
            if row.get("drift_score") is not None:
                out[row["site"]] = row["drift_score"]
        return dict(sorted(out.items()))

    def check(self) -> dict:
        """One monitoring pass: publish gauges/alerts, return the verdict.

        Returns ``{"scores": {site: psi}, "alerts": [site, ...]}`` with
        alerts sorted — deterministic given deterministic histograms.
        """
        scores = self.scores()
        gauge = self.metrics.gauge(
            "drift_score", "PSI between calibration and runtime usage",
            labelnames=("site",))
        alert = self.metrics.counter(
            "drift_alert", "sites whose usage drift crossed the threshold",
            labelnames=("site",))
        alerts = []
        for site, score in scores.items():
            gauge.set(score, site=site)
            if score > self.threshold:
                alert.inc(site=site)
                alerts.append(site)
        return {"scores": scores, "alerts": alerts}
