"""Sparsity-drift score: PSI between calibration and runtime pattern usage.

The part of the reference package's ``obs/drift.py`` that the execution
policy's ``site_telemetry`` reads. The score is a population stability
index per K-partition row of two (T, q+1) histograms (the calibration
usage and the aggregated runtime match histogram), aggregated by max::

    psi(p, q) = sum_i (p_i - q_i) * ln(p_i / q_i)

with additive smoothing so empty bins stay finite. Conventional reading:
< 0.1 stationary, 0.1-0.25 moderate shift, > 0.25 action required.
"""
from __future__ import annotations

from typing import Any

import numpy as np

#: Additive smoothing mass per bin, as a fraction of each histogram's total.
PSI_EPS = 1e-4


def psi(expected: Any, observed: Any, eps: float = PSI_EPS) -> float:
    """Population stability index between two 1-D count histograms.

    Both are normalised to probabilities with additive smoothing of ``eps``
    (fraction of total mass) per bin. Returns 0.0 when either histogram is
    empty (nothing to compare yet: not a drift signal).
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
    and runtime (T, q+1) histograms. When the shapes disagree, the per-
    pattern column sums are compared instead."""
    c = np.atleast_2d(np.asarray(calib, np.float64))
    r = np.atleast_2d(np.asarray(runtime, np.float64))
    if c.shape != r.shape:
        if c.shape[-1] != r.shape[-1]:
            raise ValueError(f"pattern-bin counts differ: {c.shape} vs {r.shape}")
        return psi(c.sum(axis=0), r.sum(axis=0), eps)
    return max(psi(cr, rr, eps) for cr, rr in zip(c, r))
