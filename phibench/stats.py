"""Percentiles of a run's samples and the readers' shared arithmetic."""
from __future__ import annotations

import statistics

from phibench.work import BF16_FLOP_PER_S


def percentile(values: list[float], p: float) -> float | None:
    """The ``p``-th percentile (nearest rank) of ``values``; None if empty."""
    if not values:
        return None
    v = sorted(values)
    return v[min(len(v) - 1, max(0, -(-len(v) * p // 100) - 1))]


def median(values: list[float]) -> float | None:
    return statistics.median(values) if values else None


def mfu(run) -> float | None:
    """The window's dense-equivalent work over its length at the bf16 peak, %."""
    if run.window_s <= 0 or run.work.flops <= 0:
        return None
    return 100.0 * run.work.flops / (run.window_s * BF16_FLOP_PER_S)


def roofline(run, kernels: list[str]) -> float | None:
    """The window's spiking GEMMs' least time over the device time of the
    named kernels in the trace, %."""
    if run.summary is None or run.work.gemm_least_s <= 0:
        return None
    dev_s = run.summary.device_s(kernels)
    return 100.0 * run.work.gemm_least_s / dev_s if dev_s > 0 else None


def idle(run) -> float | None:
    """The share of the traced window in which nothing ran on the device, %."""
    s = run.summary
    if s is None or s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
