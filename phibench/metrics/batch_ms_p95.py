"""95th percentile of the window's per-batch latency (call to synchronise)."""
from phibench.stats import percentile


def read(run):
    return percentile(run.records.get("batch_ms", []), 95)
