"""Median time of a ``model.prefill_padded`` call between two
synchronisations (the traced run's own wrapper)."""
from phibench.stats import median


def read(run):
    return median(run.records.get("prefill_ms", []))
