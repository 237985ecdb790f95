"""Median time from a request's submission to its first token."""
from phibench.stats import median


def read(run):
    return median(run.records.get("ttft_ms", []))
