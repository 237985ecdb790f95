"""Median, over requests, of ``serve.first_token`` less ``serve.submit``: time
to first token from the engine's own events."""
from phibench.metrics import _spans
from phibench.stats import median


def read(run):
    found = _spans.spans(run, "serve.submit", "serve.first_token")
    sub, first = _spans.first_at(found, "serve.submit"), _spans.first_at(found, "serve.first_token")
    return median([(t - sub[rid]) / 1e6 for rid, t in first.items() if rid in sub])
