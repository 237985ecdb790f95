"""Median, over requests, of ``serve.admit`` less ``serve.submit``: the wait
in the engine's queue before the scheduler admits a request."""
from phibench.metrics import _spans
from phibench.stats import median


def read(run):
    found = _spans.spans(run, "serve.submit", "serve.admit")
    sub, admit = _spans.first_at(found, "serve.submit"), _spans.first_at(found, "serve.admit")
    return median([(t - sub[rid]) / 1e6 for rid, t in admit.items() if rid in sub])
