"""Median ``snn.phi_apply`` span: the host's time to enqueue one batch, which
returns before the card has finished it."""
from phibench.metrics import _spans
from phibench.stats import median


def read(run):
    return median([_spans.ms(s) for s in _spans.spans(run, "snn.phi_apply") or ()])
