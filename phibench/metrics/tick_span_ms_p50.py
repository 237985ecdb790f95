"""Median ``serve.tick`` span of the ticks that admit nothing (a decode
step, its sampling and the host loop), timed inside the engine."""
from phibench.metrics import _spans
from phibench.stats import median


def read(run):
    return median([_spans.ms(s) for s in _spans.spans(run, "serve.tick") or ()
                   if s["admitted"] == 0])
