"""Median ``serve.sample`` span of the ticks that admit nothing: the host
sampling of the decode step's logits while the card sits drained, over the
ticks ``tick_span_ms_p50`` reads."""
from phibench.metrics import _spans
from phibench.stats import median


def read(run):
    return median(_spans.in_quiet_ticks(run, "serve.sample"))
