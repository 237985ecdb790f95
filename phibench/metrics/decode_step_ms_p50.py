"""Median ``serve.decode_step`` span of the ticks that admit nothing: the
decode step's call to its logits on the host (the copy waits for the card),
over the ticks ``tick_span_ms_p50`` reads."""
from phibench.metrics import _spans
from phibench.stats import median


def read(run):
    return median(_spans.in_quiet_ticks(run, "serve.decode_step"))
