"""Median ``serve.prefill`` span: building the prompt batch to the first
token's logits on the host, the model call and the slot write or page splice
inside it."""
from phibench.metrics import _spans
from phibench.stats import median


def read(run):
    return median([_spans.ms(s) for s in _spans.spans(run, "serve.prefill") or ()])
