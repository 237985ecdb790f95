"""Observability of the port: the record tracer, the metrics registry and
the drift score the execution policy writes to and reads."""
from repro_torch.obs.trace import ListSink, Tracer, get_tracer, set_tracer

__all__ = ["ListSink", "Tracer", "get_tracer", "set_tracer"]
