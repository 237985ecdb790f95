"""Observability of the port: the record tracer the execution policy writes to.

The reference package's metrics registry and drift monitor come with the
matmul half of the execution policy, which feeds them.
"""
from repro_torch.obs.trace import ListSink, Tracer, get_tracer, set_tracer

__all__ = ["ListSink", "Tracer", "get_tracer", "set_tracer"]
