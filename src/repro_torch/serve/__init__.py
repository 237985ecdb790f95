"""Serving: the continuous-batching engine, its paged KV cache, the
telemetry-driven scheduler and token sampling (port of ``repro/serve``)."""
