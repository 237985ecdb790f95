"""Hopper kernels, their plain PyTorch versions and the ops layer.

``IMPLS`` is the port's copy of the reference execution policy's lowering
names (``repro/kernels/dispatch.py::IMPLS``); ``PhiConfig`` validates against
it. Only ``ref``, ``coo`` and ``fused`` are ported so far.
"""

IMPLS = ("fused", "fused_stream", "fused_prefetch", "pallas", "coo", "ref")
