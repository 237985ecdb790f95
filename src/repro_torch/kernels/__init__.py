"""Hopper kernels, their plain PyTorch versions, the ops layer and the policy.

``IMPLS`` and ``ATTN_IMPLS`` are the port's copies of the reference execution
policy's lowering names (``repro/kernels/dispatch.py``); ``PhiConfig``
validates against ``IMPLS``. Every matmul lowering but ``pallas`` (the
three per-unit kernels) is ported; both attention lowerings are.
"""

IMPLS = ("fused", "fused_stream", "fused_prefetch", "pallas", "coo", "ref")
# "phi_flash": pattern-hierarchical flash attention (kernels/phi_attention.py);
# "flash": the dense blockwise lowering (models/flash.py). Only binary spike
# Q/K sites with a calibrated pattern bank resolve "phi_flash".
ATTN_IMPLS = ("phi_flash", "flash")
