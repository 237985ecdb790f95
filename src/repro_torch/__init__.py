"""PyTorch/CUDA port of the Phi SNN system (Hopper kernels beside plain versions).

The JAX package ``repro`` is the reference; this package imports nothing of
it and no JAX. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; :func:`resolve_device` raises when CUDA is asked for but
absent.
"""
from repro_torch.utils import resolve_device

__all__ = ["resolve_device"]
