"""Declarative parameters: specs, their initialisation and byte counts.

The single-device half of ``repro/distributed/sharding.py``. A
:class:`ParamSpec` names a parameter's shape, dtype, logical axes and init
law; model code builds nested dicts of specs (``models.model.lm_specs``)
and :func:`init_params` turns them into tensors under the same key paths.
The logical axes are kept so that the mesh half (DeviceMesh/DTensor rules)
can read them later; on one device nothing is sharded, and :func:`shard`
returns its input.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.utils import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declarative parameter: shape + dtype + logical axes + init law."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    dtype: Any = torch.float32
    init: str = "normal"      # normal | zeros | ones | scaled
    scale: float | None = None

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


def is_spec(x: Any) -> bool:
    return isinstance(x, ParamSpec)


def shard(x: torch.Tensor, *axes: str | None) -> torch.Tensor:
    """Constrain activation sharding by logical axes: a no-op on one device."""
    return x


def _init_one(spec: ParamSpec, gen: torch.Generator, device: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    scale = spec.scale if spec.scale is not None else 1.0 / math.sqrt(fan_in)
    x = torch.randn(spec.shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (x.to(device) * scale).to(spec.dtype)


def init_params(specs: Any, gen: torch.Generator,
                device: str | torch.device | None = None) -> Any:
    """Tensors for a spec tree, under the same key paths, on ``device``
    (``cuda`` unless the caller names another).

    The reference's laws (``_init_one``): zeros, ones, or a float32 normal
    times ``scale`` (default 1/sqrt(fan_in), fan_in the second-last dim)
    cast to the spec's dtype. Leaves draw from ``gen`` one after another,
    keys sorted at each level as ``jax.tree.flatten`` walks a dict, and the
    tree keeps that order; the draws happen on the generator's device and
    move to ``device``. ``jax.random`` streams cannot be replayed here, so
    parity tests carry the reference's params across (``interop``).
    """
    device = resolve_device(device)

    def build(node):
        if is_spec(node):
            return _init_one(node, gen, device)
        return {k: build(node[k]) for k in sorted(node)}

    return build(specs)


def _leaves(specs: Any):
    if is_spec(specs):
        yield specs
    else:
        for v in specs.values():
            yield from _leaves(v)


def param_bytes(specs: Any) -> int:
    """Bytes the spec tree takes once allocated."""
    return sum(math.prod(s.shape) * s.dtype.itemsize for s in _leaves(specs))
