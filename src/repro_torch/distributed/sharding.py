"""Logical-axis sharding: parameter specs, rule tables and per-rank shards.

Port of ``repro/distributed/sharding.py``. Models annotate every parameter
with *logical* axis names ('batch', 'heads', 'mlp', 'fsdp', ...); a rule
table (:data:`TRAIN_RULES`, :data:`SERVE_RULES`) maps each to mesh axes, and
:func:`shape_aware_spec` resolves a leaf's placement with the reference's
rules: axes absent from the mesh drop, a dim its mesh axes do not divide is
replicated, and a mesh axis shards at most one dim of a leaf (first
occurrence wins). A placement is a tuple of entries, one per dim (a mesh
axis name, a tuple of names, or None), trailing Nones dropped: the
reference's ``PartitionSpec`` as a tuple.

There is no global-view array here. A rank holds the slice of each leaf its
mesh coordinates select (:func:`local_shard`, the counterpart of
``device_put`` with a ``NamedSharding``), and the model code runs on those
local tensors with explicit collectives (``distributed.collectives``) where
the reference's ``pjit`` and ``shard_map`` put them. :func:`shard` therefore
stays a no-op on local tensors. The mesh a caller runs under is set with
:func:`use_rules` (thread-local, as in the reference); the functions here
read only its ``axis_names`` and ``shape``, so they take any object with
those two attributes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
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


# Default rule tables. Values are mesh-axis names (or tuples) or None.
TRAIN_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),   # DP over pod × data
    "seq": None,
    "act_embed": None,
    "act_heads": "model",       # TP over attention heads / mlp hidden
    "act_mlp": "model",
    "act_vocab": "model",
    "saved_seq": "model",       # remat-saved activations: shard seq over TP
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "vocab": "model",
    "experts": "model",         # EP
    "expert_mlp": "data",       # 2nd weight-shard dim for giant MoEs
    "embed": None,
    "fsdp": "data",             # ZeRO-3 parameter dim (intra-pod only)
    "layers": None,
    "state": None,
    "conv": None,
    "pattern": None,            # Phi pattern/index dims
    "pwp_tiles": "data",        # Phi PWP K-tile dim (weight-heavy side)
}

# Serving: no optimizer state; weights TP-sharded and replicated over data,
# except the giant-MoE expert_mlp dim and the Phi PWPs.
SERVE_RULES: dict[str, Any] = dict(
    TRAIN_RULES,
    fsdp=None,
    saved_seq=None,
    expert_mlp="data",
    pwp_tiles="data",
)

_local = threading.local()


def current_rules() -> dict[str, Any]:
    return getattr(_local, "rules", None) or TRAIN_RULES


def current_mesh():
    """The mesh set by the innermost :func:`use_rules`, or None (one device)."""
    return getattr(_local, "mesh", None)


@contextlib.contextmanager
def use_rules(rules: dict[str, Any], mesh=None):
    """Run the enclosed calls under ``rules`` on ``mesh`` (None: one device)."""
    prev_r = getattr(_local, "rules", None)
    prev_m = getattr(_local, "mesh", None)
    _local.rules = rules
    _local.mesh = mesh
    try:
        yield
    finally:
        _local.rules = prev_r
        _local.mesh = prev_m


def thread_context() -> tuple:
    """The rules, mesh and batch rows this thread runs under, for code that
    runs later on another thread under the same context (autograd runs a
    card tensor's backward, and a checkpointed body's recompute, on its own
    device thread)."""
    return (getattr(_local, "rules", None), getattr(_local, "mesh", None),
            getattr(_local, "batch_rows", None))


@contextlib.contextmanager
def use_thread_context(ctx: tuple):
    """Run the enclosed calls under a :func:`thread_context` taken elsewhere."""
    prev = thread_context()
    _local.rules, _local.mesh, _local.batch_rows = ctx
    try:
        yield
    finally:
        _local.rules, _local.mesh, _local.batch_rows = prev


def batch_rows() -> tuple[int, int] | None:
    """(global rows, first local row) of the batch the enclosed calls run on,
    as set by the innermost :func:`use_batch_rows` (None: the local batch is
    the global one)."""
    return getattr(_local, "batch_rows", None)


@contextlib.contextmanager
def use_batch_rows(rows: int, first: int):
    """Declare that the enclosed calls run on the block of a global batch of
    ``rows`` rows that starts at row ``first``."""
    prev = getattr(_local, "batch_rows", None)
    _local.batch_rows = (rows, first)
    try:
        yield
    finally:
        _local.batch_rows = prev


def resolve_spec(axes: tuple[str | None, ...], rules: dict[str, Any] | None = None,
                 mesh=None) -> tuple:
    """Map logical axes -> placement, dropping axes absent from the mesh."""
    rules = rules or current_rules()
    mesh = mesh or current_mesh()
    names = set(mesh.axis_names) if mesh is not None else {"pod", "data", "model"}
    out = []
    for ax in axes:
        m = rules.get(ax) if ax is not None else None
        if isinstance(m, tuple):
            m = tuple(x for x in m if x in names) or None
            if isinstance(m, tuple) and len(m) == 1:
                m = m[0]
        elif m is not None and m not in names:
            m = None
        out.append(m)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def shard(x: torch.Tensor, *axes: str | None) -> torch.Tensor:
    """Constrain activation sharding by logical axes: a no-op, since every
    tensor the model code sees is already its rank's local slice."""
    return x


def axis_names_of(ax) -> tuple[str, ...]:
    """The mesh axes of one placement entry (a name, a tuple of names, None)."""
    if ax is None:
        return ()
    return ax if isinstance(ax, tuple) else (ax,)


def axis_size(mesh, ax) -> int:
    """Total extent of a placement entry (mesh axis name, tuple of names, or
    None): the shard count of a dim partitioned over ``ax``."""
    return math.prod(mesh.shape[a] for a in axis_names_of(ax))


def shape_aware_spec(shape: tuple[int, ...], axes: tuple, mesh,
                     rules: dict[str, Any] | None = None) -> tuple:
    """resolve_spec + divisibility fallback: a dim that is not divisible by
    its mesh-axis product is replicated instead (e.g. vocab 50280 on 16-way
    'model', or batch 1 on the DP axes), and a mesh axis shards at most one
    dim (first occurrence wins)."""
    p = resolve_spec(axes, rules, mesh)
    entries = list(p) + [None] * (len(shape) - len(p))
    out = []
    used: set = set()
    for dim, ax in zip(shape, entries):
        if ax is not None and dim % axis_size(mesh, ax) != 0:
            ax = None
        if ax is not None:
            names = axis_names_of(ax)
            if any(n in used for n in names):
                ax = None
            else:
                used.update(names)
        out.append(ax)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def specs_to_shardings(specs: Any, mesh, rules: dict[str, Any]) -> Any:
    """The placement of every leaf of a spec tree (same structure): per
    leaf, the mesh axes each dim is split over."""
    if is_spec(specs):
        return shape_aware_spec(specs.shape, specs.axes, mesh, rules)
    return {k: specs_to_shardings(v, mesh, rules) for k, v in specs.items()}


def local_shape(shape: tuple[int, ...], placement: tuple, mesh) -> tuple[int, ...]:
    """The shape of one rank's slice of a leaf of ``shape`` under ``placement``."""
    ents = tuple(placement) + (None,) * (len(shape) - len(placement))
    return tuple(d // axis_size(mesh, ax) for d, ax in zip(shape, ents))


def shard_slices(shape: tuple[int, ...], placement: tuple, mesh,
                 coords: dict[str, int] | None = None) -> tuple[slice, ...]:
    """The index of the block of a global array of ``shape`` that the rank at
    ``coords`` (default: the mesh's own rank) holds under ``placement``: each
    split dim cut into equal blocks, block index the rank's row-major index
    over that dim's mesh axes."""
    coords = mesh.coords if coords is None else coords
    out = []
    for dim, ax in enumerate(tuple(placement) + (None,) * (len(shape) - len(placement))):
        if ax is None:
            out.append(slice(None))
            continue
        idx = 0
        for a in axis_names_of(ax):
            idx = idx * mesh.shape[a] + coords[a]
        size = shape[dim] // axis_size(mesh, ax)
        out.append(slice(idx * size, (idx + 1) * size))
    return tuple(out)


def local_shard(x: torch.Tensor, placement: tuple, mesh,
                coords: dict[str, int] | None = None) -> torch.Tensor:
    """The slice of the full tensor ``x`` that the rank at ``coords`` (default:
    the mesh's own rank) holds under ``placement`` (:func:`shard_slices`). A
    view; callers that keep a shard apart from ``x`` copy it."""
    return x[shard_slices(tuple(x.shape), placement, mesh, coords)]


def place(tree: Any, placements: Any, mesh, coords: dict[str, int] | None = None,
          copy: bool = True) -> Any:
    """A rank's shards of a tree of full tensors (:func:`local_shard` at each
    leaf), each a contiguous copy unless ``copy`` is False."""
    if isinstance(tree, dict):
        return {k: place(v, placements[k], mesh, coords, copy) for k, v in tree.items()}
    out = local_shard(tree, placements, mesh, coords)
    return out.contiguous().clone() if copy else out


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
