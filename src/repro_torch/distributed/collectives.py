"""A rank's view of a device mesh, and the collectives the model code calls.

:class:`Mesh` is what ``launch.mesh.make_mesh`` returns on each rank: the
axis names and sizes (what ``distributed.sharding`` reads), the rank's
coordinate on each axis, the ``torch.distributed`` groups of every axis and
of every tuple of axes, the device the rank computes on and the backend its
world was set up with.

Every collective of the port goes through :func:`all_reduce`,
:func:`all_gather` and :func:`all_to_all`, each over a placement entry (one
mesh axis, a tuple of them, or None: no collective). They run on the tensors
where they lie, with the world's backend: NCCL where every rank has a card of
its own, gloo otherwise (several ranks sharing one card, where NCCL refuses
two ranks on a device). Gloo takes card tensors for all three and moves them
through host memory itself; the mesh's ``transport`` says which case holds,
and ``stats`` counts the calls and bytes of each collective so a caller can
report them.

The collectives are inference only: they carry no gradient, and a tensor that
requires one is refused (training on a mesh is not ported yet).
"""
from __future__ import annotations

import itertools
import math
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import axis_names_of


class Mesh:
    """One rank's view of a ``data`` × ``model`` (× ``pod``) mesh of ranks.

    ``axis_names`` and ``shape`` (an ordered dict, axis -> size) are the
    reference's ``jax.sharding.Mesh`` attributes; ``coords`` maps each axis
    to this rank's index on it (row-major over the world's ranks);
    ``groups`` maps each tuple of axes, in mesh order, to its process group;
    ``device_mesh`` is the ``torch.distributed.device_mesh.DeviceMesh`` the
    per-axis groups come from (None for a mesh built by hand).
    """

    def __init__(self, axis_names: tuple[str, ...], shape: tuple[int, ...], *, rank: int,
                 device: torch.device, backend: str, groups: dict | None = None,
                 device_mesh: Any = None):
        if len(axis_names) != len(shape):
            raise ValueError(f"mesh axes {axis_names} and shape {shape} differ in rank")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in shape)))
        self.size = math.prod(self.shape.values())
        self.rank = rank
        self.coords = dict(zip(self.axis_names,
                               (int(i) for i in _unravel(rank, tuple(self.shape.values())))))
        self.device = torch.device(device)
        self.backend = backend
        self.groups = groups or {}
        self.device_mesh = device_mesh
        self.stats: dict[str, list[int]] = {}

    @property
    def transport(self) -> str:
        """How the collectives move data: ``nccl`` (card to card), ``gloo``
        (host tensors), or ``gloo on card tensors`` (gloo copies them through
        host memory)."""
        if self.backend == "gloo" and self.device.type == "cuda":
            return "gloo on card tensors (through host memory)"
        return self.backend

    def axes(self, ax) -> tuple[str, ...]:
        """The mesh axes of a placement entry, in mesh order."""
        names = axis_names_of(ax)
        unknown = set(names) - set(self.axis_names)
        if unknown:
            raise ValueError(f"axes {sorted(unknown)} are not in the mesh {self.axis_names}")
        return tuple(a for a in self.axis_names if a in names)

    def extent(self, ax) -> int:
        """Ranks a dim split over ``ax`` is cut among."""
        return math.prod(self.shape[a] for a in self.axes(ax))

    def index(self, ax) -> int:
        """This rank's block index along ``ax`` (row-major over its axes)."""
        idx = 0
        for a in self.axes(ax):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, ax):
        """The process group of the ranks that share every coordinate but
        those on ``ax``; its group ranks run in :meth:`index` order."""
        return self.groups[self.axes(ax)]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank} at {self.coords}, {self.device}, "
                f"{self.transport})")


def _unravel(rank: int, shape: tuple[int, ...]) -> tuple[int, ...]:
    out = []
    for n in reversed(shape):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


def build_groups(axis_names: tuple[str, ...], shape: tuple[int, ...], per_axis: dict) -> dict:
    """Process groups for every tuple of mesh axes: the single axes from
    ``per_axis`` (the DeviceMesh's), the whole mesh as the world group, and
    every other tuple from ``dist.new_group``. Every rank makes every group,
    in one order, as ``new_group`` requires."""
    groups = {(a,): per_axis[a] for a in axis_names}
    groups[tuple(axis_names)] = dist.group.WORLD
    ranks = torch.arange(math.prod(shape)).reshape(shape)
    for r in range(2, len(axis_names)):
        for sub in itertools.combinations(range(len(axis_names)), r):
            rest = [i for i in range(len(axis_names)) if i not in sub]
            block = ranks.permute(*rest, *sub).reshape(-1, math.prod(shape[i] for i in sub))
            mine = None
            for row in block.tolist():
                g = dist.new_group(ranks=row)
                if dist.get_rank() in row:
                    mine = g
            groups[tuple(axis_names[i] for i in sub)] = mine
    return groups


# ----------------------------------------------------------- collectives ---
def _begin(x: torch.Tensor, mesh: Mesh, op: str) -> torch.Tensor:
    """The buffer a collective works on (a contiguous copy of ``x``), with the
    call counted in ``mesh.stats``."""
    if x.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(f"{op} on the mesh carries no gradient: collectives are inference "
                           "only (training on a mesh is not ported)")
    calls = mesh.stats.setdefault(op, [0, 0])
    calls[0] += 1
    calls[1] += x.numel() * x.element_size()
    return x.detach().contiguous().clone()


def all_reduce(x: torch.Tensor, mesh: Mesh | None, ax) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``ax`` (a new tensor on ``x``'s device)."""
    if mesh is None or mesh.extent(ax) == 1:
        return x
    buf = _begin(x, mesh, "all_reduce")
    dist.all_reduce(buf, group=mesh.group(ax))
    return buf


def all_gather(x: torch.Tensor, mesh: Mesh | None, ax, dim: int) -> torch.Tensor:
    """The ranks' ``x`` of ``ax`` concatenated along ``dim`` in index order."""
    if mesh is None or mesh.extent(ax) == 1:
        return x
    buf = _begin(x, mesh, "all_gather")
    parts = [torch.empty_like(buf) for _ in range(mesh.extent(ax))]
    dist.all_gather(parts, buf, group=mesh.group(ax))
    return torch.cat(parts, dim=dim)


def all_to_all(x: torch.Tensor, mesh: Mesh | None, ax) -> torch.Tensor:
    """``x``'s dim 0 cut into one block per rank of ``ax``; block i goes to
    rank i, and the blocks received come back concatenated in rank order (the
    reference's ``lax.all_to_all(x, ax, 0, 0, tiled=True)``)."""
    if mesh is None or mesh.extent(ax) == 1:
        return x
    if x.shape[0] % mesh.extent(ax):
        raise ValueError(f"all_to_all: dim 0 of {tuple(x.shape)} does not split "
                         f"{mesh.extent(ax)} ways")
    buf = _begin(x, mesh, "all_to_all")
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, group=mesh.group(ax))
    return out

