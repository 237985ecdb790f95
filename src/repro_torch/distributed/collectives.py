"""A rank's view of a device mesh, and the collectives the model code calls.

:class:`Mesh` is what ``launch.mesh.make_mesh`` returns on each rank: the
axis names and sizes (what ``distributed.sharding`` reads), the rank's
coordinate on each axis, the ``torch.distributed`` groups of every axis and
of every tuple of axes, the device the rank computes on and the backend its
world was set up with.

Every collective of the port goes through :func:`all_reduce`,
:func:`all_gather`, :func:`all_to_all`, :func:`sum_grad` and the
:func:`send` / :func:`recv` pair, each over a placement entry (one mesh axis,
a tuple of them, or None: no collective). They run on the tensors where they
lie, with the world's backend: NCCL where every rank has a card of its own,
gloo otherwise (several ranks sharing one card, where NCCL refuses two ranks
on a device). Gloo takes card tensors for the collectives and moves them
through host memory itself; its send and recv read a tensor's pointer as
host memory, so :func:`send` and :func:`recv` stage card tensors through
host buffers themselves. The mesh's ``transport`` says which case holds,
``stats`` counts the calls and input bytes of each collective, the
backward's too, so a caller can report them, and ``results`` counts the
calls and result bytes of each under the reference's kinds (:data:`KINDS`),
as ``repro/distributed/hlo_analysis.py`` counts a compiled program's.

The collectives carry gradients where autograd needs them, as Megatron's
tensor-parallel regions do: a sum's backward is the identity (each rank
holds the whole upstream gradient of a replicated result),
:func:`sum_grad` is the conjugate (identity forward, the gradient summed:
a replicated activation entering a sharded computation), an all-gather's
backward is the reduce-scatter to the rank's slice, and an all-to-all's the
inverse exchange (the same exchange). Under ``torch.no_grad()`` each runs the
code it ran before gradients existed, so serving's bits do not move.
:func:`send` and :func:`recv` move bits only and carry no gradient.
"""
from __future__ import annotations

import itertools
import math
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import axis_names_of

# The reference's collective kinds (``hlo_analysis._COLLECTIVES``) of the
# operations ``Mesh.stats`` counts: a reduce-scatter is an exchange here and a
# collective-permute a send and a recv, whose result is what the recv takes.
KINDS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
         "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
         "recv": "collective-permute"}


class Mesh:
    """One rank's view of a ``data`` × ``model`` (× ``pod``) mesh of ranks.

    ``axis_names`` and ``shape`` (an ordered dict, axis -> size) are the
    reference's ``jax.sharding.Mesh`` attributes; ``coords`` maps each axis
    to this rank's index on it (row-major over the world's ranks);
    ``groups`` maps each tuple of axes, in mesh order, to its process group;
    ``device_mesh`` is the ``torch.distributed.device_mesh.DeviceMesh`` the
    per-axis groups come from (None for a mesh built by hand). ``stats``
    maps each operation to [calls, input bytes], ``results`` each of the
    reference's kinds to [calls, result bytes].
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
        self.results: dict[str, list[int]] = {}

    @property
    def transport(self) -> str:
        """How the collectives move data: ``nccl`` (card to card), ``gloo``
        (host tensors), or ``gloo on card tensors`` (gloo copies them through
        host memory)."""
        if self.backend == "gloo" and self.device.type == "cuda":
            return "gloo on card tensors (through host memory)"
        return self.backend

    @property
    def p2p_transport(self) -> str:
        """How :func:`send` and :func:`recv` move data: as ``transport``,
        except that under gloo a card tensor is copied to a host buffer by
        the helper (gloo's send and recv take host memory only)."""
        if self.backend == "gloo" and self.device.type == "cuda":
            return "gloo, card tensors staged through host buffers by send/recv"
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
def _count(mesh: Mesh, op: str, x: torch.Tensor, result_bytes: int | None = None) -> None:
    """Count a call of ``op`` on ``x`` in ``mesh.stats`` and, under its kind,
    its result (default: ``x``'s size) in ``mesh.results``."""
    nbytes = x.numel() * x.element_size()
    calls = mesh.stats.setdefault(op, [0, 0])
    calls[0] += 1
    calls[1] += nbytes
    if op in KINDS:
        res = mesh.results.setdefault(KINDS[op], [0, 0])
        res[0] += 1
        res[1] += nbytes if result_bytes is None else result_bytes


def _begin(x: torch.Tensor, mesh: Mesh, op: str, result_bytes: int | None = None
           ) -> torch.Tensor:
    """The buffer a collective works on (a contiguous copy of ``x``, never a
    tensor autograd saved), with the call counted (:func:`_count`)."""
    _count(mesh, op, x, result_bytes)
    return x.detach().contiguous().clone()


def _needs_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _all_reduce(x: torch.Tensor, mesh: Mesh, ax, op: str = "sum",
                name: str = "all_reduce") -> torch.Tensor:
    buf = _begin(x, mesh, name)
    dist.all_reduce(buf, op=_OPS[op], group=mesh.group(ax))
    return buf


def _all_gather(x: torch.Tensor, mesh: Mesh, ax, dim: int) -> torch.Tensor:
    buf = _begin(x, mesh, "all_gather", mesh.extent(ax) * x.numel() * x.element_size())
    parts = [torch.empty_like(buf) for _ in range(mesh.extent(ax))]
    dist.all_gather(parts, buf, group=mesh.group(ax))
    return torch.cat(parts, dim=dim)


def _all_to_all(x: torch.Tensor, mesh: Mesh, ax, name: str = "all_to_all",
                result_bytes: int | None = None) -> torch.Tensor:
    buf = _begin(x, mesh, name, result_bytes)
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, group=mesh.group(ax))
    return out


def _reduce_scatter(g: torch.Tensor, mesh: Mesh, ax, dim: int) -> torch.Tensor:
    """The sum over the ranks of ``ax`` of ``g``, of which this rank keeps its
    block along ``dim``: an exchange of the blocks (gloo has no
    reduce-scatter), then the ranks' blocks summed in rank order."""
    n = mesh.extent(ax)
    blocks = _all_to_all(g.movedim(dim, 0), mesh, ax, "reduce_scatter",
                         g.numel() // n * g.element_size())
    out = blocks.reshape(n, blocks.shape[0] // n, *blocks.shape[1:]).sum(0)
    return out.movedim(0, dim)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, ax):
        return _all_reduce(x, mesh, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, ax):
        ctx.mesh, ctx.ax = mesh, ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.ax), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, ax, dim):
        ctx.mesh, ctx.ax, ctx.dim = mesh, ax, dim
        return _all_gather(x, mesh, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.mesh, ctx.ax, ctx.dim), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, ax):
        ctx.mesh, ctx.ax = mesh, ax
        return _all_to_all(x, mesh, ax)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.mesh, ctx.ax), None, None


def _block(x: torch.Tensor, mesh: Mesh, ax, dim: int) -> torch.Tensor:
    n = x.shape[dim] // mesh.extent(ax)
    return x.narrow(dim, mesh.index(ax) * n, n).clone(memory_format=torch.contiguous_format)


class _KeepBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, ax, dim):
        ctx.mesh, ctx.ax, ctx.dim = mesh, ax, dim
        return _block(x, mesh, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g.contiguous(), ctx.mesh, ctx.ax, ctx.dim), None, None, None


class _GatherBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, ax, dim):
        ctx.mesh, ctx.ax, ctx.dim = mesh, ax, dim
        return _all_gather(x, mesh, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.mesh, ctx.ax, ctx.dim), None, None, None


def keep_block(x: torch.Tensor, mesh: Mesh, ax, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` (cut into ``mesh.extent(ax)`` blocks) of
    an ``x`` replicated over ``ax``, as a tensor of its own; with
    :func:`gather_blocks` after it, a replicated activation stored as 1 / n
    of itself. Its gradient is the ranks' gradient blocks all-gathered: the
    gradient of a replicated activation is whole on every rank, and
    :func:`gather_blocks` hands each rank its own block of it."""
    return _KeepBlock.apply(x, mesh, ax, dim)


def gather_blocks(x: torch.Tensor, mesh: Mesh, ax, dim: int) -> torch.Tensor:
    """The inverse of :func:`keep_block`: the ranks' blocks all-gathered along
    ``dim``, whose gradient is this rank's block of the (whole, replicated)
    gradient, with no communication."""
    return _GatherBlocks.apply(x, mesh, ax, dim)


def all_reduce(x: torch.Tensor, mesh: Mesh | None, ax, op: str = "sum") -> torch.Tensor:
    """Sum (or ``op="max"``: maximum) of ``x`` over the ranks of ``ax`` (a new
    tensor on ``x``'s device). The sum's backward is the identity; the
    maximum carries no gradient."""
    if mesh is None or mesh.extent(ax) == 1:
        return x
    if op != "sum":
        return _all_reduce(x, mesh, ax, op)
    if _needs_grad(x):
        return _AllReduce.apply(x, mesh, ax)
    return _all_reduce(x, mesh, ax)


def sum_grad(x: torch.Tensor, mesh: Mesh | None, ax) -> torch.Tensor:
    """``x`` itself, whose gradient is summed over the ranks of ``ax``: where
    an activation (or a leaf) replicated over ``ax`` enters a computation
    each rank of ``ax`` does a part of. Off autograd, ``x`` unchanged."""
    if mesh is None or mesh.extent(ax) == 1 or not _needs_grad(x):
        return x
    return _SumGrad.apply(x, mesh, ax)


def all_gather(x: torch.Tensor, mesh: Mesh | None, ax, dim: int) -> torch.Tensor:
    """The ranks' ``x`` of ``ax`` concatenated along ``dim`` in index order.
    Its backward is the reduce-scatter: the gradient summed over the ranks,
    this rank's block kept."""
    if mesh is None or mesh.extent(ax) == 1:
        return x
    if _needs_grad(x):
        return _AllGather.apply(x, mesh, ax, dim % x.ndim)
    return _all_gather(x, mesh, ax, dim)


def all_to_all(x: torch.Tensor, mesh: Mesh | None, ax) -> torch.Tensor:
    """``x``'s dim 0 cut into one block per rank of ``ax``; block i goes to
    rank i, and the blocks received come back concatenated in rank order (the
    reference's ``lax.all_to_all(x, ax, 0, 0, tiled=True)``). The exchange is
    its own inverse, and so its own backward."""
    if mesh is None or mesh.extent(ax) == 1:
        return x
    if x.shape[0] % mesh.extent(ax):
        raise ValueError(f"all_to_all: dim 0 of {tuple(x.shape)} does not split "
                         f"{mesh.extent(ax)} ways")
    if _needs_grad(x):
        return _AllToAll.apply(x, mesh, ax)
    return _all_to_all(x, mesh, ax)


def gather_global(x: torch.Tensor, placement: tuple, mesh: Mesh | None) -> torch.Tensor:
    """The global tensor whose shard under ``placement`` is this rank's
    ``x``: :func:`all_gather` along every split dim (every rank of the mesh
    must call it, and gets the whole)."""
    for dim, ax in enumerate(placement):
        if ax is not None:
            x = all_gather(x, mesh, ax, dim)
    return x


def _peer(mesh: Mesh, ax, index: int) -> int:
    """The world rank at ``index`` along ``ax`` that shares this rank's other
    coordinates."""
    return dist.get_global_rank(mesh.group(ax), index)


def _staged(mesh: Mesh, x: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and x.device.type != "cpu"


def send(x: torch.Tensor, mesh: Mesh, ax, index: int) -> None:
    """Send ``x`` to the rank at ``index`` along ``ax`` (blocking; bits only,
    no gradient). Under gloo a card tensor goes through a host copy."""
    buf = _begin(x, mesh, "send")
    if _staged(mesh, buf):
        buf = buf.cpu()
    dist.send(buf, dst=_peer(mesh, ax, index))


def recv(like: torch.Tensor, mesh: Mesh, ax, index: int) -> torch.Tensor:
    """A tensor shaped, typed and placed as ``like``, received from the rank
    at ``index`` along ``ax`` (blocking). Under gloo a card tensor arrives in
    a host buffer and is copied onto the card."""
    _count(mesh, "recv", like)
    staged = _staged(mesh, like)
    buf = torch.empty(like.shape, dtype=like.dtype,
                      device="cpu" if staged else like.device)
    dist.recv(buf, src=_peer(mesh, ax, index))
    return buf.to(like.device) if staged else buf
