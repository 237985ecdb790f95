"""Meshes of ranks: the world, its backend, the mesh over it, local spawning.

Port of ``repro/launch/mesh.py``. The reference builds a ``jax`` mesh over
the devices one process sees; here a mesh is a world of processes, one per
rank, and each rank holds a :class:`~repro_torch.distributed.collectives.Mesh`
(its coordinates, the ``DeviceMesh`` per-axis groups and the backend).

* :func:`init_world` joins a rank to its world: rank r computes on
  ``cuda:(r % device_count)``, or on the CPU when asked. The backend is NCCL
  when every rank has a card of its own and gloo otherwise (ranks sharing a
  card, or CPU ranks): NCCL refuses two ranks on one device.
* :func:`make_mesh` builds the mesh over the current world;
  :func:`make_production_mesh` gives the reference's shapes and axis names
  and refuses a world too small for them.
* :func:`spawn_ranks` runs a function in N local ranks (the ``spawn`` start
  method), each joined to a world over a file store, with a deadline: a rank
  that raises, dies or outlives the deadline fails the world at once, and
  every process is stopped.
"""
from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.distributed.collectives import Mesh, build_groups

PRODUCTION_SHAPES = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}
_world_device: torch.device | None = None     # where init_world put this rank


def init_world(rank: int, world_size: int, *, device: str | torch.device = "cuda",
               init_method: str = "env://", timeout: float = 300.0) -> str:
    """Join rank ``rank`` to a world of ``world_size`` and return its backend.

    ``device="cuda"`` puts rank r on ``cuda:(r % device_count)`` and picks
    NCCL when ``world_size <= device_count`` (a card a rank), gloo otherwise;
    ``device="cpu"`` picks gloo. ``timeout`` bounds the rendezvous and every
    collective after it."""
    global _world_device
    dev = torch.device(device)
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("init_world: device='cuda' but no card is visible")
        dev = torch.device("cuda", rank % n)
        torch.cuda.set_device(dev)
        backend = "nccl" if world_size <= n else "gloo"
    else:
        backend = "gloo"
    _world_device = dev
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout))
    return backend


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device: str | torch.device | None = None) -> Mesh:
    """The (``shape``, ``axes``) mesh over the current world: rank r at the
    row-major coordinate of r. ``device`` is where this rank computes
    (default: where ``init_world`` put it; else its card)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no world; join one first (init_world, torchrun)")
    world = dist.get_world_size()
    size = 1
    for n in shape:
        size *= n
    if size != world:
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs {size} ranks; the world has "
                         f"{world}")
    backend = dist.get_backend()
    if device is not None:
        dev = torch.device(device)
    elif _world_device is not None:
        dev = _world_device
    else:
        dev = torch.device("cuda", torch.cuda.current_device())
    dm = init_device_mesh("cuda" if backend == "nccl" else "cpu", tuple(shape),
                          mesh_dim_names=tuple(axes))
    groups = build_groups(tuple(axes), tuple(shape), {a: dm.get_group(a) for a in axes})
    return Mesh(tuple(axes), tuple(shape), rank=dist.get_rank(), device=dev, backend=backend,
                groups=groups, device_mesh=dm)


def make_production_mesh(*, multi_pod: bool = False,
                         device: str | torch.device | None = None) -> Mesh:
    """16×16 (one pod) or 2×16×16 (two pods) ranks, axes ('data', 'model')
    or ('pod', 'data', 'model'), as the reference's. Refuses a world of
    another size."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    need = 1
    for n in shape:
        need *= n
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(f"the production mesh {dict(zip(axes, shape))} needs a world of "
                         f"{need} ranks; this one has {world}")
    return make_mesh(shape, axes, device)


# -------------------------------------------------------------- spawning ---
def _rank_main(fn: Callable, rank: int, world_size: int, store: str, device: str,
               timeout: float, threads: int, args: tuple, results) -> None:
    try:
        torch.set_num_threads(threads)
        init_world(rank, world_size, device=device, init_method=f"file://{store}",
                   timeout=timeout)
        out = fn(rank, *args)
        dist.barrier()             # no rank leaves while another still talks to it
        results.put((rank, "ok", out))
    except BaseException:      # reported to the parent, which fails the world
        results.put((rank, "error", traceback.format_exc()))
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn: Callable, world_size: int, rank_args: list[tuple] | None = None, *,
                device: str = "cuda", timeout: float = 600.0, threads: int = 1) -> list[Any]:
    """Run ``fn(rank, *rank_args[rank])`` in ``world_size`` new processes,
    each joined to one world (``init_world`` over a file store) before the
    call; return the ranks' return values in rank order.

    ``fn`` and its arguments must pickle (a module-level function; card
    tensors travel as CUDA IPC handles, so the caller keeps them alive until
    this returns); the values must pickle too. Fails the world, stopping
    every process, when a rank raises (its traceback in the error), exits
    without a result, or ``timeout`` seconds pass; the same timeout bounds
    each collective inside the world."""
    import torch.multiprocessing as mp

    rank_args = rank_args or [()] * world_size
    if len(rank_args) != world_size:
        raise ValueError(f"{len(rank_args)} argument tuples for {world_size} ranks")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, args=(fn, r, world_size, store, device,
                                                      timeout, threads, rank_args[r],
                                                      results), daemon=True)
                 for r in range(world_size)]
        ifname = os.environ.get("GLOO_SOCKET_IFNAME")
        os.environ["GLOO_SOCKET_IFNAME"] = ifname or "lo"     # local ranks: loopback
        try:
            for p in procs:
                p.start()
        finally:
            if ifname is None:
                del os.environ["GLOO_SOCKET_IFNAME"]
        out: dict[int, Any] = {}
        deadline = time.monotonic() + timeout
        try:
            while len(out) < world_size:
                try:
                    rank, status, value = results.get(timeout=0.5)
                except queue.Empty:
                    dead = [(r, p.exitcode) for r, p in enumerate(procs)
                            if p.exitcode is not None and r not in out]
                    if dead:
                        raise RuntimeError(f"ranks {dead} (rank, exit code) ended without a "
                                           "result")
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"{world_size} ranks did not finish in {timeout} s")
                    continue
                if status == "error":
                    raise RuntimeError(f"rank {rank} of {world_size} failed:\n{value}")
                out[rank] = value
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
    return [out[r] for r in range(world_size)]
