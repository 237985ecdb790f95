"""Fault-tolerant checkpointing in the reference's on-disk format.

Port of ``repro/checkpoint/checkpoint.py``, single host:
  * every leaf of a tree of nested dicts is written as a raw ``.npy``
    (``leaf_{i:05d}.npy``, in the order a sorted walk meets the leaves); a JSON
    **manifest** (``key``/``file``/``shape``/``dtype`` per leaf, plus the
    caller's ``extra``: data-loader cursor, persisted policy overrides) is
    written last, and the whole directory goes through a tmp dir and an
    atomic rename — a checkpoint either fully exists or doesn't;
  * keys are the reference's ``_key_str`` of the same tree ("a/b/c"), so
    either package restores the other's checkpoints;
  * bfloat16 leaves are written as 2-byte void words (descr ``<V2``, what
    ``np.save`` writes for the reference's bfloat16 arrays, and ``np.load``
    gives back as ``|V2``) with ``"dtype": "bfloat16"`` in the manifest, and
    rebuilt with ``.view(torch.bfloat16)``: no extension dtype is needed;
  * restore puts each leaf on the ``like`` leaf's device and dtype (or on
    ``device``) and rejects a shape mismatch; ``missing_ok`` zero-fills
    leaves an older schema lacks;
  * keep-last-N garbage collection + background (async) save thread, with
    save failures surfaced on the next ``wait()``. The device-to-host copy
    happens in ``save()`` before the thread starts, so training may go on
    replacing or writing its tensors;
  * on a mesh (``CheckpointManager(mesh=)`` and ``save(shardings=)``) every
    rank gathers each leaf to its global value, rank 0 writes the files a
    single device writes for those values (synchronously), and every rank
    waits at a barrier; the ranks must share the directory's file system;
  * **elastic restore** (``shardings=``, the reference's name): every rank
    reads each global ``.npy`` (memory-mapped) and keeps the block the
    current mesh's placement gives it (``sharding.shard_slices``), so a run
    resumes on a mesh of another shape with no conversion step.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.utils import log

_SEP = "/"


def _flatten(tree: Any, prefix: tuple = ()) -> list[tuple[str, Any]]:
    """(key string, leaf) pairs of nested dicts, keys sorted as
    ``jax.tree_util.tree_flatten_with_path`` walks a dict tree."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k], prefix + (str(k),))]
    return [(_SEP.join(prefix), tree)]


def _unflatten(like: Any, values: dict[str, Any], prefix: tuple = ()) -> Any:
    if isinstance(like, dict):
        return {k: _unflatten(like[k], values, prefix + (str(k),)) for k in like}
    return values[_SEP.join(prefix)]


def _to_numpy(x: Any) -> tuple[np.ndarray, str]:
    """A host array to write, and its manifest dtype name (bfloat16 leaves
    as their int16 bit patterns)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy(), "bfloat16"
        arr = x.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(x)
    return arr, str(arr.dtype)


def _save_npy(path, arr: np.ndarray, dtype_name: str) -> None:
    """Write ``arr`` as a ``.npy`` to ``path`` (a file name or a binary file)."""
    if dtype_name != "bfloat16":
        np.save(path, arr)
        return
    # The header np.save writes for the reference's bfloat16 arrays: 2-byte
    # words whose descr is '<V2' (plain numpy would write '|V2').
    with open(path, "wb") if isinstance(path, (str, os.PathLike)) else \
            contextlib.nullcontext(path) as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(np.require(arr, requirements="C").tobytes())


def _from_numpy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    arr = np.require(arr, requirements="C")     # keeps 0-d arrays 0-d
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _host_copy(tree: Any) -> Any:
    """Host copies of a tree's tensors (copies even of CPU tensors, so the
    caller may write its own in place while a save is in flight)."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def save_tree(path: str, tree: Any, extra: dict | None = None) -> None:
    """Write a checkpoint directory atomically (tmp dir + rename)."""
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest: dict = {"leaves": [], "extra": extra or {}}
    for i, (key, leaf) in enumerate(_flatten(tree)):
        arr, dtype_name = _to_numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        _save_npy(os.path.join(tmp, fname), arr, dtype_name)
        manifest["leaves"].append(
            {"key": key, "file": fname, "shape": list(arr.shape), "dtype": dtype_name})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def restore_tree(path: str, like: Any, device: str | torch.device | None = None,
                 missing_ok: tuple[str, ...] = (), *, shardings: Any = None,
                 mesh=None) -> tuple[Any, dict]:
    """Restore into the structure of ``like``: each leaf as a tensor on the
    ``like`` leaf's device and dtype (``device``, if given, wins; a ``like``
    leaf without a device, such as a ``model.TensorSpec``, lands on the CPU).

    ``missing_ok`` names leaf keys (last path component) that may be absent
    from an older checkpoint; they are filled with zeros of the ``like``
    leaf's shape/dtype instead of failing the restore (the ``phi_*``
    ``usage`` histograms: all-zero reads as "no histogram" to the policy).

    ``shardings`` (a tree of placements like ``like``'s) restores onto
    ``mesh`` (default: the current mesh): each leaf is this rank's block of
    the saved global array, ``like`` holding the rank's shards. Returns
    (tree, extra).
    """
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {m["key"]: m for m in manifest["leaves"]}
    placed = None
    if shardings is not None:
        from repro_torch.distributed import sharding as shd

        mesh = mesh if mesh is not None else shd.current_mesh()
        if mesh is None:
            raise ValueError("restore_tree: shardings without a mesh")
        placed = dict(_flatten(shardings))
    out = {}
    for key, leaf in _flatten(like):
        dev = torch.device(device) if device is not None else getattr(leaf, "device", None)
        dtype = getattr(leaf, "dtype", None)
        m = by_key.get(key)
        if m is None:
            base = key.rsplit(_SEP, 1)[-1]
            if base in missing_ok and hasattr(leaf, "shape") and dtype is not None:
                out[key] = torch.zeros(tuple(leaf.shape), dtype=dtype, device=dev)
                log.info("checkpoint leaf %s absent (older schema): zero-filled", key)
                continue
            raise KeyError(f"checkpoint missing leaf {key}")
        if placed is None:
            arr = np.load(os.path.join(path, m["file"]))
            want = tuple(getattr(leaf, "shape", arr.shape))
            if tuple(arr.shape) != want:
                raise ValueError(f"{key}: shape {arr.shape} != expected {want}")
        else:
            arr = np.load(os.path.join(path, m["file"]), mmap_mode="r")
            local = shd.local_shape(tuple(arr.shape), placed[key], mesh)
            want = tuple(getattr(leaf, "shape", local))
            if local != want:
                raise ValueError(f"{key}: the shard {local} of {arr.shape} under "
                                 f"{placed[key]} != expected {want}")
            arr = np.array(arr[shd.shard_slices(tuple(arr.shape), placed[key], mesh)])
        t = _from_numpy(arr, m["dtype"])
        out[key] = t.to(device=dev, dtype=dtype if isinstance(dtype, torch.dtype) else None)
    return _unflatten(like, out), manifest["extra"]


class CheckpointManager:
    """Step-indexed checkpoints with keep-N GC and async save."""

    def __init__(self, root: str, keep: int = 3, async_save: bool = True, mesh=None):
        self.root = root
        self.keep = keep
        self.async_save = async_save
        self.mesh = mesh
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(root, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:010d}")

    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.root):
            if d.startswith("step_") and not d.endswith(".tmp"):
                if os.path.exists(os.path.join(self.root, d, "manifest.json")):
                    out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree: Any, extra: dict | None = None,
             shardings: Any = None) -> None:
        """Save ``tree`` as step ``step``. With the manager's mesh and
        ``shardings`` (``tree`` holding this rank's shards): every rank
        gathers each leaf, rank 0 writes, all wait at a barrier."""
        self.wait()
        if self.mesh is not None and shardings is not None:
            self._save_from_mesh(step, tree, extra, shardings)
            return
        # device -> host copy happens here so training can continue mutating
        host_tree = _host_copy(tree)

        def _do():
            try:
                save_tree(self._step_dir(step), host_tree, extra)
                self._gc()
                log.info("checkpoint saved @ step %d", step)
            except BaseException as e:  # noqa: BLE001 — surfaced on wait()
                self._error = e

        if self.async_save:
            self._thread = threading.Thread(target=_do, daemon=True)
            self._thread.start()
        else:
            _do()
            self.wait()

    def _save_from_mesh(self, step: int, tree: Any, extra: dict | None,
                        shardings: Any) -> None:
        import torch.distributed as dist

        from repro_torch.distributed import collectives as coll

        placed = dict(_flatten(shardings))
        host = {}
        for key, leaf in _flatten(tree):
            full = coll.gather_global(leaf.detach(), placed[key], self.mesh)
            if self.mesh.rank == 0:
                host[key] = full.to("cpu", copy=True)
            del full
        try:
            if self.mesh.rank == 0:
                save_tree(self._step_dir(step), _unflatten(tree, host), extra)
                self._gc()
                log.info("checkpoint saved @ step %d from the mesh", step)
        finally:
            dist.barrier()

    def latest_extra(self) -> dict:
        """The ``extra`` dict of the newest checkpoint without loading any
        array data — config-affecting metadata (e.g. the persisted Phi impl
        override) must be known before step functions are built."""
        step = self.latest_step()
        if step is None:
            return {}
        with open(os.path.join(self._step_dir(step), "manifest.json")) as f:
            return json.load(f).get("extra", {})

    def restore_latest(self, like: Any, device: str | torch.device | None = None,
                       missing_ok: tuple[str, ...] = (), shardings: Any = None):
        """(step, tree, extra) of the newest checkpoint, or (None, None, {});
        with ``shardings``, this rank's shards on the manager's mesh."""
        step = self.latest_step()
        if step is None:
            return None, None, {}
        tree, extra = restore_tree(self._step_dir(step), like, device, missing_ok=missing_ok,
                                   shardings=shardings, mesh=self.mesh)
        return step, tree, extra

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
