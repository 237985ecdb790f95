"""Small shared helpers: the package's logger, integer ceil-division, row
padding, device choice, tree sizes, timing and JSON files.

The reference's ``key_iter`` (an endless stream of ``jax.random`` keys) has
no counterpart: the port's entry points take explicit ``torch.Generator``s.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import time
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

log = logging.getLogger("repro_torch")
if not log.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[%(asctime)s %(levelname).1s] %(message)s", "%H:%M:%S"))
    log.addHandler(_h)
    log.setLevel(os.environ.get("REPRO_LOGLEVEL", "INFO"))


def cdiv(a: int, b: int) -> int:
    """Ceiling division of non-negative integers."""
    return -(-a // b)


def pad_rows(x: torch.Tensor, mult: int, fill: float = 0) -> torch.Tensor:
    """Pad the leading axis of ``x`` with ``fill`` up to a multiple of ``mult``."""
    pad = (-x.shape[0]) % mult
    if pad == 0:
        return x
    return F.pad(x, [0, 0] * (x.ndim - 1) + [0, pad], value=fill)


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names one.

    Raises when CUDA is requested (explicitly or by default) but no card is
    visible: the port never drops to the CPU on its own.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: CUDA requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions")
    return dev


def ceil_to(x: int, m: int) -> int:
    """Round ``x`` up to a multiple of ``m``."""
    return ((x + m - 1) // m) * m


def _tree_leaves(tree: Any) -> list:
    """Leaves of nested dicts, lists and tuples, dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [tree]


def _itemsize(dtype: Any) -> int:
    return dtype.itemsize if isinstance(dtype, torch.dtype) else np.dtype(dtype).itemsize


def tree_bytes(tree: Any) -> int:
    """Total bytes of all array leaves (tensors, numpy arrays or anything with
    ``shape`` and ``dtype``, such as ``model.TensorSpec``)."""
    return sum(math.prod(x.shape) * _itemsize(x.dtype)
               for x in _tree_leaves(tree) if hasattr(x, "shape"))


def tree_params(tree: Any) -> int:
    """Total element count of all array leaves."""
    return sum(math.prod(x.shape) for x in _tree_leaves(tree) if hasattr(x, "shape"))


def human_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024:
            return f"{n:.2f}{unit}"
        n /= 1024
    return f"{n:.2f}PiB"


def human_count(n: float) -> str:
    for unit in ("", "K", "M", "B", "T"):
        if abs(n) < 1000:
            return f"{n:.2f}{unit}"
        n /= 1000
    return f"{n:.2f}Q"


class StepTimer:
    """Wall-clock timer keeping a history; used by the straggler watchdog.
    Host clock only: a caller timing device work synchronises inside it."""

    def __init__(self) -> None:
        self.history: list[float] = []
        self._t0: float | None = None

    def __enter__(self) -> "StepTimer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> None:
        assert self._t0 is not None
        self.history.append(time.perf_counter() - self._t0)
        self._t0 = None

    @property
    def median(self) -> float:
        return float(np.median(self.history)) if self.history else 0.0


def asdict_json(obj: Any) -> Any:
    """dataclass/numpy/tensor-friendly JSON conversion (arrays -> lists)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: asdict_json(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: asdict_json(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [asdict_json(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().tolist()
    return obj


def dump_json(path: str, obj: Any) -> None:
    """Write ``obj`` as JSON through a tmp file and an atomic rename."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(asdict_json(obj), f, indent=1, default=str)
    os.replace(tmp, path)


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)
