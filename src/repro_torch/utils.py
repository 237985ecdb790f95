"""Small shared helpers: the package's logger, integer ceil-division, row
padding, device choice."""
from __future__ import annotations

import logging
import os

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
