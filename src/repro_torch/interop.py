"""Carry weights and Phi state across from numpy trees.

The reference package's parameters are nested dicts of arrays; converted
with ``np.asarray`` leaf by leaf they become nested dicts of numpy arrays,
which these functions turn into the port's tensors under the same keys and
layouts (HWIO conv weights, (T, q, k) patterns, (T, q+1, N) PWPs, the LM's
stacked decoder weights and ``phi_*`` entries). Plain numpy → torch copies,
so both packages can run on identical weights.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.snn.models import PhiState


def _tensor(x: Any, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    a = np.array(x, copy=True)
    if a.dtype.name == "bfloat16":          # numpy's ml_dtypes extension type
        return torch.from_numpy(a.astype(np.float32)).to(device=device,
                                                         dtype=dtype or torch.bfloat16)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def params_from_numpy(tree: Mapping[str, Any], device: str | torch.device
                      ) -> dict[str, Any]:
    """Nested dicts of numpy arrays -> the same dicts of tensors on ``device``.

    Dtypes carry across (an LM tree's int8 patterns, int32 usage histograms
    and float32 weights and PWP banks, stacked on a leading layer axis or
    not); bfloat16 leaves arrive as ``torch.bfloat16``."""
    return {k: params_from_numpy(v, device) if isinstance(v, Mapping) else _tensor(v, device)
            for k, v in tree.items()}


def phi_state_from_numpy(patterns: Mapping[str, Any], pwp: Mapping[str, Any],
                         usage: Mapping[str, Any] | None, device: str | torch.device
                         ) -> PhiState:
    """A ``PhiState`` from per-layer numpy patterns, PWPs and usage histograms.

    Attention sites (``*_attn``) have patterns and usage but no PWP: ``pwp``
    need not name every layer of ``patterns``.
    """
    return PhiState(
        patterns={k: _tensor(v, device, torch.uint8) for k, v in patterns.items()},
        pwp={k: _tensor(v, device) for k, v in pwp.items()},
        usage={k: np.asarray(v, np.int64) for k, v in (usage or {}).items()},
    )

