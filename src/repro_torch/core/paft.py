"""Pattern-Aware Fine-Tuning (paper Sec. 3.3; port of ``repro/core/paft.py``).

Adds ``λ · Σ_l N_l · Σ H(act, assigned pattern)`` to the training loss. The
pattern *assignment* follows the Sec. 3.1 rules and carries no gradient (it
is a discrete argmin); the Hamming distance itself is differentiable in the
activations because for binary a and fixed p*:

    H(a, p*) = Σ a·(1−p*) + p*·(1−a)

and gradients flow into ``a`` through the LIF surrogate. Rows with no
assigned pattern use p* = 0, i.e. their own popcount — matching the paper's
definition that R counts exactly the nonzeros of the Level-2 matrix.

The assignment is the matcher kernel's ``idx`` (``kernels.matcher``), which
is ``assign_patterns``' bit for bit; CPU tensors run ``assign_patterns``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.assign import level1_matrix
from repro_torch.kernels.matcher import matcher_cuda
from repro_torch.snn import train as snn_train
from repro_torch.snn.models import Params, PhiState, SNNConfig
from repro_torch.train import optimizer as opt


def hamming_to_assigned(act: torch.Tensor, patterns: torch.Tensor, *,
                        packed: torch.Tensor | None = None) -> torch.Tensor:
    """Differentiable Σ H(act rows, assigned patterns); act (..., K) binary,
    patterns (T, q, k) with K = T·k. ``packed`` is the bank as the matcher
    kernel reads it (``PhiState.packed``; packed per call when not given)."""
    K = act.shape[-1]
    a2 = act.reshape(-1, K)
    idx, _ = matcher_cuda(a2.detach().to(torch.float32).contiguous(), patterns, packed=packed)
    p_star = level1_matrix(idx, patterns.to(torch.float32))      # (M, K), a constant
    h = a2 * (1.0 - p_star) + p_star * (1.0 - a2)
    return h.sum()


def paft_regularizer(cfg: SNNConfig, phi: PhiState, lam: float):
    """Regularizer for ``snn.train.make_train_step``: (params, captured) -> loss."""

    def reg(params: Params, captured: dict) -> torch.Tensor:
        total = 0.0
        norm = 0.0
        for name, act in captured.items():
            if name not in phi.patterns:
                continue
            pats = phi.patterns[name]
            n_l = float(params[name]["w"].shape[-1])  # paper: weight by N_l
            K = pats.shape[0] * pats.shape[2]
            total = total + n_l * hamming_to_assigned(act[..., :K], pats,
                                                      packed=phi.packed.get(name))
            norm = norm + n_l * act.reshape(-1, act.shape[-1]).shape[0] * K
        return lam * total / max(norm, 1.0)

    return reg


def paft_finetune(
    params: Params,
    cfg: SNNConfig,
    phi: PhiState,
    x: np.ndarray,
    y: np.ndarray,
    *,
    lam: float = 0.3,
    lr: float = 1e-4,
    steps: int = 100,
    batch: int = 64,
    seed: int = 0,
    device: str | torch.device | None = None,
):
    """Paper Sec. 3.4 workflow step: a few epochs of fine-tuning with the
    Hamming regularizer against the already-calibrated patterns. Returns
    ``snn.train.train``'s (params, history)."""
    ocfg = opt.OptConfig(lr=lr, warmup_steps=0, decay_steps=steps, weight_decay=0.0)
    return snn_train.train(
        cfg, x, y, steps=steps, batch=batch, ocfg=ocfg, seed=seed,
        regularizer=paft_regularizer(cfg, phi, lam), params=params, device=device,
    )
