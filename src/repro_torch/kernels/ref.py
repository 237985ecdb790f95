"""Plain PyTorch oracles for the Phi kernels (the correctness ground truth).

Each is the reference package's ``kernels/ref.py`` function on tensors: the
dense or scatter formulation that the Hopper kernels are held against.
"""
from __future__ import annotations

import torch

from repro_torch.core.assign import assign_patterns


def matcher_ref(a: torch.Tensor, patterns: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Best-pattern match per row-partition.

    a: (M, K) binary; patterns: (T, q, k). Returns (idx (M,T) int32 in [0,q]
    with q == no-pattern, residual (M,K) int8).
    """
    return assign_patterns(a, patterns)


def l1_gather_ref(idx: torch.Tensor, pwp: torch.Tensor) -> torch.Tensor:
    """Level-1 PWP retrieval and K-tile reduction: out[m] = Σ_t pwp[t, idx[m, t]].

    idx: (M, T) int32 in [0, q]; pwp: (T, q+1, N) with pwp[:, q] == 0.
    """
    T = idx.shape[-1]
    rows = pwp[torch.arange(T, device=idx.device)[None, :], idx.long()]  # (M, T, N)
    return rows.sum(dim=-2)


def l2_spmm_ref(rows: torch.Tensor, cols: torch.Tensor, signs: torch.Tensor,
                w: torch.Tensor, m: int) -> torch.Tensor:
    """Level-2 {±1} COO spmm: out[r] += sign · w[c].

    rows/cols/signs: (P,) padded COO whose sentinel rows == m are dropped;
    w: (K, N). Returns (m, N) f32.
    """
    gathered = w[cols.long()].to(torch.float32) * signs.to(torch.float32)[:, None]
    out = torch.zeros((m + 1, w.shape[1]), dtype=torch.float32, device=w.device)
    out.index_add_(0, rows.long(), gathered)
    return out[:m]


def l2_dense_ref(residual: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Dense evaluation of the L2 correction (exactness oracle)."""
    return residual.to(torch.float32) @ w.to(torch.float32)


def phi_matmul_ref(a: torch.Tensor, w: torch.Tensor, patterns: torch.Tensor,
                   pwp: torch.Tensor) -> torch.Tensor:
    """Full Phi decomposition evaluated densely; equals ``a @ w`` exactly."""
    idx, residual = matcher_ref(a, patterns)
    return l1_gather_ref(idx, pwp) + l2_dense_ref(residual, w)


def lif_ref(v: torch.Tensor, x: torch.Tensor, decay: float, threshold: float,
            reset_mode: str = "hard") -> tuple[torch.Tensor, torch.Tensor]:
    """LIF neuron step: integrate, fire, reset.

    Returns (spike f32 {0,1}, v'). hard reset: v' = v_int · (1 − s);
    soft reset: v' = v_int − θ·s.
    """
    v_int = v * decay + x
    spike = (v_int >= threshold).to(x.dtype)
    if reset_mode == "hard":
        v_new = v_int * (1.0 - spike)
    elif reset_mode == "soft":
        v_new = v_int - threshold * spike
    else:
        raise ValueError(reset_mode)
    return spike, v_new
