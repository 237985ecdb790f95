"""Phi pattern assignment and L1/L2 decomposition (paper Sec. 3.1).

Given binary activations ``A`` (…, K) and per-partition patterns
``P`` (T, q, k) with T = K/k, produce:

  * ``idx``      (…, T) int32 — best pattern per row-partition, ``q`` = none
  * ``residual`` (…, K) int8 in {−1, 0, +1} — the Level-2 correction matrix

such that exactly ``A = Level1(idx → patterns) + residual``.

Assignment rule: pick the pattern with minimum Hamming distance (the first
index on ties); if even the best distance is not strictly better than the
row's own popcount, assign no pattern (the raw row becomes the L2 entry).
A 1→0 mismatch becomes +1 and a 0→1 mismatch −1 in the residual.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def assign_patterns(a: torch.Tensor, patterns: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Vectorised assignment. a: (..., K) binary; patterns: (T, q, k).

    Returns (idx (..., T) int32 with q == "none", residual (..., K) int8).
    """
    T, q, k = patterns.shape
    lead = a.shape[:-1]
    K = a.shape[-1]
    if K != T * k:
        raise ValueError(f"K={K} != T·k = {T}·{k}")
    at = a.reshape(*lead, T, k).to(torch.float32)
    pf = patterns.to(device=a.device, dtype=torch.float32)

    # Hamming as a matmul: H = |a| + |p| − 2 a·p (exact on binary inputs)
    dot = torch.einsum("...tk,tqk->...tq", at, pf)
    pop_a = at.sum(-1)                                   # (..., T)
    pop_p = pf.sum(-1)                                   # (T, q)
    ham = pop_a[..., None] + pop_p - 2.0 * dot           # (..., T, q)

    best = ham.argmin(dim=-1)                            # first index on ties
    best_h = ham.amin(dim=-1)
    # Strictly better than the raw bit sparsity, else no pattern: a tie keeps
    # the raw row since a match additionally costs an L1 retrieval.
    use = best_h < pop_a                                 # (..., T)
    idx = torch.where(use, best, q).to(torch.int32)

    chosen = pf[torch.arange(T, device=a.device), best]  # (..., T, k)
    chosen = torch.where(use[..., None], chosen, 0.0)
    residual = (at - chosen).to(torch.int8).reshape(*lead, K)
    return idx, residual


def level1_matrix(idx: torch.Tensor, patterns: torch.Tensor) -> torch.Tensor:
    """Materialise the Level-1 matrix (…, K) from indices (for tests/stats)."""
    T, q, k = patterns.shape
    pad = torch.cat([patterns, patterns.new_zeros((T, 1, k))], dim=1)
    flat = idx.reshape(-1, T).long()
    gathered = pad[torch.arange(T, device=idx.device)[None], flat]  # (B, T, k)
    return gathered.reshape(*idx.shape[:-1], T * k)


@dataclasses.dataclass(frozen=True)
class PhiStats:
    """Density/op statistics of a Phi decomposition (paper Table 4 columns)."""

    bit_density: float       # nnz(A) / size
    l1_density: float        # nnz(level-1 pattern bits) / size
    l2_pos_density: float    # nnz(residual == +1) / size
    l2_neg_density: float    # nnz(residual == −1) / size
    idx_density: float       # assigned fraction of the pattern-index matrix
    rows: int
    cols: int

    @property
    def l2_density(self) -> float:
        return self.l2_pos_density + self.l2_neg_density

    @property
    def speedup_over_bit(self) -> float:
        """Paper "Theo. Sp. Over B." — bit-sparse ACs vs Phi L2 ACs."""
        return self.bit_density / max(self.l2_density, 1e-12)

    @property
    def speedup_over_dense(self) -> float:
        """Paper "Theo. Sp. Over D." — dense MACs vs Phi L2 ACs."""
        return 1.0 / max(self.l2_density, 1e-12)


def phi_stats(a: torch.Tensor, patterns: torch.Tensor) -> PhiStats:
    """Compute Table-4 style statistics for activations ``a`` (…, K)."""
    a2 = a.reshape(-1, a.shape[-1])
    idx, residual = assign_patterns(a2, patterns)
    T, q, k = patterns.shape
    size = float(residual.numel())
    pop_p = patterns.to(device=a.device, dtype=torch.float32).sum(-1)  # (T, q)
    assigned = idx < q
    l1_bits = pop_p[torch.arange(T, device=a.device)[None, :],
                    torch.where(assigned, idx, 0).long()]
    l1_bits = (l1_bits * assigned).sum()
    return PhiStats(
        bit_density=float(a2.to(torch.float32).mean()),
        l1_density=float(l1_bits / size),
        l2_pos_density=float((residual == 1).to(torch.float32).mean()),
        l2_neg_density=float((residual == -1).to(torch.float32).mean()),
        idx_density=float(assigned.to(torch.float32).mean()),
        rows=int(a2.shape[0]),
        cols=int(a2.shape[1]),
    )


def pack_l2_coo(
    residual: np.ndarray, nnz_cap: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Pack an (M, K) {−1,0,1} residual into padded COO arrays (host numpy).

    Returns (rows, cols, signs) each (nnz_cap,) with out-of-range sentinel
    rows == M for padding, plus the true nnz.
    """
    r = np.asarray(residual)
    M, K = r.shape
    rows, cols = np.nonzero(r)
    signs = r[rows, cols]
    nnz = rows.shape[0]
    if nnz > nnz_cap:
        raise ValueError(f"nnz {nnz} exceeds capacity {nnz_cap}")
    pr = np.full(nnz_cap, M, np.int32)
    pc = np.zeros(nnz_cap, np.int32)
    ps = np.zeros(nnz_cap, np.int8)
    pr[:nnz], pc[:nnz], ps[:nnz] = rows, cols, signs
    return pr, pc, ps, nnz


def pack_l2_coo_jit(residual: torch.Tensor, nnz_cap: int):
    """Static-capacity COO packing on the residual's device (sentinel row == M).

    The fixed ``nnz_cap`` is the packer's load-balance budget, as in the
    reference's jit-safe packer: the first ``nnz_cap`` non-zeros in row-major
    order are kept, padding entries carry row ``M``, column 0 and sign 0, and
    the number of entries that did not fit is returned as ``overflow``.
    """
    M, K = residual.shape
    flat = residual.reshape(-1)
    nz = torch.nonzero(flat, as_tuple=True)[0][:nnz_cap]
    pad = nnz_cap - nz.shape[0]
    nz = torch.cat([nz, nz.new_full((pad,), M * K)])
    valid = nz < M * K
    rows = torch.where(valid, nz // K, M).to(torch.int32)
    cols = torch.where(valid, nz % K, 0).to(torch.int32)
    signs = torch.where(valid, flat[nz.clamp(max=M * K - 1)], 0).to(torch.int8)
    overflow = (flat != 0).sum() - (signs != 0).sum()
    return rows, cols, signs, overflow
