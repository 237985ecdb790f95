"""Theoretical operation counting for Phi (paper Table 4 / Sec. 5.6 math).

The paper counts one OP per accumulation of a '1' element in the bit-sparse
activation (Sec. 5.1). Under that model, for an (M, K) binary activation times
(K, N) weights:

  dense MACs          = M · K · N
  bit-sparse ACs      = nnz(A) · N                       = bit_density · M·K·N
  Phi ACs (paper)     = nnz(L2) · N                      = l2_density  · M·K·N
  Phi ACs (strict)    = nnz(L2) · N + assigned · N       (+ L1 PWP adds)

The paper's headline "Theo. Sp." columns use the first Phi definition (L1
retrievals are adder-tree merges of pre-computed rows and are not counted as
OPs). We reproduce that and additionally report the strict variant, which
counts each PWP row add as the real add and memory read it is on a
general-purpose device.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.assign import PhiStats


@dataclasses.dataclass(frozen=True)
class OpCounts:
    dense_macs: float
    bit_acs: float
    phi_l2_acs: float
    phi_l1_adds: float      # strict accounting: one N-row add per assigned tile
    match_ops: float        # preprocessing: q Hamming evals per row-tile
    pwp_bytes: float        # PWP table size (bytes) for this matmul
    weight_bytes: float

    @property
    def phi_total_strict(self) -> float:
        return self.phi_l2_acs + self.phi_l1_adds

    @property
    def speedup_over_bit(self) -> float:
        return self.bit_acs / max(self.phi_l2_acs, 1e-12)

    @property
    def speedup_over_dense(self) -> float:
        return self.dense_macs / max(self.phi_l2_acs, 1e-12)

    @property
    def speedup_over_bit_strict(self) -> float:
        return self.bit_acs / max(self.phi_total_strict, 1e-12)


def matmul_opcounts(
    stats: PhiStats,
    n: int,
    k: int = 16,
    q: int = 128,
    bytes_per_el: int = 2,
) -> OpCounts:
    """Op counts for one (M, K) × (K, N) Phi matmul given measured stats."""
    M, K = stats.rows, stats.cols
    size = float(M) * K
    dense = size * n
    bit = stats.bit_density * size * n
    l2 = stats.l2_density * size * n
    tiles = size / k
    l1_adds = stats.idx_density * tiles * n
    match = tiles * q  # one fused Hamming eval (xor+popcount / one MAC) per pattern
    pwp_bytes = (K / k) * (q + 1) * n * bytes_per_el
    return OpCounts(
        dense_macs=dense,
        bit_acs=bit,
        phi_l2_acs=l2,
        phi_l1_adds=l1_adds,
        match_ops=match,
        pwp_bytes=pwp_bytes,
        weight_bytes=float(K) * n * bytes_per_el,
    )


def preprocessing_benefit(counts: OpCounts) -> float:
    """Paper Sec. 6.1: ratio of saved accumulation OPs to match (preprocess) OPs."""
    saved = counts.bit_acs - counts.phi_total_strict
    return saved / max(counts.match_ops, 1e-12)
