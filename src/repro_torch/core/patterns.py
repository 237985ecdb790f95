"""Phi calibration: binary k-means pattern selection (paper Alg. 1).

Patterns are selected *per K-partition* of the activation matrix. Each
activation row slice of length ``k`` is a point in {0,1}^k; the calibration
runs Hamming-metric k-means and rounds centroids back to {0,1}.

Filtering (paper Sec. 3.2): all-zero rows need no compute and one-hot rows can
never beat their own bit sparsity via a non-identical pattern, so both are
removed before clustering. The Hamming distance is computed as a matmul,
``H(x, c) = |x| + |c| - 2 x·c``.

Divergence from the reference: the reference draws the k-means initial rows
with ``jax.random.choice``, which PyTorch cannot replay. Here the initial
rows are drawn with ``torch.multinomial`` from a ``torch.Generator`` seeded
with ``cfg.seed + t`` for partition ``t``, so the same seed gives other
patterns than the reference. Callers that need the reference's patterns pass
its initial indices (``init_idx``); from the same start the iterations agree
bitwise.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels import IMPLS
from repro_torch.utils import resolve_device


@dataclasses.dataclass(frozen=True)
class PhiConfig:
    """Hyper-parameters of Phi sparsity (paper defaults: k=16, q=128)."""

    k: int = 16          # K-partition (pattern) length
    q: int = 128         # number of patterns per partition
    iters: int = 20      # k-means iterations
    timesteps: int = 4   # SNN timesteps (spiking-mode LMs)
    nnz_budget: float = 0.10  # static L2 capacity as fraction of M·K
    pwp_int8: bool = False    # int8 PWPs with per-row scales
    seed: int = 0
    # Lowering override: None = the default lowering; a name from
    # kernels.IMPLS forces that one.
    impl: str | None = None

    def __post_init__(self) -> None:
        if self.k < 2 or self.q < 1:
            raise ValueError(f"PhiConfig needs k >= 2 and q >= 1 (k={self.k}, q={self.q})")
        if self.impl is not None and self.impl not in IMPLS:
            raise ValueError(f"impl {self.impl!r} not in {IMPLS}")


def _hamming(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Pairwise Hamming distances between binary x (n,k) and c (q,k) -> (n,q)."""
    return x.sum(-1, keepdim=True) + c.sum(-1)[None, :] - 2.0 * (x @ c.T)


def filter_rows(x: torch.Tensor) -> torch.Tensor:
    """Mask of rows that survive calibration filtering (not all-zero/one-hot)."""
    return x.sum(-1) >= 2


def _kmeans_binary(data: torch.Tensor, weight: torch.Tensor, q: int, iters: int,
                   idx0: torch.Tensor) -> torch.Tensor:
    """Weighted Hamming k-means on binary rows, started from rows ``idx0``.

    data: (n, k) float32 in {0,1}; weight: (n,) float32 multiplicities.
    Returns (q, k) binary float32 centres.
    """
    centers = data[idx0]
    for _ in range(iters):
        assign = _hamming(data, centers).argmin(-1)                 # (n,)
        onehot = torch.nn.functional.one_hot(assign, q).to(torch.float32)
        onehot = onehot * weight[:, None]
        counts = onehot.sum(0)                                      # (q,)
        sums = onehot.T @ data                                      # (q, k)
        means = sums / torch.clamp(counts, min=1.0)[:, None]
        new_centers = torch.where(means >= 0.5, 1.0, 0.0)           # Alg. 1 line 6
        # Empty clusters keep their previous centre.
        centers = torch.where((counts > 0)[:, None], new_centers, centers)
    return centers


def kmeans_unique_rows(data: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Filtered unique rows of one partition and their multiplicities.

    ``np.unique`` sorts rows lexicographically, so indices into the result
    mean the same rows here and in the reference.
    """
    x = np.asarray(data, dtype=np.uint8)
    x = x[filter_rows(torch.from_numpy(x)).numpy()]
    if x.shape[0] == 0:
        return x, np.zeros((0,), np.int64)
    return np.unique(x, axis=0, return_counts=True)


def kmeans_binary(data: np.ndarray | torch.Tensor, q: int, iters: int = 20, seed: int = 0,
                  *, init_idx: np.ndarray | None = None,
                  device: str | torch.device | None = None) -> np.ndarray:
    """Paper Alg. 1 on one partition's rows. Returns (q, k) uint8 patterns.

    Duplicate rows are collapsed to unique rows with multiplicity weights, so
    calibration costs O(unique · q) instead of O(n · q). ``init_idx`` (q,)
    indexes the unique rows to start from; without it they are drawn with
    probability proportional to multiplicity from a generator seeded ``seed``.
    The iterations run on ``device``: ``cuda`` unless the caller names
    another (see :func:`repro_torch.resolve_device`).
    """
    dev = resolve_device(device)
    if isinstance(data, torch.Tensor):
        data = data.to(torch.uint8).cpu().numpy()
    k = np.asarray(data).shape[1]
    uniq, counts = kmeans_unique_rows(data)
    if uniq.shape[0] == 0:
        return np.zeros((q, k), np.uint8)
    if uniq.shape[0] <= q:
        out = np.zeros((q, k), np.uint8)
        out[: uniq.shape[0]] = uniq
        return out
    weight = torch.as_tensor(counts, dtype=torch.float32)
    if init_idx is None:
        gen = torch.Generator().manual_seed(int(seed))
        idx0 = torch.multinomial(weight / weight.sum(), q, replacement=True, generator=gen)
    else:
        idx0 = torch.as_tensor(np.asarray(init_idx), dtype=torch.long)
    centers = _kmeans_binary(
        torch.as_tensor(uniq, dtype=torch.float32, device=dev), weight.to(dev),
        q, iters, idx0.to(dev))
    centers = centers.to(torch.uint8).cpu().numpy()
    # Dedupe identical centres: duplicates waste pattern slots; replace them
    # with the highest-weight unique rows not yet in the bank.
    seen: set[bytes] = set()
    slots: list[int] = []
    for i in range(q):
        b = centers[i].tobytes()
        if b in seen:
            slots.append(i)
        else:
            seen.add(b)
    if slots:
        order = np.argsort(-counts)
        fill = [r for r in order if uniq[r].tobytes() not in seen]
        for i, r in zip(slots, fill):
            centers[i] = uniq[r]
            seen.add(uniq[r].tobytes())
    return centers


def calibrate(acts: np.ndarray | torch.Tensor, cfg: PhiConfig, *,
              init_idx: Sequence[np.ndarray | None] | None = None,
              device: str | torch.device | None = None) -> torch.Tensor:
    """Calibrate patterns for a full activation matrix.

    acts: (M, K) binary activations (any leading dims are flattened).
    Returns patterns (T, q, k) uint8 on ``device`` (``cuda`` unless the
    caller names another), T = K // k, each
    partition clustered independently (paper Sec. 3.2). ``init_idx[t]``
    optionally fixes partition t's initial rows (see :func:`kmeans_binary`).
    """
    device = resolve_device(device)
    if isinstance(acts, torch.Tensor):
        acts = acts.to(torch.uint8).cpu().numpy()
    a = np.asarray(acts)
    a = a.reshape(-1, a.shape[-1])
    M, K = a.shape
    if K % cfg.k:
        raise ValueError(f"K={K} not divisible by k={cfg.k}")
    T = K // cfg.k
    tiles = a.reshape(M, T, cfg.k)
    pats = np.stack([
        kmeans_binary(tiles[:, t], cfg.q, cfg.iters, cfg.seed + t,
                      init_idx=None if init_idx is None else init_idx[t], device=device)
        for t in range(T)])
    return torch.as_tensor(pats.astype(np.uint8), device=device)


# ------------------------------------------------------- pattern usage ------
def pattern_usage(acts: torch.Tensor, patterns: torch.Tensor) -> np.ndarray:
    """Per-partition pattern-reference histogram of a calibration batch.

    acts: (..., K) binary activations; patterns: (T, q, k). Returns
    (T, q+1) int64 counts — column j < q is how many row-partitions matched
    pattern j, column q counts unmatched rows (the "no pattern" slot).
    """
    from repro_torch.core.assign import assign_patterns

    T, q, k = patterns.shape[-3:]
    a = acts.to(torch.float32).reshape(-1, acts.shape[-1])
    if a.shape[0] == 0:          # empty calibration: all-zero histogram
        return np.zeros((T, q + 1), np.int64)
    idx, _ = assign_patterns(a, patterns)
    offs = torch.arange(T, device=idx.device) * (q + 1)
    hist = torch.bincount((idx.long() + offs).reshape(-1), minlength=T * (q + 1))
    return hist.reshape(T, q + 1).cpu().numpy().astype(np.int64)


def active_pattern_sets(usage: np.ndarray, *, coverage: float = 0.9,
                        max_frac: float = 0.5, min_assigned: float = 0.05,
                        pad_to: int = 8) -> tuple[np.ndarray | None, float]:
    """Hot-pattern index sets from a usage histogram, or None without skew.

    Returns ``(active (T, P) int32, usage_fraction)`` where P is the smallest
    multiple of ``pad_to`` such that the top-P patterns of every partition
    cover ≥ ``coverage`` of that partition's assigned matches, and
    ``usage_fraction = (P+1)/(q+1)``. Returns ``(None, 1.0)`` for an empty
    histogram, an assigned fraction below ``min_assigned``, a bank with
    q ≤ ``pad_to``, or usage so flat that P would exceed ``max_frac``·q.
    """
    u = np.asarray(usage, np.float64)
    if u.ndim != 2 or u.shape[1] < 2:
        raise ValueError(f"usage must be (T, q+1), got {u.shape}")
    q = u.shape[1] - 1
    assigned = u[:, :q]
    total = u.sum()
    if total <= 0 or assigned.sum() / total < min_assigned or q <= pad_to:
        return None, 1.0
    srt = np.sort(assigned, axis=1)[:, ::-1]
    csum = np.cumsum(srt, axis=1)
    tot_t = assigned.sum(axis=1)
    need = 1
    for t in range(u.shape[0]):
        if tot_t[t] > 0:
            need = max(need, int(np.searchsorted(
                csum[t], coverage * tot_t[t], side="left")) + 1)
    p_active = min(q, -(-need // pad_to) * pad_to)
    if p_active > max_frac * q:
        return None, 1.0
    order = np.argsort(-assigned, kind="stable", axis=1)
    active = np.ascontiguousarray(order[:, :p_active]).astype(np.int32)
    return active, float(p_active + 1) / float(q + 1)


def top_p_sets(usage: np.ndarray, p: int) -> np.ndarray:
    """Top-``p`` pattern indices per partition from a usage histogram.

    usage: (T, q+1) counts (column q = unmatched, ignored). Returns (T, p)
    int32. Restricting the match to any set is exact (missed rows fall to
    the L2 residual), so this never refuses.
    """
    u = np.asarray(usage, np.int64)
    if u.ndim != 2 or u.shape[1] < 2:
        raise ValueError(f"usage must be (T, q+1), got {u.shape}")
    q = u.shape[1] - 1
    p = max(1, min(int(p), q))
    order = np.argsort(-u[:, :q], kind="stable", axis=1)
    return np.ascontiguousarray(order[:, :p]).astype(np.int32)


def pattern_weight_products(patterns: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Offline PWP computation: (T, q, k) patterns × (K, N) weights -> (T, q+1, N).

    Slot q (the last row of each partition) is the all-zero "no pattern
    assigned" entry so the runtime gather can index it for unmatched rows.
    """
    T, q, k = patterns.shape
    K, N = w.shape
    if T * k != K:
        raise ValueError(f"patterns {tuple(patterns.shape)} do not tile K={K}")
    wt = w.reshape(T, k, N)
    pwp = torch.einsum("tqk,tkn->tqn", patterns.to(device=w.device, dtype=w.dtype), wt)
    return torch.cat([pwp, w.new_zeros((T, 1, N))], dim=1)


def quantize_pwp(pwp: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 PWP rows with per-(tile, pattern) scales.

    Returns (q8 (T,q+1,N) int8, scale (T,q+1) f32): symmetric per-row
    quantisation, round half to even as the reference does.
    """
    p32 = pwp.to(torch.float32)
    scale = p32.abs().amax(dim=-1) / 127.0 + 1e-12
    q8 = torch.clamp(torch.round(p32 / scale[..., None]), -127, 127).to(torch.int8)
    return q8, scale
