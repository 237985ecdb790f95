"""Workload traces for the Phi accelerator simulator.

A :class:`LayerTrace` is everything the simulator needs to walk one GEMM
layer: per-row-tile pattern assignments (the matcher's output), per-tile
popcounts and residual sizes (the L1/L2 work split), and the layer's
pattern-usage histogram (what drives the PWP prefetcher — the *same*
``core.patterns.active_pattern_sets`` sets the kernel-side prefetch path
consumes).

Traces come from three places:

  * real model paths — ``snn.models.capture_phi_traces`` captures spike
    activations in GEMM layout and hands them to :func:`trace_from_acts`;
    on a CUDA device the matcher kernel (``kernels.matcher.matcher_cuda``)
    assigns them there and only the (M, T) arrays cross to the host;
  * synthetic Zipf workloads (:func:`synthetic_zipf_trace`) — the skew
    class the paper's 27.73% PWP-usage measurement comes from;
  * the deterministic VGG-16 suite (:func:`vgg16_table4_traces`) — the
    paper's Table-2 GEMM shapes at Table-4 densities, built from seeded
    numpy only (no k-means), so a trace is bit-identical across platforms
    and equal to the reference package's.

The host assignment here is a numpy mirror of ``core.assign
.assign_patterns`` (same Hamming-as-matmul, same strict tie rule); all
quantities are small integers computed exactly in float32, so the mirror
is platform-deterministic. The card's (:func:`_assign_torch`) takes the
matcher kernel's ``idx`` and residual, which are ``assign_patterns``' bit
for bit, and never materialises the (M, T, q) scores.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class LayerTrace:
    """One GEMM layer's workload, as the accelerator sees it.

    idx      (M, T) int32 — matched pattern per row-partition (q = none)
    tile_pop (M, T) int32 — popcount of each row tile (raw activation bits)
    tile_res (M, T) int32 — L2 residual nonzeros per tile under the
                            *unrestricted* assignment (Hamming distance to
                            the matched pattern; == tile_pop when unmatched)
    usage    (T, q+1) int64 — pattern-reference histogram (column q counts
                            unmatched tiles), the prefetcher's input
    reps     — timestep × batch repetitions of this GEMM (SNN semantics:
                            weights/PWPs are fetched once, activations and
                            compute repeat)
    """

    name: str
    m: int
    k_dim: int
    n: int
    k: int
    q: int
    idx: np.ndarray
    tile_pop: np.ndarray
    tile_res: np.ndarray
    usage: np.ndarray
    reps: int = 1

    @property
    def t(self) -> int:
        return self.k_dim // self.k

    @property
    def bit_nnz(self) -> int:
        return int(self.tile_pop.sum())

    @property
    def l2_nnz(self) -> int:
        """Total L2 residual entries under the unrestricted assignment."""
        return int(self.tile_res.sum())

    @property
    def bit_density(self) -> float:
        return self.bit_nnz / float(self.m * self.k_dim)

    @property
    def l2_density(self) -> float:
        return self.l2_nnz / float(self.m * self.k_dim)

    @property
    def idx_density(self) -> float:
        return float((self.idx < self.q).mean())


def _assign_np(a: np.ndarray, patterns: np.ndarray
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Numpy mirror of ``core.assign.assign_patterns``.

    a (M, K) binary, patterns (T, q, k) binary. Returns (idx (M, T) int32,
    tile_pop (M, T) int32, tile_res (M, T) int32). Exact: every quantity is
    a small integer; f32 partial sums over k ≤ 64 stay integral, so BLAS
    summation order cannot perturb the argmin.
    """
    T, q, k = patterns.shape
    M, K = a.shape
    assert K == T * k, (a.shape, patterns.shape)
    at = a.reshape(M, T, k).astype(np.float32)
    pf = patterns.astype(np.float32)
    dot = np.einsum("mtk,tqk->mtq", at, pf)
    pop_a = at.sum(-1)                                    # (M, T)
    ham = pop_a[..., None] + pf.sum(-1)[None] - 2.0 * dot  # (M, T, q)
    best = np.argmin(ham, axis=-1)
    best_h = np.min(ham, axis=-1)
    use = best_h < pop_a                                  # strict rule
    idx = np.where(use, best, q).astype(np.int32)
    tile_pop = pop_a.astype(np.int32)
    tile_res = np.where(use, best_h, pop_a).astype(np.int32)
    return idx, tile_pop, tile_res


def _usage_hist(idx: np.ndarray, q: int) -> np.ndarray:
    T = idx.shape[1]
    out = np.zeros((T, q + 1), np.int64)
    for t in range(T):
        out[t] = np.bincount(idx[:, t], minlength=q + 1)
    return out


def _assign_torch(a: torch.Tensor, patterns: torch.Tensor, match=None
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The trace arrays of ``_assign_np`` and ``_usage_hist``, computed on
    ``a``'s device: ``match`` (default ``kernels.matcher.matcher_cuda``, which
    launches the kernel on a CUDA tensor and runs its plain version on a CPU
    one) gives idx and the int8 residual; ``tile_pop`` is the tile sums of
    ``a``, ``tile_res`` the residual's nonzeros per tile (the Hamming
    distance to the matched pattern, or the popcount where none matched),
    ``usage`` one ``bincount`` over ``idx + t·(q+1)``. Returns (idx, tile_pop,
    tile_res, usage) on the host.

    a (M, K) binary float32, contiguous; patterns (T, q, k), K = T·k.
    """
    if match is None:
        from repro_torch.kernels.matcher import matcher_cuda as match
    T, q, k = patterns.shape
    M = a.shape[0]
    idx, residual = match(a, patterns.to(a.device))
    tile_pop = a.reshape(M, T, k).sum(-1).to(torch.int32)
    tile_res = (residual != 0).reshape(M, T, k).sum(-1, dtype=torch.int32)
    offs = torch.arange(T, device=a.device) * (q + 1)
    usage = torch.bincount((idx.long() + offs).reshape(-1), minlength=T * (q + 1))
    return (idx.cpu().numpy(), tile_pop.cpu().numpy(), tile_res.cpu().numpy(),
            usage.reshape(T, q + 1).cpu().numpy().astype(np.int64))


def trace_from_acts(name: str, acts, patterns, n: int, *, reps: int = 1) -> LayerTrace:
    """Build a trace from captured binary activations + calibrated patterns.

    acts: (..., K) binary (leading dims flattened to rows — the GEMM
    layout the SNN capture hooks emit); patterns: (T, q, k). Columns past
    ``T·k`` (the ragged dense tail ``phi_apply`` handles outside Phi) are
    ignored, mirroring the kernel paths. A CUDA tensor is assigned on its
    device by the matcher kernel (:func:`_assign_torch`; the card has no
    plain fallback: where the kernel raises, this raises); numpy arrays and
    CPU tensors by the numpy mirror, as the reference does.
    """
    if isinstance(acts, torch.Tensor) and acts.device.type != "cpu":
        pats = torch.as_tensor(patterns)
        T, q, k = pats.shape
        a = acts.reshape(-1, acts.shape[-1])[:, : T * k].to(torch.float32).contiguous()
        idx, tile_pop, tile_res, usage = _assign_torch(a, pats)
        return LayerTrace(name=name, m=a.shape[0], k_dim=T * k, n=int(n), k=k,
                          q=q, idx=idx, tile_pop=tile_pop, tile_res=tile_res,
                          usage=usage, reps=int(reps))
    if isinstance(acts, torch.Tensor):
        acts = acts.detach().numpy()
    if isinstance(patterns, torch.Tensor):
        patterns = patterns.cpu().numpy()
    patterns = np.asarray(patterns, np.uint8)
    T, q, k = patterns.shape
    a = np.asarray(acts, np.float32)
    a = a.reshape(-1, a.shape[-1])[:, : T * k]
    idx, tile_pop, tile_res = _assign_np(a, patterns)
    return LayerTrace(name=name, m=a.shape[0], k_dim=T * k, n=int(n), k=k,
                      q=q, idx=idx, tile_pop=tile_pop, tile_res=tile_res,
                      usage=_usage_hist(idx, q), reps=int(reps))


# ------------------------------------------------------ synthetic traces ----
def synthetic_zipf_trace(m: int = 2048, k_dim: int = 256, n: int = 256, *,
                         k: int = 16, q: int = 128, zipf_a: float = 2.0,
                         density: float = 0.25, flip: float = 0.02,
                         reps: int = 1, seed: int = 0,
                         name: str = "zipf") -> LayerTrace:
    """Zipf-referenced prototype workload (pattern rank j drawn ∝ 1/j^a).

    The pattern bank IS the prototype set (no k-means), so the trace is a
    pure function of the seed — platform-deterministic — while showing the
    hot-set skew the paper's prefetcher (and the ``fused_prefetch``
    kernel's usage gate) exploits.
    """
    assert k_dim % k == 0
    rng = np.random.default_rng(seed)
    T = k_dim // k
    protos = (rng.random((q, k_dim)) < density).astype(np.uint8)
    prob = 1.0 / (np.arange(q) + 1.0) ** zipf_a
    prob /= prob.sum()
    rows = protos[rng.choice(q, m, p=prob)]
    a = np.abs(rows.astype(np.int32)
               - (rng.random((m, k_dim)) < flip)).astype(np.float32)
    patterns = np.ascontiguousarray(
        protos.reshape(q, T, k).transpose(1, 0, 2))
    idx, tile_pop, tile_res = _assign_np(a, patterns)
    return LayerTrace(name=name, m=m, k_dim=k_dim, n=n, k=k, q=q, idx=idx,
                      tile_pop=tile_pop, tile_res=tile_res,
                      usage=_usage_hist(idx, q), reps=int(reps))


def density_sweep_traces(densities: tuple[float, ...] = (0.02, 0.05, 0.1,
                                                         0.2, 0.4),
                         m: int = 1024, k_dim: int = 256, n: int = 256, *,
                         k: int = 16, q: int = 128, reps: int = 1,
                         seed: int = 0) -> list[LayerTrace]:
    """Bernoulli-density sweep against an all-zero pattern bank.

    Common random numbers (one uniform draw, thresholded per density) make
    the nonzero sets *nested*: every L2 entry at a lower density exists at
    every higher one. With a zero bank nothing matches, so all work rides
    the packer + sparse-PE path — the sweep isolates exactly the units
    whose cycles must be monotone in ``l2_density``.
    """
    rng = np.random.default_rng(seed)
    u = rng.random((m, k_dim))
    patterns = np.zeros((k_dim // k, q, k), np.uint8)
    out = []
    for d in densities:
        a = (u < d).astype(np.float32)
        idx, tile_pop, tile_res = _assign_np(a, patterns)
        out.append(LayerTrace(
            name=f"density_{d:g}", m=m, k_dim=k_dim, n=n, k=k, q=q, idx=idx,
            tile_pop=tile_pop, tile_res=tile_res,
            usage=_usage_hist(idx, q), reps=int(reps)))
    return out


def vgg16_table4_traces(*, q: int = 128, timesteps: int = 4, batch: int = 8,
                        proto_density: float = 0.106, flip: float = 0.01,
                        n_protos: int = 48, seed: int = 0,
                        max_rows: int = 1024) -> list[LayerTrace]:
    """The paper's VGG-16 GEMM shapes at Table-4-class densities.

    Activations are prototype-structured binary rows (bit density ≈ the
    paper's 10.6% VGG16/CIFAR100 row, L2 density landing near its 1.8%)
    and the pattern bank is built from the most frequent prototypes —
    seeded numpy end to end, so the traces are bit-identical across
    platforms. Conv layers use k = 9 (one 3×3 kernel
    slice per partition, so every im2col K is divisible); the FC layer
    uses the paper default k = 16.
    """
    from repro_torch.core.perfmodel import vgg16_gemm_shapes

    rng = np.random.default_rng(seed)
    traces = []
    reps = timesteps * batch
    for li, shape in enumerate(vgg16_gemm_shapes()):
        M, K, N = shape.m, shape.k, shape.n
        k = 9 if K % 9 == 0 else 16
        m_rows = min(M, max_rows)
        protos = (rng.random((n_protos, K)) < proto_density).astype(np.uint8)
        pick = rng.integers(0, n_protos, m_rows)
        a = np.abs(protos[pick].astype(np.int32)
                   - (rng.random((m_rows, K)) < flip)).astype(np.float32)
        T = K // k
        # Pattern bank: tile slices of the prototypes, most frequent first,
        # padded with Bernoulli tiles up to q (a no-k-means stand-in for
        # Alg. 1 — the prototypes are the cluster centres by construction).
        bank = np.zeros((T, q, k), np.uint8)
        tiles = protos.reshape(n_protos, T, k)
        for t in range(T):
            uniq, counts = np.unique(tiles[:, t], axis=0, return_counts=True)
            order = np.argsort(-counts, kind="stable")
            take = min(q, uniq.shape[0])
            bank[t, :take] = uniq[order[:take]]
            if take < q:
                bank[t, take:] = (rng.random((q - take, k))
                                  < proto_density).astype(np.uint8)
        idx, tile_pop, tile_res = _assign_np(a, bank)
        traces.append(LayerTrace(
            name=f"vgg16_l{li}", m=m_rows, k_dim=K, n=N, k=k, q=q, idx=idx,
            tile_pop=tile_pop, tile_res=tile_res,
            usage=_usage_hist(idx, q),
            # fold any truncated rows into the rep count so total work
            # matches the full GEMM (M · reps row-passes)
            reps=reps * max(1, M // m_rows)))
    return traces
