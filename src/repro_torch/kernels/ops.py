"""Public wrappers around the Phi kernels (port of ``repro/kernels/ops.py``).

Responsibilities:
  * shape handling: flatten leading axes, pad rows to the block where the
    reference does, pick the ``l2_nnz`` and N blocks, default the PWP
    dequant scales;
  * the per-unit stages of the ``pallas`` lowering (``matcher``,
    ``l1_gather``, ``l2_spmm``) and, in plain PyTorch as the reference has
    them in XLA, COO bucketing (``bucket_coo``), its capacities and the
    capacity audit ``phi_l2_audit``;
  * the composite ``phi_matmul`` for every lowering of the reference
    (``ref``, ``coo``, ``pallas``, ``fused``, ``fused_stream``,
    ``fused_prefetch``), and the gate between the three fused kernels
    (``fused_shape_viable``);
  * ``lif_step`` on tensors of any shape;
  * ``phi_flash_attention`` and the attention kernel's shared-memory model
    and block choice.

The kernel wrappers choose by the device of their tensors: CPU tensors run
the plain PyTorch versions, CUDA tensors the Hopper kernels (or an error).
"""
from __future__ import annotations

import os

import torch

from repro_torch.core import hwconst
from repro_torch.core.assign import assign_patterns, pack_l2_coo_jit
from repro_torch.core.patterns import active_pattern_sets
from repro_torch.kernels import IMPLS, ref
from repro_torch.kernels.lif import lif_step_cuda
from repro_torch.kernels.matcher import matcher_cuda
from repro_torch.kernels.phi_attention import (
    SMEM_LIMIT, block_q_ok, launch_bound_blocks, phi_flash_attention_cuda, smem_bytes)
from repro_torch.kernels.phi_fused import (
    MAX_GROUP_T, MAX_K, MAX_Q, phi_fused_cuda, phi_fused_prefetch_cuda, phi_fused_stream_cuda,
    stream_smem_bytes, stripe_active_sets)
from repro_torch.kernels.phi_gather import (
    check_range_flag, l1_gather_cuda, make_range_flag, range_flag_to_host)
from repro_torch.kernels.phi_spmm import l2_spmm_cuda
from repro_torch.utils import cdiv, pad_rows


def effective_block_m(M: int, block_m: int) -> int:
    """Block-m actually used for an M-row problem: requested size clamped to
    the next power of two ≥ M."""
    return min(block_m, max(8, 1 << (M - 1).bit_length()))


def _pick_block_n(N: int, block_n: int) -> int:
    """Largest block size ≤ block_n that divides N (e.g. N = 384 with
    block_n = 256 -> 192), as the reference picks its N tiles. Degenerate
    divisors are refused loudly, as there. The per-unit CUDA kernels tile N
    by 32 columns themselves: ``l1_gather`` and ``l2_spmm`` call this only
    to refuse what the reference refuses."""
    b = min(block_n, N)
    while N % b:
        b -= 1
    if b < 8 and b != N:
        raise ValueError(f"no usable block_n ≤ {block_n} divides N={N} (best divisor {b}); "
                         "pad N to a multiple of 128 before calling")
    return b


# The reference's two retrieval modes of the gather and the spmm (a one-hot
# matmul, "mxu", or a vector gather, "take"). They select the same values;
# one-hot products are a TPU idiom, so one kernel serves both here.
_MODES = ("mxu", "take")


def _check_mode(mode: str) -> None:
    if mode not in _MODES:
        raise ValueError(f"mode {mode!r} not in {_MODES}")


# ---------------------------------------------------------------- matcher ---
def matcher(a: torch.Tensor, patterns: torch.Tensor, *, block_m: int = 256,
            packed: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Pattern match: a (..., K) binary, patterns (T, q, k) -> (idx (..., T)
    int32, residual (..., K) int8). ``block_m`` is the reference's row block:
    the kernel masks ragged M, so nothing is padded. ``packed`` is the bank
    as the kernel reads it."""
    lead = a.shape[:-1]
    K = a.shape[-1]
    idx, res = matcher_cuda(a.reshape(-1, K).to(torch.float32).contiguous(), patterns,
                            packed=packed)
    return idx.reshape(*lead, patterns.shape[0]), res.reshape(*lead, K)


# -------------------------------------------------------------- L1 gather ---
def l1_gather(idx: torch.Tensor, pwp: torch.Tensor, *, block_m: int = 256,
              block_n: int = 256, mode: str = "mxu",
              range_flag: torch.Tensor | None = None) -> torch.Tensor:
    """idx (..., T) in [0, q] -> (..., N): the sum of the indexed PWP rows.
    ``block_m`` is the reference's row block: the kernel masks ragged M.
    ``range_flag``: as :func:`phi_gather.l1_gather_cuda` takes it."""
    _check_mode(mode)
    lead = idx.shape[:-1]
    T = idx.shape[-1]
    N = pwp.shape[-1]
    _pick_block_n(N, block_n)
    out = l1_gather_cuda(idx.reshape(-1, T).to(torch.int32).contiguous(), pwp.contiguous(),
                         range_flag=range_flag)
    return out.reshape(*lead, N)


# ---------------------------------------------------------------- L2 spmm ---
def bucket_coo(rows: torch.Tensor, cols: torch.Tensor, signs: torch.Tensor, m: int,
               block_m: int, cap: int
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bucket row-sorted padded COO into per-M-block packs.

    rows must ascend (sentinel == m last), as ``pack_l2_coo_jit`` emits
    them. Returns (G, cap) local rows (sentinel block_m), (G, cap) cols,
    (G, cap) signs, and the number of entries dropped past each block's cap.

    Sentinel padding never consumes capacity and is never counted dropped:
    the packer emits sentinels (sign 0) after all real (sign ±1) entries, so
    the span boundaries are clamped to the real-entry count. Without the
    clamp, a caller whose ``m = G·block_m`` exceeds the packer's true M
    would find the sentinel rows inside the last block's span and report a
    capacity overflow that never happened.
    """
    dev = rows.device
    G = cdiv(m, block_m)
    n_valid = (signs != 0).sum()
    bounds = (torch.arange(G + 1, device=dev) * block_m).to(rows.dtype)
    starts = torch.minimum(torch.searchsorted(rows, bounds, side="left"), n_valid)
    take = starts[:-1, None] + torch.arange(cap, device=dev)[None, :]      # (G, cap)
    valid = take < starts[1:, None]
    take_c = take.clamp(0, rows.shape[0] - 1)
    local = rows[take_c] - (torch.arange(G, device=dev)[:, None] * block_m).to(rows.dtype)
    r = torch.where(valid, local, block_m)
    c = torch.where(valid, cols[take_c], 0)
    s = torch.where(valid, signs[take_c], 0)
    dropped = (starts[1:] - starts[:-1] - cap).clamp(min=0).sum()
    return r.to(torch.int32), c.to(torch.int32), s, dropped


def l2_per_block_cap(nnz_budget: float, block_m: int, K: int, cap: int) -> int:
    """Per-M-block L2 bucket capacity: the global budget with 4× local-
    imbalance headroom, clamped to the global cap. Shared by the ``pallas``
    lowering and ``phi_l2_audit``, and derived from the *requested* block_m
    in both, so the audit never checks a smaller capacity than the lowering
    enforces."""
    return max(8, min(cap, int(4 * nnz_budget * block_m * K)))


def phi_l2_audit(a: torch.Tensor, patterns: torch.Tensor, *, nnz_budget: float = 0.08,
                 block_m: int = 256, chunk_rows: int | None = None,
                 entry_block: int = 8192) -> dict:
    """Capacity-budget audit of a Phi decomposition (no matmul performed).

    Returns the dropped-entry counters of every budgeted path for
    activations ``a`` (..., K): ``pack_overflow`` (entries beyond the global
    COO cap of the ``pallas`` lowering), ``bucket_dropped`` (entries beyond
    ``bucket_coo``'s per-M-block cap) and ``chunk_overflow`` (entries beyond
    the per-chunk cap of ``coo``, whose ``PHI_CHUNK_ROWS`` it mirrors). All
    zero ⇔ the budgeted lowerings are exact for this input; a mismatch with
    nonzero counters is a capacity problem, not a kernel bug. The fused
    lowerings and ``ref`` are budget-free.
    """
    a2 = a.reshape(-1, a.shape[-1])
    M, K = a2.shape
    _, residual = assign_patterns(a2, patterns)
    cap = max(128, int(nnz_budget * M * K))
    rows, cols, signs, pack_over = pack_l2_coo_jit(residual, cap)
    bm = effective_block_m(M, block_m)
    per_block = l2_per_block_cap(nnz_budget, block_m, K, cap)
    G = cdiv(M, bm)
    _, _, _, bucket_drop = bucket_coo(rows, cols, signs, G * bm, bm, per_block)
    if chunk_rows is None:
        chunk_rows = int(os.environ.get("PHI_CHUNK_ROWS", "2048"))
    nc = cdiv(M, chunk_rows)
    chunk_cap = max(128, int(nnz_budget * chunk_rows * K))
    chunk_cap = cdiv(chunk_cap, entry_block) * entry_block
    res3 = pad_rows(residual, chunk_rows).reshape(nc, chunk_rows, K)
    chunk_nnz = res3.abs().to(torch.int64).sum(dim=(1, 2))
    chunk_over = (chunk_nnz - chunk_cap).clamp(min=0).sum()
    return {
        "l2_nnz": int(residual.abs().to(torch.int64).sum()),
        "cap": cap,
        "pack_overflow": int(pack_over),
        "bucket_dropped": int(bucket_drop),
        "chunk_cap": chunk_cap,
        "chunk_overflow": int(chunk_over),
    }


def l2_spmm(rows: torch.Tensor, cols: torch.Tensor, signs: torch.Tensor, w: torch.Tensor,
            m: int, *, block_m: int = 256, block_n: int = 256, cap: int | None = None,
            mode: str = "take") -> torch.Tensor:
    """Padded COO (sentinel row == m) × w (K, N) -> (m, N) f32, through
    ``bucket_coo`` with ``cap`` entries per M-block (default: all)."""
    _check_mode(mode)
    N = w.shape[-1]
    bm = effective_block_m(m, block_m)
    _pick_block_n(N, block_n)
    G = cdiv(m, bm)
    if cap is None:
        cap = int(rows.shape[0])
    br, bc, bs, _ = bucket_coo(rows, cols, signs, G * bm, bm, cap)
    return l2_spmm_cuda(br, bc, bs, w, block_m=bm)[:m]


# ------------------------------------------------- the counter's block rule ---
# The rows of one l2_nnz counter block and one prefetch stripe, as the
# reference picks them: its autotuners' heuristic (unmeasured) branch, the
# largest (block_m, block_n) whose modelled working set stays under an 8 MiB
# budget. The budget and the working-set models are the reference's rule for
# its TPU kernels, kept so that both packages count l2_nnz over the same rows;
# they say nothing of this card. The CUDA kernels' own tiles (32 rows, 128
# columns) and the streaming kernel's group (``stream_group_t``) do not depend
# on them. The reference's measured branch times its Pallas kernels on a TPU
# and has no counterpart here.
REF_COUNTER_BLOCK_BUDGET_BYTES = 8 * 1024 * 1024


def _fused_vmem_bytes(bm: int, bn: int, K: int, T: int, q: int) -> int:
    """The reference's model of its first fused kernel's f32 working set."""
    return 4 * (bm * K + T * q * (K // T) + T * (q + 1) * bn + K * bn + 3 * bm * bn)


def _fused_candidates(M: int, N: int) -> list[tuple[int, int]]:
    bms = [bm for bm in (128, 256) if bm <= max(8, 1 << (M - 1).bit_length())]
    bns = [bn for bn in (128, 256, 512) if N % bn == 0] or [N]
    return [(bm, bn) for bm in bms or [128] for bn in bns]


def _stream_vmem_bytes(bm: int, bn: int, K: int, T: int, q: int, gt: int) -> int:
    """The reference's model of its streaming kernel's f32 working set: two
    stages of ``gt`` partitions, the resident scales, three output blocks."""
    k = K // T
    return 4 * (2 * gt * (bm * k + q * k + (q + 1) * bn + k * bn) + T * (q + 1)
                + 3 * bm * bn)


def _stream_candidates(M: int, N: int, T: int) -> list[tuple[int, int, int]]:
    gts = [gt for gt in (8, 4, 2, 1) if T % gt == 0]
    return [(bm, bn, gt) for bm, bn in _fused_candidates(M, N) for gt in gts]


def _prefetch_vmem_bytes(bm: int, bn: int, K: int, T: int, q: int, p_active: int) -> int:
    """The reference's model of its prefetching kernel's f32 working set: the
    first kernel's, with the banks cut to the P active rows (+1)."""
    return 4 * (bm * K + T * p_active * (K // T) + T * (p_active + 1) * bn + K * bn
                + 3 * bm * bn)


def _pick_blocks(cands: list, size, key) -> tuple:
    """The largest candidate (by ``key``) under the budget; where none fits,
    the smallest working set."""
    fit = [c for c in cands if size(c) <= REF_COUNTER_BLOCK_BUDGET_BYTES]
    return max(fit, key=key) if fit else min(cands, key=size)


def autotune_fused_blocks(M: int, K: int, N: int, q: int, T: int) -> tuple[int, int]:
    """(block_m, block_n) of the reference's ``autotune_fused_blocks``,
    heuristic branch; only block_m is used here (the counter's block)."""
    return _pick_blocks(_fused_candidates(M, N),
                        lambda c: _fused_vmem_bytes(c[0], c[1], K, T, q),
                        lambda c: (c[0] * c[1], c[1]))


def autotune_stream_blocks(M: int, K: int, N: int, q: int, T: int) -> tuple[int, int, int]:
    """(block_m, block_n, group_t) of the reference's
    ``autotune_stream_blocks``, heuristic branch; only block_m is used here:
    the streaming kernel's group is :func:`stream_group_t`."""
    return _pick_blocks(_stream_candidates(M, N, T),
                        lambda c: _stream_vmem_bytes(c[0], c[1], K, T, q, c[2]),
                        lambda c: (c[0] * c[1], c[2], c[1]))


def autotune_prefetch_blocks(M: int, K: int, N: int, q: int, T: int,
                             p_active: int) -> tuple[int, int]:
    """(block_m, block_n) of the reference's ``autotune_prefetch_blocks``,
    heuristic branch; block_m is the counter's block and the stripe."""
    return _pick_blocks(_fused_candidates(M, N),
                        lambda c: _prefetch_vmem_bytes(c[0], c[1], K, T, q, p_active),
                        lambda c: (c[0] * c[1], c[1]))


def _fused_prologue(a2: torch.Tensor, pwp: torch.Tensor, pwp_scale: torch.Tensor | None,
                    T: int, q: int, block_m: int) -> tuple[int, torch.Tensor]:
    """Shared prologue of the fused wrapper: clamp the row block and default
    the PWP dequant scales. The bm·K bound keeps the int32 ``l2_nnz`` counter
    exact (a block holds at most bm·K residual entries)."""
    M, K = a2.shape
    bm = effective_block_m(M, block_m)
    if bm * K >= 2 ** 31:
        raise ValueError(f"block_m={bm} × K={K}: the l2_nnz int32 audit counter would wrap")
    if pwp_scale is None:
        if pwp.dtype == torch.int8:
            raise ValueError("int8 pwp requires pwp_scale (from quantize_pwp); "
                             "without it the L1 rows would be silently unscaled")
        pwp_scale = torch.ones((T, q + 1), dtype=torch.float32, device=pwp.device)
    return bm, pwp_scale


def phi_fused(a: torch.Tensor, patterns: torch.Tensor, pwp: torch.Tensor, w: torch.Tensor,
              *, pwp_scale: torch.Tensor | None = None, block_m: int | None = None,
              packed: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-pass fused Phi matmul (matcher + L1 + L2 in one kernel).

    a (..., K) binary × w (K, N) -> ((..., N) f32, l2_nnz (num_m_blocks,)
    int32). ``l2_nnz`` counts residual entries per block of ``block_m`` rows
    (default: the reference's rule, :func:`autotune_fused_blocks`). Exact for
    any L2 budget: nothing is dropped. pwp may be f32/bf16 (pwp_scale None) or
    int8 with per-row scales from ``quantize_pwp``. ``packed`` is the bank as
    the CUDA kernel reads it (``pack_patterns``), made once by the caller.
    """
    lead = a.shape[:-1]
    K = a.shape[-1]
    T, q, k = patterns.shape
    N = w.shape[-1]
    a2 = a.reshape(-1, K)
    block_m = block_m or autotune_fused_blocks(a2.shape[0], K, N, q, T)[0]
    bm, pwp_scale = _fused_prologue(a2, pwp, pwp_scale, T, q, block_m)
    # Binary activations and bf16 weights are exact in float32 (the
    # reference kernel widens both the same way); no copy when already f32.
    out, nnz = phi_fused_cuda(a2.to(torch.float32).contiguous(), patterns, pwp, pwp_scale,
                              w.to(torch.float32).contiguous(), block_m=bm, packed=packed)
    return out.reshape(*lead, N), nnz


def stream_group_t(q: int, k: int) -> int | None:
    """Deepest stage (partitions per group, 8 down to 1) of the streaming
    kernel whose two stages fit a block's shared memory; None when none does."""
    return next((gt for gt in range(MAX_GROUP_T, 0, -1)
                 if stream_smem_bytes(q, k, gt) <= SMEM_LIMIT), None)


def phi_fused_stream(a: torch.Tensor, patterns: torch.Tensor, pwp: torch.Tensor,
                     w: torch.Tensor, *, pwp_scale: torch.Tensor | None = None,
                     block_m: int | None = None, group_t: int | None = None,
                     packed: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """K-streaming fused Phi matmul: the contract and result of :func:`phi_fused`.

    ``group_t`` K-partitions per shared-memory stage (None: the deepest that
    fits, :func:`stream_group_t`); the next group's patterns and activations
    are copied while this one is matched and contracted. Unlike the
    reference's, ``group_t`` need not divide T: the last group is shorter.
    """
    lead = a.shape[:-1]
    K = a.shape[-1]
    T, q, k = patterns.shape
    N = w.shape[-1]
    a2 = a.reshape(-1, K)
    block_m = block_m or autotune_stream_blocks(a2.shape[0], K, N, q, T)[0]
    bm, pwp_scale = _fused_prologue(a2, pwp, pwp_scale, T, q, block_m)
    group_t = group_t or stream_group_t(q, k)
    if group_t is None:
        raise ValueError(f"phi_fused_stream: no stage of q={q}, k={k} fits shared memory")
    out, nnz = phi_fused_stream_cuda(a2.to(torch.float32).contiguous(), patterns, pwp,
                                     pwp_scale, w.to(torch.float32).contiguous(), block_m=bm,
                                     group_t=group_t, packed=packed)
    return out.reshape(*lead, N), nnz


def phi_fused_prefetch(a: torch.Tensor, patterns: torch.Tensor, pwp: torch.Tensor,
                       w: torch.Tensor, *, usage=None, p_active: int | None = None,
                       pwp_scale: torch.Tensor | None = None, block_m: int | None = None,
                       packed: torch.Tensor | None = None, runtime_sets=None,
                       return_hist: bool = False):
    """PWP-prefetching fused Phi matmul: each M-stripe of ``block_m`` rows is
    matched only against its P most referenced patterns per partition.

    P comes from ``p_active``, else from the calibration ``usage`` histogram
    ((T, q+1) counts) through ``active_pattern_sets``, which must show skew.
    The sets come from a pre-pass over the activations
    (``stripe_active_sets``), or, given ``runtime_sets`` ((T, P) indices, from
    the execution policy's aggregated runtime match histogram), those serve
    every stripe and the pre-pass is skipped. ``return_hist`` (pre-pass only)
    also returns the pre-pass's (T, q+1) int32 match histogram, the runtime
    telemetry the policy aggregates. Returns ``(out, l2_nnz[, hist])`` like
    :func:`phi_fused`: the output is exact for any sets; ``l2_nnz`` counts
    the residual of the restricted match.
    """
    lead = a.shape[:-1]
    K = a.shape[-1]
    T, q, k = patterns.shape
    N = w.shape[-1]
    a2 = a.reshape(-1, K)
    if runtime_sets is not None and p_active is None:
        p_active = int(runtime_sets.shape[-1])
    if p_active is None:
        if usage is None:
            raise ValueError("phi_fused_prefetch needs a pattern-usage histogram (usage=) or "
                             "an explicit gather size (p_active=)")
        active_sets, _ = active_pattern_sets(usage)
        if active_sets is None:
            raise ValueError("usage histogram shows no exploitable skew; use impl='fused'")
        p_active = int(active_sets.shape[-1])
    p_active = min(int(p_active), q)
    block_m = block_m or autotune_prefetch_blocks(a2.shape[0], K, N, q, T, p_active)[0]
    bm, pwp_scale = _fused_prologue(a2, pwp, pwp_scale, T, q, block_m)
    a2 = a2.to(torch.float32).contiguous()
    hist = None
    if runtime_sets is not None:
        rs = torch.as_tensor(runtime_sets, dtype=torch.int32, device=a2.device)
        if tuple(rs.shape) != (T, p_active):
            raise ValueError(f"runtime_sets shape {tuple(rs.shape)} does not match the gather "
                             f"buffer (T={T}, p_active={p_active}); derive them with "
                             "core.patterns.top_p_sets(hist, p_active)")
        if return_hist:
            raise ValueError("return_hist requires the pre-pass path (runtime_sets=None): with "
                             "runtime sets there is no match histogram to return")
        active = rs[None].expand(cdiv(a2.shape[0], bm), T, p_active).contiguous()
    elif return_hist:
        active, hist = stripe_active_sets(a2, patterns, p_active, bm, return_hist=True)
    else:
        active = stripe_active_sets(a2, patterns, p_active, bm)
    out, nnz = phi_fused_prefetch_cuda(a2, patterns, pwp, pwp_scale,
                                       w.to(torch.float32).contiguous(), active, block_m=bm,
                                       packed=packed)
    out = out.reshape(*lead, N)
    return (out, nnz, hist) if return_hist else (out, nnz)


# Fewest K-partitions at which the gate sends a GEMM to the streaming kernel.
# Neither kernel's shared memory grows with K on the Hopper, and the two take
# the same time within a few percent at every GEMM of the VGG and
# Spikformer-4-384 configurations (PERF.md), so the threshold is the
# reference's: its policy streams K for fc2 of Spikformer-4-384 (T = 96) and
# conv3/conv4 of the VGG at VGG-16 stage widths (T = 144, 288), and for none
# of their GEMMs below T = 96.
STREAM_MIN_T = 96


def fused_shape_viable(M: int, K: int, N: int, T: int, q: int, usage=None,
                       p_active: int | None = None) -> str:
    """Which fused kernel the Hopper takes for an (M, K) × (K, N) Phi GEMM
    with T partitions of q patterns: ``"fused_prefetch"``, ``"fused"``,
    ``"fused_stream"`` or ``"coo"`` (no kernel takes the bank).

    In the reference's order, re-derived from the kernels rather than from
    its VMEM model: with a calibration ``usage`` histogram that shows skew
    (``active_pattern_sets``; or an explicit ``p_active``), the prefetching
    kernel, which matches only the P hot patterns (P ≤ 512); else the
    streaming kernel where the K loop is long (T ≥ :data:`STREAM_MIN_T`) or q
    is past the first kernel's 512, and the first kernel elsewhere. Every
    kernel takes k ≤ 64, and the streaming one any q whose two stages fit
    227 KB.
    """
    k = K // T
    if k > MAX_K:
        return "coo"
    if p_active is None and usage is not None:
        active, _ = active_pattern_sets(usage)
        p_active = None if active is None else int(active.shape[-1])
    if p_active is not None and p_active <= MAX_Q:
        return "fused_prefetch"
    if q > MAX_Q:
        return "fused_stream" if stream_group_t(q, k) is not None else "coo"
    return "fused_stream" if T >= STREAM_MIN_T else "fused"


def launch_cost_prefers_coo(m: int, k_dim: int, n: int, t: int, q: int,
                            *, nnz_budget: float = 0.08,
                            pwp_usage: float | None = None) -> bool:
    """Cost-model crossover of the reference's policy: True when the
    modelled HBM bytes of the "coo" lowering undercut the cheapest fused
    lowering's plus one kernel launch.

    The fused kernels stream the full PWP bank and weight stripe per
    M-stripe regardless of M; the coo path's gathers touch only referenced
    rows, so its traffic scales with M. The launch is
    ``hwconst.KERNEL_LAUNCH_BYTES``, measured on the H100. ``pwp_usage``
    (the (P+1)/(q+1) fraction of a skewed usage histogram) lets the
    prefetching lowering compete. The port's policy applies no such row on
    ``cuda``: there the coo lowering is several PyTorch launches, not one
    program, so the crossover's premise does not hold (``chip_smoke.py``
    prints what this function would decide at each main-path GEMM).
    """
    from repro_torch.core.perfmodel import GemmShape, phi_coo_traffic, phi_kernel_traffic

    tr = phi_kernel_traffic(GemmShape(m, k_dim, n), k=k_dim // t, q=q,
                            nnz_budget=nnz_budget, pwp_usage=pwp_usage)
    fused_total = min(tr["fused"].total, tr["fused_stream"].total)
    if pwp_usage is not None:
        fused_total = min(fused_total, tr["fused_prefetch"].total)
    coo_total = phi_coo_traffic(GemmShape(m, k_dim, n), k=k_dim // t, q=q,
                                nnz_budget=nnz_budget)
    return coo_total < fused_total + hwconst.KERNEL_LAUNCH_BYTES


# -------------------------------------------------------------------- LIF ---
def lif_step(v: torch.Tensor, x: torch.Tensor, *, decay: float = 0.5, threshold: float = 1.0,
             reset: str = "hard") -> tuple[torch.Tensor, torch.Tensor]:
    """LIF update on tensors of any shape; returns (spike, v')."""
    s, vn = lif_step_cuda(v.reshape(-1), x.reshape(-1), decay=decay, threshold=threshold,
                          reset=reset)
    return s.reshape(v.shape), vn.reshape(v.shape)


# ------------------------------------------------------------ coo lowering ---
def _phi_matmul_coo_chunked(a2: torch.Tensor, w: torch.Tensor, patterns: torch.Tensor,
                            pwp: torch.Tensor, nnz_budget: float,
                            chunk_rows: int | None = None, entry_block: int = 8192,
                            gather_dtype: torch.dtype | None = None,
                            pwp_scale: torch.Tensor | None = None,
               packed: torch.Tensor | None = None) -> torch.Tensor:
    """Row-chunked gather/scatter Phi matmul (plain PyTorch).

    Per chunk of ``chunk_rows`` rows (``PHI_CHUNK_ROWS``, default 2048):
      L1 — a loop over K-tiles accumulating ``pwp[t][idx[:, t]]``;
      L2 — the residual packed as static-capacity COO (entries past the
           capacity are dropped, as the reference's packer drops them),
           processed in ``entry_block``-sized slabs of gather + ``index_add_``
           into a buffer whose extra last row takes the sentinel entries.
    """
    if chunk_rows is None:
        chunk_rows = int(os.environ.get("PHI_CHUNK_ROWS", "2048"))
    gather_dtype = gather_dtype or torch.float32
    M, K = a2.shape
    N = w.shape[-1]
    T = patterns.shape[0]
    nc = cdiv(M, chunk_rows)
    a3 = torch.nn.functional.pad(a2, (0, 0, 0, nc * chunk_rows - M)).reshape(nc, chunk_rows, K)
    cap = max(128, int(nnz_budget * chunk_rows * K))
    cap = cdiv(cap, entry_block) * entry_block
    wf = w.to(gather_dtype)
    pwpf = pwp if pwp.dtype == torch.int8 else pwp.to(gather_dtype)
    outs = []
    for chunk_a in a3:
        idx, residual = assign_patterns(chunk_a, patterns)
        idx = idx.long()
        out1 = torch.zeros((chunk_rows, N), dtype=torch.float32, device=a2.device)
        for t in range(T):
            rows = pwpf[t][idx[:, t]].to(torch.float32)
            if pwp_scale is not None:  # int8 PWP: dequantise per gathered row
                rows = rows * pwp_scale[t].to(torch.float32)[idx[:, t]][:, None]
            out1 = out1 + rows
        r, c, s, _ = pack_l2_coo_jit(residual, cap)
        out2 = torch.zeros((chunk_rows + 1, N), dtype=torch.float32, device=a2.device)
        for b in range(0, cap, entry_block):
            vals = wf[c[b:b + entry_block].long()].to(torch.float32) \
                * s[b:b + entry_block].to(torch.float32)[:, None]
            out2.index_add_(0, r[b:b + entry_block].long(), vals)
        outs.append(out1 + out2[:chunk_rows])
    return torch.cat(outs).reshape(nc * chunk_rows, N)[:M]


# -------------------------------------------------------------- composite ---
def phi_matmul(a: torch.Tensor, w: torch.Tensor, patterns: torch.Tensor, pwp: torch.Tensor,
               *, impl: str = "pallas", nnz_budget: float = 0.08,
               block_m: int | None = None, block_n: int | None = None,
               gather_dtype: torch.dtype | None = None,
               pwp_scale: torch.Tensor | None = None,
               packed: torch.Tensor | None = None, usage=None,
               p_active: int | None = None) -> torch.Tensor:
    """Full Phi sparse matmul: a (..., K) binary × w (K, N) -> (..., N) f32.

    impl:
      "fused"          — the single-pass Hopper kernel (plain version on the CPU);
      "fused_stream"   — its K-streaming variant (same result);
      "fused_prefetch" — its variant matching each M-stripe against its hot
                         patterns only (same result; needs ``usage`` or
                         ``p_active``);
      "pallas"         — the per-unit kernels: matcher → L1 gather →
                         ``pack_l2_coo_jit`` → ``bucket_coo`` → L2 spmm, with
                         the global COO cap ``max(128, nnz_budget·M·K)`` and
                         the per-block cap of ``l2_per_block_cap`` (entries
                         past them are dropped, as in the reference:
                         ``phi_l2_audit`` counts them); blocks default to 256;
      "coo"            — the row-chunked gather/scatter lowering in plain PyTorch;
      "ref"            — the dense L2 oracle.
    The default is "pallas", as the reference's. ``nnz_budget`` (the static
    L2 capacity as a fraction of M·K, or of the chunk's rows × K) applies to
    "pallas" and "coo"; ``packed`` (the bank from ``pack_patterns``) to the
    kernels that match. "pallas" refuses an int8 bank: the reference's
    lowering passes no scales to its gather and would sum unscaled int8 rows.
    ``block_m`` None gives the fused lowerings the reference's counter block
    (:func:`autotune_fused_blocks` and its two siblings).
    """
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS}")
    lead = a.shape[:-1]
    K = a.shape[-1]
    N = w.shape[-1]
    a2 = a.reshape(-1, K)
    if impl == "ref":
        out = ref.phi_matmul_ref(a2, w, patterns, pwp)
    elif impl == "fused":
        out, _ = phi_fused(a2, patterns, pwp, w, pwp_scale=pwp_scale, block_m=block_m,
                           packed=packed)
    elif impl == "fused_stream":
        out, _ = phi_fused_stream(a2, patterns, pwp, w, pwp_scale=pwp_scale, block_m=block_m,
                                  packed=packed)
    elif impl == "fused_prefetch":
        out, _ = phi_fused_prefetch(a2, patterns, pwp, w, usage=usage, p_active=p_active,
                                    pwp_scale=pwp_scale, block_m=block_m, packed=packed)
    elif impl == "pallas":
        out = _phi_matmul_pallas(a2, w, patterns, pwp, nnz_budget, block_m or 256,
                                 block_n or 256, pwp_scale, packed)
    else:
        out = _phi_matmul_coo_chunked(a2, w, patterns, pwp, nnz_budget,
                                      gather_dtype=gather_dtype, pwp_scale=pwp_scale)
    return out.reshape(*lead, N)


def _phi_matmul_pallas(a2: torch.Tensor, w: torch.Tensor, patterns: torch.Tensor,
                       pwp: torch.Tensor, nnz_budget: float, block_m: int, block_n: int,
                       pwp_scale: torch.Tensor | None, packed: torch.Tensor | None
                       ) -> torch.Tensor:
    """The per-unit lowering of :func:`phi_matmul` (``impl="pallas"``)."""
    if pwp_scale is not None or pwp.dtype == torch.int8:
        raise ValueError("impl='pallas' takes no int8 PWP bank: its L1 gather has no per-row "
                         "scales (the reference's lowering drops them and sums unscaled int8 "
                         "rows); use an f32/bf16 bank or a fused lowering")
    M, K = a2.shape
    idx, residual = matcher(a2, patterns, block_m=block_m, packed=packed)
    # The gather goes ahead of the packer and checks its indices' range on the
    # card; the flag's copy is read after the packer's torch.nonzero, which
    # waits for the stream, so the check costs no wait of its own.
    flag = make_range_flag(idx.device) if idx.is_cuda else None
    out1 = l1_gather(idx, pwp, block_m=block_m, block_n=block_n, range_flag=flag)
    flag_host = None if flag is None else range_flag_to_host(flag)
    cap = max(128, int(nnz_budget * M * K))
    rows, cols, signs, _ = pack_l2_coo_jit(residual, cap)   # torch.nonzero: one sync
    if flag_host is not None:
        check_range_flag(flag_host, idx, pwp.shape[1])
    per_block = l2_per_block_cap(nnz_budget, block_m, K, cap)
    out2 = l2_spmm(rows, cols, signs, w.to(torch.float32), M, block_m=block_m,
                   block_n=block_n, cap=per_block)
    return out1 + out2


# -------------------------------------------------------------- attention ---
def _attn_smem_bytes(bq: int, bkv: int, S: int, D: int, T: int, qp: int) -> int:
    """Shared memory of one block of the attention kernel at blocks (bq, bkv).

    The kernel streams kv-blocks (``csrc/phi_attention.cu``), so unlike the
    reference's VMEM model nothing here grows with S: the blocks are clamped
    to S and the bytes are the kernel's own layout
    (``phi_attention.smem_bytes``). ``T = 0`` is the dense instantiation.
    """
    return smem_bytes(min(bq, S), min(bkv, S), D, T, qp)


def _attn_candidates(S: int, D: int) -> list[tuple[int, int]]:
    """(block_q, block_kv) pairs the block choice considers for sequence
    length S and head size D: the kernel's block_q limit applied."""
    cap = max(8, 1 << (max(S, 1) - 1).bit_length())
    sizes = sorted({min(b, cap) for b in (32, 64, 128)})
    return [(bq, bkv) for bq in sizes for bkv in sizes if block_q_ok(min(bq, max(S, 1)), D)]


# Shared memory of one H100 SM, and what the hardware reserves per block.
_SM_SMEM = hwconst.SM_SMEM
_SM_SMEM_PER_BLOCK = hwconst.SM_SMEM_PER_BLOCK_RESERVED


def _attn_blocks_per_sm(bq: int, bkv: int, S: int, D: int, T: int, qp: int) -> int:
    """Blocks one SM can hold: as many as shared memory allows, capped by
    the kernel's launch bound (``launch_bound_blocks``), which its registers
    set."""
    by_smem = _SM_SMEM // (_attn_smem_bytes(bq, bkv, S, D, T, qp) + _SM_SMEM_PER_BLOCK)
    return min(by_smem, launch_bound_blocks(min(bq, S), D))


def attn_shape_viable(S: int, D: int, T: int, qp: int, kp: int) -> bool:
    """Shared-memory gate of the execution policy's attention row: True when
    the kernel takes the bank (kp ≤ 64, T·kp ≤ D) and some candidate block
    pair fits the 227 KB a block may use."""
    if T and (kp > MAX_K or T * kp > D):
        return False
    return any(_attn_smem_bytes(bq, bkv, S, D, T, qp) <= SMEM_LIMIT
               for bq, bkv in _attn_candidates(S, D))


_ATTN_TUNE_CACHE: dict[tuple, tuple[int, int]] = {}


def autotune_attn_blocks(S: int, D: int, T: int, qp: int, kp: int) -> tuple[int, int]:
    """Pick (block_q, block_kv) for the attention kernel.

    Heuristic, no timed pass (the dense A/B arm must run the *same*
    block_kv for the bitwise contract): the widest kv block that fits
    (fewer online-softmax rescales), then the block_q that lets the most
    blocks share an SM (shared memory, capped by the kernel's launch bound),
    then the largest block_q.
    Where nothing fits, the smallest footprint.
    """
    key = (S, D, T, qp, kp)
    if key in _ATTN_TUNE_CACHE:
        return _ATTN_TUNE_CACHE[key]
    allc = _attn_candidates(S, D) or [(8, 8)]
    cands = [c for c in allc if _attn_smem_bytes(c[0], c[1], S, D, T, qp) <= SMEM_LIMIT]
    cands = cands or [min(allc, key=lambda c: _attn_smem_bytes(c[0], c[1], S, D, T, qp))]
    best = max(cands, key=lambda c: (c[1], _attn_blocks_per_sm(*c, S, D, T, qp), c[0]))
    _ATTN_TUNE_CACHE[key] = best
    return best


def phi_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        patterns: torch.Tensor, *, causal: bool = False,
                        window: int | None = None, chunk: int | None = None,
                        block_q: int | None = None, block_kv: int | None = None,
                        packed: torch.Tensor | None = None) -> torch.Tensor:
    """Phi-sparse flash attention: q/k/v (B, S, H, D) with binary spike Q/K,
    patterns (T, qp, kp) calibrated on the K rows (T·kp ≤ D; the ragged tail
    is contracted densely). The output equals ``models.flash.flash_attention``
    with the same blocks bitwise (binary operands make every score block
    integer-exact, and scale is applied after the contraction).

    CUDA tensors launch the hand-written kernel, or raise where it refuses
    the shape; CPU tensors run its plain version, the reference's "xla"
    lowering. ``packed`` is the bank as the kernel reads it
    (``pack_patterns``). Inference only, as in the reference: raises where
    autograd would need a backward, rather than return an output cut off
    from q, k and v.
    """
    from repro_torch.models.flash import under_autograd

    if under_autograd(q, k, v):
        raise NotImplementedError(
            "phi_flash_attention is inference only: the Phi lowering has no backward, as in "
            "the reference. Under autograd call models.flash.flash_attention (its backward is "
            "the flash backward), or route the site through dispatch.attention, which "
            "resolves dense flash there (autodiff_keeps_flash, autodiff_demotes_phi_flash)")
    B, S, H, D = q.shape
    T, qp, kp = patterns.shape
    if T * kp > D:
        raise ValueError(
            f"phi_flash_attention: pattern bank covers {T}×{kp}={T * kp} features but "
            f"head_dim is only {D} — the bank was calibrated for a different head layout")
    if block_q is None or block_kv is None:
        bq, bkv = autotune_attn_blocks(S, D, T, qp, kp)
        block_q, block_kv = block_q or bq, block_kv or bkv
    q32, k32, v32 = (x.to(torch.float32).contiguous() for x in (q, k, v))
    out, _ = phi_flash_attention_cuda(q32, k32, v32, patterns, packed=packed, causal=causal,
                                      window=window, chunk=chunk, block_q=block_q,
                                      block_kv=block_kv)
    return out.to(q.dtype)
