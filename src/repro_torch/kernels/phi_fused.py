"""Fused single-pass Phi matmul: the Hopper kernels and their plain version.

Port of ``repro/kernels/phi_fused.py::phi_fused_pallas`` and of its
K-streaming and PWP-prefetching variants ``phi_fused_stream_pallas`` and
``phi_fused_prefetch_pallas``. Per row and per
K-partition: Hamming match against the bank (first-index argmin, strictly
better than the row's own popcount, else "no pattern"), the selected PWP row
times its scale into the L1 accumulator, the ±1 residual against the weight
rows into the L2 accumulator; ``out = acc1 + acc2`` once at the end, and the
residual entries counted per ``block_m`` rows. The CUDA kernels live in
``csrc/phi_fused.cu``, whose note says how they are laid out on the card.
Both share each row tile's match across a cluster of column tiles: the first
one matches all its partitions (up to 95 at a time) before one cluster
barrier and then sums them; the streaming one copies each group of
``group_t`` partitions (patterns and activations) into shared memory one
group ahead and matches a group ahead of its sums. Both do the sums in the
same order, so :func:`phi_fused_plain` serves both. The prefetching one
matches each row only against its M-stripe's active pattern set
(:func:`stripe_active_sets`) and has its own plain version,
:func:`phi_fused_prefetch_plain`.

The ``*_cuda`` wrappers choose by the device of their tensors: CPU tensors go
through the plain versions; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.core import hwconst
from repro_torch.kernels import _build
from repro_torch.utils import cdiv, pad_rows

# Shapes the CUDA kernels take (csrc/phi_fused.cu): one 64-bit word per row
# partition; for the first kernel q (or P) <= 512 and any T, its match tile
# holding up to 95 partitions at a time; for the streaming one up to 8
# partitions per stage, two stages in the 227 KB a block may use, q < 65536.
MAX_K = 64
MAX_Q = 512
MAX_GROUP_T = 8
MAX_TC = 95                 # partitions of the first kernel's match tile (a chunk of T)
SMEM_LIMIT = hwconst.SMEM_PER_BLOCK  # shared memory a block may use on an H100 (227 KB)
_BM = 32                    # rows per output tile of the fused kernels
_FIRST_LIST = 256           # residual entries a warp of the first kernel lists at a time
_PWP_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def pack_patterns(patterns: torch.Tensor) -> torch.Tensor:
    """(T, q, k) patterns -> (T, q) int64 words, bit j set where element j is non-zero.

    The CUDA kernel's form of the bank. The patterns are constant after
    calibration, so a caller that runs many batches packs once (``PhiState``
    does) and passes the words to :func:`phi_fused_cuda` as ``packed``.
    """
    k = patterns.shape[-1]
    if k > MAX_K:
        raise ValueError(f"pack_patterns takes k <= {MAX_K} (one {MAX_K}-bit word per "
                         f"pattern); got k={k}")
    bits = torch.arange(k, dtype=torch.int64, device=patterns.device)
    return ((patterns != 0).to(torch.int64) << bits).sum(-1)


def _partition_body(at: torch.Tensor, p: torch.Tensor, pwp_t: torch.Tensor,
                    scale_t: torch.Tensor, w_t: torch.Tensor, acc1: torch.Tensor,
                    acc2: torch.Tensor, *, q: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One K-partition: match → L1 → L2, as the reference's ``_partition_body``.

    at (..., M, k) f32 binary, p (q, k) f32, pwp_t (..., q+1, N), scale_t
    (q+1,) f32, w_t (..., k, N); leading axes batch independent problems
    (the attention score blocks of many heads). Returns the updated
    accumulators and the residual entries of each row. The one-hot products
    of the reference are row gathers here: they select the same values.
    """
    dot = at @ p.T                                         # (..., M, q)
    pop_a = at.sum(-1)
    ham = pop_a[..., None] + p.sum(-1) - 2.0 * dot
    best = ham.argmin(-1)                                  # first index on ties
    use = ham.amin(-1) < pop_a                             # strict rule
    idx = torch.where(use, best, q)
    rows = torch.take_along_dim(pwp_t, idx[..., None], dim=-2)
    acc1 = acc1 + rows.to(torch.float32) * scale_t[idx][..., None]
    chosen = torch.where(use[..., None], p[best], 0.0)
    residual = at - chosen                                 # (..., M, k) in {−1, 0, +1}
    acc2 = acc2 + residual @ w_t.to(torch.float32)
    return acc1, acc2, residual.abs().sum(-1).to(torch.int32)


def phi_fused_plain(a: torch.Tensor, patterns: torch.Tensor, pwp: torch.Tensor,
                    pwp_scale: torch.Tensor, w: torch.Tensor, *, block_m: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the fused kernel: a loop over the K-partitions.

    Same contract as :func:`phi_fused_cuda`. The L2 contraction is a float32
    matmul, so on a card it needs ``torch.backends.cuda.matmul.allow_tf32``
    off (the PyTorch default) to stay exact.
    """
    M, K = a.shape
    T, q, k = patterns.shape
    N = w.shape[-1]
    af = a.to(torch.float32)
    pf = patterns.to(device=a.device, dtype=torch.float32)
    acc1 = torch.zeros((M, N), dtype=torch.float32, device=a.device)
    acc2 = torch.zeros_like(acc1)
    row_nnz = torch.zeros((M,), dtype=torch.int32, device=a.device)
    for t in range(T):
        acc1, acc2, cnt = _partition_body(
            af[:, t * k:(t + 1) * k], pf[t], pwp[t], pwp_scale[t].to(torch.float32),
            w[t * k:(t + 1) * k], acc1, acc2, q=q)
        row_nnz += cnt
    nnz = pad_rows(row_nnz, block_m).reshape(-1, block_m).sum(-1, dtype=torch.int32)
    return acc1 + acc2, nnz


def stream_smem_bytes(q: int, k: int, group_t: int) -> int:
    """Shared memory of one block of the streaming kernel, in bytes, at a
    cluster of one block (the most any N gives): two stages of ``group_t``
    packed pattern rows (stride q+1) and a (32 rows × group_t·k floats)
    activation tile, each rounded up to 16 bytes; two match tiles of 32 ×
    group_t pairs (±masks, index: 20 bytes a pair); 32 row counters. The C
    layout is ``csrc/phi_fused.cu::phi_fused_stream_smem_bytes``."""
    r16 = lambda b: -(-b // 16) * 16                               # noqa: E731
    return 2 * (r16(group_t * (q + 1) * 8) + r16(_BM * group_t * k * 4)) \
        + 2 * _BM * group_t * 20 + 4 * _BM


def fused_tc(T: int) -> int:
    """Partitions a chunk of the first kernel's match takes: T in the fewest
    chunks of at most :data:`MAX_TC`, as even as they go (all of T for every
    T the policy sends that kernel, T < ``ops.STREAM_MIN_T`` = 96)."""
    if T <= MAX_TC:
        return max(T, 1)
    chunks = -(-T // MAX_TC)
    return -(-T // chunks)


def fused_smem_bytes(T: int) -> int:
    """Shared memory of one block of the first kernel (and of the
    prefetching one), in bytes, at T partitions: the match tile of 32 rows ×
    :func:`fused_tc` partitions (±masks, the matched bank row and its
    scale: 24 bytes a pair), 32 row counters, each of the 8 warps' list of
    256 residual entries (4 bytes each) and the 256 threads' parked
    accumulators (32 floats each). The bank is read from device memory, so q and P do not
    count. The C layout is ``csrc/phi_fused.cu::phi_fused_smem_bytes``; at
    most 114 048 bytes (T = 95), under the 227 KB a block may use."""
    return _BM * fused_tc(T) * 24 + 4 * _BM + 8 * _FIRST_LIST * 4 + 256 * 32 * 4


def stripe_active_sets(a2: torch.Tensor, patterns: torch.Tensor, p_active: int,
                       block_m: int, return_hist: bool = False):
    """Per-M-stripe active pattern sets: (ceil(M / block_m), T, p_active) int32.

    For each stripe of ``block_m`` rows and each K-partition, the
    ``p_active`` patterns the stripe's rows match most often under the full
    bank (first-index argmin, strict rule), most referenced first, ties to
    the lower index, as the reference's ``stripe_active_sets`` (``top_k``)
    orders them. Rows past M count as zero rows, which match nothing.

    With ``return_hist`` also returns the (T, q+1) int32 match histogram of
    the M rows (column q counts unmatched row-partitions; the padding rows
    are not counted), the runtime match telemetry the execution policy
    aggregates per site.
    """
    M, K = a2.shape
    T, q, k = patterns.shape
    at = pad_rows(a2, block_m).reshape(-1, block_m, T, k).to(torch.float32)
    pf = patterns.to(device=a2.device, dtype=torch.float32)
    pop_a = at.sum(-1)                                              # (gm, bm, T)
    ham = pop_a[..., None] + pf.sum(-1) - 2.0 * torch.einsum("gmtk,tqk->gmtq", at, pf)
    best = ham.argmin(-1)
    use = ham.amin(-1) < pop_a
    counts = torch.zeros((at.shape[0], T, q + 1), dtype=torch.int32, device=a2.device)
    counts.scatter_add_(2, torch.where(use, best, q).transpose(1, 2),
                        torch.ones_like(best, dtype=torch.int32).transpose(1, 2))
    order = torch.sort(counts[..., :q], dim=-1, descending=True, stable=True).indices
    active = order[..., :p_active].to(torch.int32).contiguous()
    if not return_hist:
        return active
    assigned = counts[..., :q].sum(0, dtype=torch.int32)             # (T, q)
    unmatched = M - assigned.sum(-1, keepdim=True, dtype=torch.int32)
    return active, torch.cat([assigned, unmatched], dim=-1)


def phi_fused_prefetch_plain(a: torch.Tensor, patterns: torch.Tensor, pwp: torch.Tensor,
                             pwp_scale: torch.Tensor, w: torch.Tensor, active: torch.Tensor,
                             *, block_m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the prefetching kernel: per stripe of ``block_m``
    rows, :func:`phi_fused_plain` over the compact bank the stripe's active
    sets select (patterns, PWP rows and scales, plus the "no pattern" slot),
    as the reference's interpret lowering runs its kernel."""
    T, q, _ = patterns.shape
    P = active.shape[-1]
    tidx = torch.arange(T, device=a.device)[:, None]
    outs, nnzs = [], []
    for g, act in enumerate(active.long()):                        # act (T, P)
        rows = a[g * block_m:(g + 1) * block_m]
        pats_c = patterns.to(a.device)[tidx, act]                   # (T, P, k)
        pwp_c = torch.cat([pwp[tidx, act], pwp[:, q:]], dim=1)      # (T, P+1, N)
        scale_c = torch.cat([pwp_scale[tidx, act], pwp_scale[:, q:]], dim=1)
        out, nnz = phi_fused_plain(rows, pats_c, pwp_c, scale_c, w, block_m=block_m)
        outs.append(out)
        nnzs.append(nnz)
    if not outs:
        return (torch.empty((0, w.shape[-1]), dtype=torch.float32, device=a.device),
                torch.zeros((0,), dtype=torch.int32, device=a.device))
    return torch.cat(outs), torch.cat(nnzs)


def _check_cuda_operands(a, patterns, packed, pwp, pwp_scale, w, group_t=None) -> None:
    M, K = a.shape
    T, q, k = patterns.shape
    N = w.shape[-1]
    if group_t is None and (k > MAX_K or q > MAX_Q):
        raise ValueError(f"phi_fused CUDA kernel takes k <= {MAX_K} and q <= {MAX_Q}; "
                         f"got k={k}, q={q}")
    if group_t is not None:
        if k > MAX_K or q >= 1 << 16 or not 1 <= group_t <= MAX_GROUP_T:
            raise ValueError(f"phi_fused_stream CUDA kernel takes k <= {MAX_K}, q < 65536 and "
                             f"1 <= group_t <= {MAX_GROUP_T}; got k={k}, q={q}, "
                             f"group_t={group_t}")
        if stream_smem_bytes(q, k, group_t) > SMEM_LIMIT:
            raise ValueError(f"phi_fused_stream: q={q}, k={k}, group_t={group_t} needs "
                             f"{stream_smem_bytes(q, k, group_t)} B of shared memory, more "
                             f"than {SMEM_LIMIT}")
    for name, x in (("a", a), ("packed", packed), ("pwp", pwp),
                    ("pwp_scale", pwp_scale), ("w", w)):
        if x.device != a.device:
            raise ValueError(f"{name} is on {x.device}, a is on {a.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"a and w must be float32, got {a.dtype} and {w.dtype}")
    if pwp.dtype not in _PWP_DTYPES:
        raise TypeError(f"pwp dtype {pwp.dtype} not in {list(_PWP_DTYPES)}")
    if pwp_scale.dtype != torch.float32:
        raise TypeError("pwp_scale must be float32")
    if packed.dtype != torch.int64 or packed.shape != (T, q):
        raise ValueError(f"packed must be (T, q) = ({T}, {q}) int64 from pack_patterns, got "
                         f"{tuple(packed.shape)} {packed.dtype}")
    if K != T * k or w.shape != (K, N) or pwp.shape != (T, q + 1, N) \
            or pwp_scale.shape != (T, q + 1):
        raise ValueError(f"shapes do not agree: a {tuple(a.shape)}, patterns "
                         f"{tuple(patterns.shape)}, pwp {tuple(pwp.shape)}, scale "
                         f"{tuple(pwp_scale.shape)}, w {tuple(w.shape)}")


def _launch(fn: str, a, patterns, pwp, pwp_scale, w, block_m, packed, *, group_t=None,
            active=None) -> tuple[torch.Tensor, torch.Tensor]:
    if a.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {a.device}")
    packed = pack_patterns(patterns) if packed is None else packed
    _check_cuda_operands(a, patterns, packed, pwp, pwp_scale, w, group_t)
    M, K = a.shape
    T, q, k = patterns.shape
    N = w.shape[-1]
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    nnz = torch.zeros((cdiv(M, block_m),), dtype=torch.int32, device=a.device)
    if M == 0 or N == 0:
        return out, nnz
    lib = _build.library()
    extra = () if group_t is None else (group_t,)
    if active is not None:
        extra = (active.data_ptr(), active.shape[-1])
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = getattr(lib, fn)(
            a.data_ptr(), packed.data_ptr(), pwp.data_ptr(), _PWP_DTYPES[pwp.dtype],
            pwp_scale.data_ptr(), w.data_ptr(), out.data_ptr(), nnz.data_ptr(),
            M, K, N, T, q, k, block_m, *extra, stream)
    _build.check(err, fn)
    return out, nnz


def phi_fused_cuda(a: torch.Tensor, patterns: torch.Tensor, pwp: torch.Tensor,
                   pwp_scale: torch.Tensor, w: torch.Tensor, *, block_m: int,
                   packed: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-pass Phi matmul.

    a (M, K) binary f32; patterns (T, q, k), K = T·k; pwp (T, q+1, N)
    f32/bf16/int8 with pwp[:, q] == 0; pwp_scale (T, q+1) f32; w (K, N) f32.
    Returns (out (M, N) f32, l2_nnz (ceil(M / block_m),) int32 — residual
    entries per block of ``block_m`` rows). CPU tensors run the plain
    version; CUDA tensors launch the kernel, counted in ``.launches``, which
    reads the bank as ``packed`` (:func:`pack_patterns` of ``patterns``;
    packed here when the caller has not).
    """
    if a.device.type == "cpu":
        return phi_fused_plain(a, patterns, pwp, pwp_scale, w, block_m=block_m)
    out = _launch("phi_fused_launch", a, patterns, pwp, pwp_scale, w, block_m, packed)
    phi_fused_cuda.launches += 1
    return out


phi_fused_cuda.launches = 0


def phi_fused_stream_cuda(a: torch.Tensor, patterns: torch.Tensor, pwp: torch.Tensor,
                          pwp_scale: torch.Tensor, w: torch.Tensor, *, block_m: int,
                          group_t: int = MAX_GROUP_T, packed: torch.Tensor | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """K-streaming single-pass Phi matmul: the contract of :func:`phi_fused_cuda`.

    ``group_t`` K-partitions per shared-memory stage (1..8; the last group
    may be shorter, so it need not divide T), copied one group ahead of the
    match. Takes any q < 65536 whose two stages fit
    (:func:`stream_smem_bytes`). CPU tensors run the plain version; CUDA
    tensors launch the kernel, counted in ``.launches``, or raise.
    """
    if a.device.type == "cpu":
        return phi_fused_plain(a, patterns, pwp, pwp_scale, w, block_m=block_m)
    out = _launch("phi_fused_stream_launch", a, patterns, pwp, pwp_scale, w, block_m, packed,
                  group_t=group_t)
    phi_fused_stream_cuda.launches += 1
    return out


phi_fused_stream_cuda.launches = 0


def phi_fused_prefetch_cuda(a: torch.Tensor, patterns: torch.Tensor, pwp: torch.Tensor,
                            pwp_scale: torch.Tensor, w: torch.Tensor, active: torch.Tensor, *,
                            block_m: int, packed: torch.Tensor | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """PWP-prefetching single-pass Phi matmul: the contract of
    :func:`phi_fused_cuda` plus ``active`` ((ceil(M / block_m), T, P) int32,
    :func:`stripe_active_sets`): each row is matched only against its
    stripe's P patterns, in that order, and a row whose best pattern is
    outside them goes whole to the exact L2 residual. ``l2_nnz`` counts that
    residual. The kernel takes P ≤ q, P ≤ 512, and ``block_m`` a multiple of
    32 unless one stripe holds every row. CPU tensors run
    :func:`phi_fused_prefetch_plain`; CUDA tensors launch the kernel, counted
    in ``.launches``, or raise.
    """
    if a.device.type == "cpu":
        return phi_fused_prefetch_plain(a, patterns, pwp, pwp_scale, w, active,
                                        block_m=block_m)
    M = a.shape[0]
    T, q, _ = patterns.shape
    P = active.shape[-1]
    if active.dtype != torch.int32 or active.device != a.device or not active.is_contiguous() \
            or active.shape != (cdiv(M, block_m), T, P):
        raise ValueError(f"active must be a contiguous ({cdiv(M, block_m)}, {T}, P) int32 "
                         f"tensor on {a.device}, got {tuple(active.shape)} {active.dtype}")
    if not 1 <= P <= min(q, MAX_Q):
        raise ValueError(f"phi_fused_prefetch: P={P} active patterns, the kernel takes "
                         f"1 <= P <= min(q, {MAX_Q})")
    if block_m % _BM and M > block_m:
        raise ValueError(f"phi_fused_prefetch: block_m={block_m} must be a multiple of {_BM} "
                         "(a tile of the kernel lies in one stripe)")
    out = _launch("phi_fused_prefetch_launch", a, patterns, pwp, pwp_scale, w, block_m, packed,
                  active=active)
    phi_fused_prefetch_cuda.launches += 1
    return out


phi_fused_prefetch_cuda.launches = 0
