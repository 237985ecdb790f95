"""Fused single-pass Phi matmul: the Hopper kernel and its plain version.

Port of ``repro/kernels/phi_fused.py::phi_fused_pallas``. Per row and per
K-partition: Hamming match against the bank (first-index argmin, strictly
better than the row's own popcount, else "no pattern"), the selected PWP row
times its scale into the L1 accumulator, the ±1 residual against the weight
rows into the L2 accumulator; ``out = acc1 + acc2`` once at the end, and the
residual entries counted per ``block_m`` rows. The CUDA kernel lives in
``csrc/phi_fused.cu``, whose note says how it is laid out on the card.

:func:`phi_fused_cuda` chooses by the device of its tensors: CPU tensors go
through :func:`phi_fused_plain`; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.utils import cdiv, pad_rows

# Shapes the CUDA kernel takes (csrc/phi_fused.cu): one 64-bit word per row
# partition, and a stage of 8 partitions' patterns in 48 KB of shared memory.
MAX_K = 64
MAX_Q = 512
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

    at (M, k) f32 binary, p (q, k) f32, pwp_t (q+1, N), scale_t (q+1,) f32,
    w_t (k, N). Returns the updated accumulators and the residual entries of
    each row. The one-hot products of the reference are row gathers here:
    they select the same values.
    """
    dot = at @ p.T                                         # (M, q)
    pop_a = at.sum(-1)
    ham = pop_a[:, None] + p.sum(-1)[None, :] - 2.0 * dot
    best = ham.argmin(-1)                                  # first index on ties
    use = ham.amin(-1) < pop_a                             # strict rule
    idx = torch.where(use, best, q)
    acc1 = acc1 + pwp_t[idx].to(torch.float32) * scale_t[idx][:, None]
    chosen = torch.where(use[:, None], p[best], 0.0)
    residual = at - chosen                                 # (M, k) in {−1, 0, +1}
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


def _check_cuda_operands(a, patterns, packed, pwp, pwp_scale, w) -> None:
    M, K = a.shape
    T, q, k = patterns.shape
    N = w.shape[-1]
    if k > MAX_K or q > MAX_Q:
        raise ValueError(f"phi_fused CUDA kernel takes k <= {MAX_K} and q <= {MAX_Q}; "
                         f"got k={k}, q={q}")
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
    if a.device.type != "cuda":
        raise ValueError(f"phi_fused: unsupported device {a.device}")
    packed = pack_patterns(patterns) if packed is None else packed
    _check_cuda_operands(a, patterns, packed, pwp, pwp_scale, w)
    M, K = a.shape
    T, q, k = patterns.shape
    N = w.shape[-1]
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    nnz = torch.zeros((cdiv(M, block_m),), dtype=torch.int32, device=a.device)
    if M == 0 or N == 0:
        return out, nnz
    lib = _build.library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.phi_fused_launch(
            a.data_ptr(), packed.data_ptr(), pwp.data_ptr(), _PWP_DTYPES[pwp.dtype],
            pwp_scale.data_ptr(), w.data_ptr(), out.data_ptr(), nnz.data_ptr(),
            M, K, N, T, q, k, block_m, stream)
    _build.check(err, "phi_fused_launch")
    phi_fused_cuda.launches += 1
    return out, nnz


phi_fused_cuda.launches = 0
