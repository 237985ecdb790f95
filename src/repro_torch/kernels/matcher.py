"""Standalone Phi pattern matcher: the Hopper kernel and its plain version.

Port of ``repro/kernels/matcher.py::matcher_pallas``, the first stage of the
per-unit ``pallas`` lowering (matcher → L1 gather → L2 spmm): per row and
K-partition, the first pattern of least Hamming distance, used only when
strictly better than the row's own popcount; returns the pattern index
((M, T) int32, ``q`` = none) and the ±1 residual ((M, K) int8). The CUDA
source is ``csrc/matcher.cu``; it reads the bank bit-packed, as the fused
kernels do (``phi_fused.pack_patterns``).

:func:`matcher_cuda` chooses by the device of its tensors: CPU tensors run
:func:`matcher_plain`; CUDA tensors launch the kernel, counted in
``.launches``, or raise.
"""
from __future__ import annotations

import torch

from repro_torch.core.assign import assign_patterns
from repro_torch.kernels import _build
from repro_torch.kernels.phi_fused import MAX_K, pack_patterns


def matcher_plain(a: torch.Tensor, patterns: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the matcher kernel: ``assign_patterns``, the
    function ``ref.matcher_ref`` computes (Hamming as a matmul, first-index
    argmin, strict rule)."""
    return assign_patterns(a, patterns)


def matcher_cuda(a: torch.Tensor, patterns: torch.Tensor, *,
                 packed: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Pattern match: a (M, K) binary f32, patterns (T, q, k) with K = T·k,
    k ≤ 64 -> (idx (M, T) int32 in [0, q], residual (M, K) int8).

    ``packed`` is the bank as the kernel reads it (``pack_patterns``; packed
    here when the caller has not). Ragged M is masked in the kernel.
    """
    if a.device.type == "cpu":
        return matcher_plain(a, patterns)
    M, K = a.shape
    T, q, k = patterns.shape
    if a.device.type != "cuda":
        raise ValueError(f"matcher: unsupported device {a.device}")
    if k > MAX_K or q < 1 or K != T * k:
        raise ValueError(f"matcher CUDA kernel takes k <= {MAX_K}, q >= 1 and K = T·k; got "
                         f"a {tuple(a.shape)}, patterns {tuple(patterns.shape)}")
    packed = pack_patterns(patterns) if packed is None else packed
    if a.dtype != torch.float32 or not a.is_contiguous():
        raise TypeError(f"a must be contiguous float32, got {a.dtype}")
    if packed.dtype != torch.int64 or packed.shape != (T, q) or packed.device != a.device \
            or not packed.is_contiguous():
        raise ValueError(f"packed must be a contiguous (T, q) = ({T}, {q}) int64 tensor on "
                         f"{a.device}, got {tuple(packed.shape)} {packed.dtype}")
    idx = torch.empty((M, T), dtype=torch.int32, device=a.device)
    residual = torch.empty((M, K), dtype=torch.int8, device=a.device)
    if M == 0:
        return idx, residual
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _build.library().matcher_launch(a.data_ptr(), packed.data_ptr(), idx.data_ptr(),
                                              residual.data_ptr(), M, K, T, q, k, stream)
    _build.check(err, "matcher_launch")
    matcher_cuda.launches += 1
    return idx, residual


matcher_cuda.launches = 0
