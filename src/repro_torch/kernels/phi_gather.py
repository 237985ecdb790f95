"""Level-1 PWP gather and K-tile reduction: the Hopper kernel and its plain version.

Port of ``repro/kernels/phi_gather.py::l1_gather_pallas``, the second stage
of the ``pallas`` lowering: ``out[m] = Σ_t pwp[t, idx[m, t], :]`` with the
sum taken in ascending t from zero, as the reference kernel's output tile
accumulates (zeroed at t = 0, ``+=`` per partition). In that order kernel,
plain version and reference agree bitwise for any f32 or bf16 bank. Every
index must lie in [0, q]; both versions refuse one outside it. The
reference's two modes (``"mxu"``, a one-hot matmul, and ``"take"``, a
vector gather) select the same values; one-hot products are a TPU idiom, so
this single row gather serves both (``ops.l1_gather`` takes ``mode``). The
CUDA source is ``csrc/phi_gather.cu``.

:func:`l1_gather_cuda` chooses by the device of its tensors: CPU tensors run
:func:`l1_gather_plain`; CUDA tensors launch the kernel, counted in
``.launches``, or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_PWP_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_range(idx: torch.Tensor, q1: int) -> None:
    """Refuse an index outside the bank's q+1 rows (one read of its extremes)."""
    if idx.numel() == 0:
        return
    lo, hi = torch.stack(torch.aminmax(idx)).tolist()
    if lo < 0 or hi >= q1:
        raise ValueError(f"l1_gather: idx spans [{lo}, {hi}], outside the bank's rows "
                         f"[0, {q1 - 1}]")


def make_range_flag(device: torch.device) -> torch.Tensor:
    """A zeroed device flag for :func:`l1_gather_cuda`'s ``range_flag``."""
    return torch.zeros(1, dtype=torch.int32, device=device)


def range_flag_to_host(flag: torch.Tensor) -> torch.Tensor:
    """Enqueue the flag's copy into pinned host memory on the current stream:
    no wait here; the copy holds the flag once the stream has been waited for."""
    host = torch.empty(1, dtype=torch.int32, pin_memory=True)
    return host.copy_(flag, non_blocking=True)


def check_range_flag(flag_host: torch.Tensor, idx: torch.Tensor, q1: int) -> None:
    """Refuse, as the direct call does, a gather whose kernel set its range
    flag. ``flag_host`` is the flag's copy on the host, read only once the
    stream has passed the gather; ``idx`` is what the gather was given."""
    if int(flag_host[0]):
        _check_range(idx, q1)
        raise ValueError(f"l1_gather: an index lies outside the bank's rows [0, {q1 - 1}]")


def l1_gather_plain(idx: torch.Tensor, pwp: torch.Tensor) -> torch.Tensor:
    """Plain version of the gather kernel: a loop over t from a zero output,
    adding each partition's gathered rows (widened to f32) in turn."""
    _check_range(idx, pwp.shape[1])
    M, T = idx.shape
    out = torch.zeros((M, pwp.shape[-1]), dtype=torch.float32, device=idx.device)
    for t in range(T):
        out += pwp[t][idx[:, t].long()].to(torch.float32)
    return out


def l1_gather_cuda(idx: torch.Tensor, pwp: torch.Tensor, *,
                   range_flag: torch.Tensor | None = None) -> torch.Tensor:
    """idx (M, T) int32 in [0, q]; pwp (T, q+1, N) f32 or bf16 with
    pwp[:, q] == 0 -> (M, N) f32. An int8 bank is refused: it needs the
    per-row scales, which this lowering does not take.

    Without ``range_flag`` the indices' range is checked before the launch
    (one read to the host). With one (an int32 device tensor from
    :func:`make_range_flag`), the kernel sets it for an index outside [0, q] and
    reads no bank row for it; the caller reads the flag once the stream has
    passed the gather and refuses the result (:func:`check_range_flag`).
    """
    if idx.device.type == "cpu":
        return l1_gather_plain(idx, pwp)
    M, T = idx.shape
    Tp, q1, N = pwp.shape
    if idx.device.type != "cuda" or pwp.device != idx.device:
        raise ValueError(f"l1_gather: idx on {idx.device}, pwp on {pwp.device}; both must "
                         "be on one CUDA device")
    if pwp.dtype not in _PWP_DTYPES:
        raise TypeError(f"l1_gather kernel takes an f32 or bf16 bank, got {pwp.dtype} (an "
                        "int8 bank needs its per-row scales: use a fused lowering)")
    if idx.dtype != torch.int32 or Tp != T:
        raise ValueError(f"idx must be (M, T={Tp}) int32, got {tuple(idx.shape)} {idx.dtype}")
    if not (idx.is_contiguous() and pwp.is_contiguous()):
        raise ValueError("idx and pwp must be contiguous")
    if range_flag is not None and (range_flag.device != idx.device
                                   or range_flag.dtype != torch.int32):
        raise ValueError("range_flag must be an int32 tensor on idx's device")
    if range_flag is None:
        _check_range(idx, q1)
    if M == 0 or N == 0 or T == 0:              # nothing to gather: every sum is zero
        return torch.zeros((M, N), dtype=torch.float32, device=idx.device)
    out = torch.empty((M, N), dtype=torch.float32, device=idx.device)
    vec = int(N % 4 == 0 and pwp.data_ptr() % 16 == 0)   # 4 columns a lane, one vector
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream(idx.device).cuda_stream
        err = _build.library().l1_gather_launch(
            idx.data_ptr(), pwp.data_ptr(), _PWP_DTYPES[pwp.dtype], out.data_ptr(),
            None if range_flag is None else range_flag.data_ptr(), M, N, T, q1, vec, stream)
    _build.check(err, "l1_gather_launch")
    l1_gather_cuda.launches += 1
    return out


l1_gather_cuda.launches = 0
