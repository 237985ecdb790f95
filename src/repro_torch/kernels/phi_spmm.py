"""Level-2 bucketed COO ±1 spmm: the Hopper kernel and its plain version.

Port of ``repro/kernels/phi_spmm.py::l2_spmm_pallas``, the third stage of
the ``pallas`` lowering: ``out[g·bm + r] += sign · w[c]`` over each M-block's
entries as ``ops.bucket_coo`` lays them out ((G, C) local rows, columns and
signs; the sentinel local row ``bm`` vanishes). Rows without entries come
out zero. The reference's ``"take"`` and ``"mxu"`` modes select the same
values; this single gather serves both (``ops.l2_spmm`` takes ``mode``).
The CUDA source is ``csrc/phi_spmm.cu``: a warp per few rows and 128
columns (:func:`spmm_rows_per_warp`), no floating-point atomics, each output
summed from zero in entry order.

:func:`l2_spmm_cuda` chooses by the device of its tensors: CPU tensors run
:func:`l2_spmm_plain`; CUDA tensors launch the kernel, counted in
``.launches``, or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.utils import cdiv

# Columns a warp owns (4 a lane), and the warps the grid should hold: 32 an SM
# of the H100's 132, half of what an SM keeps resident.
SPMM_SLICE = 128
SPMM_TARGET_WARPS = 132 * 32


def spmm_rows_per_warp(G: int, bm: int, N: int) -> int:
    """Rows a warp of the kernel owns: the most (16, 8, 4, 2) that still give
    the grid :data:`SPMM_TARGET_WARPS` warps, else 1. Fewer rows a warp mean
    more warps and more entry-range searches."""
    slices = cdiv(N, SPMM_SLICE)
    return next((rpw for rpw in (16, 8, 4, 2)
                 if G * cdiv(bm, rpw) * slices >= SPMM_TARGET_WARPS), 1)


def l2_spmm_plain(rows: torch.Tensor, cols: torch.Tensor, signs: torch.Tensor,
                  w: torch.Tensor, *, block_m: int) -> torch.Tensor:
    """Plain version of the spmm kernel: the real entries (local row below
    ``block_m``) of every block, in order, ``index_add_``-ed as
    ``w[col] · sign`` into a zero (G·block_m, N) output."""
    G, C = rows.shape
    valid = (rows >= 0) & (rows < block_m)
    base = torch.arange(G, device=rows.device)[:, None] * block_m
    out_rows = (base + rows)[valid]
    vals = w[cols[valid].long()].to(torch.float32) * signs[valid].to(torch.float32)[:, None]
    out = torch.zeros((G * block_m, w.shape[-1]), dtype=torch.float32, device=w.device)
    return out.index_add_(0, out_rows, vals)


def l2_spmm_cuda(rows: torch.Tensor, cols: torch.Tensor, signs: torch.Tensor,
                 w: torch.Tensor, *, block_m: int) -> torch.Tensor:
    """rows/cols (G, C) int32 (local rows, sentinel ``block_m``), signs
    (G, C) ±1/0 of any dtype, w (K, N) f32 -> (G·block_m, N) f32.

    The kernel takes each block's real entries in ascending local row, its
    sentinels last, which is how ``ops.bucket_coo`` emits them.
    """
    if rows.device.type == "cpu":
        return l2_spmm_plain(rows, cols, signs, w, block_m=block_m)
    G, C = rows.shape
    K, N = w.shape
    for name, x in (("rows", rows), ("cols", cols), ("signs", signs), ("w", w)):
        if x.device != rows.device or x.device.type != "cuda":
            raise ValueError(f"l2_spmm: {name} on {x.device}; all on one CUDA device")
    if rows.dtype != torch.int32 or cols.dtype != torch.int32 or cols.shape != rows.shape \
            or signs.shape != rows.shape:
        raise ValueError(f"rows and cols must be (G, C) int32 and signs (G, C); got rows "
                         f"{tuple(rows.shape)} {rows.dtype}, cols {tuple(cols.shape)} "
                         f"{cols.dtype}, signs {tuple(signs.shape)}")
    if w.dtype != torch.float32:
        raise TypeError(f"w must be float32, got {w.dtype}")
    signs = signs.to(torch.int8).contiguous()          # ±1 and 0 are exact in int8
    rows, cols, w = rows.contiguous(), cols.contiguous(), w.contiguous()
    if G == 0 or N == 0 or C == 0:                      # no entries: every row is zero
        return torch.zeros((G * block_m, N), dtype=torch.float32, device=w.device)
    out = torch.empty((G * block_m, N), dtype=torch.float32, device=w.device)
    vec = int(N % 4 == 0 and w.data_ptr() % 16 == 0)    # 16-byte column loads
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = _build.library().l2_spmm_launch(rows.data_ptr(), cols.data_ptr(),
                                              signs.data_ptr(), w.data_ptr(), out.data_ptr(),
                                              G, C, block_m, N,
                                              spmm_rows_per_warp(G, block_m, N), vec, stream)
    _build.check(err, "l2_spmm_launch")
    l2_spmm_cuda.launches += 1
    return out


l2_spmm_cuda.launches = 0
