"""Public wrappers around the Phi kernels (port of ``repro/kernels/ops.py``, main-path slice).

Responsibilities:
  * shape handling: flatten leading axes, pick the ``l2_nnz`` block, default
    the PWP dequant scales;
  * the composite ``phi_matmul`` for the ported lowerings ``ref``, ``coo``
    and ``fused``;
  * ``lif_step`` on tensors of any shape.

The kernel wrappers choose by the device of their tensors: CPU tensors run
the plain PyTorch versions, CUDA tensors the Hopper kernels (or an error).
"""
from __future__ import annotations

import os

import torch

from repro_torch.core.assign import assign_patterns, pack_l2_coo_jit
from repro_torch.kernels import IMPLS, ref
from repro_torch.kernels.lif import lif_step_cuda
from repro_torch.kernels.phi_fused import phi_fused_cuda
from repro_torch.utils import cdiv

# Rows per l2_nnz audit block when the caller names none (the reference
# kernel's default block_m). The CUDA kernel's own tiles are fixed in
# csrc/phi_fused.cu and do not depend on it.
FUSED_BLOCK_M = 256

# Lowerings of the reference that the port has not reached yet, with the
# ROADMAP item that carries each.
_NOT_PORTED = {
    "fused_stream": "ROADMAP queue 2 item 3 (phi_fused_stream_pallas)",
    "fused_prefetch": "ROADMAP queue 2 item 4 (phi_fused_prefetch_pallas)",
    "pallas": "ROADMAP queue 2 items 5-7 (matcher, l1_gather, l2_spmm)",
}


def effective_block_m(M: int, block_m: int) -> int:
    """Block-m actually used for an M-row problem: requested size clamped to
    the next power of two ≥ M."""
    return min(block_m, max(8, 1 << (M - 1).bit_length()))


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
    (default :data:`FUSED_BLOCK_M`). Exact for any L2 budget: nothing is
    dropped. pwp may be f32/bf16 (pwp_scale None) or int8 with per-row
    scales from ``quantize_pwp``. ``packed`` is the bank as the CUDA kernel
    reads it (``pack_patterns``), made once by the caller.
    """
    lead = a.shape[:-1]
    K = a.shape[-1]
    T, q, k = patterns.shape
    N = w.shape[-1]
    a2 = a.reshape(-1, K)
    bm, pwp_scale = _fused_prologue(a2, pwp, pwp_scale, T, q, block_m or FUSED_BLOCK_M)
    # Binary activations and bf16 weights are exact in float32 (the
    # reference kernel widens both the same way); no copy when already f32.
    out, nnz = phi_fused_cuda(a2.to(torch.float32).contiguous(), patterns, pwp, pwp_scale,
                              w.to(torch.float32).contiguous(), block_m=bm, packed=packed)
    return out.reshape(*lead, N), nnz


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
               *, impl: str = "fused", nnz_budget: float = 0.08,
               block_m: int | None = None, gather_dtype: torch.dtype | None = None,
               pwp_scale: torch.Tensor | None = None,
               packed: torch.Tensor | None = None) -> torch.Tensor:
    """Full Phi sparse matmul: a (..., K) binary × w (K, N) -> (..., N) f32.

    impl:
      "fused" — the single-pass Hopper kernel (plain version on the CPU);
      "coo"   — the row-chunked gather/scatter lowering in plain PyTorch;
      "ref"   — the dense L2 oracle.
    The reference's other lowerings raise ``NotImplementedError`` until
    ported. ``nnz_budget`` (the static L2 capacity as a fraction of the
    chunk's rows × K) applies to "coo" only; ``packed`` (the bank from
    ``pack_patterns``) to "fused" only.
    """
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS}")
    if impl in _NOT_PORTED:
        raise NotImplementedError(f"impl {impl!r} is not ported yet: {_NOT_PORTED[impl]}")
    lead = a.shape[:-1]
    K = a.shape[-1]
    N = w.shape[-1]
    a2 = a.reshape(-1, K)
    if impl == "ref":
        out = ref.phi_matmul_ref(a2, w, patterns, pwp)
    elif impl == "fused":
        out, _ = phi_fused(a2, patterns, pwp, w, pwp_scale=pwp_scale, block_m=block_m,
                           packed=packed)
    else:
        out = _phi_matmul_coo_chunked(a2, w, patterns, pwp, nnz_budget,
                                      gather_dtype=gather_dtype, pwp_scale=pwp_scale)
    return out.reshape(*lead, N)
