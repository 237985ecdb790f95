"""Blockwise flash attention, forward only (port of ``repro/models/flash.py``).

q-major online softmax over (block_q, block_kv) score blocks, with causal,
sliding-window and chunked-local masks in one implementation. Every internal
sum is float32; the output takes the caller's dtype.

:func:`_flash_fwd_impl` is the plain PyTorch version and keeps the
reference's ``score_fn`` hook: ``kernels/phi_attention.py`` passes the Phi
L1+L2 score decomposition through it and so shares this accumulator code.
:func:`flash_attention` runs it for CPU tensors; CUDA tensors go to the
dense instantiation of the hand-written kernel in
``kernels/csrc/phi_attention.cu``, the same kernel body the Phi path
launches. The backward pass (``_flash_bwd`` in the reference) is not ported
yet; it becomes an ``autograd.Function`` with the training slice. Until then
:func:`flash_attention` raises where autograd would need it, rather than
return an output cut off from q, k and v.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

ScoreFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def under_autograd(*tensors: torch.Tensor) -> bool:
    """True when a backward pass would run through these operands."""
    return torch.is_grad_enabled() and any(x.requires_grad for x in tensors)


def refuse_autograd(what: str, *tensors: torch.Tensor) -> None:
    """Raise when autograd would need a backward of ``what``: the attention
    lowerings are forward only, and an output without a graph would leave
    every gradient upstream silently missing."""
    if under_autograd(*tensors):
        raise NotImplementedError(
            f"{what} is forward only (the backward, the reference's _flash_bwd, is not "
            "ported yet: ROADMAP queue 1 item 9); call it under torch.no_grad() or with "
            "operands that do not require grad")


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, *, causal: bool, window: int | None,
          chunk: int | None) -> torch.Tensor:
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool, device=qpos.device)
    if causal:
        m &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        m &= kpos[None, :] > qpos[:, None] - window
    if chunk is not None:
        m &= (kpos[None, :] // chunk) == (qpos[:, None] // chunk)
    return m


def _pad_seq(x: torch.Tensor, to: int) -> torch.Tensor:
    """Zero-pad the sequence axis (dim 2 of a (B, H, S, ...) tensor) to ``to``."""
    pad = to - x.shape[2]
    if pad == 0:
        return x
    return F.pad(x, [0, 0] * (x.ndim - 3) + [0, pad])


def _dense_scores(qi: torch.Tensor, kj: torch.Tensor) -> torch.Tensor:
    return qi @ kj.transpose(-1, -2)


def _flash_fwd_impl(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                    window: int | None, chunk: int | None, block_q: int, block_kv: int,
                    score_fn: ScoreFn | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward online softmax; returns (out (B, S, H, D), lse (B, H, S)).

    ``score_fn(qi, kj) -> (B, H, bq, bkv)`` is the score-block hook (default:
    the dense product). Scores are scaled *after* the contraction, so binary
    Q/K give integer-exact score blocks under any contraction order, which
    is what makes the Phi path bitwise equal to the dense one. S need not
    divide the blocks: both sequence axes are padded to whole blocks, padded
    keys are masked out of every score block and padded query rows are
    sliced off.
    """
    B, S, H, D = q.shape
    scale = D ** -0.5
    bq, bkv = min(block_q, S), min(block_kv, S)
    sq, skv = S + (-S) % bq, S + (-S) % bkv
    nq, nkv = sq // bq, skv // bkv
    dev = q.device
    qt = _pad_seq(q.movedim(2, 1).to(torch.float32), sq)          # (B, H, sq, D)
    kt = _pad_seq(k.movedim(2, 1).to(torch.float32), skv)
    vt = _pad_seq(v.movedim(2, 1).to(torch.float32), skv)
    scores = score_fn or _dense_scores
    outs, lses = [], []
    for iq in range(nq):
        qi = qt[:, :, iq * bq:(iq + 1) * bq]
        qpos = iq * bq + torch.arange(bq, device=dev)
        m = torch.full((B, H, bq), -torch.inf, device=dev)
        den = torch.zeros((B, H, bq), device=dev)
        acc = torch.zeros((B, H, bq, D), device=dev)
        for jk in range(nkv):
            kj = kt[:, :, jk * bkv:(jk + 1) * bkv]
            vj = vt[:, :, jk * bkv:(jk + 1) * bkv]
            s = scores(qi, kj) * scale
            kpos = jk * bkv + torch.arange(bkv, device=dev)
            valid = _mask(qpos, kpos, causal=causal, window=window, chunk=chunk) \
                & (kpos < S)[None, :]
            s = torch.where(valid, s, -torch.inf)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            p = torch.where(torch.isnan(p), 0.0, p)                # fully-masked rows
            corr = torch.exp(m - m_new)
            corr = torch.where(torch.isnan(corr), 0.0, corr)
            den = den * corr + p.sum(-1)
            acc = acc * corr[..., None] + p @ vj
            m = m_new
        outs.append(acc / torch.clamp(den, min=1e-30)[..., None])
        lses.append(m + torch.log(torch.clamp(den, min=1e-30)))
    o = torch.cat(outs, dim=2)[:, :, :S]
    lse = torch.cat(lses, dim=2)[:, :, :S]
    return o.movedim(1, 2).to(q.dtype), lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                    window: int | None = None, chunk: int | None = None,
                    block_q: int = 512, block_kv: int = 1024) -> torch.Tensor:
    """q, k, v: (B, S, H, D) with H already GQA-repeated. Returns (B, S, H, D).

    Forward only: raises where autograd would need a backward. CPU tensors
    run :func:`_flash_fwd_impl`; CUDA tensors launch the dense instantiation
    of the attention kernel (``kernels.phi_attention.flash_attention_cuda``).
    """
    # Imported here: kernels.phi_attention imports this module.
    from repro_torch.kernels.phi_attention import flash_attention_cuda

    refuse_autograd("flash_attention", q, k, v)
    with torch.no_grad():
        return flash_attention_cuda(q, k, v, causal=causal, window=window, chunk=chunk,
                                    block_q=block_q, block_kv=block_kv)
