"""Blockwise flash attention and its backward (port of ``repro/models/flash.py``).

forward : q-major online softmax over (block_q, block_kv) score blocks, with
          causal, sliding-window and chunked-local masks in one
          implementation; saves (q, k, v, out, lse).
backward: Δ = Σ(do·o);
          dq pass (q-major):  dqᵢ = Σⱼ [pᵢⱼ ∘ (doᵢvⱼᵀ − Δᵢ)] kⱼ · scale
          dkv pass (kv-major): dvⱼ = Σᵢ pᵢⱼᵀ doᵢ ;  dkⱼ = Σᵢ dsᵢⱼᵀ qᵢ · scale
          with pᵢⱼ = exp(qᵢkⱼᵀ·scale − lseᵢ) recomputed per block pair.

Every internal sum is float32; outputs and gradients take the caller's dtype.

:func:`_flash_fwd_impl` is the plain PyTorch forward and keeps the
reference's ``score_fn`` hook: ``kernels/phi_attention.py`` passes the Phi
L1+L2 score decomposition through it and so shares this accumulator code.
:func:`flash_attention` runs it for CPU tensors; CUDA tensors go to the
dense instantiation of the hand-written kernel in
``kernels/csrc/phi_attention.cu``, the same kernel body the Phi path
launches, which also writes lse where autograd needs a backward.
:func:`_flash_bwd` is the backward, as the reference's is plain JAX: batched
PyTorch products over block pairs, on either device.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

ScoreFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def under_autograd(*tensors: torch.Tensor) -> bool:
    """True when a backward pass would run through these operands."""
    return torch.is_grad_enabled() and any(x.requires_grad for x in tensors)


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


def _flash_bwd(causal: bool, window: int | None, chunk: int | None, block_q: int,
               block_kv: int, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash backward: (dq, dk, dv), each (B, S, H, D) in q's dtype.

    Same pad-and-mask contract as the forward: padded key columns and
    padded query rows are zeroed out of every recomputed p block. Padded
    rows carry a garbage lse, and fully masked rows an lse of -inf, so
    masking p by ``valid`` (not s) is what keeps the inf/NaN they would give
    out of the gradients.
    """
    B, S, H, D = q.shape
    scale = D ** -0.5
    bq, bkv = min(block_q, S), min(block_kv, S)
    sq, skv = S + (-S) % bq, S + (-S) % bkv
    nq, nkv = sq // bq, skv // bkv
    dev = q.device

    def heads(x, to):                                              # (B, H, to, D) f32
        return _pad_seq(x.movedim(2, 1).to(torch.float32), to)

    qt, kt, vt = heads(q, sq), heads(k, skv), heads(v, skv)
    dot_, ot = heads(dout, sq), heads(out, sq)
    lse = F.pad(lse.to(torch.float32), [0, sq - S])
    delta = (dot_ * ot).sum(-1)                                    # (B, H, sq)
    qpos_all = torch.arange(sq, device=dev)
    kpos_all = torch.arange(skv, device=dev)

    def p_block(iq, jk):
        qpos = qpos_all[iq * bq:(iq + 1) * bq]
        kpos = kpos_all[jk * bkv:(jk + 1) * bkv]
        qi = qt[:, :, iq * bq:(iq + 1) * bq]
        kj = kt[:, :, jk * bkv:(jk + 1) * bkv]
        s = (qi @ kj.transpose(-1, -2)) * scale
        p = torch.exp(s - lse[:, :, iq * bq:(iq + 1) * bq, None])
        valid = (_mask(qpos, kpos, causal=causal, window=window, chunk=chunk)
                 & (qpos < S)[:, None] & (kpos < S)[None, :])
        return torch.where(valid, p, 0.0)

    def ds_block(p, iq, jk):
        do_i = dot_[:, :, iq * bq:(iq + 1) * bq]
        vj = vt[:, :, jk * bkv:(jk + 1) * bkv]
        return p * (do_i @ vj.transpose(-1, -2) - delta[:, :, iq * bq:(iq + 1) * bq, None])

    # ---- dq pass: q-major, block-local accumulator
    dq = []
    for iq in range(nq):
        dq_i = torch.zeros((B, H, bq, D), device=dev)
        for jk in range(nkv):
            ds = ds_block(p_block(iq, jk), iq, jk)
            dq_i = dq_i + (ds @ kt[:, :, jk * bkv:(jk + 1) * bkv]) * scale
        dq.append(dq_i)
    # ---- dk/dv pass: kv-major, block-local accumulators
    dk, dv = [], []
    for jk in range(nkv):
        dk_j = torch.zeros((B, H, bkv, D), device=dev)
        dv_j = torch.zeros((B, H, bkv, D), device=dev)
        for iq in range(nq):
            p = p_block(iq, jk)
            dv_j = dv_j + p.transpose(-1, -2) @ dot_[:, :, iq * bq:(iq + 1) * bq]
            ds = ds_block(p, iq, jk)
            dk_j = dk_j + (ds.transpose(-1, -2) @ qt[:, :, iq * bq:(iq + 1) * bq]) * scale
        dk.append(dk_j)
        dv.append(dv_j)

    def back(parts):
        return torch.cat(parts, dim=2)[:, :, :S].movedim(1, 2).to(q.dtype)

    return back(dq), back(dk), back(dv)


class _FlashAttention(torch.autograd.Function):
    """Flash attention with the flash backward: the forward keeps
    (q, k, v, out, lse), the backward is :func:`_flash_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk, block_q, block_kv):
        # Imported here: kernels.phi_attention imports this module.
        from repro_torch.kernels.phi_attention import flash_attention_cuda

        out, lse = flash_attention_cuda(q, k, v, causal=causal, window=window, chunk=chunk,
                                        block_q=block_q, block_kv=block_kv, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.blocks = (causal, window, chunk, block_q, block_kv)
        return out

    @staticmethod
    def backward(ctx, dout):
        dq, dk, dv = _flash_bwd(*ctx.blocks, *ctx.saved_tensors, dout)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                    window: int | None = None, chunk: int | None = None,
                    block_q: int = 512, block_kv: int = 1024) -> torch.Tensor:
    """q, k, v: (B, S, H, D) with H already GQA-repeated. Returns (B, S, H, D).

    CPU tensors run :func:`_flash_fwd_impl`; CUDA tensors launch the dense
    instantiation of the attention kernel
    (``kernels.phi_attention.flash_attention_cuda``). Where autograd needs a
    backward, the forward also keeps lse (the kernel writes it on the card)
    and the backward is :func:`_flash_bwd`; elsewhere no lse is written.
    """
    from repro_torch.kernels.phi_attention import flash_attention_cuda

    if under_autograd(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, window, chunk, block_q, block_kv)
    with torch.no_grad():
        return flash_attention_cuda(q, k, v, causal=causal, window=window, chunk=chunk,
                                    block_q=block_q, block_kv=block_kv)
