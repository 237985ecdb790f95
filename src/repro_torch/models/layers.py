"""Transformer building blocks: norms, RoPE, attention variants, MLPs.

Port of ``repro/models/layers.py``. Mixed-precision aware as there: norms
and softmax in float32, matmuls in ``cfg.compute_dtype``. Attention has the
three masking families of the assigned archs — full causal, sliding-window
(banded) and chunked-local — and a single-token decode path against a KV
cache (linear, or a ring for SWA and chunked-local).

Long prefill (S > 1024, full or chunked attention, and on the card the
sliding window too) goes through the execution policy to
``models.flash.flash_attention``, which launches the attention kernel's
dense instantiation on the card; the kernel walks only the kv-blocks the
masks leave open, O(S·W) under a window. The CPU keeps the reference's
banded plain path for a window past S = 8192. The policy's decision
carries the kernel's own legal (block_q, block_kv) for the shape
(``ops.autotune_attn_blocks``): the reference's 512 × 1024 tiles are TPU
tiles the kernel refuses at head dim 128, and the blocks only tile the same
online softmax. The kernel takes float32 q/k/v, so bf16 operands are widened
around it (the reference computes the scores in float32 too) and the
output is cast back.

On a mesh a rank holds a block of the batch rows and the heads. The
kernels (prefill attention, decode attention) sum each (row, head) alone,
so on the card a rank runs them on its own rows and heads; the library
contractions of the plain paths (the CPU, and materialised prefill at S ≤
1024 on the card) sum in an order that depends on their batch and head
counts, so a rank runs those inside one device's call shape (``block``,
:func:`one_device_call`) and gets one device's bits. Under autograd
(training, held to a tolerance) a rank runs its own rows and heads.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import ParamSpec, shard
from repro_torch.models.config import ModelConfig


# ------------------------------------------------------------------ norms ---
def rmsnorm(x: torch.Tensor, w: torch.Tensor | None, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    if w is not None:
        y = y * w.to(torch.float32)
    return y.to(x.dtype)


def nonparam_ln(x: torch.Tensor, _w=None, eps: float = 1e-5) -> torch.Tensor:
    """OLMo's non-parametric LayerNorm: standard LN without γ/β."""
    xf = x.to(torch.float32)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def norm_fn(cfg: ModelConfig):
    return nonparam_ln if cfg.norm == "nonparam_ln" else rmsnorm


def norm_spec(cfg: ModelConfig, layers: int | None = None) -> dict:
    if cfg.norm == "nonparam_ln":
        return {}
    shape = (cfg.d_model,) if layers is None else (layers, cfg.d_model)
    axes = ("embed",) if layers is None else ("layers", "embed")
    return {"w": ParamSpec(shape, axes, init="ones")}


def apply_norm(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    return norm_fn(cfg)(x, p.get("w"))


# ------------------------------------------------------------------- RoPE ---
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S) int."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs          # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# -------------------------------------------------------------- attention ---
def _repeat_kv(k: torch.Tensor, rep: int) -> torch.Tensor:
    if rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None].expand(b, s, h, rep, d).reshape(b, s, h * rep, d)


def one_device_call(fn, block: tuple | None, q: torch.Tensor, *kv: torch.Tensor,
                    rows_only: torch.Tensor | None = None, head_axis: int = 2) -> torch.Tensor:
    """``fn(q, *kv[, rows_only])`` for this rank's block of one device's call.

    ``block`` is (rows, row0, heads, head0): the global batch rows and Q
    heads, and the first of this rank's (None: the call is one device's).
    q and each of ``kv`` have their rows on axis 0 and their heads on
    ``head_axis`` (attention's (b, S, h, D)); they are written into zeros of
    the global shape (``kv``'s heads scaled by h / hq), ``rows_only`` (b, ...),
    which has no heads (attention's positions), into zeros of (rows, ...); the call is made and this
    rank's block of its output (rows and heads on the same axes) returned.
    Every output entry depends on its own row and head alone, so the zeros
    change no bit of the block; they cost the rest of one device's work.
    """
    args = [q, *kv] + ([] if rows_only is None else [rows_only])
    if block is None or (q.shape[0], q.shape[head_axis]) == (block[0], block[2]):
        return fn(*args)
    rows, row0, heads, head0 = block
    b, hq = q.shape[0], q.shape[head_axis]

    def place(x: torch.Tensor) -> torch.Tensor:
        h, h0 = x.shape[head_axis] * heads // hq, x.shape[head_axis] * head0 // hq
        shape = list(x.shape)
        shape[0], shape[head_axis] = rows, h
        full = x.new_zeros(shape)
        idx = [slice(None)] * x.dim()
        idx[0], idx[head_axis] = slice(row0, row0 + b), slice(h0, h0 + x.shape[head_axis])
        full[tuple(idx)] = x
        return full

    args = [place(x) for x in (q, *kv)]
    if rows_only is not None:
        full = rows_only.new_zeros((rows,) + rows_only.shape[1:])
        full[row0:row0 + b] = rows_only
        args.append(full)
    out = fn(*args)
    idx = [slice(None)] * out.dim()
    idx[0], idx[head_axis] = slice(row0, row0 + b), slice(head0, head0 + hq)
    return out[tuple(idx)]


def _softmax_rows(s: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis with fully masked rows giving zeros."""
    p = torch.softmax(s, dim=-1)
    return torch.where(torch.isnan(p), 0.0, p)


def attention_dense(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    window: int | None = None, kv_len: torch.Tensor | None = None):
    """Materialised-scores attention. q (B,Sq,H,D), k/v (B,Skv,H,D)."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), k.to(torch.float32)) * scale
    qpos = torch.arange(q.shape[1], device=q.device) + q_offset
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    s = torch.where(mask[None, None], s, -torch.inf)
    if kv_len is not None:
        s = torch.where((kpos < kv_len)[None, None, None, :], s, -torch.inf)
    p = _softmax_rows(s)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.to(torch.float32)).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True, block_q: int = 512,
                    block_kv: int = 1024, window: int | None = None):
    """Blockwise online-softmax attention in plain PyTorch (the reference's
    pure-jnp flash), for long prefill under ``attn_impl="naive"`` and long
    sliding-window prefill.

    O(S²) full-causal or O(S·W) sliding-window; scores never materialise
    beyond (B, H, bq, bkv). q, k, v: (B, S, H, D) with H already
    GQA-repeated; S a multiple of ``block_q`` (and of ``block_kv`` without a
    window), as in the reference.
    """
    B, S, H, D = q.shape
    scale = D ** -0.5
    nq = S // block_q
    dev = q.device
    outs = []
    if window is not None:
        # Banded: each q block attends one contiguous KV slice of width
        # window + block_q (clamped at 0) — O(S·W) compute.
        span = window + block_q
        for iq in range(nq):
            q0 = iq * block_q
            qi = q[:, q0:q0 + block_q]
            start = min(max(q0 + block_q - span, 0), S - span)
            kj, vj = k[:, start:start + span], v[:, start:start + span]
            s = torch.einsum("bqhd,bkhd->bhqk", qi.to(torch.float32),
                             kj.to(torch.float32)) * scale
            qpos = q0 + torch.arange(block_q, device=dev)
            kpos = start + torch.arange(span, device=dev)
            mask = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] > qpos[:, None] - window)
            p = _softmax_rows(torch.where(mask[None, None], s, -torch.inf))
            outs.append(torch.einsum("bhqk,bkhd->bqhd", p, vj.to(torch.float32)).to(q.dtype))
        return torch.cat(outs, dim=1)

    nkv = S // block_kv
    for iq in range(nq):
        q0 = iq * block_q
        qi = q[:, q0:q0 + block_q].to(torch.float32)
        qpos = q0 + torch.arange(block_q, device=dev)
        m = torch.full((B, H, block_q), -torch.inf, device=dev)
        den = torch.zeros((B, H, block_q), device=dev)
        acc = torch.zeros((B, H, block_q, D), device=dev)
        for ikv in range(nkv):
            k0 = ikv * block_kv
            kj = k[:, k0:k0 + block_kv].to(torch.float32)
            vj = v[:, k0:k0 + block_kv].to(torch.float32)
            s = torch.einsum("bqhd,bkhd->bhqk", qi, kj) * scale
            if causal:
                kpos = k0 + torch.arange(block_kv, device=dev)
                s = torch.where((kpos[None, :] <= qpos[:, None])[None, None], s, -torch.inf)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            den = den * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vj)
            m = m_new
        out = acc / torch.clamp(den, min=1e-30)[..., None]
        outs.append(out.movedim(1, 2).to(q.dtype))           # (B, bq, H, D)
    return torch.cat(outs, dim=1)


def chunked_local_attention(q, k, v, chunk: int):
    """llama4-style local attention: causal within fixed chunks."""
    B, S, H, D = q.shape
    if S <= chunk:
        return attention_dense(q, k, v, causal=True)
    if S % chunk:  # pad to a chunk multiple; causal masking hides the pad
        pad = chunk - S % chunk
        pz = [0, 0, 0, 0, 0, pad]
        out = chunked_local_attention(F.pad(q, pz), F.pad(k, pz), F.pad(v, pz), chunk)
        return out[:, :S]
    n = S // chunk
    qc, kc, vc = (x.reshape(B, n, chunk, H, D).transpose(0, 1) for x in (q, k, v))
    out = torch.stack([attention_dense(qc[i], kc[i], vc[i], causal=True) for i in range(n)])
    return out.transpose(0, 1).reshape(B, S, H, D)


def attention_prefill(cfg: ModelConfig, layer_idx, q, k, v, *, layer_global: bool,
                      block: tuple | None = None):
    """Dispatch by attention type and sequence length. q/k/v (B,S,H*,D);
    ``block``: this rank's block of one device's call (:func:`one_device_call`)."""
    from repro_torch.kernels import dispatch
    from repro_torch.models import flash as flash_mod

    k = _repeat_kv(k, q.shape[2] // k.shape[2])
    v = _repeat_kv(v, q.shape[2] // v.shape[2])
    S = q.shape[1]
    window = cfg.window if cfg.attn_type == "swa" else None
    chunk = (cfg.chunk if (cfg.attn_type == "chunked_interleaved" and not layer_global)
             else None)
    if S <= 1024:  # small sequences: materialised scores are cheapest
        run = (functools.partial(chunked_local_attention, chunk=chunk) if chunk is not None
               else functools.partial(attention_dense, causal=True, window=window))
    elif window is not None and S > 8192 and q.device.type != "cuda":
        # long SWA prefill (inference-only shapes): banded O(S·W) forward; on
        # the card the kernel below walks only the band's kv-blocks
        run = functools.partial(flash_attention, window=window, block_q=min(512, S),
                                block_kv=min(1024, S))
    elif cfg.attn_impl == "naive":
        run = (functools.partial(chunked_local_attention, chunk=chunk) if chunk is not None
               else functools.partial(flash_attention, causal=True, window=window,
                                      block_q=min(512, S), block_kv=min(1024, S)))
    else:
        # The flash branch goes through the execution policy: dense LM Q/K
        # are not spikes, so the site records ``dense_qk_keeps_flash``, or
        # ``autodiff_keeps_flash`` where a backward will run through q, k, v
        # (the reference's ``autodiff_region`` of its train step); the
        # decision carries the attention kernel's blocks for this shape.
        B, _, H, D = q.shape
        dec = dispatch.get_policy().resolve_attention(
            site="lm.attn_prefill", s=S, d=D, heads=H, batch=B,
            spike_qk=False, has_patterns=False, transform=flash_mod.under_autograd(q, k, v),
            device=q.device)
        bq, bkv = dec.blocks

        def run(*qkv):
            f32 = [x.to(torch.float32) for x in qkv]
            return flash_mod.flash_attention(*f32, True, window, chunk, bq, bkv).to(q.dtype)

        if q.device.type == "cuda":
            block = None      # the kernel sums each (row, head) alone; its plain version not
    if flash_mod.under_autograd(q, k, v):
        block = None          # training is held to a tolerance: the rank's rows and heads
    return one_device_call(run, block, q, k, v)


def attention_decode(q, k_cache, v_cache, pos, *, mode: str = "full",
                     block: tuple | None = None):
    """One-token decode. q (B,1,H,D); caches (B,Smax,Hkv,D); pos (B,) int.

    mode:
      "full"       — linear cache, slot == position: valid = kpos ≤ pos.
      "ring"       — SWA ring buffer of size Smax == window: every filled
                     slot is in-window by construction.
      "chunk_ring" — llama4 local-attention ring of size Smax == chunk:
                     slot s holds the latest position ≡ s (mod chunk); the
                     slots belonging to the current chunk are exactly
                     s ≤ pos mod chunk.

    On the card the decode kernel runs (``kernels.decode_attention``): its
    bits for a (row, head) do not depend on the batch or head count, so a
    rank runs its own rows and heads and ``block`` is not needed. Its plain
    version (CPU) makes this rank's block of one device's call
    (:func:`one_device_call`).
    """
    from repro_torch.kernels.decode_attention import decode_attention_cuda

    if q.device.type != "cuda" and block is not None:
        return one_device_call(functools.partial(decode_attention_cuda, mode=mode), block,
                               q, k_cache, v_cache, rows_only=pos)
    return decode_attention_cuda(q, k_cache, v_cache, pos, mode=mode)


# ------------------------------------------------------------- matmul fn ---
def default_mm(a: torch.Tensor, p: dict, name: str) -> torch.Tensor:
    """Default GEMM: matmul fns receive the layer param dict + weight name so
    alternative impls (Phi spiking mode) can find per-weight side state."""
    return a @ p[name].to(a.dtype)


# -------------------------------------------------------------------- MLP ---
def mlp_specs(cfg: ModelConfig, layers: int | None = None, d_ff: int | None = None) -> dict:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    L = () if layers is None else (layers,)
    A = () if layers is None else ("layers",)
    dt = cfg.param_dtype
    sp = {
        "w1": ParamSpec(L + (d, ff), A + ("fsdp", "mlp"), dt),
        "w2": ParamSpec(L + (ff, d), A + ("mlp", "fsdp"), dt),
    }
    if cfg.mlp_type == "swiglu":
        sp["w3"] = ParamSpec(L + (d, ff), A + ("fsdp", "mlp"), dt)
    return sp


def mlp_apply(cfg: ModelConfig, p: dict, x: torch.Tensor, matmul=None) -> torch.Tensor:
    mm = matmul or default_mm
    h = mm(x, p, "w1")
    h = shard(h, "batch", "seq", "act_mlp")
    if cfg.mlp_type == "swiglu":
        h = F.silu(h) * mm(x, p, "w3")
    else:
        h = F.gelu(h, approximate="tanh")       # jax.nn.gelu's default
    out = mm(h, p, "w2")
    return shard(out, "batch", "seq", "act_embed")
