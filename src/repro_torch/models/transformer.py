"""Decoder stack of the attention families (port of ``repro/models/transformer.py``).

Parameters keep the reference's layout: each position ``p{i}`` of a layer
group holds its weights stacked over the groups on a leading axis, so a
reference params tree carries across leaf by leaf (``interop``). Where the
reference scans over that axis, the port loops over it, slicing each
layer's views; ``_maybe_remat`` has nothing to do in inference and is not
ported. Heterogeneous interleavings (chunked-local/global attention) loop
over groups whose size is the LCM of the interleave periods, as there.

GQA under TP with awkward head counts keeps the reference's exact math:
padded Q heads are zero-masked before the out-projection, and logical KV
heads are repeated up to the padded head count.

The MoE, Mamba-2 and hybrid families are specs only here: their forward
raises ``NotImplementedError`` (``ROADMAP.md`` queue 1) and never runs
another layer in their place.
"""
from __future__ import annotations

import math

import torch

from repro_torch.distributed.sharding import ParamSpec, shard
from repro_torch.models import layers as ll
from repro_torch.models.config import ModelConfig


def _not_ported(cfg: ModelConfig, what: str):
    return NotImplementedError(
        f"{cfg.name}: {what} is not ported yet (ROADMAP.md queue 1: MoE, Mamba-2 and the "
        "hybrid stack come in a later slice)")


def _check_family(cfg: ModelConfig) -> None:
    """Refuse the layers the port does not run yet."""
    if cfg.family in ("ssm", "hybrid"):
        raise _not_ported(cfg, f"the {cfg.family} decoder stack")
    if cfg.n_experts:
        raise _not_ported(cfg, "the MoE feed-forward")


# ------------------------------------------------------------------ specs ---
def group_size(cfg: ModelConfig) -> int:
    if cfg.family == "hybrid":
        return max(cfg.hybrid_attn_every, 1)
    g = 1
    if cfg.n_experts and cfg.moe_interleave > 1:
        g = math.lcm(g, cfg.moe_interleave)
    if cfg.attn_type == "chunked_interleaved":
        g = math.lcm(g, cfg.global_every)
    return g


def _kv_replicated(cfg: ModelConfig) -> bool:
    return cfg.n_kv_heads < cfg.tp


def _attn_specs(cfg: ModelConfig, n: int) -> dict:
    """Attention specs; kv weights logical (replicated) when n_kv < tp."""
    d, hd = cfg.d_model, cfg.hd
    hq = cfg.q_heads_padded
    hkv = cfg.n_kv_heads if _kv_replicated(cfg) else cfg.kv_heads_padded
    kv_ax = None if _kv_replicated(cfg) else "kv_heads"
    dt = cfg.param_dtype
    L, A = ((n,), ("layers",)) if n else ((), ())
    sp = {
        "wq": ParamSpec(L + (d, hq * hd), A + ("fsdp", "heads"), dt),
        "wk": ParamSpec(L + (d, hkv * hd), A + ("fsdp", kv_ax), dt),
        "wv": ParamSpec(L + (d, hkv * hd), A + ("fsdp", kv_ax), dt),
        "wo": ParamSpec(L + (hq * hd, d), A + ("heads", "fsdp"), dt),
    }
    if cfg.qkv_bias:
        sp["bq"] = ParamSpec(L + (hq * hd,), A + ("heads",), dt, init="zeros")
        sp["bk"] = ParamSpec(L + (hkv * hd,), A + (kv_ax,), dt, init="zeros")
        sp["bv"] = ParamSpec(L + (hkv * hd,), A + (kv_ax,), dt, init="zeros")
    return sp


def _moe_specs(cfg: ModelConfig, layers: int | None = None) -> dict:
    """Specs of ``repro/models/moe.py::moe_specs`` (the forward is not ported)."""
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff
    L = () if layers is None else (layers,)
    A = () if layers is None else ("layers",)
    dt = cfg.param_dtype
    sp = {
        "router": ParamSpec(L + (d, E), A + ("embed", None), dt, scale=0.02),
        "w1": ParamSpec(L + (E, d, ff), A + ("experts", "embed", "expert_mlp"), dt),
        "w2": ParamSpec(L + (E, ff, d), A + ("experts", "expert_mlp", "embed"), dt),
    }
    if cfg.mlp_type == "swiglu":
        sp["w3"] = ParamSpec(L + (E, d, ff), A + ("experts", "embed", "expert_mlp"), dt)
    if cfg.shared_expert:
        sp["sw1"] = ParamSpec(L + (d, ff), A + ("fsdp", "mlp"), dt)
        sp["sw2"] = ParamSpec(L + (ff, d), A + ("mlp", "fsdp"), dt)
        if cfg.mlp_type == "swiglu":
            sp["sw3"] = ParamSpec(L + (d, ff), A + ("fsdp", "mlp"), dt)
    return sp


def _mamba_specs(cfg: ModelConfig, layers: int | None = None) -> dict:
    """Specs of ``repro/models/mamba2.py::mamba_specs`` (the forward is not ported)."""
    d, inner, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    kc = cfg.conv_kernel
    L = () if layers is None else (layers,)
    A = () if layers is None else ("layers",)
    dt = cfg.param_dtype
    return {
        "wz": ParamSpec(L + (d, inner), A + ("fsdp", "heads"), dt),
        "wx": ParamSpec(L + (d, inner), A + ("fsdp", "heads"), dt),
        "wB": ParamSpec(L + (d, N), A + ("fsdp", "state"), dt),
        "wC": ParamSpec(L + (d, N), A + ("fsdp", "state"), dt),
        "wdt": ParamSpec(L + (d, H), A + ("fsdp", "heads"), dt),
        "conv_x": ParamSpec(L + (kc, inner), A + ("conv", "heads"), dt, scale=0.5),
        "conv_B": ParamSpec(L + (kc, N), A + ("conv", "state"), dt, scale=0.5),
        "conv_C": ParamSpec(L + (kc, N), A + ("conv", "state"), dt, scale=0.5),
        "A_log": ParamSpec(L + (H,), A + ("heads",), torch.float32, init="zeros"),
        "D": ParamSpec(L + (H,), A + ("heads",), torch.float32, init="ones"),
        "dt_bias": ParamSpec(L + (H,), A + ("heads",), torch.float32, init="zeros"),
        "norm_w": ParamSpec(L + (inner,), A + ("heads",), dt, init="ones"),
        "wo": ParamSpec(L + (inner, d), A + ("heads", "fsdp"), dt),
    }


def _position_specs(cfg: ModelConfig, pos: int, n_groups: int) -> dict:
    """Specs of group-position ``pos`` (stacked over n_groups)."""
    sp: dict = dict(_attn_specs(cfg, n_groups))
    sp["ln1"] = ll.norm_spec(cfg, n_groups)
    sp["ln2"] = ll.norm_spec(cfg, n_groups)
    if cfg.is_moe_layer(pos):
        sp["moe"] = _moe_specs(cfg, n_groups)
        if cfg.dense_residual_ff:
            sp["dres"] = ll.mlp_specs(cfg, n_groups, d_ff=cfg.dense_residual_ff)
    else:
        sp["mlp"] = ll.mlp_specs(cfg, n_groups)
        if cfg.dense_residual_ff:  # arctic: dense residual on every layer
            sp["dres"] = ll.mlp_specs(cfg, n_groups, d_ff=cfg.dense_residual_ff)
    return sp


def decoder_specs(cfg: ModelConfig) -> dict:
    g = group_size(cfg)
    if cfg.family == "ssm":
        return {
            "mamba": _mamba_specs(cfg, cfg.n_layers),
            "ln": ll.norm_spec(cfg, cfg.n_layers),
        }
    if cfg.family == "hybrid":
        n_main = (cfg.n_layers // g) * g
        n_sites = cfg.n_layers // g
        tail = cfg.n_layers - n_main
        r = 64  # LoRA rank for per-site adaptation of the shared block
        d, hd = cfg.d_model, cfg.hd
        hq = cfg.q_heads_padded
        sp = {
            "mamba": _mamba_specs(cfg, n_main),
            "ln": ll.norm_spec(cfg, n_main),
            "shared": {
                "attn": _attn_specs(cfg, 0),
                "ln1": ll.norm_spec(cfg),
                "ln2": ll.norm_spec(cfg),
                "mlp": ll.mlp_specs(cfg),
            },
            "lora_a": ParamSpec((n_sites, d, r), ("layers", "fsdp", None), cfg.param_dtype,
                                scale=0.02),
            "lora_b": ParamSpec((n_sites, r, hq * hd), ("layers", None, "heads"),
                                cfg.param_dtype, init="zeros"),
        }
        if tail:
            sp["mamba_tail"] = _mamba_specs(cfg, tail)
            sp["ln_tail"] = ll.norm_spec(cfg, tail)
        return sp
    # attention families
    n_groups = cfg.n_layers // g
    return {"stack": {f"p{i}": _position_specs(cfg, i, n_groups) for i in range(g)}}


# ---------------------------------------------------------------- forward ---
def _head_mask(cfg: ModelConfig, device) -> torch.Tensor:
    m = torch.zeros((cfg.q_heads_padded,), dtype=torch.float32, device=device)
    m[: cfg.n_heads] = 1.0
    return m


def _qkv(cfg: ModelConfig, p: dict, x: torch.Tensor, positions: torch.Tensor, matmul=None):
    B, S, _ = x.shape
    mm = matmul or ll.default_mm
    q = mm(x, p, "wq")
    k = mm(x, p, "wk")
    v = mm(x, p, "wv")
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    hq = cfg.q_heads_padded
    hkv_stored = k.shape[-1] // cfg.hd
    q = q.reshape(B, S, hq, cfg.hd)
    k = k.reshape(B, S, hkv_stored, cfg.hd)
    v = v.reshape(B, S, hkv_stored, cfg.hd)
    if hkv_stored < cfg.kv_heads_padded:  # replicate logical KV heads
        k = ll._repeat_kv(k, cfg.kv_heads_padded // hkv_stored)
        v = ll._repeat_kv(v, cfg.kv_heads_padded // hkv_stored)
    q = shard(ll.rope(q, positions, cfg.rope_theta), "batch", "seq", "act_heads", None)
    k = shard(ll.rope(k, positions, cfg.rope_theta), "batch", "seq", "act_heads", None)
    v = shard(v, "batch", "seq", "act_heads", None)
    return q, k, v


def _out_proj(cfg: ModelConfig, p: dict, x: torch.Tensor, o: torch.Tensor, mm) -> torch.Tensor:
    o = o * _head_mask(cfg, o.device)[None, None, :, None].to(o.dtype)
    o = o.reshape(x.shape[0], x.shape[1], -1)
    return x + mm(o, p, "wo")


def attn_block_prefill(cfg: ModelConfig, p: dict, x: torch.Tensor, positions: torch.Tensor,
                       layer_global: bool, matmul=None, want_cache=False):
    mm = matmul or ll.default_mm
    h = ll.apply_norm(cfg, p["ln1"], x)
    q, k, v = _qkv(cfg, p, h, positions, matmul)
    o = ll.attention_prefill(cfg, 0, q, k, v, layer_global=layer_global)
    x = shard(_out_proj(cfg, p, x, o, mm), "batch", "saved_seq", "act_embed")
    cache = None
    if want_cache:
        win = _cache_window(cfg, layer_global)
        S = k.shape[1]
        if win is not None and S > win:
            # Ring cache: position p must land at slot p % win.
            k = torch.roll(k[:, -win:], (S - win) % win, dims=1)
            v = torch.roll(v[:, -win:], (S - win) % win, dims=1)
        cache = (k, v)
    return x, cache


def _cache_window(cfg: ModelConfig, layer_global: bool) -> int | None:
    if cfg.attn_type == "swa":
        return cfg.window
    if cfg.attn_type == "chunked_interleaved" and not layer_global:
        return cfg.chunk
    return None


def attn_block_decode(cfg: ModelConfig, p: dict, x: torch.Tensor, pos: torch.Tensor,
                      kv: tuple[torch.Tensor, torch.Tensor], layer_global: bool,
                      matmul=None):
    """x (B,1,D); pos (B,) int; kv caches (B,Smax,Hkv,hd), written in place."""
    mm = matmul or ll.default_mm
    h = ll.apply_norm(cfg, p["ln1"], x)
    q, k, v = _qkv(cfg, p, h, pos[:, None], matmul)
    k_cache, v_cache = kv
    smax = k_cache.shape[1]
    win = _cache_window(cfg, layer_global)
    if win is not None and smax == win:
        mode = "chunk_ring" if cfg.attn_type == "chunked_interleaved" else "ring"
        slot = pos % smax
    else:
        mode = "full"
        slot = torch.clamp(pos, max=smax - 1)
    bidx = torch.arange(k_cache.shape[0], device=k_cache.device)
    k_cache[bidx, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[bidx, slot] = v[:, 0].to(v_cache.dtype)
    o = ll.attention_decode(q, k_cache, v_cache, pos, mode=mode)
    return _out_proj(cfg, p, x, o, mm), (k_cache, v_cache)


def attn_block_decode_paged(cfg: ModelConfig, p: dict, x: torch.Tensor,
                            pos: torch.Tensor, kv: tuple[torch.Tensor, torch.Tensor],
                            page_table: torch.Tensor, matmul=None):
    """One-token decode against a *paged* KV cache (full attention only).

    x (B,1,D); pos (B,) int; kv pools (P+1, page_size, Hkv, hd) — the last
    physical page is the scratch target for unmapped lanes; page_table
    (B, Lp) int32 maps logical page -> physical pool page, -1 = unmapped.

    Writes scatter the new K/V row through the table, in place
    (``pool[table[b, pos // ps], pos % ps]``); reads gather every logical
    page back into a (B, Lp*ps, Hkv, hd) view that is shape-identical to the
    contiguous cache, so ``ll.attention_decode`` masks it exactly as the
    contiguous path does. Unmapped logical pages read physical page 0 in the
    view; every position they cover satisfies ``kpos > pos`` and is masked to
    an exact zero by the softmax, which is what makes paged decode bitwise
    identical to contiguous decode (see ``serve/page_manager.py``).
    """
    mm = matmul or ll.default_mm
    h = ll.apply_norm(cfg, p["ln1"], x)
    q, k, v = _qkv(cfg, p, h, pos[:, None], matmul)
    k_pool, v_pool = kv
    ps = k_pool.shape[1]
    lp = (pos // ps).long()
    phys = torch.gather(page_table.long(), 1, lp[:, None])[:, 0]
    # Unmapped lane (inactive slot / freed table row): scatter into the
    # reserved scratch page instead of wrapping to a live page via -1.
    phys = torch.where(phys < 0, k_pool.shape[0] - 1, phys)
    off = (pos % ps).long()
    k_pool[phys, off] = k[:, 0].to(k_pool.dtype)
    v_pool[phys, off] = v[:, 0].to(v_pool.dtype)
    view_table = torch.clamp(page_table.long(), min=0)

    def view(pool):
        g = pool[view_table]                      # (B, Lp, ps, Hkv, hd)
        return g.reshape(g.shape[0], -1, g.shape[3], g.shape[4])

    o = ll.attention_decode(q, view(k_pool), view(v_pool), pos, mode="full")
    return _out_proj(cfg, p, x, o, mm), (k_pool, v_pool)


def _ffn(cfg: ModelConfig, p: dict, x: torch.Tensor, matmul=None):
    h = ll.apply_norm(cfg, p["ln2"], x)
    if "moe" in p:
        raise _not_ported(cfg, "the MoE feed-forward")
    out = ll.mlp_apply(cfg, p["mlp"], h, matmul)
    if "dres" in p:  # arctic parallel dense residual
        out = out + ll.mlp_apply(cfg, p["dres"], h, matmul)
    return shard(x + out.to(x.dtype), "batch", "saved_seq", "act_embed")


def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked subtree: every leaf indexed on its leading axis."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def _n_groups(params: dict) -> int:
    """Groups of a decoder's stack: the leading extent of its stacked weights."""
    return params["stack"]["p0"]["wq"].shape[0]


# ------------------------------------------------------- attention families --
def _attn_stack_prefill(cfg: ModelConfig, params: dict, x: torch.Tensor,
                        positions: torch.Tensor, matmul=None, want_cache=False):
    g = group_size(cfg)
    caches = [[] for _ in range(g)]
    for li in range(_n_groups(params)):
        gp = layer_slice(params["stack"], li)
        for i in range(g):
            p = gp[f"p{i}"]
            x, cache = attn_block_prefill(cfg, p, x, positions, cfg.is_global_layer(i),
                                          matmul, want_cache=want_cache)
            x = _ffn(cfg, p, x, matmul)
            caches[i].append(cache)
    if not want_cache:
        return x, None
    # The reference scan stacks each position's caches on a leading axis.
    return x, tuple((torch.stack([c[0] for c in cs]), torch.stack([c[1] for c in cs]))
                    for cs in caches)


def _attn_stack_decode(cfg: ModelConfig, params: dict, x: torch.Tensor, pos: torch.Tensor,
                       caches, matmul=None):
    """Caches (per position, (n_groups, B, Smax, Hkv, hd) pairs) are written in place."""
    g = group_size(cfg)
    for li in range(_n_groups(params)):
        gp = layer_slice(params["stack"], li)
        for i in range(g):
            p = gp[f"p{i}"]
            kv = (caches[i][0][li], caches[i][1][li])
            x, _ = attn_block_decode(cfg, p, x, pos, kv, cfg.is_global_layer(i), matmul)
            x = _ffn(cfg, p, x, matmul)
    return x, caches


def _attn_stack_decode_paged(cfg: ModelConfig, params: dict, x: torch.Tensor,
                             pos: torch.Tensor, pools, page_table: torch.Tensor,
                             matmul=None):
    """Pools (per position, (n_groups, P+1, ps, Hkv, hd) pairs) are written in place."""
    g = group_size(cfg)
    for li in range(_n_groups(params)):
        gp = layer_slice(params["stack"], li)
        for i in range(g):
            p = gp[f"p{i}"]
            kv = (pools[i][0][li], pools[i][1][li])
            x, _ = attn_block_decode_paged(cfg, p, x, pos, kv, page_table, matmul)
            x = _ffn(cfg, p, x, matmul)
    return x, pools


# ------------------------------------------------------------------ facade --
def stack_prefill(cfg: ModelConfig, params: dict, x: torch.Tensor, positions: torch.Tensor,
                  matmul=None, want_cache=False):
    _check_family(cfg)
    return _attn_stack_prefill(cfg, params, x, positions, matmul, want_cache)


def stack_decode(cfg: ModelConfig, params: dict, x: torch.Tensor, pos: torch.Tensor,
                 caches, matmul=None):
    _check_family(cfg)
    return _attn_stack_decode(cfg, params, x, pos, caches, matmul)


def stack_decode_paged(cfg: ModelConfig, params: dict, x: torch.Tensor,
                       pos: torch.Tensor, pools, page_table: torch.Tensor,
                       matmul=None):
    """Paged-cache decode facade. Full attention only: ring caches
    (swa/chunked) are already O(window) and recurrent state (ssm/hybrid) has
    no sequence axis to page — those families keep dense slots (the engine's
    capability gate, same shape as ``bucketed``)."""
    if cfg.family in ("ssm", "hybrid") or cfg.attn_type != "full":
        raise ValueError(
            f"paged decode supports full-attention families only, not "
            f"family={cfg.family!r} attn_type={cfg.attn_type!r}")
    _check_family(cfg)
    return _attn_stack_decode_paged(cfg, params, x, pos, pools, page_table, matmul)
