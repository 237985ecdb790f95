"""Decoder stacks of every family (port of ``repro/models/transformer.py``).

Parameters keep the reference's layout: each position ``p{i}`` of a layer
group holds its weights stacked over the groups on a leading axis, so a
reference params tree carries across leaf by leaf (``interop``). Where the
reference scans over that axis, the port loops over it, slicing each
layer's views. Under autograd each layer-group body of a prefill (a group of
the attention stack, a Mamba-2 layer, a hybrid site) runs as the reference's
``_maybe_remat`` runs it: ``cfg.remat`` "full" keeps only the group's input
for the backward and recomputes the rest (``torch.utils.checkpoint``),
"dots" also keeps the matmuls without a batch dimension, "none" keeps every
activation. On a mesh whose rules name a ``saved_seq`` axis (``model``
under ``TRAIN_RULES``) the kept input is the rank's block of the sequence,
all-gathered inside the body. Off autograd (serving) nothing changes.
Heterogeneous interleavings (dense/MoE layers, chunked-local/global
attention) loop over groups whose size is the LCM of the interleave periods,
as there.

The Mamba-2 stack (``ssm``) loops over its layers; the hybrid (Zamba2) runs
``n_layers // hybrid_attn_every`` sites of that many Mamba-2 layers, each
followed by the one shared attention + MLP block with the site's LoRA on Q,
then the tail layers. Decode writes every state it is given in place: KV
caches, SSM states and conv rings. MoE layers take ``moe.moe_apply``: the
dense branch (on a mesh as one device's call) or ``moe_impl="ep"``,
expert-parallel on a mesh.

GQA under TP with awkward head counts keeps the reference's exact math:
padded Q heads are zero-masked before the out-projection, and logical KV
heads are repeated up to the padded head count.

On a mesh (``sharding.use_rules``) the blocks run on a rank's local shards:
its block of Q (and KV) heads, read from the local weights' widths, and its
block of ``d_ff``; the row-parallel out-projections' partial sums are
completed by the matmul (``models.model``). The head mask and replicated KV
heads take the rank's block of the global head range, and attention runs on
the rank's block inside one device's call shape (``layers.one_device_call``);
under autograd (training on a mesh) on the rank's own rows and heads. The
Mamba-2 layers of ``ssm`` and the hybrid run on the rank's SSM heads
(``mamba2``); the hybrid's shared block runs as the attention families' do,
its site LoRA on Q with ``lora_b`` split over the heads and ``lora_a`` whole
when serving.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import (
    ParamSpec, current_mesh, resolve_spec, shard, thread_context, use_thread_context)
from repro_torch.models import layers as ll
from repro_torch.models import mamba2, moe
from repro_torch.models.config import ModelConfig


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


def _position_specs(cfg: ModelConfig, pos: int, n_groups: int) -> dict:
    """Specs of group-position ``pos`` (stacked over n_groups)."""
    sp: dict = dict(_attn_specs(cfg, n_groups))
    sp["ln1"] = ll.norm_spec(cfg, n_groups)
    sp["ln2"] = ll.norm_spec(cfg, n_groups)
    if cfg.is_moe_layer(pos):
        sp["moe"] = moe.moe_specs(cfg, n_groups)
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
            "mamba": mamba2.mamba_specs(cfg, cfg.n_layers),
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
            "mamba": mamba2.mamba_specs(cfg, n_main),
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
            sp["mamba_tail"] = mamba2.mamba_specs(cfg, tail)
            sp["ln_tail"] = ll.norm_spec(cfg, tail)
        return sp
    # attention families
    n_groups = cfg.n_layers // g
    return {"stack": {f"p{i}": _position_specs(cfg, i, n_groups) for i in range(g)}}


# ---------------------------------------------------------------- forward ---
def _head_block(cfg: ModelConfig, hq: int) -> int:
    """Index of this rank's block of ``hq`` Q heads among the padded heads
    (0 on one device, where ``hq`` is all of them)."""
    if hq == cfg.q_heads_padded:
        return 0
    mesh = current_mesh()
    if mesh is None:
        raise ValueError(f"{hq} of {cfg.q_heads_padded} Q heads outside a mesh")
    return mesh.index(resolve_spec(("heads",))[0])


def _call_block(cfg: ModelConfig, q: torch.Tensor) -> tuple | None:
    """This rank's block of one device's attention call, (rows, row0, heads,
    head0) as ``layers.one_device_call`` takes it, or None off a mesh."""
    from repro_torch.distributed.sharding import batch_rows, current_mesh

    if current_mesh() is None:
        return None
    rows, row0 = batch_rows() or (q.shape[0], 0)
    hq = q.shape[2]
    return rows, row0, cfg.q_heads_padded, _head_block(cfg, hq) * hq


def _head_mask(cfg: ModelConfig, device, hq: int | None = None) -> torch.Tensor:
    """1 for the real Q heads among this rank's ``hq`` (default: all the
    padded heads), 0 for the padding."""
    hq = cfg.q_heads_padded if hq is None else hq
    first = _head_block(cfg, hq) * hq
    return (torch.arange(first, first + hq, device=device) < cfg.n_heads).to(torch.float32)


def _qkv(cfg: ModelConfig, p: dict, x: torch.Tensor, positions: torch.Tensor, matmul=None,
         lora: tuple[torch.Tensor, torch.Tensor] | None = None):
    B, S, _ = x.shape
    mm = matmul or ll.default_mm
    q = mm(x, p, "wq")
    if lora is not None:  # zamba2 per-site adaptation of the shared block
        a, b = lora
        t = x @ a.to(x.dtype)
        if b.shape[-1] != cfg.q_heads_padded * cfg.hd:
            # whole on every rank, it meets only the rank's columns of lora_b
            t = coll.sum_grad(t, current_mesh(), resolve_spec(("heads",))[0])
        q = q + t @ b.to(x.dtype)
    k = mm(x, p, "wk")
    v = mm(x, p, "wv")
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    hq = q.shape[-1] // cfg.hd                       # this rank's Q heads
    kv_local = cfg.kv_heads_padded * hq // cfg.q_heads_padded
    hkv_stored = k.shape[-1] // cfg.hd
    q = q.reshape(B, S, hq, cfg.hd)
    k = k.reshape(B, S, hkv_stored, cfg.hd)
    v = v.reshape(B, S, hkv_stored, cfg.hd)
    if _kv_replicated(cfg):  # replicate logical KV heads (the rank's block of them)
        first = _head_block(cfg, hq) * kv_local
        if current_mesh() is not None:
            # the logical heads are whole on every rank, each reading its
            # block of their padded copies: their gradients are summed over
            # the heads' axis
            k, v = (coll.sum_grad(t, current_mesh(), resolve_spec(("heads",))[0])
                    for t in (k, v))
        k = ll._repeat_kv(k, cfg.kv_heads_padded // hkv_stored)[:, :, first:first + kv_local]
        v = ll._repeat_kv(v, cfg.kv_heads_padded // hkv_stored)[:, :, first:first + kv_local]
    q = shard(ll.rope(q, positions, cfg.rope_theta), "batch", "seq", "act_heads", None)
    k = shard(ll.rope(k, positions, cfg.rope_theta), "batch", "seq", "act_heads", None)
    v = shard(v, "batch", "seq", "act_heads", None)
    return q, k, v


def _out_proj(cfg: ModelConfig, p: dict, x: torch.Tensor, o: torch.Tensor, mm) -> torch.Tensor:
    o = o * _head_mask(cfg, o.device, o.shape[2])[None, None, :, None].to(o.dtype)
    o = o.reshape(x.shape[0], x.shape[1], -1)
    return x + mm(o, p, "wo")


def attn_block_prefill(cfg: ModelConfig, p: dict, x: torch.Tensor, positions: torch.Tensor,
                       layer_global: bool, matmul=None, lora=None, want_cache=False):
    mm = matmul or ll.default_mm
    h = ll.apply_norm(cfg, p["ln1"], x)
    q, k, v = _qkv(cfg, p, h, positions, matmul, lora)
    o = ll.attention_prefill(cfg, 0, q, k, v, layer_global=layer_global,
                             block=_call_block(cfg, q))
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
                      matmul=None, lora=None):
    """x (B,1,D); pos (B,) int; kv caches (B,Smax,Hkv,hd), written in place."""
    mm = matmul or ll.default_mm
    h = ll.apply_norm(cfg, p["ln1"], x)
    q, k, v = _qkv(cfg, p, h, pos[:, None], matmul, lora)
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
    o = ll.attention_decode(q, k_cache, v_cache, pos, mode=mode, block=_call_block(cfg, q))
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
    identical to contiguous decode (see ``serve/page_manager.py``). On a
    mesh the pools hold the rank's KV heads and the table its rows, so the
    view has the contiguous cache's local shape and the attention makes the
    same one-device call (``block``).
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

    o = ll.attention_decode(q, view(k_pool), view(v_pool), pos, mode="full",
                            block=_call_block(cfg, q))
    return _out_proj(cfg, p, x, o, mm), (k_pool, v_pool)


def _ffn(cfg: ModelConfig, p: dict, x: torch.Tensor, matmul=None):
    h = ll.apply_norm(cfg, p["ln2"], x)
    if "moe" in p:
        out = moe.moe_apply(cfg, p["moe"], h)
    else:
        out = ll.mlp_apply(cfg, p["mlp"], h, matmul)
    if "dres" in p:  # arctic parallel dense residual
        out = out + ll.mlp_apply(cfg, p["dres"], h, matmul)
    return shard(x + out.to(x.dtype), "batch", "saved_seq", "act_embed")


def layer_slice(tree, i: int | slice):
    """Layer ``i`` (or the layers of a slice) of a stacked subtree: every leaf
    indexed on its leading axis."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def _n_groups(params: dict) -> int:
    """Groups of an attention family's stack: the leading extent of its
    stacked weights."""
    return params["stack"]["p0"]["wq"].shape[0]


def _dots_saveable(ctx, op, *args, **kwargs):
    """The selective-checkpoint policy of ``cfg.remat == "dots"``: jax's
    ``dots_with_no_batch_dims_saveable``, matmuls without a batch dimension
    (``mm``, ``addmm``: a weight GEMM) kept, everything else recomputed."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _needs_grad(*trees) -> bool:
    def any_leaf(t):
        if isinstance(t, dict):
            return any(any_leaf(v) for v in t.values())
        if isinstance(t, (tuple, list)):
            return any(any_leaf(v) for v in t)
        return isinstance(t, torch.Tensor) and t.requires_grad
    return torch.is_grad_enabled() and any(any_leaf(t) for t in trees)


def _maybe_remat(cfg: ModelConfig, fn):
    """``fn(x, *args)`` (a layer-group body whose first output is the next
    ``x``) under ``cfg.remat`` where a backward will run through it, as the
    reference's ``_maybe_remat``; ``fn`` itself elsewhere."""
    if cfg.remat == "none":
        return fn
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"remat {cfg.remat!r} not in ('none', 'full', 'dots')")

    def body(x, *args):
        if not _needs_grad(x, args):
            return fn(x, *args)
        from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

        from repro_torch.kernels import dispatch

        ctx = (functools.partial(create_selective_checkpoint_contexts, _dots_saveable)
               if cfg.remat == "dots" else None)
        mesh = current_mesh()
        ax = (resolve_spec(("saved_seq",)) or (None,))[0] if mesh is not None else None
        split = ax is not None and mesh.extent(ax) > 1 and x.shape[1] % mesh.extent(ax) == 0
        # The recompute runs in the backward, on autograd's device thread for
        # card tensors: it re-enters the forward's rules, mesh, batch rows
        # and SPMD region, which are thread-local.
        where = (thread_context(), dispatch.region_context())

        def run(xb, *a):
            with use_thread_context(where[0]), dispatch.use_region_context(where[1]):
                return fn(coll.gather_blocks(xb, mesh, ax, 1) if split else xb, *a)

        if split:
            x = coll.keep_block(x, mesh, ax, 1)
        kw = {"context_fn": ctx} if ctx is not None else {}
        return checkpoint(run, x, *args, use_reentrant=False, preserve_rng_state=False, **kw)

    return body


# ------------------------------------------------------- attention families --
def _attn_stack_prefill(cfg: ModelConfig, params: dict, x: torch.Tensor,
                        positions: torch.Tensor, matmul=None, want_cache=False):
    g = group_size(cfg)
    caches = [[] for _ in range(g)]

    def group_body(x, gp):
        out = []
        for i in range(g):
            p = gp[f"p{i}"]
            x, cache = attn_block_prefill(cfg, p, x, positions, cfg.is_global_layer(i),
                                          matmul, want_cache=want_cache)
            x = _ffn(cfg, p, x, matmul)
            out.append(cache)
        return x, out

    body = _maybe_remat(cfg, group_body)
    for li in range(_n_groups(params)):
        x, out = body(x, layer_slice(params["stack"], li))
        for i, cache in enumerate(out):
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


# ------------------------------------------------------------ ssm families --
def _stack_states(states: list) -> tuple:
    """Per-layer (ssm, conv dict) states stacked on a leading layer axis, as
    the reference's scan stacks them."""
    return (torch.stack([s for s, _ in states]),
            {k: torch.stack([c[k] for _, c in states]) for k in ("x", "B", "C")})


def _layer_state(states: tuple, i) -> tuple:
    """Layer ``i``'s (ssm, conv dict) views of a stacked decode state."""
    ssm, conv = states
    return ssm[i], {k: v[i] for k, v in conv.items()}


def _write_state(dst: tuple, new: tuple) -> None:
    """Write a layer's new (ssm, conv dict) state into its views, in place."""
    dst[0].copy_(new[0])
    for k, v in dst[1].items():
        v.copy_(new[1][k])


def _mamba_layer_prefill(cfg: ModelConfig, p: dict, ln: dict, x: torch.Tensor, matmul):
    out, state = mamba2.mamba_prefill(cfg, p, ll.apply_norm(cfg, ln, x), matmul)
    return shard(x + out.to(x.dtype), "batch", "saved_seq", "act_embed"), state


def _mamba_layer_decode(cfg: ModelConfig, p: dict, ln: dict, x: torch.Tensor, state,
                        matmul):
    """x (B,1,D); ``state`` (views of one layer's state) is written in place."""
    out, new = mamba2.mamba_decode(cfg, p, ll.apply_norm(cfg, ln, x[:, 0]), state, matmul)
    _write_state(state, new)
    return x + out[:, None].to(x.dtype)


def _mamba_stack_prefill(cfg, mamba_p: dict, lns: dict, x, matmul, want_state,
                         remat: bool = False):
    states = []

    def layer(x, p, ln):
        return _mamba_layer_prefill(cfg, p, ln, x, matmul)

    if remat:
        layer = _maybe_remat(cfg, layer)
    for li in range(mamba_p["wz"].shape[0]):
        x, st = layer(x, layer_slice(mamba_p, li), layer_slice(lns, li))
        if want_state:      # a conv ring is a view: keeping it keeps its whole input
            states.append(st)
    return x, (_stack_states(states) if want_state else None)


def _mamba_stack_decode(cfg, mamba_p: dict, lns: dict, x, states, matmul):
    for li in range(mamba_p["wz"].shape[0]):
        x = _mamba_layer_decode(cfg, layer_slice(mamba_p, li), layer_slice(lns, li), x,
                                _layer_state(states, li), matmul)
    return x


def _ssm_stack_prefill(cfg: ModelConfig, params: dict, x: torch.Tensor, matmul=None,
                       want_state=False):
    return _mamba_stack_prefill(cfg, params["mamba"], params["ln"], x, matmul, want_state,
                                remat=True)


def _ssm_stack_decode(cfg: ModelConfig, params: dict, x: torch.Tensor, states,
                      matmul=None):
    """``states`` = (ssm (L,B,H,P,N), {"x","B","C"} conv rings), written in place."""
    return _mamba_stack_decode(cfg, params["mamba"], params["ln"], x, states, matmul), states


# --------------------------------------------------------- hybrid (zamba2) --
def _shared_block(params: dict, site: int):
    """The shared attention + MLP block's params (attention and ln1 merged, as
    the reference merges them) and site ``site``'s LoRA on Q."""
    sp = params["shared"]
    merged = dict(sp["attn"])
    merged["ln1"] = sp["ln1"]
    return sp, merged, (params["lora_a"][site], params["lora_b"][site])


def _shared_mlp(cfg: ModelConfig, sp: dict, x: torch.Tensor, matmul) -> torch.Tensor:
    h = ll.apply_norm(cfg, sp["ln2"], x)
    return x + ll.mlp_apply(cfg, sp["mlp"], h, matmul).to(x.dtype)


def _hybrid_prefill(cfg: ModelConfig, params: dict, x: torch.Tensor, positions: torch.Tensor,
                    matmul=None, want_cache=False):
    """Sites of ``g`` main Mamba-2 layers (``params["mamba"][site * g + j]``),
    each followed by the shared block; then the tail. With ``want_cache`` it
    also returns the decode state {"mamba": main states (n_sites, g, B, ...),
    "kv": the shared block's caches (n_sites, B, S, Hkv, hd), "tail"}."""
    g = group_size(cfg)
    n_sites = cfg.n_layers // g
    main_states, caches = [], []

    def site_body(x, site, mamba_p, lns, lora_a, lora_b):
        states = []
        for j in range(g):
            x, st = _mamba_layer_prefill(cfg, layer_slice(mamba_p, j), layer_slice(lns, j), x,
                                         matmul)
            states.append(st if want_cache else None)
        sp, merged, _ = _shared_block(params, site)
        x, cache = attn_block_prefill(cfg, merged, x, positions, True, matmul,
                                      lora=(lora_a, lora_b), want_cache=want_cache)
        return _shared_mlp(cfg, sp, x, matmul), states, cache

    body = _maybe_remat(cfg, site_body)
    for site in range(n_sites):
        rows = slice(site * g, (site + 1) * g)
        x, states, cache = body(
            x, site, layer_slice(params["mamba"], rows), layer_slice(params["ln"], rows),
            params["lora_a"][site], params["lora_b"][site])
        if want_cache:
            main_states += states
        caches.append(cache)
    tail = None
    if "mamba_tail" in params:
        x, tail = _mamba_stack_prefill(cfg, params["mamba_tail"], params["ln_tail"], x,
                                       matmul, want_cache)
    if not want_cache:
        return x, None
    ssm, conv = _stack_states(main_states)

    def site_major(t):
        return t.reshape((n_sites, g) + t.shape[1:])

    kv = (torch.stack([c[0] for c in caches]), torch.stack([c[1] for c in caches]))
    return x, {"mamba": (site_major(ssm), {k: site_major(v) for k, v in conv.items()}),
               "kv": kv, "tail": tail}


def _hybrid_decode(cfg: ModelConfig, params: dict, x: torch.Tensor, pos: torch.Tensor,
                   states, matmul=None):
    """``states`` as ``_hybrid_prefill`` returns it; every leaf is written in place."""
    g = group_size(cfg)
    n_sites = cfg.n_layers // g
    for site in range(n_sites):
        for j in range(g):
            li = site * g + j
            main = _layer_state(_layer_state(states["mamba"], site), j)
            x = _mamba_layer_decode(cfg, layer_slice(params["mamba"], li),
                                    layer_slice(params["ln"], li), x, main, matmul)
        sp, merged, lora = _shared_block(params, site)
        kv = (states["kv"][0][site], states["kv"][1][site])
        x, _ = attn_block_decode(cfg, merged, x, pos, kv, True, matmul, lora=lora)
        x = _shared_mlp(cfg, sp, x, matmul)
    if "mamba_tail" in params:
        x = _mamba_stack_decode(cfg, params["mamba_tail"], params["ln_tail"], x,
                                states["tail"], matmul)
    return x, states


# ------------------------------------------------------------------ facade --
def stack_prefill(cfg: ModelConfig, params: dict, x: torch.Tensor, positions: torch.Tensor,
                  matmul=None, want_cache=False):
    if cfg.family == "ssm":
        return _ssm_stack_prefill(cfg, params, x, matmul, want_state=want_cache)
    if cfg.family == "hybrid":
        return _hybrid_prefill(cfg, params, x, positions, matmul, want_cache)
    return _attn_stack_prefill(cfg, params, x, positions, matmul, want_cache)


def stack_decode(cfg: ModelConfig, params: dict, x: torch.Tensor, pos: torch.Tensor,
                 caches, matmul=None):
    if cfg.family == "ssm":
        return _ssm_stack_decode(cfg, params, x, caches, matmul)
    if cfg.family == "hybrid":
        return _hybrid_decode(cfg, params, x, pos, caches, matmul)
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
    return _attn_stack_decode_paged(cfg, params, x, pos, pools, page_table, matmul)
