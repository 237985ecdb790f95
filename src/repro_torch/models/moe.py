"""Mixture-of-Experts: top-k routing with two execution paths (port of
``repro/models/moe.py``).

``moe_impl="dense"`` — every expert evaluated densely, outputs combined by
the gates. Exact (infinite capacity): the correctness oracle and the
smoke-test path. On a mesh a rank holds only its shards of the layer (its
experts over ``model``, their hidden dim over ``data``, the shared expert's
hidden dim over ``model``); :func:`moe_apply` then makes one device's call
(:func:`_moe_dense_on_mesh`): every leaf all-gathered whole and the rows
gathered over the batch axes, the rank keeping its rows of the output. So
a rank's rows are bitwise one device's, at the cost of the whole layer on
every rank (only the smoke configs run it; the full configs run ``ep``).
The gathers carry the gradients (``collectives.all_gather``: the
reduce-scatter back), a leaf gathered over an axis whose ranks hold the
same rows taking the mean of their equal gradients, as :func:`moe_ep`'s
experts do.

``moe_impl="ep"`` — expert parallelism on a mesh of ranks. Tokens stay on
their rank's rows (the ``pod``/``data`` axes); experts are split over
``model`` and the expert hidden dim over ``data`` (ZeRO-3 style, gathered per
layer). Per rank:

    route → local capacity dispatch → all_to_all('model') →
    all_gather(expert weights, 'data') → grouped FFN →
    all_to_all('model') back → combine with gates

Capacity is static (ceil(k·tokens·cf/E)); tokens past it are dropped
(standard token-dropping MoE): :func:`moe_ep` with ``capacity_factor`` large
enough that nothing drops equals the dense path, and under autograd so do
its gradients (the collectives carry them; see :func:`moe_ep`). Without a
mesh it is the dense path, as the reference's. Experts are contracted by einsum, not
through the injectable GEMM, so they stay dense in Phi spiking mode, as in
the reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import (
    ParamSpec, axis_names_of, batch_rows, current_mesh, resolve_spec)
from repro_torch.models.config import ModelConfig


def moe_specs(cfg: ModelConfig, layers: int | None = None) -> dict:
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


def _route(cfg: ModelConfig, router_w: torch.Tensor, x: torch.Tensor):
    """x (..., D) -> (gates (..., k), idx (..., k) int32). Softmax, then top-k,
    renormalised (Mixtral-style); top-1 degenerates to a plain argmax gate."""
    logits = x.to(torch.float32) @ router_w.to(torch.float32)
    probs = torch.softmax(logits, -1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, idx.to(torch.int32)


def _act(cfg: ModelConfig, h: torch.Tensor, gate) -> torch.Tensor:
    if cfg.mlp_type == "swiglu":
        return F.silu(h) * gate()
    return F.gelu(h, approximate="tanh")        # jax.nn.gelu's default


def _expert_ffn(cfg: ModelConfig, p: dict, toks: torch.Tensor) -> torch.Tensor:
    """toks (E, C, D) grouped per expert -> (E, C, D)."""
    ct = cfg.compute_dtype
    t = toks.to(ct)
    h = torch.einsum("ecd,edf->ecf", t, p["w1"].to(ct))
    h = _act(cfg, h, lambda: torch.einsum("ecd,edf->ecf", t, p["w3"].to(ct)))
    return torch.einsum("ecf,efd->ecd", h, p["w2"].to(ct))


def _shared_expert(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """The always-on expert (a plain MLP). On a mesh its ``sw1``/``sw3`` are
    column-parallel (the input's gradient summed over their N axis) and its
    ``sw2`` row-parallel: the partial products are summed over its K axis."""
    ct = cfg.compute_dtype
    xc = x.to(ct)
    split = p["sw2"].shape[-2] != cfg.d_ff
    if split:
        ax = resolve_spec(("mlp",))[0]
        xc = coll.sum_grad(xc, current_mesh(), ax)
    h = _act(cfg, xc @ p["sw1"].to(ct), lambda: xc @ p["sw3"].to(ct))
    out = h @ p["sw2"].to(ct)
    if split:
        out = coll.all_reduce(out.to(torch.float32), current_mesh(), ax).to(ct)
    return out


def moe_dense(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Evaluate every expert densely, combine by gates. (..., D)."""
    E = cfg.n_experts
    gates, idx = _route(cfg, p["router"], x)
    onehot = F.one_hot(idx.long(), E).to(torch.float32)               # (..., k, E)
    comb = (gates[..., None] * onehot).sum(-2)                        # (..., E)
    toks = x[None].expand((E,) + x.shape).reshape(E, -1, x.shape[-1])
    outs = _expert_ffn(cfg, p, toks).reshape((E,) + x.shape)          # (E, ..., D)
    out = torch.einsum("e...,e...d->...d", comb.movedim(-1, 0), outs.to(torch.float32))
    if cfg.shared_expert:
        out = out + _shared_expert(cfg, p, x)
    return out.to(x.dtype)


# ---------------------------------------------------------------- EP path ---
def _dispatch(x_flat: torch.Tensor, idx: torch.Tensor, gates: torch.Tensor, E: int, cap: int):
    """x (N, D), idx/gates (N, k) -> buf (E, cap, D) and the route
    (expert, slot, keep, source token) of each of the N·k choices: a choice
    takes the next free slot of its expert, in token order, and is dropped
    past ``cap``."""
    N, k = idx.shape
    flat_e = idx.reshape(-1).long()                                   # (N·k,)
    oh = F.one_hot(flat_e, E)
    pos = ((torch.cumsum(oh, 0) - 1) * oh).sum(-1)                    # rank within expert
    keep = pos < cap
    posc = pos.clamp(0, cap - 1)
    src = torch.arange(N, device=x_flat.device).repeat_interleave(k)
    buf = torch.zeros((E, cap, x_flat.shape[-1]), dtype=x_flat.dtype, device=x_flat.device)
    buf.index_put_((flat_e, posc), x_flat[src] * keep[:, None].to(x_flat.dtype),
                   accumulate=True)
    return buf, (flat_e, posc, keep, src)


def _combine(out_buf: torch.Tensor, route, gates: torch.Tensor, N: int) -> torch.Tensor:
    """Each token's kept choices' expert outputs, weighted by their gates and
    summed: (N, D)."""
    flat_e, posc, keep, src = route
    vals = out_buf[flat_e, posc] * (keep * gates.reshape(-1)).to(out_buf.dtype)[:, None]
    out = torch.zeros((N, out_buf.shape[-1]), dtype=out_buf.dtype, device=out_buf.device)
    return out.index_add_(0, src, vals)


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the gradient times ``factor``."""

    @staticmethod
    def forward(ctx, x, factor):
        ctx.factor = factor
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.factor, None


def moe_ep(cfg: ModelConfig, p: dict, x: torch.Tensor, stats: dict | None = None
           ) -> torch.Tensor:
    """Expert-parallel MoE on the current mesh. x (B, S, D): this rank's
    rows; ``p`` its shards (experts on ``model``, the expert hidden dim on
    ``data``). ``stats``, if given, receives this rank's ``dropped`` choices
    and ``capacity``. Without a mesh: :func:`moe_dense`."""
    mesh = current_mesh()
    if mesh is None:
        return moe_dense(cfg, p, x)
    tp = mesh.shape["model"]
    fsdp_ax = "data" if "data" in mesh.axis_names else None
    E = cfg.n_experts
    if E % tp or p["w1"].shape[0] != E // tp:
        raise ValueError(f"moe_ep: {E} experts do not split over model = {tp} "
                         f"(local experts {p['w1'].shape[0]})")
    e_loc = E // tp
    B, S, D = x.shape
    cap = max(1, math.ceil(cfg.top_k * B * S / E * cfg.capacity_factor))
    xf = x.reshape(-1, D)
    gates, idx = _route(cfg, p["router"], xf)
    buf, route = _dispatch(xf, idx, gates, E, cap)                     # (E, cap, D)
    if stats is not None:
        stats.update(dropped=int((~route[2]).sum()), capacity=cap)
    # all_to_all over 'model': block i (peer i's experts) goes to peer i; the
    # blocks that come back are each peer's tokens for this rank's experts
    buf = coll.all_to_all(buf.reshape(tp, e_loc, cap, D), mesh, "model")
    buf = buf.transpose(0, 1).reshape(e_loc, tp * cap, D)
    pp = {k: p[k] for k in ("w1", "w2", "w3") if k in p}
    if torch.is_grad_enabled():
        # every rank of 'model' holds its rows' tokens, so each token reaches
        # its experts once from each of them: under autograd (a loss the same
        # on every rank) the experts' weights take the mean of those tp
        # gradients
        pp = {k: _ScaleGrad.apply(w, 1.0 / tp) for k, w in pp.items()}
    if fsdp_ax is not None and mesh.shape[fsdp_ax] > 1:   # ZeRO-3 gather of the hidden dim
        pp = {k: coll.all_gather(w, mesh, fsdp_ax, dim=1 if k == "w2" else 2)
              for k, w in pp.items()}
    out = _expert_ffn(cfg, pp, buf)                                    # (e_loc, tp·cap, D)
    out = out.reshape(e_loc, tp, cap, D).transpose(0, 1)               # (dst peer, e_loc, …)
    out = coll.all_to_all(out, mesh, "model").reshape(E, cap, D)
    y = _combine(out.to(torch.float32), route, gates, xf.shape[0])
    y = y.reshape(x.shape).to(x.dtype)
    if cfg.shared_expert:   # a plain dense MLP, outside the expert exchange
        y = y + _shared_expert(cfg, p, x).to(y.dtype)
    return y


def _moe_dense_on_mesh(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """:func:`moe_dense` of this rank's rows ``x`` from its shards ``p`` on
    the current mesh, as one device's call (see the module docstring)."""
    mesh = current_mesh()
    bd = (resolve_spec(("batch",)) or (None,))[0]
    batch_axes = set(axis_names_of(bd))
    specs = moe_specs(cfg)
    whole = {}
    for k, w in p.items():
        spec = specs[k]
        for dim, (n, logical) in enumerate(zip(spec.shape, spec.axes)):
            if w.shape[dim] == n:
                continue
            ax = resolve_spec((logical,))[0]
            same_rows = [a for a in axis_names_of(ax) if a not in batch_axes]
            if same_rows and torch.is_grad_enabled():
                w = _ScaleGrad.apply(w, 1.0 / math.prod(mesh.shape[a] for a in same_rows))
            w = coll.all_gather(w, mesh, ax, dim)
        whole[k] = w
    block = batch_rows()
    if block is None or block[0] == x.shape[0]:
        return moe_dense(cfg, whole, x)
    rows = coll.all_gather(x, mesh, bd, dim=0)
    return moe_dense(cfg, whole, rows)[block[1]:block[1] + x.shape[0]]


def moe_apply(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.moe_impl == "ep":
        return moe_ep(cfg, p, x)
    if current_mesh() is not None:
        return _moe_dense_on_mesh(cfg, p, x)
    return moe_dense(cfg, p, x)
