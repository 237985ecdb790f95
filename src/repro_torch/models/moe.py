"""Mixture-of-Experts: top-k routing, single device. Port of the
``moe_impl="dense"`` branch of ``repro/models/moe.py``.

``moe_dense`` evaluates every expert densely and combines the outputs by
the gates: exact (infinite capacity) and mesh-free, the reference's oracle
and its smoke-test path. ``moe_impl="ep"`` (expert parallelism under
``shard_map``: all-to-all dispatch, ZeRO-3 gathered expert weights) needs a
device mesh, which the port does not have yet (``ROADMAP.md`` queue 1,
multi-device): ``moe_apply`` refuses it and never runs the dense branch in
its place. Experts are contracted by einsum, not through the injectable
GEMM, so they stay dense in Phi spiking mode, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import ParamSpec
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
    ct = cfg.compute_dtype
    xc = x.to(ct)
    h = _act(cfg, xc @ p["sw1"].to(ct), lambda: xc @ p["sw3"].to(ct))
    return h @ p["sw2"].to(ct)


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


def moe_apply(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.moe_impl == "ep":
        raise NotImplementedError(
            f"{cfg.name}: moe_impl='ep' (expert parallelism under shard_map) needs a device "
            "mesh, which the port does not have yet (ROADMAP.md queue 1, multi-device); "
            "moe_impl='dense' runs on one device")
    return moe_dense(cfg, p, x)
