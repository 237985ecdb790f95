"""Optimizers and schedules, written out (port of ``repro/train/optimizer.py``).

AdamW with decoupled weight decay, global-norm clipping, and an optional
factored second moment (Adafactor-style) for memory-constrained training.
State is a plain dict of tensors, nested as the parameters are. The update
is functional, under ``torch.no_grad()``, in the reference's order (clip →
moments → bias-correct → decoupled decay): ``torch.optim.AdamW`` rounds in
another order and has no factored moment.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    factored: bool = False      # factored 2nd moment for tensors with ndim >= 2
    grad_compress: bool = False  # int8 error-feedback all-reduce (no multi-device port yet)


def _is_factored(v: Any) -> bool:
    return isinstance(v, dict) and "vr" in v


def _map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (nested dicts of tensors) and the
    entries at the same keys of ``rest``, which may hold a factored moment
    ({"vr", "vc"}) where ``tree`` holds a tensor."""
    if isinstance(tree, dict):
        return {key: _map(fn, tree[key], *(r[key] for r in rest)) for key in tree}
    return fn(tree, *rest)


def _leaves(tree: Any) -> list[torch.Tensor]:
    """The tensors of a nested dict, keys sorted (the reference's leaf order)."""
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in _leaves(tree[key])]
    return [tree]


def lr_schedule(cfg: OptConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warmup + cosine decay to min_lr_ratio·lr."""

    def fn(step: torch.Tensor) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = step / max(cfg.warmup_steps, 1)
        prog = torch.clamp((step - cfg.warmup_steps)
                           / max(cfg.decay_steps - cfg.warmup_steps, 1), 0, 1)
        cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
        return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)

    return fn


def _second_moment_init(p: torch.Tensor, factored: bool):
    if factored and p.ndim >= 2:
        return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),
                "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32,
                                  device=p.device)}
    return torch.zeros_like(p, dtype=torch.float32)


def init(params: dict, cfg: OptConfig) -> dict:
    """Zero moments shaped as ``params``; ``step`` a 0-d int32 on their device."""
    device = _leaves(params)[0].device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "m": _map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
        "v": _map(lambda p: _second_moment_init(p, cfg.factored), params),
    }


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32))) for x in _leaves(tree)))


def _update_moment_v(v, g2: torch.Tensor, b2: float):
    if _is_factored(v):
        return {"vr": b2 * v["vr"] + (1 - b2) * g2.mean(-1),
                "vc": b2 * v["vc"] + (1 - b2) * g2.mean(-2)}
    return b2 * v + (1 - b2) * g2


def _precondition(v, g: torch.Tensor, eps: float) -> torch.Tensor:
    if _is_factored(v):  # v ≈ vr·vc / mean(vr)
        r = v["vr"][..., None]
        c = v["vc"][..., None, :]
        denom = r * c / torch.clamp(v["vr"].mean(-1)[..., None, None], min=1e-30)
        return g / (torch.sqrt(denom) + eps)
    return g / (torch.sqrt(v) + eps)


@torch.no_grad()
def apply_updates(params: dict, grads: dict, state: dict, cfg: OptConfig
                  ) -> tuple[dict, dict]:
    """One AdamW step: clip → moments → bias-correct → decoupled decay.
    Returns new (params, state); the inputs are not modified."""
    step = state["step"] + 1
    scale = 1.0
    if cfg.grad_clip:
        scale = torch.clamp(cfg.grad_clip / torch.clamp(global_norm(grads), min=1e-9), max=1.0)
    grads = _map(lambda g: g.to(torch.float32) * scale, grads)

    m = _map(lambda g, m_: cfg.b1 * m_ + (1 - cfg.b1) * g, grads, state["m"])
    v = _map(lambda g, v_: _update_moment_v(v_, torch.square(g), cfg.b2), grads, state["v"])
    stepf = step.to(torch.float32)
    bc1 = 1 - cfg.b1 ** stepf
    bc2 = 1 - cfg.b2 ** stepf
    lr = lr_schedule(cfg)(step)

    def upd(p, m_, v_):
        mhat = m_ / bc1
        vhat = {key: x / bc2 for key, x in v_.items()} if _is_factored(v_) else v_ / bc2
        pf = p.to(torch.float32)
        return (pf - lr * (_precondition(vhat, mhat, cfg.eps) + cfg.weight_decay * pf)
                ).to(p.dtype)

    return _map(upd, params, m, v), {"step": step, "m": m, "v": v}
