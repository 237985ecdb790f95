"""Optimizers and schedules, written out (port of ``repro/train/optimizer.py``).

AdamW with decoupled weight decay, global-norm clipping, and an optional
factored second moment (Adafactor-style) for memory-constrained training.
State is a plain dict of tensors, nested as the parameters are. The update
is functional, under ``torch.no_grad()``, in the reference's order (clip →
moments → bias-correct → decoupled decay): ``torch.optim.AdamW`` rounds in
another order and has no factored moment.

On a mesh (``apply_updates(..., mesh=, placements=)``) each rank updates its
shards of the leaves (ZeRO-3: the moments are placed as the leaves are).
Two parts read more than a shard: the clip's global norm sums each leaf's
squares over the axes the leaf is split over and only those (a leaf
replicated over an axis counts once), and the factored moment's means over
a dim that is split sum the local partials over that dim's axes and divide
by the global size. Off a mesh the code and its bits are as before.
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
    grad_compress: bool = False  # int8 error-feedback cross-pod exchange (train/grad_compress.py)


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
    """Zero moments shaped as ``params``; ``step`` a 0-d int32 on their device;
    with ``grad_compress`` also the error-feedback residual ``ef`` (zeros, as
    ``train.step.opt_state_specs`` lays it out)."""
    device = _leaves(params)[0].device
    out = {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "m": _map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
        "v": _map(lambda p: _second_moment_init(p, cfg.factored), params),
    }
    if cfg.grad_compress:
        out["ef"] = _map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    return out


def _axes_of(placement) -> tuple[str, ...]:
    """The mesh axes a placement splits a leaf over."""
    from repro_torch.distributed.sharding import axis_names_of

    return tuple(a for ent in placement for a in axis_names_of(ent))


def global_norm(tree: Any, mesh=None, placements: Any = None) -> torch.Tensor:
    """The gradient's global norm. On a mesh ``tree`` holds this rank's
    shards placed as ``placements``: the squares are summed over each leaf's
    split axes (one all-reduce per set of axes), so every rank gets the whole
    tree's norm."""
    if mesh is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                              for x in _leaves(tree)))
    from repro_torch.distributed import collectives as coll

    by_axes: dict[tuple, torch.Tensor] = {}
    for x, pl in zip(_leaves(tree), _leaves(placements)):
        key = tuple(a for a in mesh.axis_names if a in _axes_of(pl))
        sq = torch.sum(torch.square(x.to(torch.float32)))
        by_axes[key] = by_axes[key] + sq if key in by_axes else sq
    return torch.sqrt(sum(coll.all_reduce(sq, mesh, key or None)
                          for key, sq in sorted(by_axes.items())))


def _mean(x: torch.Tensor, dim: int, mesh, ax) -> torch.Tensor:
    """``x.mean(dim)`` over the global dim: where the dim is split over
    ``ax``, the local sums are reduced over it and divided by its size."""
    if mesh is None or mesh.extent(ax) == 1:
        return x.mean(dim)
    from repro_torch.distributed import collectives as coll

    return coll.all_reduce(x.sum(dim), mesh, ax) / (x.shape[dim] * mesh.extent(ax))


def _dim_axes(placement, ndim: int) -> tuple:
    """(axis entry of dim -2, of dim -1) of a leaf of ``ndim`` dims."""
    ents = tuple(placement) + (None,) * (ndim - len(placement))
    return ents[-2], ents[-1]


def _update_moment_v(v, g2: torch.Tensor, b2: float, mesh=None, placement=()):
    if _is_factored(v):
        ax_r, ax_c = _dim_axes(placement, g2.ndim)
        return {"vr": b2 * v["vr"] + (1 - b2) * _mean(g2, -1, mesh, ax_c),
                "vc": b2 * v["vc"] + (1 - b2) * _mean(g2, -2, mesh, ax_r)}
    return b2 * v + (1 - b2) * g2


def _precondition(v, g: torch.Tensor, eps: float, mesh=None, placement=()) -> torch.Tensor:
    if _is_factored(v):  # v ≈ vr·vc / mean(vr)
        r = v["vr"][..., None]
        c = v["vc"][..., None, :]
        ax_r, _ = _dim_axes(placement, g.ndim)
        vr_mean = _mean(v["vr"], -1, mesh, ax_r)
        denom = r * c / torch.clamp(vr_mean[..., None, None], min=1e-30)
        return g / (torch.sqrt(denom) + eps)
    return g / (torch.sqrt(v) + eps)


@torch.no_grad()
def apply_updates(params: dict, grads: dict, state: dict, cfg: OptConfig, *,
                  mesh=None, placements: Any = None) -> tuple[dict, dict]:
    """One AdamW step: clip → moments → bias-correct → decoupled decay.
    Returns new (params, state); the inputs are not modified. On a ``mesh``,
    ``params``, ``grads`` and the moments are this rank's shards, placed as
    ``placements`` (a tree like ``params``). An ``ef`` entry of the state
    passes through."""
    if mesh is None:
        placements = _map(lambda p: (), params)
    step = state["step"] + 1
    scale = 1.0
    if cfg.grad_clip:
        gn = global_norm(grads, mesh, placements)
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-9), max=1.0)
    grads = _map(lambda g: g.to(torch.float32) * scale, grads)

    m = _map(lambda g, m_: cfg.b1 * m_ + (1 - cfg.b1) * g, grads, state["m"])
    v = _map(lambda g, v_, pl: _update_moment_v(v_, torch.square(g), cfg.b2, mesh, pl),
             grads, state["v"], placements)
    stepf = step.to(torch.float32)
    bc1 = 1 - cfg.b1 ** stepf
    bc2 = 1 - cfg.b2 ** stepf
    lr = lr_schedule(cfg)(step)

    def upd(p, m_, v_, pl):
        mhat = m_ / bc1
        vhat = {key: x / bc2 for key, x in v_.items()} if _is_factored(v_) else v_ / bc2
        pf = p.to(torch.float32)
        pre = _precondition(vhat, mhat, cfg.eps, mesh, pl)
        return (pf - lr * (pre + cfg.weight_decay * pf)).to(p.dtype)

    out = {"step": step, "m": m, "v": v}
    if "ef" in state:
        out["ef"] = state["ef"]
    return _map(upd, params, m, v, placements), out
