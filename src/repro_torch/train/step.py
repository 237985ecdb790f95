"""LM train and serve steps (port of ``repro/train/step.py``).

The reference wires its steps with ``pjit`` shardings resolved from the
logical-axis rules. Here the steps are plain functions. The serving builders
(:func:`make_prefill`, :func:`make_decode_step`) take an optional mesh: with
one they run under ``use_rules(rules, mesh)`` and an ``spmd_region`` on the
rank's shards and also return the placements (``model.param_shardings``,
:func:`batch_shardings`). :func:`state_sharding_for_leaf` and
:func:`decode_state_shardings` place the decode state. The train step runs on
one device; its mesh half and the cross-pod compressed gradients are not
ported yet.

The train step takes the trainable half's gradients with autograd. The Phi
state (``phi_*``: int8 patterns, PWP banks, usage histograms) is frozen: it
is split off before the loss, never requires grad, gets no optimizer state
and is merged back uncopied. Under autograd every Phi GEMM resolves the
differentiable ``coo`` lowering (``autodiff_or_vmap``), the rate coding
takes the LIF loop, and attention at S > 1024 records
``autodiff_keeps_flash``: the reference's ``autodiff_region`` reads here as
the operands' ``requires_grad``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import ParamSpec
from repro_torch.kernels import dispatch
from repro_torch.models import model
from repro_torch.models.config import ModelConfig
from repro_torch.train import optimizer as opt


def _tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` over the leaves of nested dicts, keeping every (also empty) dict."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# ----------------------------------------------------------- opt state specs
def opt_state_specs(param_specs: Any, ocfg: opt.OptConfig) -> dict:
    """ParamSpec tree for the optimizer state (so it shards like params)."""

    def m_spec(s: ParamSpec) -> ParamSpec:
        return ParamSpec(s.shape, s.axes, torch.float32, init="zeros")

    def v_spec(s: ParamSpec):
        if ocfg.factored and len(s.shape) >= 2:
            return {
                "vr": ParamSpec(s.shape[:-1], s.axes[:-1], torch.float32, init="zeros"),
                "vc": ParamSpec(s.shape[:-2] + s.shape[-1:], s.axes[:-2] + s.axes[-1:],
                                torch.float32, init="zeros"),
            }
        return m_spec(s)

    out = {
        "step": ParamSpec((), (), torch.int32, init="zeros"),
        "m": _tree_map(m_spec, param_specs),
        "v": _tree_map(v_spec, param_specs),
    }
    if ocfg.grad_compress:  # error-feedback residual, replicated across pods
        out["ef"] = _tree_map(m_spec, param_specs)
    return out


# ------------------------------------------------------------------- steps
@dataclasses.dataclass
class StepBundle:
    """``fn(params, opt_state, batch) -> (params, opt_state, loss)``: one
    optimizer step, functional (the inputs are not written). ``grads(params,
    batch) -> (loss, grads)`` is its first half: the loss and the gradients
    of the trainable half, a tree shaped like it."""

    fn: Callable
    grads: Callable


def make_train_step(cfg: ModelConfig, ocfg: opt.OptConfig
                    ) -> tuple[StepBundle, dict, dict]:
    """The single-device train step. Returns (bundle, param specs, optimizer
    state specs); the optimizer state mirrors only the TRAINABLE half."""
    param_specs = model.lm_specs(cfg)
    ostate_specs = opt_state_specs(model.split_phi_state(param_specs)[0], ocfg)

    def loss_and_grads(params: dict, batch: dict) -> tuple[torch.Tensor, dict]:
        trainable, phi_state = model.split_phi_state(params)
        flat: list[torch.Tensor] = []

        def leaf(w: torch.Tensor) -> torch.Tensor:
            flat.append(w.detach().requires_grad_())
            return flat[-1]

        leaves = _tree_map(leaf, trainable)
        with torch.enable_grad():
            loss = model.train_loss(cfg, model.merge_phi_state(leaves, phi_state), batch)
            gs = iter(torch.autograd.grad(loss, flat, allow_unused=True))

        def grad(w: torch.Tensor) -> torch.Tensor:
            # a leaf off the forward (the token embedding of a frame
            # frontend) gets zeros, as jax.grad gives it
            g = next(gs)
            return torch.zeros_like(w) if g is None else g

        return loss.detach(), _tree_map(grad, leaves)

    def train_step(params: dict, opt_state: dict, batch: dict):
        loss, grads = loss_and_grads(params, batch)
        trainable, phi_state = model.split_phi_state(params)
        new_t, new_opt = opt.apply_updates(trainable, grads, opt_state, ocfg)
        return model.merge_phi_state(new_t, phi_state), new_opt, loss

    return StepBundle(fn=train_step, grads=loss_and_grads), param_specs, ostate_specs


# ------------------------------------------------------------- batch specs
def batch_shardings(cfg: ModelConfig, mesh, rules: dict) -> Callable:
    """The placement of an input batch leaf by its key: rows over the
    ``batch`` axes (as a tuple, the reference's ``PartitionSpec``)."""
    bd = (shd.resolve_spec(("batch",), rules, mesh) or (None,))[0]

    def spec(k: str) -> tuple:
        if k in ("patch_embeds", "frame_embeds"):
            return (bd, None, None)
        return (bd, None)

    return spec


# -------------------------------------------------------- decode state specs
def state_sharding_for_leaf(cfg: ModelConfig, shape: tuple, mesh, rules: dict, batch: int,
                            batch_dim: int | None = None) -> tuple:
    """Pattern-match a decode-state leaf to its placement (one entry a dim).

    KV caches (..., B, S, H, hd): batch → the ``batch`` axes, heads →
    'model'. SSM states (..., B, H, P, N): heads → 'model'. Conv states
    (..., B, k-1, C=d_inner): channels → 'model'. Then the divisibility
    fallback. The batch dim is the first of size ``batch``, as the
    reference finds it, unless ``batch_dim`` names it: with as many stacked
    layers as batch rows the first match is the layer axis."""
    bd = (shd.resolve_spec(("batch",), rules, mesh) or (None,))[0]
    tp = (shd.resolve_spec(("heads",), rules, mesh) or (None,))[0]
    axes: list = [None] * len(shape)
    b_i = batch_dim if batch_dim is not None else next(
        (i for i, s in enumerate(shape) if s == batch), None)
    if b_i is not None:
        axes[b_i] = bd
        if len(shape) >= b_i + 4 and shape[b_i + 3] == cfg.hd and \
                shape[b_i + 2] == cfg.kv_heads_padded:
            axes[b_i + 2] = tp                      # kv cache heads
        elif cfg.ssm_state and len(shape) == b_i + 4 and \
                shape[b_i + 1] == cfg.ssm_heads and shape[b_i + 3] == cfg.ssm_state:
            axes[b_i + 1] = tp                      # ssm state heads
        elif cfg.ssm_state and len(shape) == b_i + 3 and shape[b_i + 2] == cfg.d_inner:
            axes[b_i + 2] = tp                      # conv_x channels
    # divisibility fallback (batch 1, odd head counts, ...)
    for i, ax in enumerate(axes):
        if ax is not None and shape[i] % shd.axis_size(mesh, ax) != 0:
            axes[i] = None
    return tuple(axes)


def _leaf_shardings(cfg: ModelConfig, state_specs: Any, mesh, rules: dict,
                    batch: int) -> list[tuple]:
    """The placement of each leaf of a decode-state tree, in
    ``model.state_leaves`` order, each leaf's batch dim taken from
    ``model.state_batch_axes``."""
    dims = model.state_leaves(model.state_batch_axes(cfg, state_specs))
    return [state_sharding_for_leaf(cfg, tuple(s.shape), mesh, rules, batch, batch_dim=d)
            for s, d in zip(model.state_leaves(state_specs), dims)]


def decode_state_shardings(cfg: ModelConfig, state_specs: Any, mesh, rules: dict,
                           batch: int) -> Any:
    """:func:`state_sharding_for_leaf` over a decode-state tree (specs or
    tensors; same structure, a placement at each leaf), each leaf's batch
    dim taken from ``model.state_batch_axes``."""
    it = iter(_leaf_shardings(cfg, state_specs, mesh, rules, batch))
    return model.map_state(lambda _: next(it), state_specs)


def init_decode_state(cfg: ModelConfig, batch: int, context: int, mesh=None,
                      rules: dict | None = None,
                      device: str | torch.device | None = None) -> tuple[Any, list | None]:
    """Zero decode state of ``batch`` slots: on a mesh, this rank's shards of
    it. Returns (state, the leaves' placements in ``model.state_leaves``
    order), the placements None off a mesh."""
    specs = model.decode_state_specs(cfg, batch, context)
    if mesh is None:
        return model.init_decode_state(cfg, batch, context, device), None
    placements = _leaf_shardings(cfg, specs, mesh, rules or shd.SERVE_RULES, batch)
    it = iter(placements)
    local = model.map_state(
        lambda s: model.TensorSpec(shd.local_shape(s.shape, next(it), mesh), s.dtype), specs)
    return model._zeros(local, mesh.device if device is None else device), placements


# ----------------------------------------------------------------- serving
def _serving(mesh, rules):
    """The context a serving step runs in: the mesh's rules and an SPMD
    region, or nothing off a mesh."""
    import contextlib

    if mesh is None:
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(shd.use_rules(rules, mesh))
    stack.enter_context(dispatch.spmd_region())
    return stack


def make_prefill(cfg: ModelConfig, mesh=None, rules: dict | None = None) -> tuple:
    """(prefill_fn(params, batch) -> (last logits, decode state), param specs)
    on one device; with a ``mesh`` (rules default ``SERVE_RULES``), also the
    params' placements and the batch's: (fn, specs, param placements, batch
    placement by key). On a mesh ``params`` are the rank's shards, the batch
    is global and the state the rank's."""
    param_specs = model.lm_specs(cfg)
    rules = rules or shd.SERVE_RULES

    @torch.no_grad()
    def prefill_fn(params, batch):
        with _serving(mesh, rules):
            return model.prefill(cfg, params, batch)

    if mesh is None:
        return prefill_fn, param_specs
    return (prefill_fn, param_specs, model.param_shardings(cfg, mesh, rules),
            batch_shardings(cfg, mesh, rules))


def make_decode_step(cfg: ModelConfig, mesh=None, rules: dict | None = None) -> tuple:
    """(decode_fn(params, token, pos, caches, embeds=None) -> (logits,
    caches), param specs) on one device; the caches are written in place.
    With a ``mesh``, also the params' placements and the tokens' and
    embeddings': (fn, specs, param placements, token placement, embeds
    placement)."""
    param_specs = model.lm_specs(cfg)
    rules = rules or shd.SERVE_RULES

    @torch.no_grad()
    def decode_fn(params, token, pos, caches, embeds=None):
        with _serving(mesh, rules):
            return model.decode_step(cfg, params, token, pos, caches, embeds=embeds)

    if mesh is None:
        return decode_fn, param_specs
    bd = (shd.resolve_spec(("batch",), rules, mesh) or (None,))[0]
    return (decode_fn, param_specs, model.param_shardings(cfg, mesh, rules), (bd,),
            (bd, None))
