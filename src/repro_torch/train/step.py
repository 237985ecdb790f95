"""LM train and serve steps, single device (port of ``repro/train/step.py``).

The reference wires its steps with ``pjit`` shardings resolved from the
logical-axis rules; here one device holds everything, so these
return plain functions and the specs they were built from. The mesh half
(``batch_shardings``, ``state_sharding_for_leaf``,
``decode_state_shardings``, the cross-pod compressed gradients) waits for
the multi-device port.

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

from repro_torch.distributed.sharding import ParamSpec
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


def make_prefill(cfg: ModelConfig) -> tuple[Callable, dict]:
    """(prefill_fn(params, batch) -> (last logits, decode state), param specs)."""
    param_specs = model.lm_specs(cfg)

    @torch.no_grad()
    def prefill_fn(params, batch):
        return model.prefill(cfg, params, batch)

    return prefill_fn, param_specs


def make_decode_step(cfg: ModelConfig) -> tuple[Callable, dict]:
    """(decode_fn(params, token, pos, caches, embeds=None) -> (logits,
    caches), param specs); the caches are written in place."""
    param_specs = model.lm_specs(cfg)

    @torch.no_grad()
    def decode_fn(params, token, pos, caches, embeds=None):
        return model.decode_step(cfg, params, token, pos, caches, embeds=embeds)

    return decode_fn, param_specs
