"""Surrogate-gradient training loop for the spiking models (port of
``repro/snn/train.py``).

A step runs ``models.apply`` with plain matmuls under autograd (the LIF
layers take their differentiable loop, the surrogate an
``autograd.Function``; ``attn="flash"`` sites the flash backward), adds an
optional regularizer of the activations captured in the same forward, takes
``torch.autograd.grad`` over the weights and applies one optimizer update.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.snn import models
from repro_torch.snn.models import Params, SNNConfig
from repro_torch.train import optimizer as opt
from repro_torch.utils import log, resolve_device

Regularizer = Callable[[Params, dict], torch.Tensor]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return -torch.take_along_dim(logp, labels[:, None].long(), dim=-1).mean()


def loss_and_grads(params: Params, cfg: SNNConfig, x: torch.Tensor, y: torch.Tensor,
                   regularizer: Regularizer | None = None
                   ) -> tuple[Params, tuple[torch.Tensor, torch.Tensor]]:
    """Gradients of cross-entropy (+ regularizer) over every weight, and the
    (loss, accuracy) of the batch without the regularizer: the port of
    ``jax.grad(loss_fn, has_aux=True)`` in the reference's train step.

    ``regularizer(params, captured_spikes)`` sees the spike activations
    captured during the same forward pass (no second forward).
    """
    leaves = {name: {key: w.detach().requires_grad_() for key, w in leaf.items()}
              for name, leaf in params.items()}
    with torch.enable_grad():
        cap: dict | None = {} if regularizer is not None else None
        logits = models.apply(leaves, cfg, x, capture=cap)
        loss = cross_entropy(logits, y)
        total = loss + regularizer(leaves, cap) if regularizer is not None else loss
        flat = [(name, key, w) for name, leaf in leaves.items() for key, w in leaf.items()]
        grads = torch.autograd.grad(total, [w for _, _, w in flat])
    out: Params = {name: {} for name in leaves}
    for (name, key, _), g in zip(flat, grads):
        out[name][key] = g
    acc = (logits.detach().argmax(-1) == y).to(torch.float32).mean()
    return out, (loss.detach(), acc)


def make_train_step(cfg: SNNConfig, ocfg: opt.OptConfig,
                    regularizer: Regularizer | None = None):
    """A train step: ``step(params, state, x, y) -> (params, state, loss, acc)``."""

    def step(params, state, x, y):
        grads, (loss, acc) = loss_and_grads(params, cfg, x, y, regularizer)
        new_params, new_state = opt.apply_updates(params, grads, state, ocfg)
        return new_params, new_state, loss, acc

    return step


def train(
    cfg: SNNConfig,
    x: np.ndarray,
    y: np.ndarray,
    *,
    steps: int = 200,
    batch: int = 64,
    ocfg: opt.OptConfig | None = None,
    seed: int = 0,
    regularizer: Regularizer | None = None,
    params: Params | None = None,
    log_every: int = 50,
    device: str | torch.device | None = None,
):
    """Train a spiking model on (x, y); returns (params, history).

    Runs on ``device`` (default ``cuda``; ``utils.resolve_device``). Batch
    indices come from ``np.random.default_rng(seed).integers(0, n, batch)``,
    as in the reference; ``params=None`` draws weights from
    ``torch.Generator().manual_seed(seed)``. ``history`` holds one
    ``(loss, accuracy)`` pair of floats a step.
    """
    dev = resolve_device(device)
    ocfg = ocfg or opt.OptConfig(lr=1e-3, warmup_steps=20, decay_steps=steps, weight_decay=1e-4)
    if params is None:
        params = models.init(cfg, torch.Generator().manual_seed(seed), device=dev)
    # optimizer state only over weight sub-trees
    weights = {k: {kk: w.to(dev) for kk, w in v.items()}
               for k, v in params.items() if isinstance(v, dict)}
    state = opt.init(weights, ocfg)
    step_fn = make_train_step(cfg, ocfg, regularizer)
    hist: list[tuple[float, float]] = []
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    for i in range(steps):
        sl = rng.integers(0, n, batch)
        xb = torch.from_numpy(np.ascontiguousarray(x[sl])).to(dev)
        yb = torch.from_numpy(np.ascontiguousarray(y[sl])).to(dev)
        weights, state, loss, acc = step_fn(weights, state, xb, yb)
        hist.append((float(loss), float(acc)))
        if log_every and (i + 1) % log_every == 0:
            recent = np.asarray(hist[-log_every:])
            log.info("snn step %d loss %.4f acc %.3f", i + 1, *recent.mean(0))
    out = dict(params)
    out.update(weights)
    return out, hist


def evaluate(params: Params, cfg: SNNConfig, x: np.ndarray, y: np.ndarray,
             batch: int = 256) -> float:
    """Accuracy of ``params`` on (x, y), on the device the weights lie on.
    Runs under ``torch.no_grad()``, so the inference kernels (LIF) run."""
    dev = next(iter(params.values()))["w"].device
    correct = 0
    with torch.no_grad():
        for i in range(0, len(x), batch):
            logits = models.apply(params, cfg, torch.from_numpy(x[i:i + batch]).to(dev))
            correct += int((logits.argmax(-1).cpu().numpy() == y[i:i + batch]).sum())
    return correct / len(x)
