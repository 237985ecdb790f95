"""LIF neurons with surrogate-gradient training support.

Forward: integrate, fire at threshold, reset. Backward: arctan surrogate on
the Heaviside firing function, as a ``torch.autograd.Function``. Inference
(no gradient needed) on CUDA goes through the LIF sequence kernel.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels.lif import lif_sequence_cuda


@dataclasses.dataclass(frozen=True)
class LIFConfig:
    decay: float = 0.5        # membrane leak (tau = 2 in spikingjelly terms)
    threshold: float = 1.0
    alpha: float = 2.0        # surrogate sharpness
    reset: str = "hard"       # "hard" | "soft"
    detach_reset: bool = True  # stop-grad through the reset path (standard)


class SpikeFn(torch.autograd.Function):
    """Heaviside(v − θ) with arctan surrogate gradient."""

    @staticmethod
    def forward(ctx, v_over: torch.Tensor, alpha: float) -> torch.Tensor:
        ctx.save_for_backward(v_over)
        ctx.alpha = alpha
        return (v_over >= 0.0).to(v_over.dtype)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (v_over,) = ctx.saved_tensors
        alpha = ctx.alpha
        surr = alpha / 2.0 / (1.0 + (math.pi / 2.0 * alpha * v_over) ** 2)
        return g * surr, None


spike_fn = SpikeFn.apply


def lif_update(v: torch.Tensor, x: torch.Tensor, cfg: LIFConfig
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """One differentiable LIF step. Returns (spike, v')."""
    v_int = v * cfg.decay + x
    s = spike_fn(v_int - cfg.threshold, cfg.alpha)
    s_reset = s.detach() if cfg.detach_reset else s
    if cfg.reset == "hard":
        v_new = v_int * (1.0 - s_reset)
    else:
        v_new = v_int - cfg.threshold * s_reset
    return s, v_new


def lif_sequence(x_seq: torch.Tensor, cfg: LIFConfig) -> torch.Tensor:
    """Run LIF over a leading time axis: (T, ...) currents -> (T, ...) spikes.

    Where no gradient is needed, the sequence kernel runs it (its plain
    version on CPU tensors); otherwise a differentiable loop of
    :func:`lif_update`. Both give the same spikes.
    """
    if not (torch.is_grad_enabled() and x_seq.requires_grad):
        return lif_sequence_cuda(x_seq, decay=cfg.decay, threshold=cfg.threshold,
                                 reset=cfg.reset)
    v = torch.zeros_like(x_seq[0])
    spikes = []
    for x in x_seq:
        s, v = lif_update(v, x, cfg)
        spikes.append(s)
    return torch.stack(spikes)
