"""Token sampling: greedy / temperature / top-k, shared or per-slot (port of
``repro/serve/sampling.py``). Draws come from a ``torch.Generator``; the
reference's ``jax.random`` streams cannot be replayed, so sampled tokens
differ between the packages while greedy ones agree."""
from __future__ import annotations

import numpy as np
import torch


def sample(logits: torch.Tensor, gen: torch.Generator, *,
           temperature: float | np.ndarray | torch.Tensor = 0.0,
           top_k: int = 0) -> torch.Tensor:
    """logits (B, V) -> tokens (B,) int32.

    ``temperature`` is either a Python scalar shared by the whole batch or a
    (B,) array of per-slot temperatures. Slots with temperature <= 0 decode
    greedily (argmax, first index on ties) and are unaffected by the other
    slots' temperatures — batching a sampled request next to a greedy one
    must not perturb the greedy stream. ``gen`` lies on the logits' device.
    """
    if isinstance(temperature, (np.ndarray, torch.Tensor)):
        temps = torch.as_tensor(temperature, dtype=logits.dtype, device=logits.device)
        greedy = logits.argmax(-1).to(torch.int32)
        scaled = logits / torch.where(temps > 0.0, temps, 1.0)[:, None]
        sampled = _draw(scaled, gen, top_k)
        return torch.where(temps > 0.0, sampled, greedy)
    if temperature <= 0.0:
        return logits.argmax(-1).to(torch.int32)
    return _draw(logits / temperature, gen, top_k)


def _draw(logits: torch.Tensor, gen: torch.Generator, top_k: int) -> torch.Tensor:
    """One categorical draw per row (over the top ``top_k`` logits if > 0)."""
    if top_k:
        vals, idx = torch.topk(logits, top_k, dim=-1)
        draw = torch.multinomial(torch.softmax(vals.float(), -1), 1, generator=gen)
        return torch.gather(idx, 1, draw)[:, 0].to(torch.int32)
    probs = torch.softmax(logits.float(), -1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)
