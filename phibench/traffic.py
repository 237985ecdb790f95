"""The general traffic generator: every file under ``workloads/`` is read here.

Every seed gets the same work in another order. Lengths are laid out in
blocks of ``block`` requests (a power of two): a block holds ``block``
prompt lengths spread evenly over [low, high] and, apart, ``block`` output
lengths spread evenly over theirs. Each list runs in bit-reversed order,
which mixes short and long in every stretch of it, so that a window that
ends inside a block still holds about the block's mean; the seed rotates
each list of each block by an offset of its own. Token ids are drawn from
the seed. Images are class templates plus noise, as the port's
synthetic CIFAR stand-in draws them, made on the device and rounded onto the
2^-10 grid.
"""
from __future__ import annotations

import numpy as np
import torch


def sub_seed(seed: int, *stream: int) -> int:
    """A 63-bit seed of its own for each stream of one run's seed."""
    ss = np.random.SeedSequence([seed & (2**64 - 1), seed >> 64, *stream])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> 1)


def spread(low: int, high: int, n: int) -> np.ndarray:
    """``n`` whole numbers spread evenly over [low, high]."""
    return low + ((2 * np.arange(n) + 1) * (high - low + 1)) // (2 * n)


def mixed_order(n: int) -> np.ndarray:
    """The bit-reversal permutation of range(n), n a power of two."""
    bits = n.bit_length() - 1
    if n != 1 << bits:
        raise ValueError(f"block {n} is not a power of two")
    return np.array([int(f"{i:0{bits}b}"[::-1] or "0", 2) for i in range(n)])


def lm_stream(traffic: dict, vocab: int, seed: int):
    """The endless stream of requests: {rid, tokens, max_new}."""
    block = traffic["block"]
    order = mixed_order(block)
    rng = np.random.default_rng(sub_seed(seed, 1))
    rid = 0
    while True:
        plens = spread(*traffic["prompt_len"], block)[np.roll(order, rng.integers(block))]
        news = spread(*traffic["new_tokens"], block)[np.roll(order, rng.integers(block))]
        for plen, new in zip(plens, news):
            yield {"rid": rid, "tokens": rng.integers(3, vocab, int(plen)), "max_new": int(new)}
            rid += 1


def buckets(traffic: dict) -> list[int]:
    """The power-of-two prefill buckets (capped at the context) that the
    stream's prompt lengths fall in, as the engine pads them."""
    plens = spread(*traffic["prompt_len"], traffic["block"])
    return sorted({min(1 << (int(p) - 1).bit_length(), traffic["max_context"])
                   for p in plens})


def _templates(num_classes: int, size: int) -> np.ndarray:
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    out = []
    for c in range(num_classes):
        fx, fy = 1 + c % 4, 1 + (c // 4) % 4
        t = 0.5 + 0.5 * np.sin(2 * np.pi * (fx * xx + fy * yy) + c * 0.7)
        cy, cx = (c * 37) % size, (c * 53) % size
        blob = np.exp(-(((np.arange(size)[:, None] - cy) ** 2
                         + (np.arange(size)[None, :] - cx) ** 2) / (2 * (size / 6) ** 2)))
        out.append(0.6 * t + 0.4 * blob)
    return np.stack(out).astype(np.float32)


def images(sizes: dict, n: int, seed: int, stream: int, device, noise: float = 0.15
           ) -> torch.Tensor:
    """``n`` images (n, H, W, C) in [0, 1] on the 2^-10 grid, on ``device``."""
    size, C = sizes["input_size"], sizes["input_channels"]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, stream))
    tpl = torch.as_tensor(_templates(sizes["num_classes"], size), device=device)
    y = torch.randint(0, sizes["num_classes"], (n,), generator=gen, device=device)
    x = tpl[y][..., None].expand(n, size, size, C)
    x = x + noise * torch.randn((n, size, size, C), generator=gen, device=device)
    return (x.clamp(0, 1) * 1024).round() / 1024
