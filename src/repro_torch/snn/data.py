"""Synthetic datasets for the paper-side SNN experiments.

A numpy copy of ``synthetic_images``, ``synthetic_event_frames``,
``synthetic_text_tokens`` and ``batches`` from the reference package's
``snn/data.py``: class-conditional spatial templates plus noise (and a
DVS-style frame stream of them), whose spike activations show the clustered
binary statistics Phi exploits, and class-conditional token streams.
"""
from __future__ import annotations

import numpy as np


def synthetic_images(
    n: int, num_classes: int = 10, size: int = 16, channels: int = 3, seed: int = 0,
    noise: float = 0.15,
) -> tuple[np.ndarray, np.ndarray]:
    """Class-templated images. Returns (x (n,H,W,C) f32 in [0,1], y (n,) i32)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    templates = []
    for c in range(num_classes):
        fx, fy = 1 + c % 4, 1 + (c // 4) % 4
        phase = c * 0.7
        t = 0.5 + 0.5 * np.sin(2 * np.pi * (fx * xx + fy * yy) + phase)
        # localized blob distinguishing high classes
        cy, cx = (c * 37) % size, (c * 53) % size
        blob = np.exp(-(((np.arange(size)[:, None] - cy) ** 2 +
                         (np.arange(size)[None, :] - cx) ** 2) / (2 * (size / 6) ** 2)))
        templates.append(0.6 * t + 0.4 * blob)
    templates = np.stack(templates)  # (C, H, W)
    y = rng.integers(0, num_classes, n).astype(np.int32)
    x = templates[y][..., None].repeat(channels, -1)
    x = x + noise * rng.standard_normal(x.shape)
    return np.clip(x, 0, 1).astype(np.float32), y


def synthetic_event_frames(
    n: int, num_classes: int = 10, size: int = 16, timesteps: int = 4, seed: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """DVS-style binary event frames: (n, T, H, W, 2) {0,1}, labels (n,)."""
    x, y = synthetic_images(n, num_classes, size, channels=1, seed=seed)
    rng = np.random.default_rng(seed + 1)
    frames = []
    for t in range(timesteps):
        shift = np.roll(x, t, axis=2)  # simple motion
        pos = (shift[..., 0] > rng.uniform(0.55, 0.75)).astype(np.float32)
        neg = (shift[..., 0] < rng.uniform(0.25, 0.45)).astype(np.float32)
        frames.append(np.stack([pos, neg], -1))
    return np.stack(frames, 1).astype(np.float32), y


def synthetic_text_tokens(
    n: int, num_classes: int = 2, seq_len: int = 32, vocab: int = 256, seed: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """SST-style classification: class-specific token unigram mixtures.
    Returns (x (n, seq_len) i32, y (n,) i32)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, n).astype(np.int32)
    logits = rng.standard_normal((num_classes, vocab)) * 1.5
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    x = np.stack([rng.choice(vocab, seq_len, p=probs[c]) for c in y])
    return x.astype(np.int32), y


def batches(x: np.ndarray, y: np.ndarray, batch: int, seed: int = 0, epochs: int = 1):
    """Shuffled full batches of ``(x, y)`` for ``epochs`` passes."""
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    for _ in range(epochs):
        perm = rng.permutation(n)
        for i in range(0, n - batch + 1, batch):
            sl = perm[i : i + batch]
            yield x[sl], y[sl]
