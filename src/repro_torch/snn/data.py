"""Synthetic datasets for the paper-side SNN experiments.

A numpy copy of ``synthetic_images`` and ``batches`` from the reference
package's ``snn/data.py``: class-conditional spatial templates plus noise,
whose spike activations show the clustered binary statistics Phi exploits.
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


def batches(x: np.ndarray, y: np.ndarray, batch: int, seed: int = 0, epochs: int = 1):
    """Shuffled full batches of ``(x, y)`` for ``epochs`` passes."""
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    for _ in range(epochs):
        perm = rng.permutation(n)
        for i in range(0, n - batch + 1, batch):
            sl = perm[i : i + batch]
            yield x[sl], y[sl]
