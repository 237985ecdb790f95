"""Plain spiking Spikformer forward (Zhou et al., ICLR 2023) in float32.

The configuration's stem: each image is cut into 4 x 4 patches whose pixels,
repeated over ``timesteps``, are multiplied by the embedding weight (analog
input, no spikes). Each block: LIF -> qkv GEMM -> LIF on q, k and v per head
-> softmax attention of the binary q and k (scores scaled by head_dim^-0.5
after the product) over the binary v -> LIF -> proj GEMM, residual -> LIF ->
fc1 GEMM -> LIF -> fc2 GEMM, residual. The readout averages the tokens, runs
an LIF and the head GEMM, and averages the timesteps.

``gemm`` names the precision of every matmul: "float32" (TF32 off) is the
stated one, "float64" the same arithmetic with less rounding, "tf32" the
control. ``margin`` (B,), where given, receives each image's least distance
of a membrane potential from the threshold at the LIF after each attention:
its input is the only rounded one (binary spikes times weights on the 2^-10
grid sum exactly), so it alone can spike differently under another order of
the same float32 sums.
Weights: ``embed`` (48, D),
``b{i}_qkv`` (D, 3D), ``b{i}_proj`` (D, D), ``b{i}_fc1`` (D, 4D),
``b{i}_fc2`` (4D, D), ``head`` (D, classes).
"""
from __future__ import annotations

import torch

from phibench.reference.spiking import exact_float32, lif_spikes, matmul


def logits(weights: dict, sizes: dict, images: torch.Tensor, gemm: str = "float32",
           margin: torch.Tensor | None = None) -> torch.Tensor:
    """Logits (B, classes) of images (B, H, W, C), in float64 for
    ``gemm="float64"`` and float32 otherwise."""
    T, D, H = sizes["timesteps"], sizes["dim"], sizes["heads"]
    decay, thr = sizes["lif_decay"], sizes["lif_threshold"]
    B, size, _, C = images.shape
    hw = size // 4
    dh = D // H

    dtype = torch.float64 if gemm == "float64" else torch.float32

    def lif(x, rounded=False):                     # x (T, B, ...)
        return lif_spikes(x, decay, thr, margin if rounded else None)

    def heads(z):
        return z.reshape(T, B, -1, H, dh).permute(0, 1, 3, 2, 4)

    with exact_float32(), torch.no_grad():
        x = images.to(dtype)[None].expand(T, *images.shape)
        x = x.reshape(T, B, hw, 4, hw, 4, C).permute(0, 1, 2, 4, 3, 5, 6)
        h = matmul(x.reshape(T, B, hw * hw, 16 * C), weights["embed"], gemm)
        for b in range(sizes["blocks"]):
            qkv = matmul(lif(h), weights[f"b{b}_qkv"], gemm)
            q, k, v = (lif(heads(t)) for t in qkv.split(D, dim=-1))
            s = matmul(q, k.transpose(-1, -2), gemm) * dh ** -0.5
            attn = matmul(torch.softmax(s, -1), v, gemm)
            attn = attn.permute(0, 1, 3, 2, 4).reshape(T, B, -1, D)
            h = h + matmul(lif(attn, rounded=True), weights[f"b{b}_proj"], gemm)
            m = matmul(lif(h), weights[f"b{b}_fc1"], gemm)
            h = h + matmul(lif(m), weights[f"b{b}_fc2"], gemm)
        return matmul(lif(h.mean(2)), weights["head"], gemm).mean(0)
