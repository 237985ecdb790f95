"""The benchmark's own count of work, from the model's shapes, and the card's peaks.

A spiking GEMM of ``rows`` x K x N (``rows`` counts every timestep) is
2 * rows * K * N operations at the bfloat16 dense peak. Its bytes are the
binary spike rows once (one bit a spike), the float32 weight once and the
float32 output once. Its least time is the larger of the two bounds. The
count is the dense-equivalent work, whatever kernel computes the product:
a kernel that does the work another way leaves it valid. Attention is
counted at the causal half for the language model (its q and k are rate
decoded, so once) and at the full S^2 for each timestep of the Spikformer.
Only the work the requests need is counted: true prompt lengths, not the
bucket a prompt is padded to, and the active decode rows only.
"""
from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM, data sheet, dense (no sparsity), at the 700 W limit.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12
INT8_OPS_PER_S = 1979e12


@dataclasses.dataclass
class Work:
    """Operations of a stretch of work, and its spiking GEMMs' least time."""

    flops: float = 0.0
    gemm_flops: float = 0.0
    gemm_bytes: float = 0.0
    gemm_least_s: float = 0.0

    def add(self, other: "Work", times: float = 1.0) -> None:
        self.flops += other.flops * times
        self.gemm_flops += other.gemm_flops * times
        self.gemm_bytes += other.gemm_bytes * times
        self.gemm_least_s += other.gemm_least_s * times


def spiking_gemm(rows: float, K: int, N: int) -> tuple[float, float]:
    """(operations, bytes) of one spiking GEMM."""
    return 2.0 * rows * K * N, rows * K / 8.0 + K * N * 4.0 + rows * N * 4.0


def least_s(flops: float, nbytes: float) -> float:
    return max(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)


def _gemms(shapes, rows: float) -> Work:
    w = Work()
    for K, N in shapes:
        f, b = spiking_gemm(rows, K, N)
        w.flops += f
        w.gemm_flops += f
        w.gemm_bytes += b
        w.gemm_least_s += least_s(f, b)
    return w


def lm_gemm_shapes(sizes: dict) -> list[tuple[int, int]]:
    """(K, N) of every spiking GEMM of the decoder, layer by layer."""
    d, ff = sizes["d_model"], sizes["d_ff"]
    layer = [(d, d)] * 4 + [(d, ff), (d, ff), (ff, d)]
    return layer * sizes["n_layers"]


def lm_gemm_params(sizes: dict) -> int:
    return sum(K * N for K, N in lm_gemm_shapes(sizes))


def lm_prefill(sizes: dict, plen: int) -> Work:
    """One prompt of ``plen`` tokens: the GEMMs at every position, causal
    attention, and the head at the last position."""
    d, L = sizes["d_model"], sizes["n_layers"]
    w = _gemms(lm_gemm_shapes(sizes), sizes["timesteps"] * plen)
    w.flops += L * 2.0 * plen * plen * d + 2.0 * d * sizes["vocab"]
    return w


def lm_decode_step(sizes: dict, rows: int) -> Work:
    """One decode step of ``rows`` tokens: each GEMM once over every row
    (the weights read once), and the head; attention is counted per token
    (:func:`lm_decode_attention`)."""
    w = _gemms(lm_gemm_shapes(sizes), sizes["timesteps"] * rows)
    w.flops += rows * 2.0 * sizes["d_model"] * sizes["vocab"]
    return w


def lm_decode_attention(sizes: dict, context: int) -> float:
    """Operations of one decoded token's attention over ``context`` keys."""
    return sizes["n_layers"] * 4.0 * context * sizes["d_model"]


def snn_block_shapes(sizes: dict) -> list[tuple[int, int]]:
    D = sizes["dim"]
    return [(D, 3 * D), (D, D), (D, 4 * D), (4 * D, D)] * sizes["blocks"]


def snn_block_params(sizes: dict) -> int:
    return sum(K * N for K, N in snn_block_shapes(sizes))


def snn_batch(sizes: dict, batch: int) -> Work:
    """One batch of ``batch`` images through the Spikformer."""
    T, D = sizes["timesteps"], sizes["dim"]
    S = (sizes["input_size"] // 4) ** 2
    w = _gemms(snn_block_shapes(sizes), T * batch * S)
    w.add(_gemms([(D, sizes["num_classes"])], T * batch))
    w.flops += 2.0 * T * batch * S * 16 * sizes["input_channels"] * D      # analog stem
    w.flops += sizes["blocks"] * 4.0 * S * S * D * T * batch               # attention
    return w
