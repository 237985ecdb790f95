"""The frozen arithmetic against numbers worked by hand."""
import json
from pathlib import Path

import pytest

from phibench import work as wk

CONFIGS = Path(__file__).resolve().parent / "configs"


def sizes(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())["sizes"]


def test_peaks_are_the_h100_data_sheet():
    assert wk.HBM_BYTES_PER_S == 3.35e12
    assert wk.BF16_FLOP_PER_S == 989e12
    assert wk.F32_FLOP_PER_S == 67e12
    assert wk.INT8_OPS_PER_S == 1979e12


def test_olmo_gemm_parameters():
    # 16 x (4 * 2048^2 + 3 * 2048 * 8192)
    assert wk.lm_gemm_params(sizes("olmo-1b-phi")) == 1_073_741_824


def test_spikformer_block_gemm_parameters():
    # 4 x (384 * 1152 + 384^2 + 2 * 384 * 1536)
    assert wk.snn_block_params(sizes("spikformer-4-384")) == 7_077_888


def test_spiking_gemm_counts_bits_weight_and_output_once():
    flops, nbytes = wk.spiking_gemm(8, 16, 4)
    assert flops == 2 * 8 * 16 * 4
    assert nbytes == 8 * 16 / 8 + 16 * 4 * 4 + 8 * 4 * 4
    assert wk.least_s(989e12, 0) == 1.0 and wk.least_s(0, 3.35e12) == 1.0


def test_olmo_prefill_of_2048_tokens():
    s = sizes("olmo-1b-phi")
    w = wk.lm_prefill(s, 2048)
    gemm = 2 * 4 * 2048 * 1_073_741_824                  # 1.76e13 a 2 048-token prefill
    attn = 16 * 2 * 2048 ** 2 * 2048                     # causal half of QK and PV
    head = 2 * 2048 * 50304
    assert w.gemm_flops == gemm
    assert w.flops == gemm + attn + head
    assert w.gemm_flops == pytest.approx(1.76e13, rel=2e-3)


def test_olmo_decode_step():
    s = sizes("olmo-1b-phi")
    w = wk.lm_decode_step(s, 32)
    assert w.flops == 32 * (2 * 4 * 1_073_741_824 + 2 * 2048 * 50304)
    assert wk.lm_decode_attention(s, 300) == 16 * 4 * 300 * 2048
    # 32 rows of four timesteps: the weights, read once a step, bound every GEMM
    assert w.gemm_least_s == pytest.approx(
        sum((K * N * 4 + 128 * K / 8 + 128 * N * 4) / 3.35e12
            for K, N in wk.lm_gemm_shapes(s)))


def test_spikformer_image():
    s = sizes("spikformer-4-384")
    w = wk.snn_batch(s, 1)
    gemm = 2 * 4 * 64 * 7_077_888 + 2 * 4 * 384 * 10
    stem = 2 * 4 * 64 * 48 * 384
    attn = 4 * 4 * 64 ** 2 * 384 * 4
    assert w.gemm_flops == gemm
    assert w.flops == gemm + stem + attn
    assert w.flops == pytest.approx(3.7e9, rel=0.02)       # 3.7 GFLOP an image
