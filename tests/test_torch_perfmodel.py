"""repro_torch's hwconst, opcount, perfmodel and launch-cost crossover held
against the reference package's on the same inputs.

Statistics are the reference's ``phi_stats`` on binary activations made
from a seed with numpy (and the paper's own Table-4 VGG16/CIFAR100 row),
carried into the port's ``PhiStats`` field by field. Every output is a
closed form in Python floats: integers are compared exactly and floats at
a relative tolerance of 1e-12.
"""
from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import hwconst as RH
from repro.core import opcount as ROC
from repro.core import perfmodel as RP
from repro.core.assign import PhiStats as RPhiStats
from repro.core.assign import phi_stats as rphi_stats
from repro.kernels import ops as RO
from repro_torch.core import hwconst as H
from repro_torch.core import opcount as OC
from repro_torch.core import perfmodel as P
from repro_torch.core.assign import PhiStats

REL = 1e-12
ROOT = Path(__file__).resolve().parents[1]

# The reference's ASIC section (paper Table 1/3 and the per-access energies).
ASIC = ("FREQ", "DRAM_GBPS", "DRAM_BPC", "DRAM_PJ_PER_BYTE", "DRAM_STATIC_W", "CORE_POWER_W",
        "EYERISS_POWER_W", "MATCHER_WIDTH", "CHANNELS", "SIMD", "ARRAY_UTIL", "PE_EYERISS",
        "PWP_BUFFER_KB", "PACKER_CAP", "PACKER_RATE", "E_MATCH_PJ", "E_SIMD_OP_PJ", "E_PACK_PJ",
        "E_SRAM_RD_PJ_B", "E_SRAM_WR_PJ_B", "E_MAC_PJ")

# The paper's Table 4 VGG16/CIFAR100 row, as the reference's
# benchmarks/table2_accel.py plugs it in: bit 10.6%, L1 9.1%, L2 1.6+0.2%.
PAPER_VGG = dict(bit_density=0.106, l1_density=0.091, l2_pos_density=0.016,
                 l2_neg_density=0.002, idx_density=0.5066, rows=1024, cols=256)

SHAPES = [(1024, 256, 128), (1000, 144, 100), (37, 576, 10), (32768, 576, 128), (1, 512, 100),
          (300, 4608, 512)]
BANKS = [(16, 128), (9, 64), (16, 7)]


def same(got, want, path="") -> None:
    """Equal: ints and strings exactly, floats at REL, containers and
    dataclasses field by field."""
    if dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__, path
        for f in dataclasses.fields(want):
            same(getattr(got, f.name), getattr(want, f.name), f"{path}.{f.name}")
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for key in want:
            same(got[key], want[key], f"{path}[{key!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, (float, int)), path
        assert got == pytest.approx(want, rel=REL, abs=0.0), path
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def _stats(seed: int, M: int, K: int, k: int, q: int) -> tuple[PhiStats, RPhiStats]:
    """Reference ``phi_stats`` of clustered binary activations against a bank
    drawn from their rows, and the same numbers as the port's PhiStats."""
    rng = np.random.default_rng(seed)
    protos = (rng.random((12, K)) < 0.15).astype(np.float32)
    a = np.abs(protos[rng.integers(0, 12, M)] - (rng.random((M, K)) < 0.03)).astype(np.float32)
    pats = a[rng.integers(0, M, q)].reshape(q, K // k, k).transpose(1, 0, 2).astype(np.uint8)
    ref = rphi_stats(jnp.asarray(a), jnp.asarray(pats, jnp.float32))
    return PhiStats(**dataclasses.asdict(ref)), ref


def _pair(**fields) -> tuple[PhiStats, RPhiStats]:
    return PhiStats(**fields), RPhiStats(**fields)


# ----------------------------------------------------------------- hwconst ---
@pytest.mark.parametrize("name", ASIC)
def test_hwconst_asic_section_equals_the_reference(name):
    got, want = getattr(H, name), getattr(RH, name)
    assert type(got) is type(want) and got == want


def test_hwconst_holds_no_tpu_constant_and_names_the_h100():
    tpu = {"PALLAS_LAUNCH_BYTES", "VMEM_BUDGET_BYTES", "TPU_PEAK_FLOPS", "TPU_HBM_BW",
           "TPU_ICI_BW"}
    assert not tpu & set(vars(H))
    assert not {n for n in vars(H) if "TPU" in n or "VMEM" in n or "PALLAS" in n}
    assert (H.HBM_BYTES_PER_S, H.F32_FLOP_PER_S, H.INT8_OPS_PER_S) == (3.35e12, 67e12, 1979e12)
    assert (H.SMEM_PER_BLOCK, H.SM_SMEM, H.SM_SMEM_PER_BLOCK_RESERVED, H.SM_COUNT) == (
        232448, 228 * 1024, 1024, 132)
    assert isinstance(H.KERNEL_LAUNCH_BYTES, int) and H.KERNEL_LAUNCH_BYTES > 0


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_module", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_card_constants_have_one_source():
    """Every copy of the card's constants is hwconst's object, under its old
    local name: no value changed, so every gate and tile choice stays."""
    from repro_torch.kernels import ops, phi_attention, phi_fused

    cs = _chip_smoke()
    assert cs.HBM_BYTES_PER_S is H.HBM_BYTES_PER_S
    assert cs.F32_FLOP_PER_S is H.F32_FLOP_PER_S
    assert cs.INT8_OPS_PER_S is H.INT8_OPS_PER_S
    assert phi_fused.SMEM_LIMIT is H.SMEM_PER_BLOCK and phi_fused.SMEM_LIMIT == 232448
    assert phi_attention.SMEM_LIMIT is H.SMEM_PER_BLOCK
    assert ops._SM_SMEM is H.SM_SMEM and ops._SM_SMEM == 228 * 1024
    assert ops._SM_SMEM_PER_BLOCK is H.SM_SMEM_PER_BLOCK_RESERVED


# ----------------------------------------------------------------- opcount ---
@pytest.mark.parametrize("k,q", BANKS)
@pytest.mark.parametrize("n,bytes_per_el", [(128, 2), (10, 1), (384, 4)])
def test_opcounts_and_preprocessing_benefit_match_the_reference(k, q, n, bytes_per_el):
    st, rst = _stats(k + q, 300, 36 * k, k, q)
    got = OC.matmul_opcounts(st, n=n, k=k, q=q, bytes_per_el=bytes_per_el)
    want = ROC.matmul_opcounts(rst, n=n, k=k, q=q, bytes_per_el=bytes_per_el)
    same(got, want)
    for prop in ("phi_total_strict", "speedup_over_bit", "speedup_over_dense",
                 "speedup_over_bit_strict"):
        same(getattr(got, prop), getattr(want, prop), prop)
    same(OC.preprocessing_benefit(got), ROC.preprocessing_benefit(want))


# ------------------------------------------------------ cycle/energy model ---
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("k,q", BANKS[:2])
def test_phi_and_eyeriss_layers_match_the_reference(shape, k, q):
    st, rst = _stats(sum(shape), 256, 16 * k, k, q)
    g, rg = P.GemmShape(*shape), RP.GemmShape(*shape)
    for kw in ({}, dict(bytes_per_el=2, pwp_util=0.5, timesteps=2, batch=3)):
        same(P.phi_layer(g, st, k=k, q=q, **kw), RP.phi_layer(rg, rst, k=k, q=q, **kw))
    for kw in ({}, dict(bytes_per_el=2, timesteps=1, batch=5)):
        same(P.eyeriss_layer(g, st, **kw), RP.eyeriss_layer(rg, rst, **kw))


@pytest.mark.parametrize("which", ["measured", "paper_densities"])
def test_summarize_and_compare_match_the_reference(which):
    shapes = P.vgg16_gemm_shapes()
    rshapes = RP.vgg16_gemm_shapes()
    if which == "paper_densities":
        pairs = [_pair(**PAPER_VGG)] * len(shapes)
    else:
        pairs = [_stats(i, 200, 144, 9, 64) for i in range(len(shapes))]
    stats, rstats = [p for p, _ in pairs], [r for _, r in pairs]
    same(P.compare(shapes, stats), RP.compare(rshapes, rstats))
    layers = [P.phi_layer(s, st) for s, st in zip(shapes, stats)]
    rlayers = [RP.phi_layer(s, st) for s, st in zip(rshapes, rstats)]
    same(P.summarize(layers), RP.summarize(rlayers))
    same(P.summarize(layers, core_power=P.EYERISS_POWER_W),
         RP.summarize(rlayers, core_power=RP.EYERISS_POWER_W))
    assert P.REPORTED == RP.REPORTED and P.PAPER_PHI == RP.PAPER_PHI


# ---------------------------------------------------------- traffic models ---
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("k,q", BANKS)
@pytest.mark.parametrize("usage,prepass", [(None, True), (0.3, True), (0.3, False)])
def test_kernel_traffic_matches_the_reference_field_by_field(shape, k, q, usage, prepass):
    M, K, N = shape
    K = K // k * k or k
    blocks = [{}, dict(block_m=32, block_n=128), dict(block_m=100, block_n=64, nnz_budget=0.02,
                                                       pwp_bytes_per_el=2, w_bytes_per_el=1)]
    for kw in blocks:
        got = P.phi_kernel_traffic(P.GemmShape(M, K, N), k=k, q=q, pwp_usage=usage,
                                   prefetch_prepass=prepass, **kw)
        want = RP.phi_kernel_traffic(RP.GemmShape(M, K, N), k=k, q=q, pwp_usage=usage,
                                     prefetch_prepass=prepass, **kw)
        same(got, want)
        for entry in want:
            same(got[entry].total, want[entry].total, entry)
    for kw in ({}, dict(nnz_budget=0.02, pwp_bytes_per_el=2, w_bytes_per_el=1)):
        same(P.phi_coo_traffic(P.GemmShape(M, K, N), k=k, q=q, **kw),
             RP.phi_coo_traffic(RP.GemmShape(M, K, N), k=k, q=q, **kw))


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("row_parallel", [True, False])
@pytest.mark.parametrize("usage", [None, 0.25])
def test_sharded_traffic_matches_the_reference(shards, row_parallel, usage):
    for M, K, N in [(2048, 1024, 512), (7, 512, 256)]:
        got = P.phi_sharded_traffic(P.GemmShape(M, K, N), shards=shards,
                                    row_parallel=row_parallel, pwp_usage=usage)
        want = RP.phi_sharded_traffic(RP.GemmShape(M, K, N), shards=shards,
                                      row_parallel=row_parallel, pwp_usage=usage)
        same(got, want)


@pytest.mark.parametrize("s,d,heads,batch,l2", [(64, 32, 12, 32, 0.03), (256, 64, 2, 1, 0.026),
                                                (100, 48, 3, 2, 0.068), (8, 16, 1, 1, 0.5)])
def test_attention_traffic_matches_the_reference(s, d, heads, batch, l2):
    for kw in ({}, dict(k=8, q=64, block_q=32, block_kv=64)):
        same(P.phi_attention_traffic(s, d, heads=heads, batch=batch, l2_density=l2, **kw),
             RP.phi_attention_traffic(s, d, heads=heads, batch=batch, l2_density=l2, **kw))


@pytest.mark.parametrize("img,classes", [(32, 100), (32, 10), (64, 1000)])
def test_vgg16_gemm_shapes_match_the_reference(img, classes):
    same(P.vgg16_gemm_shapes(img, classes), RP.vgg16_gemm_shapes(img, classes))


@pytest.mark.parametrize("dtype_bytes", [2, 4])
def test_cache_and_obs_models_match_the_reference(dtype_bytes):
    kw = dict(n_scan=3, kv_heads=4, head_dim=64, dtype_bytes=dtype_bytes)
    same(P.kv_cache_bytes(slots=8, context=512, **kw), RP.kv_cache_bytes(slots=8, context=512,
                                                                         **kw))
    same(P.paged_pool_bytes(num_pages=40, page_size=16, **kw),
         RP.paged_pool_bytes(num_pages=40, page_size=16, **kw))
    for args in (dict(trace_bytes=12345, metrics_bytes=678, decoded_tokens=97,
                      payload_bytes=10 ** 7),
                 dict(trace_bytes=0, metrics_bytes=0, decoded_tokens=0, payload_bytes=0)):
        same(P.obs_overhead_report(**args), RP.obs_overhead_report(**args))


# ------------------------------------------------------ launch-cost crossover ---
@pytest.mark.parametrize("k_dim,n,t,q", [(576, 128, 36, 128), (4608, 512, 288, 128),
                                         (384, 384, 24, 128), (512, 10, 32, 128),
                                         (144, 100, 16, 64)])
@pytest.mark.parametrize("usage", [None, 0.25])
def test_launch_cost_crossover_matches_the_reference_at_its_constant(monkeypatch, k_dim, n,
                                                                     t, q, usage):
    """At the reference's 64 KiB launch constant, the port decides as the
    reference does at every M of the grid (which spans both sides)."""
    from repro_torch.kernels import ops

    monkeypatch.setattr(H, "KERNEL_LAUNCH_BYTES", RH.PALLAS_LAUNCH_BYTES)
    assert RH.PALLAS_LAUNCH_BYTES == 64 * 1024
    decisions = []
    for m in (1, 2, 4, 8, 16, 32, 64, 128, 512, 2048, 8192, 32768):
        got = ops.launch_cost_prefers_coo(m, k_dim, n, t, q, pwp_usage=usage)
        want = RO.launch_cost_prefers_coo(m, k_dim, n, t, q, pwp_usage=usage)
        assert got is want, m
        decisions.append(got)
    assert decisions[0] and not decisions[-1]


def test_launch_cost_crossover_reads_the_h100_constant():
    """With the measured H100 constant the crossover moves to larger M than
    at the reference's 64 KiB (a larger launch favours the coo path)."""
    from repro_torch.kernels import ops

    flips = [m for m in range(1, 4097) if ops.launch_cost_prefers_coo(m, 576, 128, 36, 128)]
    rflips = [m for m in range(1, 4097) if RO.launch_cost_prefers_coo(m, 576, 128, 36, 128)]
    assert max(flips) >= max(rflips)
