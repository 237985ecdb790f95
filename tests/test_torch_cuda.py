"""Hopper kernels of repro_torch against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA card: a CUDA
kernel has no CPU mode. The file imports neither JAX nor the reference
package, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance 0 for the three fused matmul kernels and the LIF kernels: with
dyadic weights every partial sum is exact, and the kernels round each
product and sum separately as the plain versions do. Tolerance 0 also for
the per-unit kernels of the ``pallas`` lowering: the matcher is integer
work, and the gather and the spmm sum each output from zero in the plain
versions' order (ascending partition; entry order, which the plain spmm keeps
on the CPU), so they are bitwise on any f32 data. The attention kernel's scores and ``l2_nnz`` are
exact too (binary Q and K), but its softmax sums ``p`` and ``p·V`` in
another order than the plain version and uses CUDA's ``expf``: its output
is held to ATTN_ATOL_ULPS ulps of max|V| (each output is a convex
combination of V rows). Its Phi and dense instantiations share the softmax
code and are compared bitwise. The dense instantiation's ``lse`` (the
forward of ``models.flash.flash_attention`` under autograd) is held to
LSE_ATOL_ULPS ulps of max(1, max|lse|), m + log(den) in another order; the
flash backward's gradients against plain autograd through
``_flash_fwd_impl`` to GRAD_REL of each gradient's largest magnitude, and so
are one VGG train step's gradients on the card against the CPU's (identical
spikes, another order of the backward's sums).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core.patterns import PhiConfig, calibrate, pattern_weight_products, quantize_pwp
from repro_torch.kernels import _build, dispatch, ops, ref
from repro_torch.kernels.lif import lif_sequence_cuda, lif_sequence_plain, lif_step_cuda
from repro_torch.kernels.phi_attention import (
    flash_attention_cuda, phi_flash_attention_cuda, phi_flash_attention_plain, smem_bytes)
from repro_torch.core.assign import pack_l2_coo_jit
from repro_torch.kernels.matcher import matcher_cuda, matcher_plain, matcher_plan
from repro_torch.kernels.phi_fused import (
    fused_smem_bytes, pack_patterns, phi_fused_cuda, phi_fused_plain, phi_fused_prefetch_cuda,
    phi_fused_prefetch_plain, phi_fused_stream_cuda, stream_smem_bytes, stripe_active_sets)
from repro_torch.kernels.phi_gather import (
    check_range_flag, l1_gather_cuda, l1_gather_plain, make_range_flag, range_flag_to_host)
from repro_torch.kernels.phi_spmm import l2_spmm_cuda, l2_spmm_plain
from repro_torch.core import paft
from repro_torch.core.assign import assign_patterns, level1_matrix
from repro_torch.models import flash as flash_mod
from repro_torch.models.flash import flash_attention
from repro_torch.sim import trace as sim_trace
from repro_torch.snn import models as M
from repro_torch.snn import train as snn_train
from repro_torch.snn.data import synthetic_images

_FUSED = {"fused": phi_fused_cuda, "fused_stream": phi_fused_stream_cuda,
          "fused_prefetch": phi_fused_prefetch_cuda}
_UNITS = (matcher_cuda, l1_gather_cuda, l2_spmm_cuda)


def _gate_launches(params, state, acts):
    """Launches one phi_apply makes of each fused kernel: the gate's answer
    per calibrated GEMM, from its shape and calibration usage."""
    want = dict.fromkeys(_FUSED, 0)
    for name, act in acts.items():
        if not name.endswith("_attn"):
            T, q = state.patterns[name].shape[:2]
            want[ops.fused_shape_viable(act.shape[0], act.shape[1],
                                        params[name]["w"].shape[-1], T, q,
                                        usage=state.usage[name])] += 1
    return want

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (a CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _setup(M_, K, N, q, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    protos = (torch.rand((8, K), generator=g) < 0.3).float()
    a = protos[torch.randint(0, 8, (M_,), generator=g)]
    a = (a - (torch.rand((M_, K), generator=g) < 0.03).float()).abs()
    a = a.to(dev)
    w = (torch.round(torch.randn((K, N), generator=g) * 0.3 * 1024) / 1024).to(dev)
    pats = calibrate(a, PhiConfig(k=16, q=q, iters=3), device=dev)
    return a, w, pats, pattern_weight_products(pats, w)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("M_", [256, 293])
def test_fused_kernel_matches_plain(dev, kind, M_):
    a, w, pats, pwp = _setup(M_, 96, 72, 16, dev, seed=M_)
    scale = torch.ones(pwp.shape[:2], device=dev)
    if kind == "bf16":
        pwp = pwp.to(torch.bfloat16)
    elif kind == "int8":
        pwp, scale = quantize_pwp(pwp)
    before = phi_fused_cuda.launches
    out, nnz = phi_fused_cuda(a, pats, pwp, scale, w, block_m=64)
    assert phi_fused_cuda.launches == before + 1
    pout, pnnz = phi_fused_plain(a, pats, pwp, scale, w, block_m=64)
    torch.cuda.synchronize()
    assert torch.equal(out, pout) and torch.equal(nnz, pnnz) and int(nnz.sum()) > 0


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("M_,group_t", [(256, 8), (293, 8), (293, 4), (64, 1)])
def test_stream_kernel_matches_plain_and_the_first_kernel(dev, kind, M_, group_t):
    # K = 208: T = 13 partitions, so every group depth but 1 ends on a short group
    a, w, pats, pwp = _setup(M_, 208, 72, 16, dev, seed=M_ + group_t)
    scale = torch.ones(pwp.shape[:2], device=dev)
    if kind == "bf16":
        pwp = pwp.to(torch.bfloat16)
    elif kind == "int8":
        pwp, scale = quantize_pwp(pwp)
    before = phi_fused_stream_cuda.launches
    out, nnz = phi_fused_stream_cuda(a, pats, pwp, scale, w, block_m=64, group_t=group_t)
    assert phi_fused_stream_cuda.launches == before + 1
    pout, pnnz = phi_fused_plain(a, pats, pwp, scale, w, block_m=64)
    fout, fnnz = phi_fused_cuda(a, pats, pwp, scale, w, block_m=64)
    torch.cuda.synchronize()
    assert torch.equal(out, pout) and torch.equal(nnz, pnnz) and int(nnz.sum()) > 0
    assert torch.equal(out, fout) and torch.equal(nnz, fnnz)


def _banks(pwp, kind, dev):
    scale = torch.ones(pwp.shape[:2], device=dev)
    if kind == "bf16":
        return pwp.to(torch.bfloat16), scale
    if kind == "int8":
        return quantize_pwp(pwp)
    return pwp, scale


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("M_,N,density", [(293, 364, None), (64, 1000, None), (160, 130, None),
                                          (96, 1403, None), (128, 200, 0.5)])
def test_stream_kernel_clusters_match_the_first_kernel(dev, kind, M_, N, density):
    # 128-column tiles: N = 364, three tiles share each row tile's match, the
    # last one ragged; N = 1000, eight; N = 130, two, and N not a multiple of
    # 4 (scalar loads); N = 1403, eleven tiles, no divisor up to 8: a cluster
    # of one; density 0.5: a residual-heavy input
    a, w, pats, pwp = _setup(M_, 208, N, 16, dev, seed=M_ + N)
    if density is not None:
        g = torch.Generator().manual_seed(N)
        a = (torch.rand(a.shape, generator=g) < density).float().to(dev)
        pats = calibrate(a, PhiConfig(k=16, q=16, iters=3), device=dev)
        pwp = pattern_weight_products(pats, w)
    pwp, scale = _banks(pwp, kind, dev)
    gt = ops.stream_group_t(16, 16)
    out, nnz = phi_fused_stream_cuda(a, pats, pwp, scale, w, block_m=64, group_t=gt)
    pout, pnnz = phi_fused_plain(a, pats, pwp, scale, w, block_m=64)
    fout, fnnz = phi_fused_cuda(a, pats, pwp, scale, w, block_m=64)
    torch.cuda.synchronize()
    assert torch.equal(out, pout) and torch.equal(nnz, pnnz) and int(nnz.sum()) > 0
    assert torch.equal(out, fout) and torch.equal(nnz, fnnz)
    if density is not None:
        assert int(nnz.sum()) > 0.1 * a.numel()


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("N", [136, 133])
def test_stream_kernel_takes_a_large_bank(dev, kind, N):
    # q = 4096 at k = 64: two partitions a stage (N = 133: scalar loads)
    T, q, k, M_ = 3, 4096, 64, 77
    gt = ops.stream_group_t(q, k)
    assert gt == 2
    g = torch.Generator().manual_seed(7)
    a = (torch.rand((M_, T * k), generator=g) < 0.2).float()
    pats = (torch.rand((T, q, k), generator=g) < 0.2).to(torch.uint8)
    # plant each row's partitions, a few bits flipped, so rows match and
    # leave a residual
    flips = (torch.rand((T, M_, k), generator=g) < 0.05).to(torch.uint8)
    pats[:, 100:100 + M_] = a.reshape(M_, T, k).transpose(0, 1).to(torch.uint8) ^ flips
    w = torch.round(torch.randn((T * k, N), generator=g) * 0.3 * 1024) / 1024
    a, pats, w = a.to(dev), pats.to(dev), w.to(dev)
    pwp, scale = _banks(pattern_weight_products(pats, w), kind, dev)
    out, nnz = phi_fused_stream_cuda(a, pats, pwp, scale, w, block_m=32, group_t=gt)
    pout, pnnz = phi_fused_plain(a, pats, pwp, scale, w, block_m=32)
    torch.cuda.synchronize()
    assert torch.equal(out, pout) and torch.equal(nnz, pnnz) and int(nnz.sum()) > 0


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("M_,P", [(256, 4), (293, 8), (20, 16)])
def test_prefetch_kernel_matches_plain(dev, kind, M_, P):
    a, w, pats, pwp = _setup(M_, 96, 72, 16, dev, seed=M_ + P)
    scale = torch.ones(pwp.shape[:2], device=dev)
    if kind == "bf16":
        pwp = pwp.to(torch.bfloat16)
    elif kind == "int8":
        pwp, scale = quantize_pwp(pwp)
    bm = 64 if M_ > 32 else 32                          # M_ = 20: one stripe, rows < 32
    active = stripe_active_sets(a, pats, P, bm)
    before = phi_fused_prefetch_cuda.launches
    out, nnz = phi_fused_prefetch_cuda(a, pats, pwp, scale, w, active, block_m=bm)
    assert phi_fused_prefetch_cuda.launches == before + 1
    pout, pnnz = phi_fused_prefetch_plain(a, pats, pwp, scale, w, active, block_m=bm)
    torch.cuda.synchronize()
    assert torch.equal(out, pout) and torch.equal(nnz, pnnz) and int(nnz.sum()) > 0
    if kind == "f32":                                   # exact whatever the sets
        assert torch.equal(out, phi_fused_cuda(a, pats, pwp, scale, w, block_m=bm)[0])


def test_prefetch_kernel_refuses_what_it_cannot_take(dev):
    a, w, pats, pwp = _setup(100, 32, 8, 16, dev)
    scale = torch.ones(pwp.shape[:2], device=dev)
    active = stripe_active_sets(a, pats, 4, 16)
    with pytest.raises(ValueError, match="multiple of 32"):
        phi_fused_prefetch_cuda(a, pats, pwp, scale, w, active, block_m=16)
    with pytest.raises(ValueError, match="int32"):
        phi_fused_prefetch_cuda(a, pats, pwp, scale, w, active.long(), block_m=16)
    with pytest.raises(ValueError, match="P=17"):
        phi_fused_prefetch_cuda(a, pats, pwp, scale, w,
                                torch.zeros((4, 2, 17), dtype=torch.int32, device=dev),
                                block_m=32)


def test_stream_kernel_smem_model_and_refusals(dev):
    lib = _build.library()
    for q, k, gt in [(128, 16, 8), (7, 5, 3), (512, 64, 8), (1024, 16, 2)]:
        assert lib.phi_fused_stream_smem_bytes(q, k, gt) == stream_smem_bytes(q, k, gt)
    a, w, pats, pwp = _setup(64, 32, 8, 4, dev)
    scale = torch.ones(pwp.shape[:2], device=dev)
    for gt in (0, 9):
        with pytest.raises(ValueError, match="group_t"):
            phi_fused_stream_cuda(a, pats, pwp, scale, w, block_m=32, group_t=gt)
    big = torch.zeros((2, 1 << 14, 16), device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        phi_fused_stream_cuda(a, big, torch.zeros((2, (1 << 14) + 1, 8), device=dev),
                              torch.ones((2, (1 << 14) + 1), device=dev), w, block_m=32)


def _planted(M_, T, k, q, N, dev, seed, density=0.2):
    """Random binary rows whose partitions are planted in the bank with a
    few bits flipped (so rows match and leave a residual), dyadic w."""
    g = torch.Generator().manual_seed(seed)
    a = (torch.rand((M_, T * k), generator=g) < density).float()
    pats = (torch.rand((T, q, k), generator=g) < density).to(torch.uint8)
    n = min(M_, q // 2)
    flips = (torch.rand((T, n, k), generator=g) < 0.05).to(torch.uint8)
    pats[:, q - n:] = a[:n].reshape(n, T, k).transpose(0, 1).to(torch.uint8) ^ flips
    w = torch.round(torch.randn((T * k, N), generator=g) * 0.3 * 1024) / 1024
    a, pats, w = a.to(dev), pats.to(dev), w.to(dev)
    return a, w, pats, pattern_weight_products(pats, w)


# (M, T, k, q, N): what the first kernel's tiles, clusters and chunks meet.
FIRST_CASES = {
    "cluster3": (293, 24, 16, 128, 384),       # three 128-column tiles share the match
    "cluster6": (200, 24, 16, 128, 768),
    "n10": (293, 24, 16, 128, 10),             # the head's N: scalar loads, one ragged tile
    "n390": (96, 8, 16, 32, 390),              # N % 4 = 2, a cluster of 4, ragged last tile
    "n75": (130, 12, 16, 64, 75),
    "t95": (100, 95, 16, 64, 136),             # the largest whole-T match tile
    "t100": (70, 100, 16, 32, 72),             # T >= 96 on a direct call: two chunks of 50
    "t200": (40, 200, 8, 16, 256),             # three chunks of 67/67/66
    "q512_k64": (96, 6, 64, 512, 256),
    "k5": (77, 9, 5, 33, 72),                  # k not a multiple of 4: scalar bit packing
    "k12": (64, 10, 12, 40, 132),
}


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("case", list(FIRST_CASES))
def test_fused_kernel_tiles_clusters_and_chunks_match_plain(dev, kind, case):
    M_, T, k, q, N = FIRST_CASES[case]
    a, w, pats, pwp = _planted(M_, T, k, q, N, dev, seed=M_ + T + N)
    pwp, scale = _banks(pwp, kind, dev)
    before = phi_fused_cuda.launches
    out, nnz = phi_fused_cuda(a, pats, pwp, scale, w, block_m=64)
    assert phi_fused_cuda.launches == before + 1
    pout, pnnz = phi_fused_plain(a, pats, pwp, scale, w, block_m=64)
    torch.cuda.synchronize()
    assert torch.equal(out, pout) and torch.equal(nnz, pnnz) and int(nnz.sum()) > 0


@pytest.mark.parametrize("M_,T,N", [(293, 24, 384), (256, 36, 128), (100, 72, 256),
                                    (77, 24, 1536)])
def test_fused_kernel_equals_the_streaming_kernel_off_the_grid(dev, M_, T, N):
    # Weights not on a dyadic grid: the sums round, so only the same add
    # order (L1 and L2 apart, ascending t, ascending residual bit) gives
    # the same bits.
    a, _, pats, _ = _planted(M_, T, 16, 128, N, dev, seed=T + N)
    g = torch.Generator().manual_seed(N)
    w = torch.randn((T * 16, N), generator=g).to(dev)
    pwp = pattern_weight_products(pats, w)
    scale = torch.ones(pwp.shape[:2], device=dev)
    out, nnz = phi_fused_cuda(a, pats, pwp, scale, w, block_m=64)
    sout, snnz = phi_fused_stream_cuda(a, pats, pwp, scale, w, block_m=64,
                                       group_t=ops.stream_group_t(128, 16))
    torch.cuda.synchronize()
    assert torch.equal(out, sout) and torch.equal(nnz, snnz) and int(nnz.sum()) > 0


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("M_,bm,N", [(293, 32, 384), (293, 96, 768), (64, 32, 10)])
def test_prefetch_kernel_stripes_of_one_tile(dev, kind, M_, bm, N):
    # bm = 32: every 32-row tile is a stripe of its own, with its own sets
    a, w, pats, pwp = _planted(M_, 24, 16, 128, N, dev, seed=M_ + bm)
    pwp, scale = _banks(pwp, kind, dev)
    active = stripe_active_sets(a, pats, 8, bm)
    out, nnz = phi_fused_prefetch_cuda(a, pats, pwp, scale, w, active, block_m=bm)
    pout, pnnz = phi_fused_prefetch_plain(a, pats, pwp, scale, w, active, block_m=bm)
    torch.cuda.synchronize()
    assert torch.equal(out, pout) and torch.equal(nnz, pnnz) and int(nnz.sum()) > 0
    with pytest.raises(ValueError, match="multiple of 32"):
        phi_fused_prefetch_cuda(a, pats, pwp, scale, w, stripe_active_sets(a, pats, 8, 48),
                                block_m=48)


def test_fused_smem_model_is_the_kernels(dev):
    lib = _build.library()
    for T in (1, 24, 36, 72, 95, 96, 100, 200, 4000):
        assert lib.phi_fused_smem_bytes(T) == fused_smem_bytes(T)


def test_fused_kernel_refuses_k_above_64(dev):
    with pytest.raises(ValueError, match="k <= 64"):
        phi_fused_cuda(torch.zeros((8, 128), device=dev), torch.zeros((1, 4, 128), device=dev),
                       torch.zeros((1, 5, 8), device=dev), torch.ones((1, 5), device=dev),
                       torch.zeros((128, 8), device=dev), block_m=8)


@pytest.mark.parametrize("reset", ["hard", "soft"])
def test_lif_kernels_match_plain(dev, reset):
    g = torch.Generator().manual_seed(0)
    x = (torch.randn((4, 3000), generator=g) * 1.5).to(dev)
    v = torch.randn((3000,), generator=g).to(dev)
    s, vn = lif_step_cuda(v, x[0], reset=reset)
    rs, rv = ref.lif_ref(v, x[0], 0.5, 1.0, reset)
    assert torch.equal(s, rs) and torch.equal(vn, rv)
    got = lif_sequence_cuda(x, reset=reset)
    torch.cuda.synchronize()
    assert torch.equal(got, lif_sequence_plain(x, reset=reset))


def test_vgg16_widths_phi_apply_equals_apply(dev):
    """One batch of the slice's configuration through the Hopper kernels."""
    cfg = M.SNNConfig(kind="vgg", widths=(64, 128, 256, 512, 512), input_size=32,
                      phi=PhiConfig(k=16, q=128, iters=20))
    params = M.init(cfg, torch.Generator().manual_seed(0), device=dev)
    for name, leaf in params.items():
        gain = 1.0 if name == "conv0" else 3.0      # keeps spikes alive at depth
        leaf["w"] = torch.round(leaf["w"] * gain * 1024) / 1024
    x, _ = synthetic_images(16, size=32, seed=1)
    x = torch.from_numpy(np.round(x * 1024) / 1024).to(dev)
    with torch.no_grad():
        state, acts = M.calibrate_model(params, cfg, x)
        before = {impl: fn.launches for impl, fn in _FUSED.items()}
        lif_before = lif_sequence_cuda.launches
        got = M.phi_apply(params, cfg, state, x)
        want = _gate_launches(params, state, acts)
        assert {impl: fn.launches - before[impl] for impl, fn in _FUSED.items()} == want
        assert sum(want.values()) == 5
        assert lif_sequence_cuda.launches > lif_before
        assert torch.equal(got, M.apply(params, cfg, x))
    for act in acts.values():
        assert float(act.mean()) >= 0.01


# --------------------------------------------------- the pallas lowering ---
# (M, K, k, q, kind): the kernel's block is 64 rows (``MATCHER_ROWS``);
# k <= 16, <= 32 and <= 64 take the three mma depths, k = 5 and 33 straddle
# 32-bit words; q = 3500 (k = 16) and 900 (k = 64) run past one bank chunk;
# K = 368 (T = 23) splits into partition blocks of 8, 8 and 7. ``ties``:
# one-hot patterns and duplicates, so many patterns are equidistant and the
# lowest index must win; ``popcount_tie``: disjoint 2-bit patterns against
# rows on even bits, so the best distance only ties the row's popcount
# (idx = q everywhere); ``unaligned``: ``a`` a contiguous view one float
# past a 16-byte boundary (the kernel's scalar loads).
MATCHER_CASES = [
    (256, 96, 16, 16, "random"), (293, 64, 16, 128, "random"), (1, 96, 16, 16, "random"),
    (77, 40, 5, 9, "random"), (130, 128, 64, 32, "random"), (101, 96, 32, 128, "random"),
    (101, 99, 33, 9, "random"), (64, 48, 16, 1, "random"), (101, 368, 16, 128, "random"),
    (101, 45, 5, 128, "random"), (130, 64, 16, 3500, "random"), (70, 128, 64, 900, "random"),
    (101, 96, 16, 16, "ties"), (77, 40, 5, 9, "ties"), (101, 128, 64, 64, "ties"),
    (101, 96, 16, 8, "popcount_tie"), (101, 96, 16, 128, "unaligned"),
    (37, 40, 5, 9, "unaligned"),
]


@pytest.mark.parametrize("M_,K,k,q,kind", MATCHER_CASES)
def test_matcher_kernel_matches_plain(dev, M_, K, k, q, kind):
    g = torch.Generator().manual_seed(M_ + k + q)
    T = K // k
    if kind == "popcount_tie":
        a = torch.zeros((M_, K))
        a[:, ::2] = (torch.rand((M_, K // 2), generator=g) < 0.5).float()
        pats = torch.zeros((T, q, k), dtype=torch.uint8)
        for i in range(q):
            pats[:, i, 2 * i:2 * i + 2] = 1                  # a row holds at most one bit of each
    else:
        a = (torch.rand((M_, K), generator=g) < 0.3).float()
        pats = (torch.rand((T, q, k), generator=g) < 0.3).to(torch.uint8)
        if kind == "ties":
            pats = torch.zeros((T, q, k), dtype=torch.uint8)
            pats[:, torch.arange(q), torch.arange(q) % k] = 1    # one-hot, repeating past k
        if q > 1:
            pats[:, 1] = pats[:, 0]                           # a duplicate: ties go to index 0
    if kind == "unaligned":
        flat = torch.zeros(M_ * K + 1, device=dev)
        flat[1:] = a.reshape(-1).to(dev)
        a = flat[1:].view(M_, K)
        assert a.is_contiguous() and a.data_ptr() % 16 != 0
    a, pats = a.to(dev), pats.to(dev)
    before = matcher_cuda.launches
    idx, res = matcher_cuda(a, pats)
    assert matcher_cuda.launches == before + 1
    pidx, pres = matcher_plain(a, pats)
    torch.cuda.synchronize()
    assert torch.equal(idx, pidx) and torch.equal(res, pres)
    assert idx.dtype == torch.int32 and res.dtype == torch.int8
    if kind == "popcount_tie":
        assert bool((idx == q).all())
    else:
        assert int((idx < q).sum()) > 0


def test_matcher_plan_is_the_kernels(dev):
    """The kernel's own launch plan (its ``matcher_plan`` export) equals the
    Python one at the VGG's banks and at the card cases' shapes."""
    import ctypes

    lib = _build.library()
    out = (ctypes.c_int * 3)()
    shapes = [(36, 128, 16), (72, 128, 16), (144, 128, 16), (288, 128, 16), (32, 128, 16)]
    shapes += [(K // k, q, k) for _, K, k, q, _ in MATCHER_CASES]
    for T, q, k in shapes:
        assert lib.matcher_plan(T, q, k, out) == 0
        assert tuple(out) == matcher_plan(T, q, k), (T, q, k)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("M_,N", [(256, 72), (293, 10), (64, 384)])
def test_l1_gather_kernel_matches_plain(dev, kind, M_, N):
    g = torch.Generator().manual_seed(M_ + N)
    T, q = 7, 33
    idx = torch.randint(0, q + 1, (M_, T), generator=g, dtype=torch.int32).to(dev)
    pwp = torch.randn((T, q + 1, N), generator=g)                # not dyadic
    pwp[:, q] = 0
    pwp = pwp.to(dev, torch.bfloat16 if kind == "bf16" else torch.float32)
    before = l1_gather_cuda.launches
    out = l1_gather_cuda(idx, pwp)
    assert l1_gather_cuda.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(out, l1_gather_plain(idx, pwp))


@pytest.mark.parametrize("M_,K,bm", [(256, 96, 256), (293, 64, 256), (1000, 48, 64), (40, 32, 8)])
def test_l2_spmm_kernel_matches_plain(dev, M_, K, bm):
    g = torch.Generator().manual_seed(M_ + K)
    r = (torch.randint(0, 2, (M_, K), generator=g) * 2 - 1).to(torch.int8)
    r[torch.rand((M_, K), generator=g) > 0.1] = 0
    rows, cols, signs, _ = pack_l2_coo_jit(r.to(dev), M_ * K)
    Gbm = -(-M_ // bm) * bm
    br, bc, bs, dropped = ops.bucket_coo(rows, cols, signs, Gbm, bm, M_ * K)
    assert int(dropped) == 0
    w = torch.randn((K, 72), generator=g)                         # not dyadic
    before = l2_spmm_cuda.launches
    out = l2_spmm_cuda(br, bc, bs, w.to(dev), block_m=bm)
    assert l2_spmm_cuda.launches == before + 1
    want = l2_spmm_plain(br.cpu(), bc.cpu(), bs.cpu(), w, block_m=bm)   # entry order
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), want)
    wd = torch.round(w * 1024) / 1024                             # dyadic: any order
    assert torch.equal(l2_spmm_cuda(br, bc, bs, wd.to(dev), block_m=bm),
                       l2_spmm_plain(br, bc, bs, wd.to(dev), block_m=bm))
    assert torch.equal(l2_spmm_cuda(br, bc, bs, wd.to(dev), block_m=bm)[:M_].cpu(),
                       r.float() @ wd)


def _spmm_operands(dev, M_, K, bm, seed, density=0.1, full_row=None, empty_rows=(),
                   empty_block=None):
    """A ±1 residual (M_, K), its COO bucketed per bm rows, and the residual."""
    g = torch.Generator().manual_seed(seed)
    r = (torch.randint(0, 2, (M_, K), generator=g) * 2 - 1).to(torch.int8)
    r[torch.rand((M_, K), generator=g) > density] = 0
    if full_row is not None:                       # an entry in every column
        r[full_row] = (torch.randint(0, 2, (K,), generator=g) * 2 - 1).to(torch.int8)
    for row in empty_rows:
        r[row] = 0
    if empty_block is not None:                    # a block of sentinels only
        r[empty_block * bm:(empty_block + 1) * bm] = 0
    rows, cols, signs, _ = pack_l2_coo_jit(r.to(dev), M_ * K)
    G = -(-M_ // bm)
    br, bc, bs, dropped = ops.bucket_coo(rows, cols, signs, G * bm, bm, bm * K)
    assert int(dropped) == 0
    return br, bc, bs, r


# (M, K, bm, density, full row, empty rows, all-sentinel block)
SPMM_CASES = {
    # a row of 300 entries (past the 4 in flight and the 32 a warp loads),
    # empty rows at every block edge, the middle block all sentinels
    "long_row_edges": (768, 300, 256, 0.1, 5, (0, 255, 256, 511, 512, 767), 1),
    "g1_bm8": (5, 40, 8, 0.3, None, (), None),     # one block of 8 rows, 3 of them padding
    "many_rows_a_warp": (16384, 64, 256, 0.05, 77, (0, 4095), None),   # 2 to 8 rows a warp
}


@pytest.mark.parametrize("N", [10, 72, 130, 512])
@pytest.mark.parametrize("case", list(SPMM_CASES))
def test_l2_spmm_kernel_edge_cases(dev, case, N):
    """Bitwise equal to the plain version on weights off the dyadic grid (the
    kernel sums each output in entry order), and to r @ w on dyadic ones; N
    of 10 and 130 take the scalar columns, 72 and 512 the 16-byte ones."""
    M_, K, bm, density, full_row, empty_rows, empty_block = SPMM_CASES[case]
    br, bc, bs, r = _spmm_operands(dev, M_, K, bm, seed=M_ + N, density=density,
                                   full_row=full_row, empty_rows=empty_rows,
                                   empty_block=empty_block)
    if empty_block is not None:
        assert int((bs[empty_block] != 0).sum()) == 0
    w = torch.randn((K, N), generator=torch.Generator().manual_seed(N))   # not dyadic
    before = l2_spmm_cuda.launches
    out = l2_spmm_cuda(br, bc, bs, w.to(dev), block_m=bm)
    assert l2_spmm_cuda.launches == before + 1
    want = l2_spmm_plain(br.cpu(), bc.cpu(), bs.cpu(), w, block_m=bm)   # entry order
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), want)
    wd = torch.round(w * 1024) / 1024
    got = l2_spmm_cuda(br, bc, bs, wd.to(dev), block_m=bm)
    assert torch.equal(got[:M_].cpu(), r.float() @ wd)
    assert int(got[M_:].abs().sum()) == 0                 # padding rows: zeros


# (M, T, q, N): rows past the last block's 8, fewer rows than a block, conv4's
# T = 288 with q = 128, N not a multiple of 4 (one column a lane), N past one
# 128-column slice, conv3's shape
GATHER_CASES = {
    "ragged_m": (700, 9, 33, 64),
    "below_one_block": (5, 5, 33, 96),
    "t288": (300, 288, 128, 64),
    "n10": (293, 7, 33, 10),
    "n130": (64, 9, 33, 130),
    "n72": (300, 7, 63, 72),
    "conv3": (2048, 144, 128, 512),
}


def _gather_operands(dev, M_, T, q, N, kind, seed):
    g = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, q + 1, (M_, T), generator=g, dtype=torch.int32).to(dev)
    pwp = torch.randn((T, q + 1, N), generator=g)                 # not dyadic
    pwp[:, q] = 0
    return idx, pwp.to(dev, torch.bfloat16 if kind == "bf16" else torch.float32)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(GATHER_CASES))
def test_l1_gather_kernels_match_plain(dev, case, kind):
    M_, T, q, N = GATHER_CASES[case]
    idx, pwp = _gather_operands(dev, M_, T, q, N, kind, seed=M_ + T)
    want = l1_gather_plain(idx, pwp)
    flag = make_range_flag(dev)
    before = l1_gather_cuda.launches
    got = l1_gather_cuda(idx, pwp)
    flagged = l1_gather_cuda(idx, pwp, range_flag=flag)
    assert l1_gather_cuda.launches == before + 2
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(flagged, want)
    assert int(flag[0]) == 0


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("N", [64, 10])
def test_l1_gather_flags_an_index_outside_the_bank_and_reads_no_bank_row(dev, kind, N):
    """Indices far outside the bank (2^30, -2^31) would fault if read: the
    kernel sets the flag, reads nothing for them, and every other row equals
    the plain version (vector and scalar columns)."""
    idx, pwp = _gather_operands(dev, 300, 9, 33, N, kind, seed=N)
    bad_rows = [3, 150, 299]
    for row, (t, v) in zip(bad_rows, [(0, -1), (4, 2 ** 30), (8, -2 ** 31)]):
        idx[row, t] = v
    flag = make_range_flag(dev)
    out = l1_gather_cuda(idx, pwp, range_flag=flag)
    host = range_flag_to_host(flag)
    torch.cuda.synchronize()
    assert int(host[0]) == 1
    keep = torch.ones(300, dtype=torch.bool)
    keep[bad_rows] = False
    good = idx[keep.to(dev)].contiguous()
    assert torch.equal(out[keep.to(dev)], l1_gather_plain(good, pwp))
    with pytest.raises(ValueError, match="outside the bank's rows"):
        check_range_flag(host, idx, 34)


def test_pallas_lowering_refuses_a_flagged_gather_after_launching_it(dev, monkeypatch):
    """The lowering launches the gather with a flag and refuses the result
    once the packer's sync has passed it; the gather itself ran."""
    a, w, pats, pwp = _setup(64, 32, 8, 4, dev)
    real = ops.matcher

    def bad_matcher(*args, **kw):
        idx, res = real(*args, **kw)
        idx[7, 1] = 9                                 # past the bank's 5 rows
        return idx, res

    monkeypatch.setattr(ops, "matcher", bad_matcher)
    before = l1_gather_cuda.launches
    with pytest.raises(ValueError, match="outside the bank's rows"):
        ops.phi_matmul(a, w, pats, pwp, impl="pallas")
    assert l1_gather_cuda.launches == before + 1


def test_unit_kernels_refuse_what_they_cannot_take(dev):
    with pytest.raises(ValueError, match="k <= 64"):
        matcher_cuda(torch.zeros((8, 128), device=dev),
                     torch.zeros((1, 4, 128), dtype=torch.uint8, device=dev))
    idx = torch.zeros((8, 2), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="int8"):
        l1_gather_cuda(idx, torch.zeros((2, 5, 8), dtype=torch.int8, device=dev))
    with pytest.raises(ValueError, match="int32"):
        l1_gather_cuda(idx.long(), torch.zeros((2, 5, 8), device=dev))
    for bad in (-1, 5):             # outside the bank's rows [0, q]: refused as the plain does
        before = l1_gather_cuda.launches
        idx[3, 1] = bad
        for fn in (l1_gather_cuda, l1_gather_plain):
            with pytest.raises(ValueError, match="outside the bank's rows"):
                fn(idx, torch.zeros((2, 5, 8), device=dev))
        assert l1_gather_cuda.launches == before
    rows = torch.zeros((1, 4), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int32"):
        l2_spmm_cuda(rows.long(), rows, rows, torch.zeros((4, 8), device=dev), block_m=8)
    a, w, pats, pwp = _setup(64, 32, 8, 4, dev)
    q8, scale = quantize_pwp(pwp)
    with pytest.raises(ValueError, match="int8"):
        ops.phi_matmul(a, w, pats, q8, impl="pallas", pwp_scale=scale)


def test_policy_telemetry_follows_a_site_across_devices(dev):
    """One site run on the CPU, then on the card, then read: both runs'
    counters are folded in (each device's sums are read on their own)."""
    a, w, pats, pwp = _setup(300, 96, 72, 16, "cpu", seed=6)
    pol = dispatch.PhiExecutionPolicy(telemetry=True)
    cpu = pol.matmul(a, w, pats, pwp, site="s", override="fused")
    card = pol.matmul(*(x.to(dev) for x in (a, w, pats, pwp)), site="s", override="fused")
    assert torch.equal(card.cpu(), cpu)
    (b,) = pol.report()["packer_budgets"]
    _, residual = ref.matcher_ref(a, pats)
    assert (b.executions, b.rows) == (2, 600)
    assert b.l2_nnz_total == 2 * int(residual.abs().sum())


@pytest.mark.parametrize("impl", [None, "fused", "fused_stream", "fused_prefetch"])
def test_policy_refuses_on_the_card_a_bank_no_kernel_takes(dev, impl):
    """k = 128 > 64: the policy raises on CUDA operands instead of running
    the plain ``coo`` lowering on the card, and launches nothing."""
    g = torch.Generator().manual_seed(4)
    a = (torch.rand((64, 512), generator=g) < 0.3).float().to(dev)
    pats = (torch.rand((4, 8, 128), generator=g) < 0.3).to(torch.uint8).to(dev)
    w = torch.randn((512, 32), generator=g).to(dev)
    pwp = pattern_weight_products(pats, w)
    pol = dispatch.PhiExecutionPolicy(telemetry=True)
    launches = [f.launches for f in (*_FUSED.values(), *_UNITS)]
    with pytest.raises(ValueError, match="no Phi kernel takes site"):
        pol.matmul(a, w, pats, pwp, site="wide_k", override=impl, p_active=4)
    assert [f.launches for f in (*_FUSED.values(), *_UNITS)] == launches
    assert pol.decisions() == {}


def test_vgg16_widths_pallas_phi_apply_equals_apply(dev):
    """One batch of the slice's configuration on the matcher, gather and
    spmm kernels (``PhiConfig(impl="pallas")``), every budget exact."""
    cfg = M.SNNConfig(kind="vgg", widths=(64, 128, 256, 512, 512), input_size=32,
                      phi=PhiConfig(k=16, q=128, iters=20, impl="pallas"))
    params = M.init(cfg, torch.Generator().manual_seed(0), device=dev)
    for name, leaf in params.items():
        gain = 1.0 if name == "conv0" else 3.0
        leaf["w"] = torch.round(leaf["w"] * gain * 1024) / 1024
    x, _ = synthetic_images(16, size=32, seed=1)
    x = torch.from_numpy(np.round(x * 1024) / 1024).to(dev)
    prev = dispatch.set_policy(dispatch.PhiExecutionPolicy())
    try:
        with torch.no_grad():
            state, acts = M.calibrate_model(params, cfg, x)
            before = [fn.launches for fn in _UNITS]
            got = M.phi_apply(params, cfg, state, x)
            assert [fn.launches - b for fn, b in zip(_UNITS, before)] == [5, 5, 5]
            assert torch.equal(got, M.apply(params, cfg, x))
        assert dispatch.get_policy().decisions() == {
            (f"snn.{name}", "pallas", "config_override"): 1 for name in acts}
    finally:
        dispatch.set_policy(prev)
    for name, act in acts.items():
        aud = ops.phi_l2_audit(act, state.patterns[name], nnz_budget=cfg.phi.nnz_budget)
        assert aud["pack_overflow"] == aud["bucket_dropped"] == aud["chunk_overflow"] == 0


# ------------------------------------------------------------- attention ---
ATTN_ATOL_ULPS = 16
# (B, S, H, D, T, kp, qp, causal, window, chunk, block_q, block_kv)
ATTN_CASES = {
    "slice": (8, 64, 12, 32, 2, 16, 128, False, None, None, 64, 64),
    "causal": (2, 96, 3, 32, 2, 16, 64, True, None, None, 32, 64),
    "window": (2, 96, 3, 32, 2, 16, 64, True, 7, None, 64, 32),
    "chunk": (2, 96, 3, 32, 2, 16, 64, False, None, 16, 32, 32),
    "ragged_s": (3, 37, 2, 32, 2, 16, 32, False, None, None, 16, 16),
    "ragged_d": (2, 50, 2, 40, 2, 16, 32, True, None, None, 32, 32),
    # small S: a block of 16 rows, 15 (batch, head) pairs
    "small_s": (3, 16, 5, 32, 2, 16, 32, False, None, None, 16, 16),
    # p.V in two passes (128 rows, 64 a pass at D = 32) and in four (D = 128:
    # 16 rows a pass), the latter with a dense tail of 64 features
    "rpt2": (2, 128, 2, 32, 2, 16, 64, True, None, None, 128, 128),
    "d128": (2, 64, 2, 128, 4, 16, 64, False, None, None, 64, 64),
    # more (K row, partition) pairs than the block's 256 threads: 512 pairs
    # (two match passes) and 384 (a partial second pass, a ragged last
    # kv-block, a dense tail of 8 features)
    "pairs512": (2, 256, 2, 64, 4, 16, 64, False, None, None, 32, 128),
    "pairs384": (2, 200, 2, 56, 3, 16, 64, True, None, None, 64, 128),
}


def _attn_inputs(B, S, H, D, T, kp, qp, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = (torch.rand((B, S, H, D), generator=g) < 0.3).float()
    k = (torch.rand((B, S, H, D), generator=g) < 0.3).float()
    v = torch.randn((B, S, H, D), generator=g)
    rows = k.reshape(-1, D)[torch.randint(0, B * S * H, (qp,), generator=g), :T * kp]
    pats = rows.reshape(qp, T, kp).transpose(0, 1).to(torch.uint8).contiguous()
    return q.to(dev), k.to(dev), v.to(dev), pats.to(dev)


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_kernel_matches_plain(dev, case):
    B, S, H, D, T, kp, qp, causal, window, chunk, bq, bkv = ATTN_CASES[case]
    q, k, v, pats = _attn_inputs(B, S, H, D, T, kp, qp, dev)
    kw = dict(causal=causal, window=window, chunk=chunk, block_q=bq, block_kv=bkv)
    before = phi_flash_attention_cuda.launches
    out, nnz = phi_flash_attention_cuda(q, k, v, pats, packed=pack_patterns(pats), **kw)
    assert phi_flash_attention_cuda.launches == before + 1
    pout, pnnz = phi_flash_attention_plain(q, k, v, pats, **kw)
    torch.cuda.synchronize()
    assert torch.equal(nnz, pnnz) and int(nnz.sum()) > 0
    atol = ATTN_ATOL_ULPS * 2.0 ** -24 * float(v.abs().max())
    assert float((out - pout).abs().max()) <= atol
    before = flash_attention_cuda.launches
    dense = flash_attention(q, k, v, causal, window, chunk, bq, bkv)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    assert torch.equal(out, dense)           # Phi and dense instantiations, bitwise


@pytest.mark.parametrize("B,S,H,D,causal,bq_phi,bq_dense,bkv", [
    (8, 64, 12, 32, False, 32, 64, 64), (2, 96, 3, 32, True, 64, 32, 32),
    (3, 37, 2, 40, False, 16, 32, 16)])
def test_attention_phi_equals_dense_at_another_block_q(dev, B, S, H, D, causal, bq_phi,
                                                       bq_dense, bkv):
    # a query row's softmax arithmetic depends on block_kv only
    q, k, v, pats = _attn_inputs(B, S, H, D, 2, 16, 64, dev, seed=S)
    out, _ = phi_flash_attention_cuda(q, k, v, pats, causal=causal, block_q=bq_phi,
                                      block_kv=bkv)
    dense = flash_attention_cuda(q, k, v, causal=causal, block_q=bq_dense, block_kv=bkv)
    torch.cuda.synchronize()
    assert torch.equal(out, dense)


@pytest.mark.parametrize("bq,bkv", [(64, 64), (32, 16)])
def test_attention_float_route_for_non_binary_q(dev, bq, bkv):
    # Q on a dyadic grid but not binary: the block takes the float route.
    # Every partial sum is exact, so the scores (and l2_nnz) are exact and
    # the output equals the dense instantiation's bitwise.
    q, k, v, pats = _attn_inputs(4, 64, 3, 32, 2, 16, 64, dev, seed=3)
    g = torch.Generator().manual_seed(4)
    q = q * torch.tensor([0.5, 0.25, 2.0, -1.0])[torch.randint(0, 4, q.shape, generator=g)].to(dev)
    kw = dict(block_q=bq, block_kv=bkv)
    out, nnz = phi_flash_attention_cuda(q, k, v, pats, **kw)
    pout, pnnz = phi_flash_attention_plain(q, k, v, pats, **kw)
    dense = flash_attention_cuda(q, k, v, causal=False, **kw)
    torch.cuda.synchronize()
    assert torch.equal(nnz, pnnz) and int(nnz.sum()) > 0
    assert float((out - pout).abs().max()) <= ATTN_ATOL_ULPS * 2.0 ** -24 * float(v.abs().max())
    assert torch.equal(out, dense)


def test_kernels_report_their_occupancy(dev):
    lib = _build.library()
    assert lib.phi_attention_occupancy(64, 64, 32, 2, 128, 1) >= 1
    assert lib.phi_attention_occupancy(64, 64, 32, 0, 0, 0) >= 1
    assert lib.phi_attention_occupancy(128, 64, 128, 0, 0, 0) == 0      # refused block_q
    for kernel in (0, 1):
        assert lib.phi_fused_occupancy(kernel, 128, 16, 0, 384, 24) >= 2
        assert lib.phi_fused_occupancy(kernel, 512, 64, 0, 384, 95) >= 1
    assert lib.phi_fused_occupancy(2, 128, 16, ops.stream_group_t(128, 16), 384, 0) >= 1
    assert lib.phi_fused_occupancy(2, 4096, 64, ops.stream_group_t(4096, 64), 72, 0) >= 1


def test_attention_smem_model_is_the_kernels(dev):
    lib = _build.library()
    for bq, bkv, D, T, qp in [(64, 64, 32, 2, 128), (32, 128, 40, 2, 8), (128, 128, 64, 0, 0),
                              (16, 8, 128, 8, 512)]:
        assert lib.phi_attention_smem_bytes(bq, bkv, D, T, qp, int(T > 0)) \
            == smem_bytes(bq, bkv, D, T, qp)


def test_attention_kernel_refuses_what_it_cannot_take(dev):
    q, k, v, pats = _attn_inputs(1, 16, 2, 32, 2, 16, 8, dev)
    with pytest.raises(ValueError, match="<= 64"):
        phi_flash_attention_cuda(torch.zeros((1, 16, 1, 128), device=dev),
                                 torch.zeros((1, 16, 1, 128), device=dev),
                                 torch.zeros((1, 16, 1, 128), device=dev),
                                 torch.zeros((1, 4, 128), dtype=torch.uint8, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        phi_flash_attention_cuda(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), pats)
    with pytest.raises(TypeError, match="float32"):
        flash_attention_cuda(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="shared memory"):
        phi_flash_attention_cuda(*_attn_inputs(1, 256, 1, 64, 4, 16, 512, dev), block_q=256,
                                 block_kv=256)
    with pytest.raises(ValueError, match="more rows"):
        flash_attention_cuda(*_attn_inputs(1, 128, 1, 128, 4, 16, 8, dev)[:3], block_q=128,
                             block_kv=32)


def test_spikformer_phi_apply_equals_apply(dev):
    """One batch of Spikformer-4-384 through the Hopper kernels."""
    cfg = M.SNNConfig(kind="spikformer", input_size=32, dim=384, heads=12, blocks=4,
                      attn="flash", phi=PhiConfig(k=16, q=128, iters=20))
    params = M.init(cfg, torch.Generator().manual_seed(0), device=dev)
    for name, leaf in params.items():
        gain = 1.0 if name == "embed" else 3.0      # keeps spikes alive at depth
        leaf["w"] = torch.round(leaf["w"] * gain * 1024) / 1024
    x, _ = synthetic_images(16, size=32, seed=1)
    x = torch.from_numpy(np.round(x * 1024) / 1024).to(dev)
    prev = dispatch.set_policy(dispatch.PhiExecutionPolicy())
    try:
        with torch.no_grad():
            state, acts = M.calibrate_model(params, cfg, x)
            before = {impl: fn.launches for impl, fn in _FUSED.items()}
            attn_before = phi_flash_attention_cuda.launches
            got = M.phi_apply(params, cfg, state, x)
            want = _gate_launches(params, state, acts)
            assert {impl: fn.launches - before[impl] for impl, fn in _FUSED.items()} == want
            assert sum(want.values()) == 4 * 4 + 1
            assert phi_flash_attention_cuda.launches - attn_before == 4
            assert torch.equal(got, M.apply(params, cfg, x))
        decisions = dispatch.get_policy().decisions()
        for b in range(4):
            assert decisions[(f"snn.b{b}_attn", "phi_flash", "spike_qk_phi_flash_native")] == 1
    finally:
        dispatch.set_policy(prev)
    assert torch.isfinite(got).all() and float(got.abs().sum()) > 0
    for act in acts.values():
        assert float(act.mean()) >= 0.01


# -------------------------------------------------------------- training ---
LSE_ATOL_ULPS = 64
GRAD_REL = 1e-5
# (B, S, H, D, causal, window, chunk, block_q, block_kv): the Spikformer-4-384
# site (T·B = 128 images, 12 heads of 32, S = 64, the policy's blocks), an odd
# S with a ragged last block on both axes, and the three masks.
TRAIN_ATTN_CASES = {
    "spikformer_site": (128, 64, 12, 32, False, None, None, 64, 64),
    "odd_s": (3, 37, 2, 32, False, None, None, 16, 16),
    "odd_s_causal": (2, 53, 3, 32, True, None, None, 32, 16),
    "window": (2, 96, 3, 32, True, 7, None, 64, 32),
    "chunk": (2, 96, 3, 32, False, None, 16, 32, 32),
}


@pytest.mark.parametrize("case", list(TRAIN_ATTN_CASES))
def test_attention_kernel_lse_matches_flash_fwd_impl(dev, case):
    B, S, H, D, causal, window, chunk, bq, bkv = TRAIN_ATTN_CASES[case]
    q, k, v, _ = _attn_inputs(B, S, H, D, 2, 16, 8, dev, seed=S)
    kw = dict(causal=causal, window=window, chunk=chunk, block_q=bq, block_kv=bkv)
    before = flash_attention_cuda.lse_launches
    out, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    assert flash_attention_cuda.lse_launches == before + 1
    pout, plse = flash_mod._flash_fwd_impl(q, k, v, causal, window, chunk, bq, bkv)
    torch.cuda.synchronize()
    assert lse.shape == plse.shape == (B, H, S)
    atol = LSE_ATOL_ULPS * 2.0 ** -24 * max(1.0, float(plse.abs().max()))
    assert float((lse - plse).abs().max()) <= atol
    assert float((out - pout).abs().max()) <= ATTN_ATOL_ULPS * 2.0 ** -24 * float(v.abs().max())
    # the output is the inference launch's, bit for bit
    assert torch.equal(out, flash_attention_cuda(q, k, v, **kw))


@pytest.mark.parametrize("case", list(TRAIN_ATTN_CASES))
def test_flash_function_gradients_match_plain_autograd(dev, case, monkeypatch):
    B, S, H, D, causal, window, chunk, bq, bkv = TRAIN_ATTN_CASES[case]
    g = torch.Generator().manual_seed(S + 1)
    qkv = [torch.randn((B, S, H, D), generator=g).to(dev) for _ in range(3)]
    cot = torch.randn((B, S, H, D), generator=g).to(dev)
    plain = [x.clone().requires_grad_() for x in qkv]
    out_p, _ = flash_mod._flash_fwd_impl(*plain, causal, window, chunk, bq, bkv)
    (out_p * cot).sum().backward()

    def refuse(*a, **k):
        raise AssertionError("_flash_fwd_impl ran on the card")

    import repro_torch.kernels.phi_attention as attn_mod

    monkeypatch.setattr(flash_mod, "_flash_fwd_impl", refuse)
    monkeypatch.setattr(attn_mod, "_flash_fwd_impl", refuse)
    x = [z.clone().requires_grad_() for z in qkv]
    before = (flash_attention_cuda.launches, flash_attention_cuda.lse_launches)
    out = flash_attention(*x, causal, window, chunk, bq, bkv)
    (out * cot).sum().backward()
    torch.cuda.synchronize()
    assert (flash_attention_cuda.launches, flash_attention_cuda.lse_launches) == \
        (before[0] + 1, before[1] + 1)
    for name, xi, pi in zip("qkv", x, plain):
        assert torch.isfinite(xi.grad).all(), name
        err = float((xi.grad - pi.grad).abs().max())
        assert err <= GRAD_REL * float(pi.grad.abs().max()), (name, err)


def test_inference_attention_launches_write_no_lse(dev):
    q, k, v, _ = _attn_inputs(8, 64, 12, 32, 2, 16, 8, dev)
    before = (flash_attention_cuda.launches, flash_attention_cuda.lse_launches)
    with torch.no_grad():
        out = flash_attention(q, k, v, False, None, None, 64, 64)
    assert out.grad_fn is None
    assert (flash_attention_cuda.launches, flash_attention_cuda.lse_launches) == \
        (before[0] + 1, before[1])
    qg = q.clone().requires_grad_()
    out_g = flash_attention(qg, k, v, False, None, None, 64, 64)
    torch.cuda.synchronize()
    assert flash_attention_cuda.lse_launches == before[1] + 1
    assert torch.equal(out_g.detach(), out)       # one kernel, lse on or off


def test_paft_hamming_through_the_matcher_matches_plain(dev):
    """PAFT's assignment on the card (the matcher kernel) against the plain
    ``assign_patterns``: value exact, gradient bitwise."""
    g = torch.Generator().manual_seed(5)
    M_, T_, k, q = 4096 + 37, 36, 16, 128
    base = (torch.rand((24, T_ * k), generator=g) < 0.2).float()
    a = base[torch.randint(0, 24, (M_,), generator=g)]
    a = (a + (torch.rand(a.shape, generator=g) < 0.03).float()) % 2
    pats = a[torch.randint(0, M_, (q,), generator=g)].reshape(q, T_, k).transpose(0, 1)
    pats = pats.to(torch.uint8).contiguous().to(dev)
    a = a.to(dev)
    x = a.clone().requires_grad_()
    before = matcher_cuda.launches
    h = paft.hamming_to_assigned(x, pats, packed=pack_patterns(pats))
    h.backward()
    torch.cuda.synchronize()
    assert matcher_cuda.launches == before + 1
    idx, _ = assign_patterns(a, pats)
    p_star = level1_matrix(idx, pats.float())
    want = (a * (1 - p_star) + p_star * (1 - a)).sum()
    assert float(h.detach()) == float(want) > 0
    assert torch.equal(x.grad, 1 - 2 * p_star)


def test_vgg_train_step_on_the_card_matches_the_cpu(dev):
    cfg = M.SNNConfig(kind="vgg", widths=(64, 128, 256), input_size=32,
                      phi=PhiConfig(k=16, q=128, iters=20))
    params = M.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    for name, leaf in params.items():
        gain = 1.0 if name == "conv0" else 3.0
        leaf["w"] = torch.round(leaf["w"] * gain * 1024) / 1024
    x, y = synthetic_images(16, size=32, seed=1)
    x = torch.from_numpy(np.round(x * 1024) / 1024)
    y = torch.from_numpy(y)
    cpu, (cpu_loss, cpu_acc) = snn_train.loss_and_grads(params, cfg, x, y)
    on_card = {n: {"w": leaf["w"].to(dev)} for n, leaf in params.items()}
    lif_before = lif_sequence_cuda.launches
    got, (loss, acc) = snn_train.loss_and_grads(on_card, cfg, x.to(dev), y.to(dev))
    torch.cuda.synchronize()
    assert lif_sequence_cuda.launches == lif_before     # the differentiable loop
    assert abs(float(loss) - float(cpu_loss)) <= 1e-6 * abs(float(cpu_loss))
    assert float(acc) == float(cpu_acc)
    for name in cpu:
        want = cpu[name]["w"]
        assert float(want.abs().max()) > 0, name
        err = float((got[name]["w"].cpu() - want).abs().max())
        assert err <= GRAD_REL * float(want.abs().max()), (name, err)


# The VGG's five GEMMs on the main path (M, K at k = 16, q = 128), and odd
# banks: k = 9 (the table-4 traces' conv partitions), q = 7, ragged M.
TRACE_CASES = [(32768, 576, 16, 128), (8192, 1152, 16, 128), (2048, 2304, 16, 128),
               (512, 4608, 16, 128), (128, 512, 16, 128), (1000, 63, 9, 7),
               (777, 144, 9, 128), (301, 96, 16, 7)]


@pytest.mark.parametrize("M_,K,k,q", TRACE_CASES)
def test_trace_from_acts_on_the_card_matches_plain_and_numpy(dev, M_, K, k, q):
    """``trace_from_acts`` on a CUDA tensor (the matcher kernel) equals the
    same arrays built by the plain matcher on the card and the reference's
    numpy mirror on the CPU, to the integer."""
    g = torch.Generator().manual_seed(M_ + K + q)
    T = K // k
    base = (torch.rand((24, K), generator=g) < 0.15).float()
    a = base[torch.randint(0, 24, (M_,), generator=g)]
    a = (a + (torch.rand(a.shape, generator=g) < 0.03).float()) % 2
    pats = a[torch.randint(0, M_, (q,), generator=g)].reshape(q, T, k).transpose(0, 1)
    pats = pats.to(torch.uint8).contiguous()
    before = matcher_cuda.launches
    got = sim_trace.trace_from_acts("t", a.to(dev), pats.to(dev), 64)
    assert matcher_cuda.launches == before + 1
    plain = sim_trace._assign_torch(a.to(dev), pats.to(dev), matcher_plain)
    host = sim_trace.trace_from_acts("t", a.numpy(), pats.numpy(), 64)
    for i, field in enumerate(("idx", "tile_pop", "tile_res", "usage")):
        np.testing.assert_array_equal(getattr(got, field), plain[i])
        np.testing.assert_array_equal(getattr(got, field), getattr(host, field))
    assert got.idx_density > 0 and (got.m, got.k_dim, got.k, got.q) == (M_, K, k, q)


def test_capture_phi_traces_on_the_card_never_assigns_on_the_host(dev, monkeypatch):
    """On the card every calibrated GEMM is assigned by the matcher kernel:
    the numpy mirror is swapped for a raise, and the traces equal the ones
    captured on the CPU from the same weights and patterns."""
    cfg = M.SNNConfig(kind="vgg", widths=(64, 128, 256), input_size=32,
                      phi=PhiConfig(k=16, q=128, iters=10))
    params = M.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    for name, leaf in params.items():
        leaf["w"] = torch.round(leaf["w"] * (1.0 if name == "conv0" else 3.0) * 1024) / 1024
    x, _ = synthetic_images(16, size=32, seed=0)
    x = torch.round(torch.from_numpy(x) * 1024) / 1024
    state, _ = M.calibrate_model(params, cfg, x)
    want = M.capture_phi_traces(params, cfg, state, x)

    def refuse(*a, **k):
        raise AssertionError("_assign_np ran on the card")

    monkeypatch.setattr(sim_trace, "_assign_np", refuse)
    params_d = {n: {"w": leaf["w"].to(dev)} for n, leaf in params.items()}
    state_d = M.PhiState({n: p.to(dev) for n, p in state.patterns.items()},
                         {n: p.to(dev) for n, p in state.pwp.items()}, state.usage)
    before = matcher_cuda.launches
    got = M.capture_phi_traces(params_d, cfg, state_d, x.to(dev))
    assert matcher_cuda.launches == before + len(want) and len(want) == 3
    for g_, w_ in zip(got, want):
        assert (g_.name, g_.m, g_.k_dim, g_.n) == (w_.name, w_.m, w_.k_dim, w_.n)
        for field in ("idx", "tile_pop", "tile_res", "usage"):
            np.testing.assert_array_equal(getattr(g_, field), getattr(w_, field))
