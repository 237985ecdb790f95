"""repro_torch kernels: plain versions against the reference, kernels against plain.

On the CPU the wrappers run their plain PyTorch versions; those are held
against the reference's Pallas kernels in interpret mode and its ops layer.
Tolerances: bitwise wherever every product is exact (dyadic weights with an
f32 or bf16 bank, LIF with decay 0.5), since then neither the summation
order nor a fused multiply-add can change a bit; where a product rounds, the
tolerance is stated beside the test. The Hopper kernels themselves are held
against these plain versions on the card in ``test_torch_cuda.py``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_util import clustered, dyadic, t

from repro.core import patterns as RP
from repro.kernels import ops as RO
from repro.kernels import ref as RR
from repro.kernels.lif import lif_pallas
from repro.kernels.phi_fused import phi_fused_pallas, phi_fused_prefetch_pallas
from repro.kernels.phi_fused import phi_fused_stream_pallas
from repro.kernels.phi_fused import stripe_active_sets as ref_stripe_active_sets
from repro.snn import lif as RL
from repro_torch.core import patterns as P
from repro_torch.kernels import ops, ref
from repro_torch.kernels.lif import lif_sequence_cuda, lif_sequence_plain, lif_step_cuda
from repro_torch.kernels.phi_fused import (
    SMEM_LIMIT, pack_patterns, phi_fused_cuda, phi_fused_plain, phi_fused_prefetch_cuda,
    phi_fused_stream_cuda, stream_smem_bytes, stripe_active_sets)
from repro_torch.snn import lif as L
from repro_torch.snn.models import PhiState


def _setup(M, K, N, q, seed=0, dyadic_w=True):
    rng = np.random.default_rng(seed)
    a = clustered(rng, M, K, protos=max(4, q // 2))
    w = rng.standard_normal((K, N)).astype(np.float32) * 0.3
    if dyadic_w:
        w = dyadic(w)
    pats = RP.calibrate(a, RP.PhiConfig(k=16, q=q, iters=3))
    pwp = np.asarray(RP.pattern_weight_products(jnp.asarray(pats), jnp.asarray(w)))
    return a, w, pats, pwp


def _pwp_variant(pwp, kind):
    """(jax pwp, jax scale, torch pwp, torch scale) for f32 / bf16 / int8 banks."""
    T, q1, _ = pwp.shape
    if kind == "f32":
        return jnp.asarray(pwp), jnp.ones((T, q1), jnp.float32), t(pwp), torch.ones(T, q1)
    if kind == "bf16":
        return (jnp.asarray(pwp).astype(jnp.bfloat16), jnp.ones((T, q1), jnp.float32),
                t(pwp).to(torch.bfloat16), torch.ones(T, q1))
    q8, scale = RP.quantize_pwp(jnp.asarray(pwp))
    return q8, scale, t(q8), t(scale)


# XLA on the CPU contracts ``acc + pwp·scale`` into one fused multiply-add;
# the port rounds the product first, as the source writes it (and as the
# CUDA kernel must, built with --fmad=false). With an f32 or bf16 bank the
# scale is 1 and the product exact, so the two agree bitwise. With an int8
# bank each of the T products may differ by one rounding: the sum is held to
# INT8_RTOL of the L1 magnitude.
INT8_RTOL = 1e-5


def _assert_fused_equal(kind, got, want):
    if kind == "int8":
        np.testing.assert_allclose(got, want, rtol=INT8_RTOL, atol=INT8_RTOL)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("M,K,N,q,bm,bn", [(64, 64, 32, 8, 32, 32), (96, 48, 24, 16, 32, 24)])
def test_plain_fused_bitwise_vs_pallas_interpret(kind, M, K, N, q, bm, bn):
    a, w, pats, pwp = _setup(M, K, N, q, seed=M + q)
    jp, js, tp, ts = _pwp_variant(pwp, kind)
    rout, rnnz = phi_fused_pallas(jnp.asarray(a), jnp.asarray(pats), jp, js, jnp.asarray(w),
                                  block_m=bm, block_n=bn, interpret=True)
    out, nnz = phi_fused_plain(t(a), t(pats), tp, ts, t(w), block_m=bm)
    _assert_fused_equal(kind, out.numpy(), np.asarray(rout))
    np.testing.assert_array_equal(nnz.numpy(), np.asarray(rnnz))
    assert int(nnz.sum()) > 0                     # the L2 path was exercised


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("M,K,N,q,bm,bn,gt", [(64, 128, 32, 8, 32, 32, 4),
                                              (96, 96, 24, 16, 32, 24, 2),
                                              (32, 64, 16, 8, 32, 16, 1)])
def test_plain_fused_stream_bitwise_vs_pallas_interpret(kind, M, K, N, q, bm, bn, gt):
    # The streaming kernel sums each partition in the same order as the first
    # one; its wrapper's plain version is the same function, held here against
    # the reference's streaming kernel, whatever its group depth.
    a, w, pats, pwp = _setup(M, K, N, q, seed=M + K + q)
    jp, js, tp, ts = _pwp_variant(pwp, kind)
    rout, rnnz = phi_fused_stream_pallas(jnp.asarray(a), jnp.asarray(pats), jp, js,
                                         jnp.asarray(w), block_m=bm, block_n=bn, group_t=gt,
                                         interpret=True)
    out, nnz = phi_fused_stream_cuda(t(a), t(pats), tp, ts, t(w), block_m=bm, group_t=gt)
    _assert_fused_equal(kind, out.numpy(), np.asarray(rout))
    np.testing.assert_array_equal(nnz.numpy(), np.asarray(rnnz))
    assert int(nnz.sum()) > 0


@pytest.mark.parametrize("M", [37, 100])
def test_ops_phi_fused_stream_ragged_m_and_short_last_group(M):
    # T = 6 partitions in groups of 4: the port's last group is shorter (the
    # reference's group_t must divide T, so it runs 2 and is compared at 2).
    a, w, pats, pwp = _setup(M, 96, 40, 8, seed=M)
    rout, rnnz = RO.phi_fused_stream(jnp.asarray(a), jnp.asarray(pats), jnp.asarray(pwp),
                                     jnp.asarray(w), block_m=32, block_n=40, group_t=2)
    for gt in (2, 4, None):
        out, nnz = ops.phi_fused_stream(t(a), t(pats), t(pwp), t(w), block_m=32, group_t=gt)
        assert out.shape == (M, 40) and nnz.shape == (-(-M // 32),)
        np.testing.assert_array_equal(out.numpy(), np.asarray(rout))
        np.testing.assert_array_equal(nnz.numpy(), np.asarray(rnnz))


def test_stream_smem_model_and_group_choice():
    # two stages of (group_t pattern rows of stride q+1, 16-byte rounded) and a
    # 32-row activation tile of group_t·k floats, plus the match tile
    assert stream_smem_bytes(128, 16, 8) == 2 * (8 * 129 * 8 + 4 * 32 * 8 * 16) + 32 * 8 * 24
    assert stream_smem_bytes(7, 5, 3) == 2 * (-(-3 * 8 * 8 // 16) * 16 + 4 * 32 * 3 * 5) \
        + 32 * 8 * 24
    assert ops.stream_group_t(128, 16) == 8
    gt = ops.stream_group_t(4096, 64)
    assert stream_smem_bytes(4096, 64, gt) <= SMEM_LIMIT < stream_smem_bytes(4096, 64, gt + 1)
    assert ops.stream_group_t(1 << 16, 16) is None


# The slice's GEMMs (M, K, N) at k = 16, q = 128: Spikformer-4-384's qkv,
# proj, fc1, fc2 and head, then the VGG's conv1-conv4 and head.
SLICE_GEMMS = [(8192, 384, 1152), (8192, 384, 384), (8192, 384, 1536), (8192, 1536, 384),
               (128, 384, 10), (32768, 576, 128), (8192, 1152, 256), (2048, 2304, 512),
               (512, 4608, 512), (128, 512, 10)]


def test_fused_shape_viable_is_the_hopper_gate():
    # Without usage skew the gate streams where T >= STREAM_MIN_T, which at
    # the slice's GEMMs is where the reference's VMEM gate streams.
    assert ops.STREAM_MIN_T == 96
    for M, K, N in SLICE_GEMMS:
        want = RO.fused_shape_viable(M, K, N, K // 16, 128)
        assert ops.fused_shape_viable(M, K, N, K // 16, 128) == want, (M, K, N)
    assert [RO.fused_shape_viable(M, K, N, K // 16, 128) for M, K, N in SLICE_GEMMS].count(
        "fused_stream") == 3
    # With skew the prefetching kernel, at every GEMM (the reference's VMEM
    # gate streams conv4 instead; the Hopper kernel's footprint is P-sized)
    for M, K, N in SLICE_GEMMS:
        assert ops.fused_shape_viable(M, K, N, K // 16, 128, p_active=24) == "fused_prefetch"
    assert ops.fused_shape_viable(256, 64, 64, 4, 1024) == "fused_stream"   # q past 512
    assert ops.fused_shape_viable(256, 64, 64, 4, 1 << 16) == "coo"        # no stage fits
    assert ops.fused_shape_viable(256, 256, 64, 2, 8) == "coo"             # k = 128


def _skewed_usage(T, q, hot, seed=0):
    """(T, q+1) usage counts: most matches on ``hot`` patterns per partition."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 3, (T, q + 1)).astype(np.int64)
    u[:, :hot] += 1000
    return u


@pytest.mark.parametrize("hot", [0, 8, 24])
def test_gate_reads_usage_skew_as_the_reference(hot):
    u = _skewed_usage(24, 128, hot) if hot else np.ones((24, 129), np.int64)
    want = RO.fused_shape_viable(8192, 384, 384, 24, 128, usage=u)
    assert ops.fused_shape_viable(8192, 384, 384, 24, 128, usage=u) == want
    assert want == ("fused_prefetch" if hot else "fused")


@pytest.mark.parametrize("M,bm,P", [(128, 32, 4), (100, 64, 8), (256, 256, 3)])
def test_stripe_active_sets_bitwise_vs_reference(M, bm, P):
    a, _, pats, _ = _setup(M, 64, 8, 16, seed=M + P)
    pad = -M % bm
    want = ref_stripe_active_sets(jnp.asarray(np.pad(a, ((0, pad), (0, 0)))),
                                  jnp.asarray(pats), P, bm)
    got = stripe_active_sets(t(a), t(pats), P, bm)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32 and got.shape == (-(-M // bm), 4, P)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("M,K,N,q,bm,bn,P", [(64, 64, 32, 16, 32, 32, 4),
                                             (96, 48, 24, 16, 32, 24, 8)])
def test_plain_fused_prefetch_bitwise_vs_pallas_interpret(kind, M, K, N, q, bm, bn, P):
    a, w, pats, pwp = _setup(M, K, N, q, seed=M + P)
    jp, js, tp, ts = _pwp_variant(pwp, kind)
    active = ref_stripe_active_sets(jnp.asarray(a), jnp.asarray(pats), P, bm)
    rout, rnnz = phi_fused_prefetch_pallas(jnp.asarray(a), jnp.asarray(pats), jp, js,
                                           jnp.asarray(w), active, block_m=bm, block_n=bn,
                                           interpret=True)
    out, nnz = phi_fused_prefetch_cuda(t(a), t(pats), tp, ts, t(w), t(active), block_m=bm)
    _assert_fused_equal(kind, out.numpy(), np.asarray(rout))
    np.testing.assert_array_equal(nnz.numpy(), np.asarray(rnnz))
    # with an f32 bank exact whatever the sets (a bf16 or int8 bank rounds its
    # rows, so another decomposition rounds otherwise); the restricted match
    # leaves more residual
    full, fnnz = phi_fused_plain(t(a), t(pats), tp, ts, t(w), block_m=bm)
    if kind == "f32":
        np.testing.assert_array_equal(out.numpy(), full.numpy())
    assert (nnz >= fnnz).all() and int(nnz.sum()) > int(fnnz.sum())


@pytest.mark.parametrize("M", [37, 100])
def test_ops_phi_fused_prefetch_from_usage_vs_reference(M):
    a, w, pats, pwp = _setup(M, 64, 40, 16, seed=M)
    usage = np.asarray(RP.pattern_usage(jnp.asarray(a), jnp.asarray(pats)))
    usage[:, :4] += 10 * M                          # skew: four hot patterns a partition
    rout, rnnz = RO.phi_fused_prefetch(jnp.asarray(a), jnp.asarray(pats), jnp.asarray(pwp),
                                       jnp.asarray(w), usage=usage, block_m=32, block_n=40)
    out, nnz = ops.phi_fused_prefetch(t(a), t(pats), t(pwp), t(w), usage=usage, block_m=32)
    assert out.shape == (M, 40) and nnz.shape == (-(-M // 32),)
    np.testing.assert_array_equal(out.numpy(), np.asarray(rout))
    np.testing.assert_array_equal(nnz.numpy(), np.asarray(rnnz))
    np.testing.assert_array_equal(out.numpy(), a @ w)                    # lossless
    with pytest.raises(ValueError, match="no exploitable skew"):
        ops.phi_fused_prefetch(t(a), t(pats), t(pwp), t(w), usage=np.ones((4, 17)))
    with pytest.raises(ValueError, match="usage"):
        ops.phi_fused_prefetch(t(a), t(pats), t(pwp), t(w))


def test_plain_fused_undyadic_weights_within_tolerance():
    # Off the dyadic grid only the order of the k-term L2 sum of a partition
    # differs (a matmul on each side): a few float32 ulps of the row sums.
    a, w, pats, pwp = _setup(64, 64, 32, 8, seed=5, dyadic_w=False)
    rout, _ = phi_fused_pallas(jnp.asarray(a), jnp.asarray(pats), jnp.asarray(pwp),
                               jnp.ones(pwp.shape[:2], jnp.float32), jnp.asarray(w),
                               block_m=32, block_n=32, interpret=True)
    out, _ = phi_fused_plain(t(a), t(pats), t(pwp), torch.ones(pwp.shape[:2]), t(w), block_m=32)
    np.testing.assert_allclose(out.numpy(), np.asarray(rout), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [5, 16, 64])
def test_pack_patterns_sets_bit_j_for_element_j(k):
    rng = np.random.default_rng(k)
    pats = (rng.random((3, 7, k)) < 0.4).astype(np.uint8) * rng.integers(1, 256, (3, 7, k),
                                                                           dtype=np.uint8)
    words = pack_patterns(t(pats)).numpy().astype(np.uint64)
    want = ((pats != 0).astype(np.uint64) << np.arange(k, dtype=np.uint64)).sum(-1)
    np.testing.assert_array_equal(words, want)
    state = PhiState({"x": t(pats)}, {"x": torch.zeros((3, 8, 2))})
    assert torch.equal(state.packed["x"], pack_patterns(t(pats)))
    with pytest.raises(ValueError, match="64-bit word"):
        pack_patterns(torch.zeros((1, 2, 65), dtype=torch.uint8))


@pytest.mark.parametrize("M", [37, 100])
def test_ops_phi_fused_ragged_m(M):
    a, w, pats, pwp = _setup(M, 48, 40, 8, seed=M)
    rout, rnnz = RO.phi_fused(jnp.asarray(a), jnp.asarray(pats), jnp.asarray(pwp),
                              jnp.asarray(w), block_m=32, block_n=40)
    out, nnz = ops.phi_fused(t(a), t(pats), t(pwp), t(w), block_m=32)
    assert out.shape == (M, 40) and nnz.shape == (-(-M // 32),)
    np.testing.assert_array_equal(out.numpy(), np.asarray(rout))
    np.testing.assert_array_equal(nnz.numpy(), np.asarray(rnnz))


# The ref lowering takes no dequant scale in either package: no int8 case.
@pytest.mark.parametrize("impl,int8", [("ref", False), ("coo", False), ("fused", False),
                                       ("fused_stream", False), ("fused_prefetch", False),
                                       ("coo", True), ("fused", True), ("fused_stream", True),
                                       ("fused_prefetch", True)])
def test_phi_matmul_bitwise_vs_reference(impl, int8):
    a, w, pats, pwp = _setup(80, 64, 48, 16, seed=7)
    a3 = a.reshape(2, 40, 64)
    kw, tkw, jp, tp = {}, {}, jnp.asarray(pwp), t(pwp)
    if impl == "fused_prefetch":
        kw, tkw = {"p_active": 6}, {"p_active": 6}
    if int8:
        jp, js = RP.quantize_pwp(jnp.asarray(pwp))
        kw, tkw, tp = {**kw, "pwp_scale": js}, {**tkw, "pwp_scale": t(js)}, t(jp)
    want = RO.phi_matmul(jnp.asarray(a3), jnp.asarray(w), jnp.asarray(pats), jp,
                         impl=impl, **kw)
    got = ops.phi_matmul(t(a3), t(w), t(pats), tp, impl=impl, **tkw)
    assert got.shape == (2, 40, 48)
    _assert_fused_equal("int8" if int8 else "f32", got.numpy(), np.asarray(want))
    if not int8:
        np.testing.assert_array_equal(got.numpy(), a3 @ w)    # lossless


def test_phi_matmul_refuses_unported_and_unknown_impls():
    """Named when "pallas" raised NotImplementedError; every lowering is
    ported now, so "pallas" runs (bitwise equal to the reference's on dyadic
    weights) and refuses only an int8 bank, whose scales it cannot apply."""
    a, w, pats, pwp = _setup(16, 32, 8, 4)
    got = ops.phi_matmul(t(a), t(w), t(pats), t(pwp), impl="pallas")
    want = RO.phi_matmul(jnp.asarray(a), jnp.asarray(w), jnp.asarray(pats), jnp.asarray(pwp),
                         impl="pallas")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        ops.phi_matmul(t(a), t(w), t(pats), t(pwp), impl="bogus")
    q8, scale = P.quantize_pwp(t(pwp))
    with pytest.raises(ValueError, match="pwp_scale"):
        ops.phi_fused(t(a), t(pats), q8, t(w))
    for kw in (dict(), dict(pwp_scale=scale)):
        with pytest.raises(ValueError, match="int8"):
            ops.phi_matmul(t(a), t(w), t(pats), q8, impl="pallas", **kw)


def test_oracles_bitwise():
    a, w, pats, pwp = _setup(48, 32, 16, 8, seed=11)
    idx, res = ref.matcher_ref(t(a), t(pats))
    ridx, rres = RR.matcher_ref(jnp.asarray(a), jnp.asarray(pats, jnp.float32))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_array_equal(ref.l1_gather_ref(idx, t(pwp)).numpy(),
                                  np.asarray(RR.l1_gather_ref(ridx, jnp.asarray(pwp))))
    np.testing.assert_array_equal(ref.l2_dense_ref(res, t(w)).numpy(),
                                  np.asarray(RR.l2_dense_ref(rres, jnp.asarray(w))))
    rows, cols, signs = np.nonzero(np.asarray(rres)) + (None,)
    signs = np.asarray(rres)[rows, cols]
    rows = np.concatenate([rows, [48, 48]]).astype(np.int32)          # sentinel entries
    cols = np.concatenate([cols, [0, 3]]).astype(np.int32)
    signs = np.concatenate([signs, [1, -1]]).astype(np.int8)
    got = ref.l2_spmm_ref(t(rows), t(cols), t(signs), t(w), 48)
    want = RR.l2_spmm_ref(jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(signs),
                          jnp.asarray(w), 48)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(ref.phi_matmul_ref(t(a), t(w), t(pats), t(pwp)).numpy(), a @ w)


# ------------------------------------------------------------------- LIF ---
# With decay 0.5 (the model's) v·decay is exact and the step is bitwise. For
# another decay XLA on the CPU fuses v·decay + x into one multiply-add while
# the port rounds twice: v_int, and so v', may differ by one rounding of a
# value below 8 in magnitude, 2^-21 (spikes agree at this seed).
@pytest.mark.parametrize("reset", ["hard", "soft"])
@pytest.mark.parametrize("decay,threshold,atol", [(0.5, 1.0, 0.0), (0.75, 0.6, 2.0 ** -21)])
def test_plain_lif_step_vs_pallas_interpret(reset, decay, threshold, atol):
    rng = np.random.default_rng(0)
    v = rng.standard_normal((16, 128)).astype(np.float32)
    x = rng.standard_normal((16, 128)).astype(np.float32)
    rs, rv = lif_pallas(jnp.asarray(v), jnp.asarray(x), decay=decay, threshold=threshold,
                        reset=reset, block_r=8, block_c=128, interpret=True)
    s, vn = lif_step_cuda(t(v), t(x), decay=decay, threshold=threshold, reset=reset)
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_allclose(vn.numpy(), np.asarray(rv), rtol=0, atol=atol)
    s2, v2 = ops.lif_step(t(v).reshape(4, 4, 128), t(x).reshape(4, 4, 128), decay=decay,
                          threshold=threshold, reset=reset)
    np.testing.assert_array_equal(s2.reshape(16, 128).numpy(), s.numpy())
    np.testing.assert_array_equal(v2.reshape(16, 128).numpy(), vn.numpy())


@pytest.mark.parametrize("reset", ["hard", "soft"])
def test_lif_sequence_bitwise_vs_reference(reset):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((4, 6, 10)) * 1.5).astype(np.float32)
    cfg = L.LIFConfig(reset=reset)
    want = np.asarray(RL.lif_sequence(jnp.asarray(x), RL.LIFConfig(reset=reset)))
    got = L.lif_sequence(t(x), cfg)                       # no grad: kernel's plain version
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        lif_sequence_plain(t(x), decay=0.5, threshold=1.0, reset=reset).numpy(), want)
    xg = t(x).requires_grad_()
    with torch.enable_grad():
        got_g = L.lif_sequence(xg, cfg)                   # differentiable loop
    np.testing.assert_array_equal(got_g.detach().numpy(), want)


def test_spike_surrogate_gradient_matches_reference():
    # The arctan surrogate is a few float32 ops (square, divide) that XLA
    # and PyTorch may round differently in the last place: rtol 1e-6.
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, 5, 7)) * 1.5).astype(np.float32)
    g = rng.standard_normal((3, 5, 7)).astype(np.float32)

    def jloss(xx):
        return (RL.lif_sequence(xx, RL.LIFConfig()) * g).sum()

    want = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = t(x).requires_grad_()
    (L.lif_sequence(xt, L.LIFConfig()) * t(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-6, atol=1e-7)


def test_wrappers_refuse_devices_they_have_no_kernel_for():
    meta = torch.empty((4, 32), device="meta")
    with pytest.raises(ValueError):
        lif_sequence_cuda(meta)
    for fn in (phi_fused_cuda, phi_fused_stream_cuda):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(meta, torch.zeros(2, 4, 16), torch.zeros(2, 5, 8), torch.ones(2, 5),
               torch.zeros(32, 8), block_m=32)
    with pytest.raises(ValueError, match="unsupported device"):
        phi_fused_prefetch_cuda(meta, torch.zeros(2, 4, 16), torch.zeros(2, 5, 8),
                                torch.ones(2, 5), torch.zeros(32, 8),
                                torch.zeros((1, 2, 2), dtype=torch.int32, device="meta"),
                                block_m=32)
