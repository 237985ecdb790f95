"""The per-unit lowering (``impl="pallas"``) of the port against the reference.

Matcher, L1 gather and L2 spmm (on the CPU their wrappers run the plain
versions), ``bucket_coo`` and its capacities, ``phi_l2_audit`` and the
composite ``phi_matmul(impl="pallas")``, each held against
``repro.kernels.ops`` on the same numpy inputs, the reference's Pallas
kernels in interpret mode. Tolerance 0 throughout: the matcher is integer
work; the gather sums each row's partitions from zero in ascending t, the
reference's order, so it is bitwise on any f32 or bf16 bank; the spmm and the
composite are held on dyadic weights, where every sum is exact whatever the
order. Sizes are small: M ≤ 600, K ≤ 128, T ≤ 8, q ≤ 32.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_util import binary, clustered, dyadic, t

from repro.core import patterns as RP
from repro.core.assign import pack_l2_coo_jit as ref_pack_l2_coo_jit
from repro.kernels import ops as RO
from repro_torch.core.assign import pack_l2_coo_jit
from repro_torch.core.patterns import quantize_pwp
from repro_torch.kernels import ops
from repro_torch.kernels.matcher import matcher_cuda, matcher_plain
from repro_torch.kernels.phi_gather import (
    check_range_flag, l1_gather_cuda, l1_gather_plain, make_range_flag)
from repro_torch.kernels.phi_spmm import l2_spmm_cuda, l2_spmm_plain, spmm_rows_per_warp


def _setup(M, K, N, q, seed=0, dyadic_w=True):
    rng = np.random.default_rng(seed)
    a = clustered(rng, M, K, protos=max(4, q // 2))
    w = rng.standard_normal((K, N)).astype(np.float32) * 0.3
    if dyadic_w:
        w = dyadic(w)
    pats = RP.calibrate(a, RP.PhiConfig(k=16, q=q, iters=3))
    pwp = np.asarray(RP.pattern_weight_products(jnp.asarray(pats), jnp.asarray(w)))
    return a, w, pats, pwp


def _coo(M, K, seed, density=0.1):
    """A {-1, 0, +1} residual and its padded COO from both packers."""
    rng = np.random.default_rng(seed)
    r = (rng.integers(0, 2, (M, K)) * 2 - 1).astype(np.int8)
    r[rng.random((M, K)) >= density] = 0
    cap = int(M * K * 0.2)
    want = ref_pack_l2_coo_jit(jnp.asarray(r), cap)
    got = pack_l2_coo_jit(t(r), cap)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    return r, got[:3], want[:3]


# ----------------------------------------------------------------- matcher ---
@pytest.mark.parametrize("M", [256, 293, 600])
def test_matcher_bitwise_vs_reference(M):
    a, _, pats, _ = _setup(M, 96, 8, 16, seed=M)
    got_idx, got_res = ops.matcher(t(a), t(pats))
    want_idx, want_res = RO.matcher(jnp.asarray(a), jnp.asarray(pats))
    assert got_idx.dtype == torch.int32 and got_res.dtype == torch.int8
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_res.numpy(), np.asarray(want_res))
    # leading axes are kept, as the reference keeps them
    idx3, res3 = ops.matcher(t(a[:240]).reshape(2, 120, 96), t(pats), block_m=64)
    np.testing.assert_array_equal(idx3.reshape(240, -1).numpy(), np.asarray(want_idx)[:240])
    np.testing.assert_array_equal(res3.reshape(240, -1).numpy(), np.asarray(want_res)[:240])


def test_matcher_hamming_ties_and_the_strict_rule():
    """Duplicate and equidistant patterns (the first index wins) and rows
    whose best distance only ties their popcount (no pattern)."""
    k = 16
    bank = np.zeros((2, 4, k), np.uint8)
    bank[:, 0, [0, 1]] = 1
    bank[:, 1, [0, 1]] = 1                          # a duplicate of pattern 0
    bank[:, 2, [2, 3]] = 1
    bank[:, 3, [0]] = 1
    rows = np.zeros((5, 2 * k), np.float32)
    for r, bits in enumerate(([0, 1], [2], [0, 2], [0, 1, 2, 3], [])):
        rows[r, bits] = 1
        rows[r, [k + b for b in bits]] = 1
    rng = np.random.default_rng(7)                  # sparse rows and patterns: many ties
    rows = np.concatenate([rows, binary(rng, (60, 2 * k), 0.1)])
    bank = np.concatenate([bank, binary(rng, (2, 4, k), 0.1).astype(np.uint8)], axis=1)
    got_idx, got_res = ops.matcher(t(rows), t(bank), block_m=32)
    want_idx, want_res = RO.matcher(jnp.asarray(rows), jnp.asarray(bank), block_m=32)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_res.numpy(), np.asarray(want_res))
    assert got_idx[:5, 0].tolist() == [0, 8, 3, 0, 8]           # q = 8: no pattern
    plain_idx, plain_res = matcher_plain(t(rows), t(bank))
    kern_idx, kern_res = matcher_cuda(t(rows), t(bank))           # CPU: the plain version
    assert torch.equal(kern_idx, plain_idx) and torch.equal(kern_res, plain_res)


# --------------------------------------------------------------- L1 gather ---
@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["mxu", "take"])
@pytest.mark.parametrize("M,N", [(256, 128), (300, 96), (40, 10)])
def test_l1_gather_bitwise_vs_reference_on_any_bank(kind, mode, M, N):
    rng = np.random.default_rng(M + N)
    T, q = 5, 31
    idx = rng.integers(0, q + 1, (M, T)).astype(np.int32)
    pwp = rng.standard_normal((T, q + 1, N)).astype(np.float32)      # not dyadic
    pwp[:, q] = 0.0
    jpwp, tpwp = jnp.asarray(pwp), t(pwp)
    if kind == "bf16":
        jpwp, tpwp = jpwp.astype(jnp.bfloat16), tpwp.to(torch.bfloat16)
    got = ops.l1_gather(t(idx), tpwp, mode=mode, block_n=128)
    want = RO.l1_gather(jnp.asarray(idx), jpwp, mode=mode, block_n=128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    other = "take" if mode == "mxu" else "mxu"                        # both modes, bitwise
    assert torch.equal(ops.l1_gather(t(idx), tpwp, mode=other, block_n=128), got)
    assert torch.equal(l1_gather_cuda(t(idx), tpwp), got)           # CPU: the plain version
    assert torch.equal(l1_gather_plain(t(idx), tpwp), got)
    with pytest.raises(ValueError, match="mode"):
        ops.l1_gather(t(idx), tpwp, mode="onehot")


@pytest.mark.parametrize("bad", [-1, 32])
def test_l1_gather_refuses_an_index_outside_the_bank(bad):
    """An index outside [0, q] is refused, not wrapped or dropped: the kernel
    and its plain version raise alike."""
    rng = np.random.default_rng(3)
    T, q = 4, 31
    idx = rng.integers(0, q + 1, (40, T)).astype(np.int32)
    idx[7, 2] = bad
    pwp = t(rng.standard_normal((T, q + 1, 16)).astype(np.float32))
    for fn in (l1_gather_plain, l1_gather_cuda, ops.l1_gather):
        with pytest.raises(ValueError, match="outside the bank's rows"):
            fn(t(idx), pwp)


# ----------------------------------------------------------------- L2 spmm ---
@pytest.mark.parametrize("mode", ["take", "mxu"])
@pytest.mark.parametrize("M,K", [(40, 64), (256, 128), (513, 48)])
def test_l2_spmm_bitwise_vs_reference(mode, M, K):
    r, (rows, cols, signs), (jr, jc, js) = _coo(M, K, seed=M + K)
    w = dyadic(np.random.default_rng(K).standard_normal((K, 128)).astype(np.float32))
    got = ops.l2_spmm(rows, cols, signs, t(w), M, mode=mode, block_n=128)
    want = RO.l2_spmm(jr, jc, js, jnp.asarray(w), M, mode=mode, block_n=128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), r.astype(np.float32) @ w)
    other = "mxu" if mode == "take" else "take"
    assert torch.equal(ops.l2_spmm(rows, cols, signs, t(w), M, mode=other, block_n=128), got)
    with pytest.raises(ValueError, match="mode"):
        ops.l2_spmm(rows, cols, signs, t(w), M, mode="onehot")


def test_l2_spmm_plain_sums_each_row_from_zero_in_entry_order():
    """The order the kernel sums in: on weights off the dyadic grid the plain
    version equals a loop over the entries."""
    r, (rows, cols, signs), _ = _coo(70, 48, seed=5, density=0.3)
    w = np.random.default_rng(1).standard_normal((48, 40)).astype(np.float32)
    bm = 32
    br, bc, bs, dropped = ops.bucket_coo(rows, cols, signs, 96, bm, cap=48 * bm)
    assert int(dropped) == 0
    got = l2_spmm_plain(br, bc, bs, t(w), block_m=bm)
    assert torch.equal(l2_spmm_cuda(br, bc, bs, t(w), block_m=bm), got)  # CPU: plain
    want = np.zeros((96, 40), np.float32)
    for g in range(3):
        for lr, c, s in zip(br[g].tolist(), bc[g].tolist(), bs[g].tolist()):
            if lr < bm:
                want[g * bm + lr] = want[g * bm + lr] + w[c] * np.float32(s)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------- bucket_coo, caps ---
def test_bucket_coo_overflow_reported():
    rows = torch.zeros(16, dtype=torch.int32)                        # 16 entries in block 0
    cols = torch.zeros(16, dtype=torch.int32)
    signs = torch.ones(16, dtype=torch.int8)
    got = ops.bucket_coo(rows, cols, signs, 8, 8, cap=4)
    want = RO.bucket_coo(jnp.asarray(rows.numpy()), jnp.asarray(cols.numpy()),
                         jnp.asarray(signs.numpy()), 8, 8, cap=4)
    assert int(got[3]) == int(want[3]) == 12
    for g, w_ in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


@pytest.mark.parametrize("cap,dropped", [(4, 0), (1, 2)])
def test_bucket_coo_sentinels_not_counted_dropped(cap, dropped):
    """With M = 10 in blocks of 8 the sentinels (row M, sign 0) fall inside
    the last block's span; they take no capacity and are not dropped. At
    cap 1 each block drops one real entry."""
    r = np.zeros((10, 8), np.int8)
    r[0, 0], r[5, 3], r[9, 1] = 1, -1, 1
    r[9, 5] = -1
    rows, cols, signs, over = pack_l2_coo_jit(t(r), 32)
    assert int(over) == 0
    got = ops.bucket_coo(rows, cols, signs, 16, 8, cap=cap)
    want = RO.bucket_coo(*(jnp.asarray(x.numpy()) for x in (rows, cols, signs)), 16, 8,
                         cap=cap)
    assert int(got[3]) == int(want[3]) == dropped
    for g, w_ in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    assert got[0].dtype == torch.int32 and got[2].dtype == torch.int8
    w = dyadic(np.random.default_rng(0).standard_normal((8, 128)).astype(np.float32))
    out = ops.l2_spmm(rows, cols, signs, t(w), 10, block_m=8, cap=cap)
    want_out = RO.l2_spmm(*(jnp.asarray(x.numpy()) for x in (rows, cols, signs)),
                          jnp.asarray(w), 10, block_m=8, cap=cap)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want_out))
    assert np.array_equal(out.numpy(), r.astype(np.float32) @ w) == (dropped == 0)


@pytest.mark.parametrize("args", [(0.08, 256, 576, 10 ** 7), (0.10, 256, 4608, 10 ** 4),
                                  (1e-6, 8, 16, 100), (0.5, 64, 64, 50)])
def test_l2_per_block_cap_vs_reference(args):
    assert ops.l2_per_block_cap(*args) == RO.l2_per_block_cap(*args)


@pytest.mark.parametrize("N,block_n", [(128, 256), (512, 256), (384, 256), (10, 256),
                                       (96, 64), (7, 256)])
def test_pick_block_n_vs_reference(N, block_n):
    assert ops._pick_block_n(N, block_n) == RO._pick_block_n(N, block_n)


@pytest.mark.parametrize("N", [257, 538])
def test_pick_block_n_refuses_degenerate_divisors(N):
    with pytest.raises(ValueError, match="no usable block_n"):
        RO._pick_block_n(N, 256)
    with pytest.raises(ValueError, match="no usable block_n"):
        ops._pick_block_n(N, 256)
    a, w, pats, pwp = _setup(16, 32, N, 4)
    with pytest.raises(ValueError, match="no usable block_n"):
        ops.phi_matmul(t(a), t(w), t(pats), t(pwp), impl="pallas")


# ------------------------------------------------------------------ audit ---
@pytest.mark.parametrize("M,budget,block_m", [(300, 0.08, 8), (20, 0.01, 256),
                                              (600, 0.10, 256), (293, 0.002, 64)])
def test_phi_l2_audit_equals_reference(M, budget, block_m, monkeypatch):
    monkeypatch.setenv("PHI_CHUNK_ROWS", "128")
    a, _, pats, _ = _setup(M, 64, 8, 16, seed=M)
    got = ops.phi_l2_audit(t(a), t(pats), nnz_budget=budget, block_m=block_m)
    want = RO.phi_l2_audit(jnp.asarray(a), jnp.asarray(pats), nnz_budget=budget,
                           block_m=block_m)
    assert got == want
    assert set(got) == {"l2_nnz", "cap", "pack_overflow", "bucket_dropped", "chunk_cap",
                        "chunk_overflow"}


# -------------------------------------------------------------- composite ---
@pytest.mark.parametrize("M,N", [(256, 72), (293, 96), (600, 10)])
def test_phi_matmul_pallas_bitwise_vs_reference(M, N):
    a, w, pats, pwp = _setup(M, 128, N, 32, seed=M + N)
    got = ops.phi_matmul(t(a), t(w), t(pats), t(pwp), impl="pallas", nnz_budget=0.10)
    want = RO.phi_matmul(jnp.asarray(a), jnp.asarray(w), jnp.asarray(pats), jnp.asarray(pwp),
                         impl="pallas", nnz_budget=0.10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), a @ w)                  # lossless in budget
    aud = ops.phi_l2_audit(t(a), t(pats), nnz_budget=0.10)
    assert aud["pack_overflow"] == aud["bucket_dropped"] == 0
    # a bf16 bank and leading axes
    got16 = ops.phi_matmul(t(a).reshape(1, M, 128), t(w), t(pats), t(pwp).to(torch.bfloat16),
                           impl="pallas", nnz_budget=0.10)
    want16 = RO.phi_matmul(jnp.asarray(a), jnp.asarray(w), jnp.asarray(pats),
                           jnp.asarray(pwp).astype(jnp.bfloat16), impl="pallas",
                           nnz_budget=0.10)
    np.testing.assert_array_equal(got16.reshape(M, N).numpy(), np.asarray(want16))


@pytest.mark.parametrize("budget", [0.02, 0.005])
def test_phi_matmul_pallas_drops_the_same_entries_at_an_overflowing_budget(budget):
    rng = np.random.default_rng(3)
    a = binary(rng, (300, 64), 0.2)                   # unclustered: a large residual
    w = dyadic(rng.standard_normal((64, 24)).astype(np.float32))
    pats = RP.calibrate(a, RP.PhiConfig(k=16, q=8, iters=3))
    pwp = np.asarray(RP.pattern_weight_products(jnp.asarray(pats), jnp.asarray(w)))
    aud = ops.phi_l2_audit(t(a), t(pats), nnz_budget=budget)
    assert aud == RO.phi_l2_audit(jnp.asarray(a), jnp.asarray(pats), nnz_budget=budget)
    assert aud["pack_overflow"] > 0 or aud["bucket_dropped"] > 0
    got = ops.phi_matmul(t(a), t(w), t(pats), t(pwp), impl="pallas", nnz_budget=budget)
    want = RO.phi_matmul(jnp.asarray(a), jnp.asarray(w), jnp.asarray(pats), jnp.asarray(pwp),
                         impl="pallas", nnz_budget=budget)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(got.numpy(), a @ w)     # entries were dropped, as audited


def test_phi_matmul_pallas_refuses_an_int8_bank():
    a, w, pats, pwp = _setup(64, 32, 16, 8)
    q8, scale = quantize_pwp(t(pwp))
    for kw in (dict(), dict(pwp_scale=scale)):
        with pytest.raises(ValueError, match="int8"):
            ops.phi_matmul(t(a), t(w), t(pats), q8, impl="pallas", **kw)
    # the fused lowerings take it, with its scales
    ops.phi_matmul(t(a), t(w), t(pats), q8, impl="fused", pwp_scale=scale)


def test_phi_matmul_defaults_are_the_references():
    """Every keyword both packages' ``phi_matmul`` take has the same default;
    the lowering a caller gets without naming one is the budgeted "pallas"."""
    import inspect

    ours = inspect.signature(ops.phi_matmul).parameters
    theirs = inspect.signature(RO.phi_matmul).parameters
    shared = [name for name in theirs if name in ours]
    assert {"impl", "nnz_budget", "block_m", "block_n", "pwp_scale", "usage",
            "p_active"} <= set(shared)
    for name in shared:
        assert ours[name].default == theirs[name].default, name
    assert ours["impl"].default == "pallas"


@pytest.mark.parametrize("budget", [0.02, 0.005])
def test_phi_matmul_without_an_impl_equals_the_references_at_an_overflowing_budget(budget):
    rng = np.random.default_rng(4)
    a = binary(rng, (300, 64), 0.2)
    w = dyadic(rng.standard_normal((64, 24)).astype(np.float32))
    pats = RP.calibrate(a, RP.PhiConfig(k=16, q=8, iters=3))
    pwp = np.asarray(RP.pattern_weight_products(jnp.asarray(pats), jnp.asarray(w)))
    got = ops.phi_matmul(t(a), t(w), t(pats), t(pwp), nnz_budget=budget)
    want = RO.phi_matmul(*(jnp.asarray(x) for x in (a, w, pats, pwp)), nnz_budget=budget)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(got.numpy(), a @ w)          # the budget dropped entries


@pytest.mark.parametrize("bad", [-1, 32, 2 ** 30])
def test_l1_gather_with_a_range_flag_refuses_on_the_cpu_as_the_plain_does(bad):
    """On CPU tensors the wrapper runs the plain version, which checks the
    range itself: a flag changes nothing there."""
    rng = np.random.default_rng(5)
    T, q = 4, 31
    idx = rng.integers(0, q + 1, (40, T)).astype(np.int32)
    idx[11, 3] = bad
    pwp = t(rng.standard_normal((T, q + 1, 16)).astype(np.float32))
    flag = make_range_flag(torch.device("cpu"))
    for call in (lambda: l1_gather_plain(t(idx), pwp),
                 lambda: l1_gather_cuda(t(idx), pwp, range_flag=flag),
                 lambda: ops.l1_gather(t(idx), pwp, range_flag=flag)):
        with pytest.raises(ValueError, match=rf"idx spans \[{min(bad, 0)}, {max(bad, q)}\], "
                                             "outside the bank's rows"):
            call()
    assert int(flag[0]) == 0
    # a flag the kernel set is refused with the direct call's message
    flag[0] = 1
    with pytest.raises(ValueError, match="outside the bank's rows"):
        check_range_flag(flag, t(idx), q + 1)
    check_range_flag(torch.zeros(1, dtype=torch.int32), t(idx), q + 1)   # clear: no raise


@pytest.mark.parametrize("M,N", [(256, 72), (600, 10)])
def test_phi_matmul_pallas_gathers_ahead_of_the_packer_bitwise(M, N, monkeypatch):
    """The lowering launches the gather before the COO packer (whose sync
    then covers the gather's range flag), and stays bitwise equal to the
    reference's lowering."""
    a, w, pats, pwp = _setup(M, 128, N, 32, seed=M + 2 * N)
    order = []
    for name in ("l1_gather", "matcher", "l2_spmm"):
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *x, _r=real, _n=name, **k: (order.append(_n),
                                                                          _r(*x, **k))[1])
    real_pack = ops.pack_l2_coo_jit
    monkeypatch.setattr(ops, "pack_l2_coo_jit",
                        lambda *x, **k: (order.append("pack"), real_pack(*x, **k))[1])
    got = ops.phi_matmul(t(a), t(w), t(pats), t(pwp), impl="pallas", nnz_budget=0.10)
    assert order == ["matcher", "l1_gather", "pack", "l2_spmm"]
    want = RO.phi_matmul(*(jnp.asarray(x) for x in (a, w, pats, pwp)), impl="pallas",
                         nnz_budget=0.10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# The VGG slice's five pallas GEMMs: (M, N, T).
VGG_UNITS = {"conv1": (32768, 128, 36), "conv2": (8192, 256, 72), "conv3": (2048, 512, 144),
             "conv4": (512, 512, 288), "head": (128, 10, 32)}


@pytest.mark.parametrize("layer,rpw", [("conv1", 4), ("conv2", 2), ("conv3", 1), ("conv4", 1),
                                       ("head", 1)])
def test_spmm_rows_per_warp_at_each_vgg_gemm(layer, rpw):
    """The spmm's launch plan at the slice's GEMMs (blocks of 256 rows): a
    warp gets the most rows that keep 4224 warps in the grid, fewer where the
    GEMM has few rows; no fewer than one."""
    M, N, T = VGG_UNITS[layer]
    bm = ops.effective_block_m(M, 256)
    G = -(-M // bm)
    assert spmm_rows_per_warp(G, bm, N) == rpw
    warps = G * -(-bm // rpw) * -(-N // 128)
    assert warps >= 4224 or rpw == 1
