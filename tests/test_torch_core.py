"""repro_torch.core held against repro.core on the same numpy inputs.

Every comparison here is bitwise (tolerance 0): assignment, packing and
k-means work on binary data and integer counts, and the PWP test uses
dyadic weights, where every float32 sum is exact.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_util import binary, clustered, dyadic, reference_init_idx, t

from repro.core import assign as RA
from repro.core import patterns as RP
from repro_torch.core import assign as A
from repro_torch.core import patterns as P


def _bank(rng, T, q, k, p=0.3):
    return binary(rng, (T, q, k), p).astype(np.uint8)


def _tie_rows(pats: np.ndarray) -> np.ndarray:
    """Rows with Hamming ties between patterns and rows with best_h == pop_a."""
    T, q, k = pats.shape
    rows = []
    p0, p1 = pats[0, 0].astype(np.float32), pats[0, 1].astype(np.float32)
    # equidistant from patterns 0 and 1 where they differ in two bits
    mid = p0.copy()
    diff = np.flatnonzero(p0 != p1)
    if diff.size >= 2:
        mid[diff[0]] = p1[diff[0]]
    rows.append(mid)
    rows.append(p1.copy())                        # exact match of a later pattern
    one_hot = np.zeros(k, np.float32)
    one_hot[3] = 1.0                              # pop_a = 1: best_h >= pop_a likely
    rows.append(one_hot)
    rows.append(np.zeros(k, np.float32))          # all-zero row
    block = np.stack(rows)                        # (r, k) for partition 0
    return np.tile(block, (1, T))


@pytest.mark.parametrize("M,T,q,k", [(64, 3, 8, 16), (33, 2, 16, 8), (16, 4, 5, 16)])
def test_assign_patterns_bitwise(M, T, q, k):
    rng = np.random.default_rng(M + T)
    pats = _bank(rng, T, q, k)
    pats[:, 1] = pats[:, 0]                       # duplicate pattern: argmin tie
    a = np.concatenate([clustered(rng, M, T * k), _tie_rows(pats)])
    ridx, rres = RA.assign_patterns(jnp.asarray(a), jnp.asarray(pats, jnp.float32))
    idx, res = A.assign_patterns(t(a), t(pats))
    assert idx.dtype == torch.int32 and res.dtype == torch.int8
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_array_equal(res.numpy(), np.asarray(rres))
    # lossless: A = Level1 + residual, and Level1 equals the reference's
    l1 = A.level1_matrix(idx, t(pats))
    np.testing.assert_array_equal(l1.numpy(), np.asarray(RA.level1_matrix(ridx, jnp.asarray(pats))))
    np.testing.assert_array_equal(l1.to(torch.float32).numpy() + res.numpy(), a)


def test_assign_strict_rule_and_first_index_on_hand_built_rows():
    k = 8
    pats = np.zeros((1, 3, k), np.uint8)
    pats[0, 0, :4] = 1                            # 11110000
    pats[0, 1, :4] = 1                            # duplicate: tie, first index wins
    pats[0, 2, 4:6] = 1                           # 00001100
    a = np.zeros((4, k), np.float32)
    a[0, :4] = 1                                  # exact match -> idx 0
    a[1, :3] = 1                                  # H=1 < pop 3 -> idx 0
    a[2, 4] = 1                                   # H=1 == pop 1 -> no pattern
    a[3, [0, 4]] = 1                              # H(p0)=4, H(p2)=2 == pop 2 -> none
    idx, res = A.assign_patterns(t(a), t(pats))
    assert idx[:, 0].tolist() == [0, 0, 3, 3]
    np.testing.assert_array_equal(res[2].numpy(), a[2])
    ridx, rres = RA.assign_patterns(jnp.asarray(a), jnp.asarray(pats, jnp.float32))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_array_equal(res.numpy(), np.asarray(rres))


@pytest.mark.parametrize("cap", [4, 40, 400])
def test_pack_l2_coo_bitwise(cap):
    rng = np.random.default_rng(cap)
    res = (rng.integers(-1, 2, (12, 32)) * (rng.random((12, 32)) < 0.1)).astype(np.int8)
    ref = RA.pack_l2_coo_jit(jnp.asarray(res), cap)
    got = A.pack_l2_coo_jit(t(res), cap)
    for g, r in zip(got[:3], ref[:3]):
        assert g.dtype == getattr(torch, str(np.asarray(r).dtype))
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert int(got[3]) == int(ref[3])             # overflow count
    nnz = int((res != 0).sum())
    if nnz <= cap:
        for g, r in zip(A.pack_l2_coo(res, cap), RA.pack_l2_coo(res, cap)):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(r))
    else:
        with pytest.raises(ValueError):
            A.pack_l2_coo(res, cap)


@pytest.mark.parametrize("q,iters", [(8, 5), (16, 3), (64, 2)])
def test_calibrate_bitwise_from_the_reference_initial_rows(q, iters):
    rng = np.random.default_rng(q)
    a = clustered(rng, 300, 48, protos=40, flip=0.08)
    cfg_r = RP.PhiConfig(k=16, q=q, iters=iters, seed=3)
    cfg = P.PhiConfig(k=16, q=q, iters=iters, seed=3)
    init = reference_init_idx(a, 16, q, seed=3)
    got = P.calibrate(t(a), cfg, init_idx=init, device="cpu")
    assert got.dtype == torch.uint8 and got.shape == (3, q, 16)
    np.testing.assert_array_equal(got.numpy(), RP.calibrate(a, cfg_r))


def test_kmeans_own_draw_is_seeded_and_gives_a_unique_binary_bank():
    rng = np.random.default_rng(0)
    a = clustered(rng, 400, 16, protos=60, flip=0.1)
    one = P.kmeans_binary(a, 32, iters=4, seed=5, device="cpu")
    two = P.kmeans_binary(t(a), 32, iters=4, seed=5, device="cpu")
    np.testing.assert_array_equal(one, two)
    assert set(np.unique(one)) <= {0, 1}
    assert len({r.tobytes() for r in one}) == 32
    # few unique rows: the bank is those rows, zero-padded, as in the reference
    few = a[:3]
    np.testing.assert_array_equal(P.kmeans_binary(few, 8, device="cpu"), RP.kmeans_binary(few, 8))


def test_calibrate_runs_on_the_card_unless_told_otherwise():
    a = clustered(np.random.default_rng(1), 64, 16, protos=20, flip=0.1)
    if torch.cuda.is_available():
        assert P.calibrate(t(a), P.PhiConfig(k=16, q=8, iters=2)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            P.calibrate(t(a), P.PhiConfig(k=16, q=8, iters=2))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            P.kmeans_binary(a, 8)


def test_pattern_usage_and_sets_equal():
    rng = np.random.default_rng(1)
    a = clustered(rng, 256, 64, protos=10)
    pats = RP.calibrate(a, RP.PhiConfig(k=16, q=16, iters=4))
    usage = P.pattern_usage(t(a), t(pats))
    ref_usage = RP.pattern_usage(a, pats)
    assert usage.dtype == np.int64
    np.testing.assert_array_equal(usage, ref_usage)
    np.testing.assert_array_equal(P.pattern_usage(t(a[:0]), t(pats)),
                                  RP.pattern_usage(a[:0], pats))
    for p in (1, 4, 99):
        np.testing.assert_array_equal(P.top_p_sets(usage, p), RP.top_p_sets(ref_usage, p))
    skew = ref_usage.copy()
    skew[:, :2] += 10_000                         # strong skew: active sets exist
    for u in (ref_usage, skew, np.zeros_like(ref_usage)):
        got, frac = P.active_pattern_sets(u, pad_to=2)
        want, rfrac = RP.active_pattern_sets(u, pad_to=2)
        assert frac == rfrac and (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, want)


def test_phi_stats_equal():
    rng = np.random.default_rng(2)
    a = clustered(rng, 128, 32)
    pats = RP.calibrate(a, RP.PhiConfig(k=16, q=8, iters=3))
    got = A.phi_stats(t(a), t(pats))
    want = RA.phi_stats(a, pats)
    for f in ("bit_density", "l1_density", "l2_pos_density", "l2_neg_density",
              "idx_density", "rows", "cols"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-6), f
    assert got.speedup_over_dense == pytest.approx(want.speedup_over_dense, rel=1e-6)


def test_pattern_weight_products_and_quantize_bitwise():
    rng = np.random.default_rng(3)
    pats = _bank(rng, 4, 8, 16)
    w = dyadic(rng.standard_normal((64, 24)))
    got = P.pattern_weight_products(t(pats), t(w))
    want = np.asarray(RP.pattern_weight_products(jnp.asarray(pats), jnp.asarray(w)))
    assert got.shape == (4, 9, 24)
    np.testing.assert_array_equal(got.numpy(), want)
    q8, scale = P.quantize_pwp(got)
    rq8, rscale = RP.quantize_pwp(jnp.asarray(want))
    np.testing.assert_array_equal(q8.numpy(), np.asarray(rq8))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(rscale))
