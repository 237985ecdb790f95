"""repro_torch attention held against the JAX reference on identical inputs.

The port's ``attn_score_block``, ``flash_attention`` and
``phi_flash_attention_plain`` against the reference's ``attn_score_block``,
``flash_attention``, ``phi_flash_attention_xla`` and
``phi_flash_attention_pallas(interpret=True)``; then the spikformer with
``attn="flash"`` end to end. The reference's policy-dispatched entries
(``dispatch.attention``, ``phi_apply``) die on the installed jax, so the
oracle is built from the lowerings directly.

Tolerances. Binary Q and K make every score an exact small integer, so the
score blocks and ``l2_nnz`` are compared bitwise, and the port's Phi flash
is bitwise equal to the port's dense flash (one accumulator code). Against
the reference the softmax differs in the last places: PyTorch's CPU ``exp``
and XLA's differ by an ulp on about one value in ten, the two reduce
``p.sum`` in another order, and XLA contracts ``den·corr + Σp`` and
``acc·corr + p·V`` into fused multiply-adds. Each output is a convex
combination of V rows, so the difference is held to ATOL_ULPS ulps of
max|V| (measured: at most 2.4e-7 at max|V| ≈ 3, about 2 ulps).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_util import binary, dyadic, np_tree, t

from repro.core.patterns import PhiConfig as RPhiConfig
from repro.kernels import ops as RO
from repro.kernels import phi_attention as RA
from repro.models import flash as RF
from repro.snn import models as RM
from repro_torch.core.patterns import PhiConfig
from repro_torch.interop import params_from_numpy, phi_state_from_numpy
from repro_torch.kernels import dispatch, ops
from repro_torch.kernels import phi_attention as A
from repro_torch.models import flash as F
from repro_torch.snn import models as M
from repro_torch.snn.data import synthetic_images

ATOL_ULPS = 16

# (B, S, H, D, causal, window, chunk, block_q, block_kv): unmasked, the three
# masks, and S % block != 0 on both axes.
CASES = {
    "plain": (2, 32, 3, 32, False, None, None, 16, 16),
    "causal": (2, 32, 3, 32, True, None, None, 16, 8),
    "window": (2, 32, 3, 32, True, 5, None, 16, 16),
    "chunk": (2, 32, 3, 32, False, None, 8, 8, 16),
    "ragged_s": (2, 37, 3, 32, False, None, None, 16, 16),
    "ragged_causal": (1, 37, 2, 32, True, None, None, 16, 8),
}


def _qkv(B, S, H, D, seed):
    rng = np.random.default_rng(seed)
    return (binary(rng, (B, S, H, D)), binary(rng, (B, S, H, D)),
            rng.standard_normal((B, S, H, D)).astype(np.float32), rng)


def _bank(rng, T, qp, kp, k_rows=None):
    """A bank of qp patterns; half drawn from the K rows so matches happen."""
    pats = binary(rng, (T, qp, kp), 0.3).astype(np.uint8)
    if k_rows is not None:
        rows = k_rows.reshape(-1, k_rows.shape[-1])
        pick = rows[rng.integers(0, rows.shape[0], qp // 2)]
        for ti in range(T):
            pats[ti, :qp // 2] = pick[:, ti * kp:(ti + 1) * kp]
    return pats


def _atol(v):
    return ATOL_ULPS * 2.0 ** -24 * float(np.abs(v).max())


@pytest.mark.parametrize("D,T,kp,qp", [(32, 2, 16, 8), (40, 2, 16, 8), (32, 4, 8, 16)])
def test_attn_score_block_bitwise_vs_reference(D, T, kp, qp):
    rng = np.random.default_rng(D + qp)
    kt, qi = binary(rng, (24, D)), binary(rng, (16, D))
    pats = _bank(rng, T, qp, kp, kt)
    s_ref, nnz_ref = RA.attn_score_block(jnp.asarray(kt), jnp.asarray(qi),
                                         jnp.asarray(pats, jnp.float32))
    s, nnz = A.attn_score_block(t(kt), t(qi), t(pats))
    assert s.shape == (16, 24) and nnz.shape == ()
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    assert int(nnz) == int(nnz_ref) > 0
    np.testing.assert_array_equal(s.numpy(), qi @ kt.T)            # exact scores
    # leading axes batch independent (batch, head) blocks
    kb, qb = binary(rng, (2, 3, 24, D)), binary(rng, (2, 3, 16, D))
    sb, nb = A.attn_score_block(t(kb), t(qb), t(pats))
    for i in range(2):
        for j in range(3):
            s1, n1 = A.attn_score_block(t(kb[i, j]), t(qb[i, j]), t(pats))
            assert torch.equal(sb[i, j], s1) and int(nb[i, j]) == int(n1)


@pytest.mark.parametrize("case", list(CASES))
def test_flash_attention_vs_reference(case):
    B, S, H, D, causal, window, chunk, bq, bkv = CASES[case]
    q, k, v, _ = _qkv(B, S, H, D, seed=len(case))
    want = np.asarray(RF.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         causal, window, chunk, bq, bkv))
    got = F.flash_attention(t(q), t(k), t(v), causal, window, chunk, bq, bkv)
    assert got.shape == (B, S, H, D) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=_atol(v))


@pytest.mark.parametrize("case", list(CASES))
def test_phi_flash_plain_vs_reference_lowerings(case):
    B, S, H, D, causal, window, chunk, bq, bkv = CASES[case]
    q, k, v, rng = _qkv(B, S, H, D, seed=10 + len(case))
    pats = _bank(rng, 2, 8, 16, k)
    kw = dict(causal=causal, window=window, chunk=chunk, block_q=bq, block_kv=bkv)
    jq, jk, jv, jp = (jnp.asarray(x) for x in (q, k, v, pats))
    want_xla = np.asarray(RA.phi_flash_attention_xla(jq, jk, jv, jp, **kw))
    want_pl, nnz_pl = RA.phi_flash_attention_pallas(jq, jk, jv, jp, interpret=True, **kw)
    got, nnz = A.phi_flash_attention_plain(t(q), t(k), t(v), t(pats), **kw)
    np.testing.assert_array_equal(nnz.numpy(), np.asarray(nnz_pl))   # exact audit counter
    assert int(nnz.sum()) > 0
    # every q-block column holds the count of the whole K panel
    assert (nnz == nnz[:, :1]).all()
    np.testing.assert_allclose(got.numpy(), want_xla, rtol=0, atol=_atol(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pl), rtol=0, atol=_atol(v))
    # the kernel's wrapper takes its plain version for CPU tensors
    out, nnz2 = A.phi_flash_attention_cuda(t(q), t(k), t(v), t(pats), **kw)
    assert torch.equal(out, got) and torch.equal(nnz2, nnz)


@pytest.mark.parametrize("case", list(CASES))
def test_phi_flash_plain_bitwise_equals_port_dense_flash(case):
    B, S, H, D, causal, window, chunk, bq, bkv = CASES[case]
    q, k, v, rng = _qkv(B, S, H, D, seed=20 + len(case))
    pats = _bank(rng, 2, 16, 16, k)
    got, _ = A.phi_flash_attention_plain(t(q), t(k), t(v), t(pats), causal=causal,
                                         window=window, chunk=chunk, block_q=bq,
                                         block_kv=bkv)
    dense = F.flash_attention(t(q), t(k), t(v), causal, window, chunk, bq, bkv)
    assert torch.equal(got, dense)
    assert torch.equal(A.flash_attention_cuda(t(q), t(k), t(v), causal=causal, window=window,
                                              chunk=chunk, block_q=bq, block_kv=bkv), dense)


def test_ops_phi_flash_attention_lowerings_and_checks():
    q, k, v, rng = _qkv(2, 20, 2, 40, seed=3)
    pats = _bank(rng, 2, 8, 16, k)                    # T·kp = 32 < D = 40: ragged tail
    dense = F.flash_attention(t(q), t(k), t(v), False, None, None,
                              *ops.autotune_attn_blocks(20, 40, 2, 8, 16))
    # one lowering: the kernel's wrapper, which runs the plain version for
    # CPU tensors (the card has no plain fallback to choose)
    assert torch.equal(ops.phi_flash_attention(t(q), t(k), t(v), t(pats)), dense)
    want = RO.phi_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(pats), block_q=16, block_kv=16, impl="xla")
    got = ops.phi_flash_attention(t(q), t(k), t(v), t(pats), block_q=16, block_kv=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=_atol(v))
    with pytest.raises(ValueError, match="head_dim is only 40"):
        ops.phi_flash_attention(t(q), t(k), t(v), torch.zeros((3, 8, 16), dtype=torch.uint8))


def test_attention_wrappers_refuse_devices_they_have_no_kernel_for():
    meta = torch.empty((1, 8, 1, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        A.phi_flash_attention_cuda(meta, meta, meta, torch.zeros((1, 2, 16), dtype=torch.uint8))
    with pytest.raises(ValueError, match="unsupported device"):
        A.flash_attention_cuda(meta, meta, meta)


# ------------------------------------------------------ spikformer, flash ---
GAIN = 3.0
SPIKFORMER = dict(kind="spikformer", dim=64, heads=2, blocks=2, input_size=8, attn="flash")


def _spikformer(q=16, iters=3, seed=0):
    rcfg = RM.SNNConfig(**SPIKFORMER, phi=RPhiConfig(k=16, q=q, iters=iters))
    cfg = M.SNNConfig(**SPIKFORMER, phi=PhiConfig(k=16, q=q, iters=iters))
    raw = np_tree(RM.init(rcfg, jax.random.PRNGKey(seed)))
    w = {name: {"w": dyadic(leaf["w"] * (1.0 if name == "embed" else GAIN))}
         for name, leaf in raw.items()}
    x, _ = synthetic_images(3, size=8, seed=1)
    return rcfg, cfg, w, dyadic(x)


def _ref_flash_attention(phi_state=None):
    """Reference attention for ``RM.apply(attention=...)``: the spikformer fold
    around ``flash_attention`` (no bank) or ``phi_flash_attention_xla``, with
    the blocks the port's policy resolves (one block at these shapes)."""
    def attn(qh, kh, vh, name):
        T_, B, H, S, Dh = qh.shape

        def fold(z):
            return jnp.moveaxis(z.reshape(T_ * B, H, S, Dh), 1, 2)

        if phi_state is None:
            out = RF.flash_attention(fold(qh), fold(kh), fold(vh), False, None, None, 128, 128)
        else:
            out = RA.phi_flash_attention_xla(fold(qh), fold(kh), fold(vh),
                                             jnp.asarray(phi_state.patterns[name]),
                                             block_q=128, block_kv=128)
        return jnp.moveaxis(out, 2, 1).reshape(T_, B, H, S, Dh)
    return attn


def test_spikformer_flash_calibrate_captures_attention_sites_bitwise():
    rcfg, cfg, w, x = _spikformer()
    cap: dict = {}
    RM.apply(jax.tree.map(jnp.asarray, w), rcfg, jnp.asarray(x), capture=cap,
             attention=_ref_flash_attention())
    state, acts = M.calibrate_model(params_from_numpy(w, "cpu"), cfg, t(x))
    assert sorted(acts) == sorted(cap) == sorted(state.patterns)
    assert {"b0_attn", "b1_attn"} <= set(acts)
    for name, act in acts.items():
        np.testing.assert_array_equal(act.numpy(), np.asarray(cap[name]))
        T, q, k = state.patterns[name].shape
        assert state.usage[name].shape == (T, q + 1)
        assert (name in state.pwp) == (not name.endswith("_attn"))
    assert acts["b0_attn"].shape == (4 * 3 * 2 * 4, 32)           # T·B·H·S rows, Dh
    assert state.patterns["b0_attn"].shape == (2, 16, 16) and "b0_attn" in state.packed


def test_spikformer_flash_phi_apply_bitwise_equals_dense_apply_and_resolves_phi_flash():
    rcfg, cfg, w, x = _spikformer()
    params = params_from_numpy(w, "cpu")
    state, acts = M.calibrate_model(params, cfg, t(x))
    prev = dispatch.set_policy(dispatch.PhiExecutionPolicy())
    try:
        dense = M.apply(params, cfg, t(x))
        got = M.phi_apply(params, cfg, state, t(x))
        forced = M.phi_apply(params, cfg, state, t(x), attn_impl="flash")
        pol = dispatch.get_policy()
        for b in range(2):
            d = pol.last_decision(f"snn.b{b}_attn")
            assert d.impl == "flash" and d.reason == "call_override"
        assert pol.decisions()[("snn.b0_attn", "phi_flash", "spike_qk_phi_flash_xla")] == 1
        assert pol.decisions()[("snn.b1_attn", "flash", "no_patterns_keeps_flash")] == 1
    finally:
        dispatch.set_policy(prev)
    assert float(dense.abs().sum()) > 0                             # spikes reached the head
    assert torch.equal(got, dense) and torch.equal(forced, dense)
    assert float(acts["b1_attn"].mean()) >= 0.01


def test_spikformer_flash_phi_apply_vs_reference_apply_with_injected_lowerings():
    # The reference calibrates; its PhiState is carried across by interop.
    # Reference side: models.apply with ops.phi_matmul(impl="fused") and the
    # folded phi_flash_attention_xla injected (its phi_apply dies on this jax).
    rcfg, cfg, w, x = _spikformer()
    jw = jax.tree.map(jnp.asarray, w)
    cap: dict = {}
    RM.apply(jw, rcfg, jnp.asarray(x), capture=cap, attention=_ref_flash_attention())
    from repro.core.patterns import calibrate as rcalibrate, pattern_usage as rusage
    from repro.core.patterns import pattern_weight_products as rpwp

    patterns, pwps, usage = {}, {}, {}
    for name, act in cap.items():
        act = np.asarray(act)
        pats = rcalibrate(act, rcfg.phi)
        patterns[name] = pats
        usage[name] = rusage(act, pats)
        if not name.endswith("_attn"):
            pwps[name] = np.asarray(rpwp(jnp.asarray(pats), jw[name]["w"]))
    rstate = RM.PhiState(patterns, pwps, usage)

    def ref_mm(a, wt, name):
        return RO.phi_matmul(a, wt, jnp.asarray(rstate.patterns[name]),
                             jnp.asarray(rstate.pwp[name]), impl="fused")

    want = np.asarray(RM.apply(jw, rcfg, jnp.asarray(x), matmul=ref_mm,
                               attention=_ref_flash_attention(rstate)))
    state = phi_state_from_numpy(patterns, pwps, usage, "cpu")
    assert sorted(state.patterns) == sorted(patterns) and "b0_attn" not in state.pwp
    got = M.phi_apply(params_from_numpy(w, "cpu"), cfg, state, t(x))
    # Bitwise at this seed: the attention outputs differ from the reference's
    # by at most ATOL_ULPS ulps (module docstring), and no such difference
    # moves a membrane potential across the LIF threshold here.
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.abs(want).sum() > 0
