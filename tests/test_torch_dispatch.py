"""The port's execution policy, attention half, against the reference's rows.

``resolve_attention`` is compared row for row with the reference's on the
CPU: impl, reason, shape and backend word for word (the reference's
``attention`` and ``matmul`` entries die on the installed jax, but its
``resolve_attention(transform=False)`` runs). The shape gate is the port's
own: a shared-memory model of the CUDA kernel, tested here against its
layout, not against the reference's VMEM budget.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_util import binary, clustered, dyadic, t

from repro.core import patterns as RP
from repro.core.assign import assign_patterns as ref_assign_patterns
from repro.kernels import dispatch as RD
from repro.kernels import ops as RO
from repro_torch.kernels import ATTN_IMPLS, IMPLS, dispatch, ops
from repro_torch.kernels.phi_attention import SMEM_LIMIT, block_q_ok, smem_bytes
from repro_torch.kernels.phi_fused import MAX_TC, fused_smem_bytes, fused_tc
from repro_torch.models import flash as F
from repro_torch.obs import ListSink, Tracer, set_tracer

SITE = dict(s=64, d=32, heads=12, batch=128, t=2, q=128, kp=16)
# (resolve_attention keywords, expected impl, expected reason)
ROWS = {
    "call_override_flash": (dict(spike_qk=True, has_patterns=True, override="flash"),
                            "flash", "call_override"),
    "config_override_flash": (dict(spike_qk=True, has_patterns=True,
                                   config_override="flash"), "flash", "config_override"),
    "call_override_phi_flash": (dict(has_patterns=True, override="phi_flash"),
                                "phi_flash", "call_override"),
    "config_override_phi_flash": (dict(has_patterns=True, config_override="phi_flash"),
                                  "phi_flash", "config_override"),
    "call_beats_config": (dict(has_patterns=True, override="flash",
                               config_override="phi_flash"), "flash", "call_override"),
    "override_autodiff_demotes": (dict(has_patterns=True, override="phi_flash",
                                       transform=True), "flash", "autodiff_demotes_phi_flash"),
    "override_no_patterns_demotes": (dict(override="phi_flash"), "flash",
                                     "no_patterns_demotes_phi_flash"),
    "autodiff_keeps_flash": (dict(spike_qk=True, has_patterns=True, transform=True),
                             "flash", "autodiff_keeps_flash"),
    "dense_qk_keeps_flash": (dict(has_patterns=True), "flash", "dense_qk_keeps_flash"),
    "no_patterns_keeps_flash": (dict(spike_qk=True), "flash", "no_patterns_keeps_flash"),
    "spike_qk_phi_flash": (dict(spike_qk=True, has_patterns=True), "phi_flash",
                           "spike_qk_phi_flash_xla"),
}


@pytest.mark.parametrize("row", list(ROWS))
def test_resolve_attention_row_for_row_vs_reference(row):
    kw, impl, reason = ROWS[row]
    want = RD.PhiExecutionPolicy(telemetry=False).resolve_attention(site="snn.b0_attn",
                                                                    **SITE, **kw)
    got = dispatch.PhiExecutionPolicy().resolve_attention(site="snn.b0_attn", **SITE, **kw)
    assert (got.impl, got.reason) == (want.impl, want.reason) == (impl, reason)
    assert got.shape == want.shape == (128 * 12 * 64, 32, 64, 2, 128)
    assert got.site == want.site and got.backend == want.backend == "cpu"
    assert got.blocks == (64, 64)                                  # the slice's sites
    # on the card the Phi row names the kernel
    if reason == "spike_qk_phi_flash_xla":
        card = dispatch.PhiExecutionPolicy().resolve_attention(
            site="snn.b0_attn", device="cuda", **SITE, **kw)
        assert (card.impl, card.reason, card.backend) == (
            "phi_flash", "spike_qk_phi_flash_native", "cuda")


@pytest.mark.parametrize("bad", [dict(override="dense"), dict(config_override="phi")])
def test_unknown_attention_override_raises_like_the_reference(bad):
    with pytest.raises(ValueError, match="unknown attention impl override"):
        RD.PhiExecutionPolicy(telemetry=False).resolve_attention(**SITE, **bad)
    with pytest.raises(ValueError, match="unknown attention impl override"):
        dispatch.PhiExecutionPolicy().resolve_attention(**SITE, **bad)


def test_impl_names_match_the_reference():
    assert ATTN_IMPLS == RD.ATTN_IMPLS and IMPLS == RD.IMPLS


# ----------------------------------------------------- the shape gate ---
def test_smem_model_is_the_kernels_layout():
    # dense: Q and K blocks (rows of an odd number of 16-byte words: 36
    # floats at D = 32), V (rows of 8-float multiples), scores (+1 column),
    # the per-row rescale, the counter
    assert smem_bytes(64, 64, 32) == 4 * (64 * 36 * 2 + 64 * 32 + 64 * 65 + 64 + 1)
    assert smem_bytes(16, 16, 40) == 4 * (16 * 44 * 2 + 16 * 40 + 16 * 17 + 16 + 1)
    assert smem_bytes(16, 16, 36) == 4 * (16 * 36 * 2 + 16 * 40 + 16 * 17 + 16 + 1)
    # Phi adds the packed bank, the matched word and ± masks per K row and
    # partition and the Q rows as bits, rounded up to 16 bytes; no
    # pattern×Q table, so the block is about the dense one's
    phi = 8 * 2 * (128 + 3 * 64 + 64)
    assert smem_bytes(64, 64, 32, 2, 128) == smem_bytes(64, 64, 32) + phi
    assert smem_bytes(8, 8, 32, 1, 3) == smem_bytes(8, 8, 32) + 16 * -(-8 * (3 + 24 + 8) // 16)
    assert smem_bytes(64, 64, 32, 2, 128) < 50 * 1024
    # blocks are clamped to S, and nothing grows with S past the blocks
    assert ops._attn_smem_bytes(128, 128, 37, 32, 2, 8) == smem_bytes(37, 37, 32, 2, 8)
    assert ops._attn_smem_bytes(64, 64, 4096, 32, 2, 128) == smem_bytes(64, 64, 32, 2, 128)


def test_shape_gate_and_block_choice_follow_the_smem_model():
    # the slice's sites: every candidate is clamped to S = 64, and (64, 64)
    # keeps the three blocks an SM the kernel is built for; the dense arm
    # takes the same blocks
    assert ops.autotune_attn_blocks(64, 32, 2, 128, 16) == (64, 64)
    assert ops.autotune_attn_blocks(64, 32, 0, 0, 0) == (64, 64)
    assert ops.attn_shape_viable(64, 32, 2, 128, 16)
    assert ops._attn_blocks_per_sm(64, 64, 64, 32, 2, 128) == 3
    # long S: the widest kv block that fits, then the block_q that keeps the
    # most blocks an SM (by shared memory, capped by the launch bound: three
    # where one p.V pass covers the block, else two), then the largest block_q
    for T, qp in [(4, 128), (0, 0), (4, 1024)]:
        bq, bkv = ops.autotune_attn_blocks(4096, 64, T, qp, 16)
        fits = [c for c in ops._attn_candidates(4096, 64)
                if ops._attn_smem_bytes(*c, 4096, 64, T, qp) <= SMEM_LIMIT]
        assert (bq, bkv) in fits and bkv == max(c[1] for c in fits)
        occ = lambda c: ops._attn_blocks_per_sm(*c, 4096, 64, T, qp)  # noqa: E731
        assert all(occ(c) <= (3 if c[0] <= 32 else 2) for c in fits)
        same_kv = [c for c in fits if c[1] == bkv]
        assert occ((bq, bkv)) == max(occ(c) for c in same_kv)
        assert bq == max(c[0] for c in same_kv if occ(c) == occ((bq, bkv)))
    assert ops.autotune_attn_blocks(4096, 64, 4, 128, 16) == (32, 128)
    # the kernel's block_q limit: at most 128 rows, four p.V passes of
    # 256 // ceil(D / 8) rows
    assert block_q_ok(128, 64) and not block_q_ok(128, 128) and block_q_ok(64, 128)
    assert all(block_q_ok(c[0], 256) for c in ops._attn_candidates(4096, 256))
    # banks the kernel cannot take: a bank past shared memory, kp > 64, T·kp > D. On
    # the CPU the reference's row runs the plain lowering; the card has no
    # such fallback, so the row raises there, forced or resolved.
    assert ops.attn_shape_viable(4096, 64, 4, 2048, 16)        # no pattern×Q table now
    for S, D, T, qp, kp in [(4096, 64, 4, 8192, 16), (64, 128, 1, 8, 128),
                            (64, 32, 3, 8, 16)]:
        assert not ops.attn_shape_viable(S, D, T, qp, kp)
        site = dict(s=S, d=D, t=T, q=qp, kp=kp, has_patterns=True)
        for kw in (dict(spike_qk=True), dict(override="phi_flash")):
            d = dispatch.PhiExecutionPolicy().resolve_attention(**site, **kw)
            assert (d.impl, d.reason) == ("phi_flash", "vmem_gate_phi_flash_xla")
            pol = dispatch.PhiExecutionPolicy()
            with pytest.raises(ValueError, match="cannot take"):
                pol.resolve_attention(**site, **kw, device="cuda")
            assert pol.decisions() == {}
        # the rows that do not run the kernel resolve on the card as anywhere
        for kw, reason in ((dict(spike_qk=True, override="flash"), "call_override"),
                           (dict(spike_qk=True, transform=True), "autodiff_keeps_flash")):
            d = dispatch.PhiExecutionPolicy().resolve_attention(**site, **kw, device="cuda")
            assert (d.impl, d.reason) == ("flash", reason)


# --------------------------------------------------- attention(), telemetry ---
def test_attention_runs_the_resolved_lowering_and_records_it():
    rng = np.random.default_rng(0)
    q, k = binary(rng, (2, 24, 2, 32)), binary(rng, (2, 24, 2, 32))
    v = rng.standard_normal((2, 24, 2, 32)).astype(np.float32)
    pats = binary(rng, (2, 8, 16)).astype(np.uint8)
    sink = ListSink()
    prev_tracer = set_tracer(Tracer(sink))
    prev = dispatch.set_policy(dispatch.PhiExecutionPolicy())
    try:
        phi = dispatch.phi_flash_attention(t(q), t(k), t(v), t(pats), site="s", spike_qk=True)
        dense = dispatch.phi_flash_attention(t(q), t(k), t(v), t(pats), site="s",
                                             spike_qk=True, override="flash")
        pol = dispatch.get_policy()
        assert torch.equal(phi, dense)
        assert torch.equal(dense, F.flash_attention(t(q), t(k), t(v), False, None, None,
                                                    *pol.last_decision("s").blocks))
        # autodiff through the operands resolves the dense lowering, as the
        # reference does; with no backward ported, running it raises
        with torch.enable_grad(), pytest.raises(NotImplementedError, match="forward only"):
            dispatch.phi_flash_attention(t(q).requires_grad_(), t(k), t(v), t(pats), site="g",
                                         spike_qk=True)
        assert pol.last_decision("g").reason == "autodiff_keeps_flash"
        assert pol.decisions() == {("s", "phi_flash", "spike_qk_phi_flash_xla"): 1,
                                   ("s", "flash", "call_override"): 1,
                                   ("g", "flash", "autodiff_keeps_flash"): 1}
        pol.reset()
        assert pol.decisions() == {} and pol.last_decision("s") is None
    finally:
        dispatch.set_policy(prev)
        set_tracer(prev_tracer)
    spans = [r for r in sink.records if r["kind"] == "dispatch"]
    assert [(r["site"], r["impl"], r["reason"]) for r in spans] == [
        ("s", "phi_flash", "spike_qk_phi_flash_xla"), ("s", "flash", "call_override"),
        ("g", "flash", "autodiff_keeps_flash")]
    assert spans[0]["shape"] == [2 * 2 * 24, 32, 24, 2, 8] and spans[0]["blocks"] == [32, 32]
    assert [r["seq"] for r in spans] == [0, 1, 2]


def test_tracer_numbers_records_and_drops_none():
    tracer = Tracer()
    assert tracer.emit("dispatch", site="a", blocks=None) == {"site": "a", "kind": "dispatch",
                                                              "seq": 0}
    tracer.emit("dispatch", site="b")
    assert [r["seq"] for r in tracer.sink.records] == [0, 1]
    prev = set_tracer(tracer)
    try:
        assert set_tracer(prev) is tracer
    finally:
        set_tracer(prev)


@pytest.mark.parametrize("grad_on", ["q", "k", "v"])
def test_attention_lowerings_refuse_autograd(grad_on):
    rng = np.random.default_rng(1)
    x = {n: t(binary(rng, (1, 8, 1, 16))) for n in "qkv"}
    x[grad_on].requires_grad_()
    pats = t(binary(rng, (1, 4, 16)).astype(np.uint8))
    with pytest.raises(NotImplementedError, match="forward only"):
        F.flash_attention(x["q"], x["k"], x["v"], False)
    with pytest.raises(NotImplementedError, match="forward only"):
        ops.phi_flash_attention(x["q"], x["k"], x["v"], pats)
    with torch.no_grad():                     # no graph wanted: runs
        F.flash_attention(x["q"], x["k"], x["v"], False)
        ops.phi_flash_attention(x["q"], x["k"], x["v"], pats)


# ============================================================ matmul half ===
# (m, k_dim, n, t, q) of the rows below. Each shape is one where the Hopper
# gate (ops.fused_shape_viable) and the reference's VMEM gate agree.
SMALL = dict(m=256, k_dim=96, n=72, t=6, q=16)
LONG_K = dict(m=2048, k_dim=2304, n=512, t=144, q=128)            # VGG conv3: streamed
NO_KERNEL = dict(m=256, k_dim=64, n=128, t=4, q=16384)            # no kernel takes the bank
WIDE_SKEW = dict(m=512, k_dim=4608, n=512, t=288, q=2048)         # skewed, P = 544 > 512


def _usage(t, q, hot):
    """A (t, q+1) usage histogram whose top ``hot`` patterns take every match."""
    u = np.zeros((t, q + 1), np.int64)
    u[:, :hot] = 100
    u[:, q] = 10
    return u


SKEWED = _usage(6, 16, 4)                       # P = 8
FLAT = np.ones((6, 17), np.int64)               # no skew
WIDE = _usage(288, 2048, 600)                   # P = 544
# The gate's refusals: the CPU runs ``coo`` for them, the card raises.
CARD_REFUSES = ("fused_vmem_gate", "vmem_gate_demotes_fused", "vmem_gate_demotes_fused_stream",
                "vmem_gate_demotes_fused_prefetch")
# (resolve keywords, expected impl, expected reason)
MATMUL_ROWS = {
    "call_override": (dict(SMALL, override="coo"), "coo", "call_override"),
    "config_override": (dict(SMALL, config_override="pallas"), "pallas", "config_override"),
    "call_beats_config": (dict(SMALL, override="ref", config_override="pallas"), "ref",
                          "call_override"),
    "forced_fused": (dict(SMALL, override="fused"), "fused", "call_override"),
    "forced_stream_where_fused_fits": (dict(SMALL, config_override="fused_stream"),
                                       "fused_stream", "config_override"),
    "autodiff_demotes_pallas": (dict(SMALL, override="pallas", transform=True), "coo",
                                "autodiff_demotes_pallas"),
    "autodiff_demotes_fused": (dict(SMALL, config_override="fused", transform=True), "coo",
                               "autodiff_demotes_fused"),
    "autodiff_demotes_fused_prefetch": (dict(SMALL, override="fused_prefetch", transform=True,
                                             usage=SKEWED), "coo",
                                        "autodiff_demotes_fused_prefetch"),
    "autodiff_keeps_forced_coo": (dict(SMALL, override="coo", transform=True), "coo",
                                  "call_override"),
    "autodiff_or_vmap": (dict(SMALL, transform=True), "coo", "autodiff_or_vmap"),
    "prefetch_override": (dict(SMALL, override="fused_prefetch", usage=SKEWED),
                          "fused_prefetch", "call_override"),
    "prefetch_no_skew": (dict(SMALL, override="fused_prefetch", usage=FLAT), "fused",
                         "no_skew_demotes_fused_prefetch"),
    "prefetch_no_skew_long_k": (dict(LONG_K, config_override="fused_prefetch"),
                                "fused_stream", "no_skew_demotes_fused_prefetch"),
    "prefetch_no_kernel": (dict(NO_KERNEL, override="fused_prefetch"), "coo",
                           "vmem_gate_demotes_fused_prefetch"),
    "prefetch_set_too_wide": (dict(WIDE_SKEW, override="fused_prefetch", usage=WIDE),
                              "fused_stream", "vmem_gate_streams_fused_prefetch"),
    "vmem_gate_streams_fused": (dict(LONG_K, override="fused"), "fused_stream",
                                "vmem_gate_streams_fused"),
    "vmem_gate_demotes_fused": (dict(NO_KERNEL, override="fused"), "coo",
                                "vmem_gate_demotes_fused"),
    "vmem_gate_demotes_fused_stream": (dict(NO_KERNEL, override="fused_stream"), "coo",
                                       "vmem_gate_demotes_fused_stream"),
    "default_fused": (dict(SMALL), "fused", "single_device_default_interpret"),
    "default_flat_usage": (dict(SMALL, usage=FLAT), "fused",
                           "single_device_default_interpret"),
    "default_stream": (dict(LONG_K), "fused_stream", "vmem_gate_k_stream_interpret"),
    "default_prefetch": (dict(SMALL, usage=SKEWED), "fused_prefetch",
                         "pattern_usage_prefetch_interpret"),
    "default_wide_skew_streams": (dict(WIDE_SKEW, usage=WIDE), "fused_stream",
                                  "vmem_gate_k_stream_interpret"),
    "default_no_kernel": (dict(NO_KERNEL), "coo", "fused_vmem_gate"),
}


@pytest.mark.parametrize("row", list(MATMUL_ROWS))
def test_resolve_row_for_row_vs_reference(row, monkeypatch):
    monkeypatch.delenv("PHI_IMPL", raising=False)
    kw, impl, reason = MATMUL_ROWS[row]
    want = RD.PhiExecutionPolicy(telemetry=False).resolve(site="snn.conv1", **kw)
    got = dispatch.PhiExecutionPolicy().resolve(site="snn.conv1", **kw)
    assert (got.impl, got.reason) == (want.impl, want.reason) == (impl, reason)
    assert got.shape == want.shape and got.backend == want.backend == "cpu"
    assert (got.usage_ratio, got.p_active) == (want.usage_ratio, want.p_active)
    # on the card the resolved kernel rows name the native kernels, and a
    # row whose gate finds no kernel raises: the card has no plain fallback
    if reason in CARD_REFUSES:
        with pytest.raises(ValueError, match="no Phi kernel takes site"):
            dispatch.PhiExecutionPolicy().resolve(site="snn.conv1", device="cuda", **kw)
        return
    card = dispatch.PhiExecutionPolicy().resolve(site="snn.conv1", device="cuda", **kw)
    assert (card.impl, card.reason, card.backend) == (
        impl, reason.replace("_interpret", "_native"), "cuda")


@pytest.mark.parametrize("override", [None, "fused", "fused_stream", "fused_prefetch"])
def test_card_refuses_a_bank_no_kernel_takes(override, monkeypatch):
    """k = 128 > 64: every Hopper kernel refuses the bank (the reference's
    TPU gate takes it). On the CPU the gate's row runs ``coo``; on the card
    it raises before any decision is recorded. Autodiff and a forced plain
    lowering still resolve."""
    monkeypatch.delenv("PHI_IMPL", raising=False)
    wide_k = dict(m=512, k_dim=512, n=64, t=4, q=16)
    cpu = dispatch.PhiExecutionPolicy().resolve(site="s", override=override, **wide_k)
    assert cpu.impl == "coo" and cpu.reason in CARD_REFUSES
    pol = dispatch.PhiExecutionPolicy()
    with pytest.raises(ValueError, match="k <= 64"):
        pol.resolve(site="s", override=override, device="cuda", **wide_k)
    assert pol.decisions() == {}
    grad = pol.resolve(site="s", override=override, transform=True, device="cuda", **wide_k)
    assert grad.impl == "coo" and grad.reason.startswith("autodiff")
    forced = pol.resolve(site="s", override="coo", device="cuda", **wide_k)
    assert (forced.impl, forced.reason) == ("coo", "call_override")


@pytest.mark.parametrize("env,kw,want", [
    ("pallas", {}, ("pallas", "policy_override")),
    ("pallas", dict(config_override="coo"), ("coo", "config_override")),
    ("pallas", dict(override="ref", config_override="coo"), ("ref", "call_override")),
    ("fused", dict(transform=True), ("coo", "autodiff_demotes_fused")),
    ("fused", dict(LONG_K), ("fused_stream", "vmem_gate_streams_fused")),
])
def test_phi_impl_env_override_and_its_precedence(env, kw, want, monkeypatch):
    monkeypatch.setenv("PHI_IMPL", env)
    kw = {**SMALL, **kw}
    ref = RD.PhiExecutionPolicy(telemetry=False).resolve(**kw)
    got = dispatch.PhiExecutionPolicy().resolve(**kw)
    assert (got.impl, got.reason) == (ref.impl, ref.reason) == want


@pytest.mark.parametrize("bad", [dict(override="pallas2"), dict(config_override="dense")])
def test_unknown_matmul_override_raises_like_the_reference(bad, monkeypatch):
    monkeypatch.delenv("PHI_IMPL", raising=False)
    for pol in (RD.PhiExecutionPolicy(telemetry=False), dispatch.PhiExecutionPolicy()):
        with pytest.raises(ValueError, match="unknown Phi impl override"):
            pol.resolve(**SMALL, **bad)
    monkeypatch.setenv("PHI_IMPL", "bogus")
    for cls in (RD.PhiExecutionPolicy, dispatch.PhiExecutionPolicy):
        with pytest.raises(ValueError, match="unknown Phi impl override"):
            cls()


def _operands(M, K, N, q, seed=0):
    rng = np.random.default_rng(seed)
    a = clustered(rng, M, K, protos=4)
    w = dyadic(rng.standard_normal((K, N)).astype(np.float32) * 0.3)
    pats = RP.calibrate(a, RP.PhiConfig(k=16, q=q, iters=3))
    pwp = np.asarray(RP.pattern_weight_products(pats, w))
    return a, w, pats, pwp


@pytest.mark.parametrize("row", ["call_override", "config_override", "forced_fused",
                                 "autodiff_or_vmap", "prefetch_override", "default_fused",
                                 "default_prefetch"])
def test_matmul_runs_the_decision_like_the_reference_lowering(row, monkeypatch):
    """The reference's ``matmul`` dies on this jax (dispatch.py:209), so the
    port's is held against reference ``resolve`` + ``ops.phi_matmul``."""
    monkeypatch.delenv("PHI_IMPL", raising=False)
    kw, impl, reason = MATMUL_ROWS[row]
    kw = {k: v for k, v in kw.items() if k not in SMALL}
    transform = kw.pop("transform", False)
    a, w, pats, pwp = _operands(256, 96, 72, 16, seed=len(row))
    d = RD.PhiExecutionPolicy(telemetry=False).resolve(site="s", **SMALL, transform=transform,
                                                        **kw)
    want = RO.phi_matmul(*(jnp.asarray(x) for x in (a, w, pats, pwp)), impl=d.impl,
                         usage=kw.get("usage"))
    pol = dispatch.PhiExecutionPolicy()
    ta = t(a).requires_grad_() if transform else t(a)
    with torch.set_grad_enabled(transform):
        got = pol.matmul(ta, t(w), t(pats), t(pwp), site="s", **kw)
    assert (pol.last_decision("s").impl, pol.last_decision("s").reason) == (impl, reason)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))


def test_register_usage_accumulates_and_feeds_resolve(monkeypatch):
    monkeypatch.delenv("PHI_IMPL", raising=False)
    pols = (RD.PhiExecutionPolicy(telemetry=False), dispatch.PhiExecutionPolicy())
    half = _usage(6, 16, 4) // 2
    for pol in pols:
        assert pol.usage_for("s") is None
        pol.register_usage("s", half)
        pol.register_usage("s", half)
        pol.register_usage("s", np.ones((3, 5), np.int64))  # another shape replaces
        pol.register_usage("s", np.ones((3, 5), np.int64))
        np.testing.assert_array_equal(pol.usage_for("s"), 2 * np.ones((3, 5), np.int64))
        pol.register_usage("t", half)
        pol.register_usage("t", half)
        np.testing.assert_array_equal(pol.usage_for("t"), 2 * half)
    got, want = (pol.resolve(site="t", **SMALL) for pol in reversed(pols))
    assert (got.impl, got.reason, got.p_active, got.usage_ratio) == (
        want.impl, want.reason, want.p_active, want.usage_ratio) == (
        "fused_prefetch", "pattern_usage_prefetch_interpret", 8, 9 / 17)


def test_runtime_sets_from_the_second_prefetch_execution(monkeypatch):
    """After one execution the site's match histogram supplies the gather
    sets (reason suffix ``_runtime_sets``), in both packages, and the port's
    matmul then skips the pre-pass with the same output."""
    from repro_torch.kernels import ops

    monkeypatch.delenv("PHI_IMPL", raising=False)
    rng = np.random.default_rng(4)
    hist = rng.integers(0, 50, (6, 17))
    ref_pol = RD.PhiExecutionPolicy(telemetry=False)
    pol = dispatch.PhiExecutionPolicy()
    for p in (ref_pol, pol):
        first = p.resolve(site="s", **SMALL, usage=SKEWED)
        assert first.reason == "pattern_usage_prefetch_interpret" and first.runtime_sets is None
        p._record_nnz("s", 256, 96, 256, np.array([5]), match_hist=hist)
    want, got = (p.resolve(site="s", **SMALL, usage=SKEWED) for p in (ref_pol, pol))
    assert got.reason == want.reason == "pattern_usage_prefetch_interpret_runtime_sets"
    np.testing.assert_array_equal(got.runtime_sets, np.asarray(want.runtime_sets))

    a, w, pats, pwp = _operands(256, 96, 72, 16, seed=9)
    usage = SKEWED
    pol = dispatch.PhiExecutionPolicy()
    calls = []
    real = ops.stripe_active_sets
    monkeypatch.setattr(ops, "stripe_active_sets",
                        lambda *x, **k: (calls.append(1), real(*x, **k))[1])
    outs = [pol.matmul(t(a), t(w), t(pats), t(pwp), site="s", usage=usage) for _ in range(3)]
    assert len(calls) == 1                                 # the pre-pass ran once
    assert all(torch.equal(o, outs[0]) for o in outs)
    np.testing.assert_array_equal(outs[0].numpy(), a @ w)
    assert pol.decisions() == {("s", "fused_prefetch", "pattern_usage_prefetch_interpret"): 1,
                               ("s", "fused_prefetch",
                                "pattern_usage_prefetch_interpret_runtime_sets"): 2}
    assert pol.runtime_usage_for("s").sum() == 256 * 6      # every row-partition counted


def test_report_and_site_telemetry_equal_the_reference(monkeypatch):
    monkeypatch.delenv("PHI_IMPL", raising=False)
    rng = np.random.default_rng(2)
    calib = _usage(6, 16, 4)
    ref_pol = RD.PhiExecutionPolicy(telemetry=False)
    pol = dispatch.PhiExecutionPolicy()
    for p in (ref_pol, pol):
        p.register_usage("snn.conv1", calib)
        p.register_usage("snn.cold", FLAT)
        p.resolve(site="snn.conv1", **SMALL)
        p.resolve(site="snn.head", **SMALL, override="coo")
    feeds = [("snn.conv1", 256, 96, 512, rng.integers(0, 300, 2), rng.integers(0, 90, (6, 17))),
             ("snn.conv1", 256, 96, 300, rng.integers(0, 300, 2), rng.integers(0, 90, (6, 17))),
             ("snn.conv2", 128, 144, 128, rng.integers(0, 900, 1), None)]
    for site, bm, K, rows, nnz, hist in feeds:
        for p in (ref_pol, pol):
            p._record_nnz(site, bm, K, rows, nnz, group_t=0, usage_ratio=0.5, match_hist=hist)
    assert pol.site_telemetry() == ref_pol.site_telemetry()
    assert pol.site_telemetry("snn.conv") == ref_pol.site_telemetry("snn.conv")
    want, got = ref_pol.report(), pol.report()
    assert got["decisions"] == want["decisions"]
    assert [dataclasses.asdict(b) for b in got["packer_budgets"]] == \
        [dataclasses.asdict(b) for b in want["packer_budgets"]]
    snap, ref_snap = pol.metrics_snapshot(), ref_pol.metrics_snapshot()
    for name in ("phi_dispatch_decisions", "phi_site_executions", "phi_site_rows",
                 "phi_site_l2_nnz", "phi_site_l2_nnz_max_block"):
        assert snap[name]["series"] == ref_snap[name]["series"]
    pol.reset(keep_usage=True)
    assert pol.decisions() == {} and pol.report()["packer_budgets"] == []
    assert pol.usage_for("snn.conv1") is not None
    pol.reset()
    assert pol.usage_for("snn.conv1") is None and pol.site_telemetry() == []


def test_matmul_telemetry_is_folded_in_where_it_is_read(monkeypatch):
    """A fused matmul adds its l2_nnz counter to the site's accumulators
    without a copy to the host; report() folds them in."""
    monkeypatch.delenv("PHI_IMPL", raising=False)
    a, w, pats, pwp = _operands(300, 96, 72, 16, seed=3)
    pol = dispatch.PhiExecutionPolicy()
    for _ in range(2):
        pol.matmul(t(a), t(w), t(pats), t(pwp), site="s")
    acc = pol._acc["s"]
    assert pol._sites == {} and (acc["executions"], acc["rows"]) == (2, 600)
    assert all(isinstance(acc[key], torch.Tensor) for key in ("nnz_total", "nnz_max"))
    (b,) = pol.report()["packer_budgets"]
    _, residual = ref_assign_patterns(jnp.asarray(a), jnp.asarray(pats))
    assert (b.site, b.executions, b.rows, b.block_m, b.k_dim) == ("s", 2, 600, 256, 96)
    assert b.l2_nnz_total == 2 * int(np.abs(residual).sum())
    assert pol._acc == {}


def test_phi_telemetry_env_turns_telemetry_off(monkeypatch):
    monkeypatch.delenv("PHI_IMPL", raising=False)
    monkeypatch.setenv("PHI_TELEMETRY", "0")
    assert not RD.PhiExecutionPolicy().telemetry
    pol = dispatch.PhiExecutionPolicy()
    assert not pol.telemetry
    a, w, pats, pwp = _operands(256, 96, 72, 16, seed=5)
    for _ in range(2):
        pol.matmul(t(a), t(w), t(pats), t(pwp), site="s", usage=SKEWED)
    # no histogram is kept, so the prefetch site never gets runtime sets
    assert pol.report()["packer_budgets"] == [] and pol.runtime_usage_for("s") is None
    assert pol.decisions() == {("s", "fused_prefetch", "pattern_usage_prefetch_interpret"): 2}
    monkeypatch.setenv("PHI_TELEMETRY", "1")
    assert dispatch.PhiExecutionPolicy().telemetry


def test_checkpoint_helpers_equal_the_reference():
    from types import SimpleNamespace

    from repro_torch.core.patterns import PhiConfig
    from repro_torch.snn.models import SNNConfig

    for impl in ("pallas", None):
        cfg = SimpleNamespace(phi=SimpleNamespace(impl=impl))
        assert dispatch.checkpoint_extra(cfg) == RD.checkpoint_extra(cfg)
    assert dispatch.checkpoint_extra(SimpleNamespace()) == RD.checkpoint_extra(
        SimpleNamespace()) == {}
    usage = {"conv1": _usage(6, 16, 4), "head": FLAT}
    extra = dispatch.usage_checkpoint_extra(usage)
    assert extra == RD.usage_checkpoint_extra(usage)
    assert dispatch.usage_checkpoint_extra({}) == RD.usage_checkpoint_extra({}) == {}
    back, ref_back = (dispatch.usage_from_checkpoint_extra(extra),
                      RD.usage_from_checkpoint_extra(extra))
    assert back.keys() == ref_back.keys() == usage.keys()
    for name in usage:
        np.testing.assert_array_equal(back[name], ref_back[name])
        np.testing.assert_array_equal(back[name], usage[name])
    # a persisted override is re-applied; a live one wins
    cfg = SNNConfig()
    assert dispatch.apply_checkpoint_extra(cfg, {"phi_impl": "pallas"}).phi.impl == "pallas"
    live = SNNConfig(phi=PhiConfig(impl="coo"))
    assert dispatch.apply_checkpoint_extra(live, {"phi_impl": "pallas"}) is live
    assert dispatch.apply_checkpoint_extra(cfg, None) is cfg


# Every spiking GEMM of the two main paths, (M, K, N, T, q, P) at k = 16, and
# the kernel the Hopper gate gives it: b0_proj and b2_proj carry the P their
# calibration usage gives (PERF.md §4), the other GEMMs no skew.
MAIN_PATH_GEMMS = {
    "spikformer_qkv": ((8192, 384, 1152, 24, 128, None), "fused"),
    "spikformer_proj": ((8192, 384, 384, 24, 128, None), "fused"),
    "spikformer_b0_proj": ((8192, 384, 384, 24, 128, 24), "fused_prefetch"),
    "spikformer_b2_proj": ((8192, 384, 384, 24, 128, 64), "fused_prefetch"),
    "spikformer_fc1": ((8192, 384, 1536, 24, 128, None), "fused"),
    "spikformer_fc2": ((8192, 1536, 384, 96, 128, None), "fused_stream"),
    "spikformer_head": ((128, 384, 10, 24, 128, None), "fused"),
    "vgg_conv1": ((32768, 576, 128, 36, 128, None), "fused"),
    "vgg_conv2": ((8192, 1152, 256, 72, 128, None), "fused"),
    "vgg_conv3": ((2048, 2304, 512, 144, 128, None), "fused_stream"),
    "vgg_conv4": ((512, 4608, 512, 288, 128, None), "fused_stream"),
    "vgg_head": ((128, 512, 10, 32, 128, None), "fused"),
}


@pytest.mark.parametrize("gemm", list(MAIN_PATH_GEMMS))
def test_hopper_gate_routes_every_main_path_gemm(gemm):
    (M, K, N, T, q, p_active), want = MAIN_PATH_GEMMS[gemm]
    assert ops.fused_shape_viable(M, K, N, T, q, p_active=p_active) == want
    if want != "fused_stream":            # the first kernel matches T whole, in one tile
        assert fused_tc(T) == T and fused_smem_bytes(T) <= SMEM_LIMIT


def test_first_kernel_smem_model_and_its_limits():
    # the match tile, 32 × tc pairs of 24 bytes; 32 row counters; 8 warps'
    # lists of 256 residual entries of 4 bytes; 256 threads' 32 parked floats
    assert fused_smem_bytes(24) == 32 * 24 * 24 + 4 * 32 + 8 * 256 * 4 + 256 * 32 * 4 == 59520
    # T whole up to 95 (the gate sends T < 96 here); past it, the fewest
    # chunks of at most 95, as even as they go
    assert [fused_tc(T) for T in (0, 1, 24, 95, 96, 100, 190, 191, 1000)] == \
        [1, 1, 24, 95, 48, 50, 95, 64, 91]
    assert ops.STREAM_MIN_T - 1 == MAX_TC
    # the most any T needs: T = 95 (the bank is read from device memory, so
    # q and P do not count)
    assert max(fused_smem_bytes(T) for T in range(1, 4000)) == fused_smem_bytes(95) == 114048
    assert fused_smem_bytes(95) <= SMEM_LIMIT
    # at the main paths' T (24, 36, 72) two blocks an SM fit by shared memory
    assert 2 * fused_smem_bytes(72) <= 228 * 1024
