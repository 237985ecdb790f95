"""The port's execution policy, attention half, against the reference's rows.

``resolve_attention`` is compared row for row with the reference's on the
CPU: impl, reason, shape and backend word for word (the reference's
``attention`` and ``matmul`` entries die on the installed jax, but its
``resolve_attention(transform=False)`` runs). The shape gate is the port's
own: a shared-memory model of the CUDA kernel, tested here against its
layout, not against the reference's VMEM budget.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
from torch_parity_util import binary, t

from repro.kernels import dispatch as RD
from repro_torch.kernels import ATTN_IMPLS, IMPLS, dispatch, ops
from repro_torch.kernels.phi_attention import SMEM_LIMIT, smem_bytes
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
    # dense: Q and K blocks (+1 column), V, scores (+1 column), acc, m, den, counter
    assert smem_bytes(64, 64, 32) == 4 * (64 * 33 * 2 + 64 * 32 + 64 * 65 + 64 * 32 + 128 + 1)
    # Phi adds the packed bank, ± masks and indices per K row and partition,
    # and the pattern×Q products
    phi = 8 * 2 * 128 + 16 * 64 * 2 + 4 * 2 * 129 * 64 + 4 * 64 * 2
    assert smem_bytes(64, 64, 32, 2, 128) == smem_bytes(64, 64, 32) + phi
    # blocks are clamped to S, and nothing grows with S past the blocks
    assert ops._attn_smem_bytes(128, 128, 37, 32, 2, 8) == smem_bytes(37, 37, 32, 2, 8)
    assert ops._attn_smem_bytes(64, 64, 4096, 32, 2, 128) == smem_bytes(64, 64, 32, 2, 128)


def test_shape_gate_and_block_choice_follow_the_smem_model():
    # the slice's sites: every candidate is clamped to S = 64
    assert ops.autotune_attn_blocks(64, 32, 2, 128, 16) == (64, 64)
    assert ops.attn_shape_viable(64, 32, 2, 128, 16)
    # long S: the largest pair that fits, wide kv first
    bq, bkv = ops.autotune_attn_blocks(4096, 64, 4, 128, 16)
    assert ops._attn_smem_bytes(bq, bkv, 4096, 64, 4, 128) <= SMEM_LIMIT
    bigger = [c for c in ops._attn_candidates(4096) if c[0] * c[1] > bq * bkv]
    assert all(ops._attn_smem_bytes(*c, 4096, 64, 4, 128) > SMEM_LIMIT for c in bigger)
    assert ops.autotune_attn_blocks(4096, 64, 0, 0, 0) == (128, 128)      # dense
    # banks the kernel cannot take: too many patterns, kp > 64, T·kp > D. On
    # the CPU the reference's row runs the plain lowering; the card has no
    # such fallback, so the row raises there, forced or resolved.
    for S, D, T, qp, kp in [(4096, 64, 4, 2048, 16), (64, 128, 1, 8, 128),
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
