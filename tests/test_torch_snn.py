"""repro_torch.snn held against repro.snn on identical, carried-over weights.

Weights come from the reference's ``init``, are multiplied by a gain of 3
(except the encoder layer, so spikes do not die out with depth) and rounded
onto the dyadic 2^-10 grid together with the images; ``interop`` carries
them across. On such inputs every float32 sum of the forward pass is exact,
so logits are compared bitwise (tolerance 0).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_util import dyadic, np_tree, t

from repro.core.patterns import PhiConfig as RPhiConfig
from repro.kernels import ops as RO
from repro.snn import models as RM
from repro_torch.core.assign import phi_stats
from repro_torch.core.patterns import PhiConfig
from repro_torch.interop import params_from_numpy, phi_state_from_numpy
from repro_torch.kernels import dispatch
from repro_torch.snn import models as M
from repro_torch.snn.data import synthetic_images

GAIN = 3.0
SMALL = {
    "vgg": dict(kind="vgg", widths=(16, 32), input_size=8),
    "resnet": dict(kind="resnet", widths=(16, 32), input_size=8),
    "mlp": dict(kind="mlp", widths=(64, 32), input_size=8),
    "spikformer": dict(kind="spikformer", dim=32, heads=2, blocks=1, input_size=8),
}
FIRST = {"vgg": "conv0", "resnet": "conv0", "mlp": "fc0", "spikformer": "embed"}


def _configs(kind, q=16, iters=3):
    kw = SMALL[kind]
    return (RM.SNNConfig(**kw, phi=RPhiConfig(k=16, q=q, iters=iters)),
            M.SNNConfig(**kw, phi=PhiConfig(k=16, q=q, iters=iters)))


def _weights(kind, rcfg, seed=0):
    raw = np_tree(RM.init(rcfg, jax.random.PRNGKey(seed)))
    return {name: {"w": dyadic(leaf["w"] * (1.0 if name == FIRST[kind] else GAIN))}
            for name, leaf in raw.items()}


def _images(n, size, seed=1):
    x, _ = synthetic_images(n, size=size, seed=seed)
    return dyadic(x)


def _both(kind, n=3):
    rcfg, cfg = _configs(kind)
    w = _weights(kind, rcfg)
    x = _images(n, rcfg.input_size)
    return rcfg, cfg, w, x


@pytest.mark.parametrize("kind", ["vgg", "resnet", "mlp", "spikformer"])
def test_apply_bitwise_vs_reference(kind):
    rcfg, cfg, w, x = _both(kind)
    want = np.asarray(RM.apply(jax.tree.map(jnp.asarray, w), rcfg, jnp.asarray(x)))
    got = M.apply(params_from_numpy(w, "cpu"), cfg, t(x))
    assert got.shape == (3, 10) and np.abs(want).sum() > 0   # spikes reached the head
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["vgg", "spikformer"])
def test_calibrate_model_captures_bitwise(kind):
    rcfg, cfg, w, x = _both(kind)
    cap: dict = {}
    RM.apply(jax.tree.map(jnp.asarray, w), rcfg, jnp.asarray(x), capture=cap)
    state, acts = M.calibrate_model(params_from_numpy(w, "cpu"), cfg, t(x))
    assert sorted(acts) == sorted(cap) == sorted(state.patterns)
    for name, act in acts.items():
        np.testing.assert_array_equal(act.numpy(), np.asarray(cap[name]))
        T, q, k = state.patterns[name].shape
        assert (q, k) == (16, 16) and state.pwp[name].shape[:2] == (T, q + 1)
        assert state.usage[name].shape == (T, q + 1)
        assert state.usage[name].sum() == act.shape[0] * T


@pytest.mark.parametrize("impl", ["fused", "coo"])
def test_phi_apply_bitwise_vs_reference_with_injected_phi_matmul(impl):
    # The reference's phi_apply goes through its execution policy; its
    # phi_matmul is injected into reference ``apply`` here instead, with the
    # PhiState the reference calibrated, carried across by interop.
    rcfg, cfg, w, x = _both("vgg")
    jw = jax.tree.map(jnp.asarray, w)
    rstate, _ = RM.calibrate_model(jw, rcfg, jnp.asarray(x))

    def ref_mm(a, wt, name):
        pats = jnp.asarray(rstate.patterns[name])
        return RO.phi_matmul(a, wt, pats, rstate.pwp[name], impl=impl)

    want = np.asarray(RM.apply(jw, rcfg, jnp.asarray(x), matmul=ref_mm))
    state = phi_state_from_numpy(rstate.patterns, np_tree(rstate.pwp), rstate.usage, "cpu")
    params = params_from_numpy(w, "cpu")
    got = M.phi_apply(params, cfg, state, t(x), impl=impl)
    np.testing.assert_array_equal(got.numpy(), want)
    # impl=None takes the gate's kernel per layer: the same exact sums
    np.testing.assert_array_equal(M.phi_apply(params, cfg, state, t(x)).numpy(), want)


@pytest.mark.parametrize("kind", ["vgg", "resnet", "mlp", "spikformer"])
def test_phi_apply_is_lossless(kind):
    rcfg, cfg, w, x = _both(kind)
    params = params_from_numpy(w, "cpu")
    state, acts = M.calibrate_model(params, cfg, t(x))
    dense = M.apply(params, cfg, t(x))
    for impl in ("fused", "fused_stream", "coo", "ref"):
        np.testing.assert_array_equal(M.phi_apply(params, cfg, state, t(x), impl=impl).numpy(),
                                      dense.numpy())
    # the decomposition did real work: patterns matched and residuals remain
    stats = [phi_stats(a, state.patterns[n]) for n, a in acts.items()]
    assert max(s.idx_density for s in stats) > 0 and max(s.l2_density for s in stats) > 0


def test_phi_apply_refuses_a_state_of_another_model():
    rcfg, cfg, w, x = _both("vgg")
    params = params_from_numpy(w, "cpu")
    state, _ = M.calibrate_model(params, cfg, t(x))
    state.patterns["conv1"] = state.patterns["conv1"][:-1]
    with pytest.raises(ValueError, match="calibrated for K="):
        M.phi_apply(params, cfg, state, t(x))


def test_phi_apply_routes_each_layer_through_the_gate(monkeypatch):
    """impl=None: each layer on the kernel ``ops.fused_shape_viable`` picks
    from its shape and calibration usage; the logits stay bitwise dense."""
    from repro_torch.kernels import ops

    rcfg, cfg, w, x = _both("vgg")
    params = params_from_numpy(w, "cpu")
    state, _ = M.calibrate_model(params, cfg, t(x))
    T, q = state.patterns["conv1"].shape[:2]
    T_head, q_head = state.patterns["head"].shape[:2]
    skewed = np.ones((T_head, q_head + 1), np.int64)
    skewed[:, :4] = 1000                                            # four hot patterns
    usage = {"conv1": np.ones((T, q + 1), np.int64), "head": skewed}  # conv1 flat: no skew
    state = M.PhiState(state.patterns, state.pwp, usage)
    assert state.p_active == {"conv1": None, "head": 8}
    calls = []
    for name in ("phi_fused", "phi_fused_stream", "phi_fused_prefetch"):
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _n=name, _r=real, **k: (calls.append(_n),
                                                                          _r(*a, **k))[1])
    monkeypatch.setattr(ops, "STREAM_MIN_T", 1)                    # stream every long-K GEMM
    got = M.phi_apply(params, cfg, state, t(x))
    assert calls == ["phi_fused_stream", "phi_fused_prefetch"]      # conv1, then the head
    assert torch.equal(got, M.apply(params, cfg, t(x)))


def test_spikformer_flash_attention_is_not_ported_yet():
    """Named when ``attn="flash"`` raised NotImplementedError; now checks the
    ported path: it runs, and its attention sites resolve ``phi_flash``."""
    rcfg, cfg, w, x = _both("spikformer")
    cfg = M.SNNConfig(**{**SMALL["spikformer"], "attn": "flash"},
                      phi=PhiConfig(k=16, q=16, iters=3))
    params = params_from_numpy(w, "cpu")
    state, _ = M.calibrate_model(params, cfg, t(x))
    assert "b0_attn" in state.patterns and "b0_attn" not in state.pwp
    prev = dispatch.set_policy(dispatch.PhiExecutionPolicy())
    try:
        got = M.phi_apply(params, cfg, state, t(x))
        d = dispatch.get_policy().last_decision("snn.b0_attn")
    finally:
        dispatch.set_policy(prev)
    assert (d.impl, d.reason) == ("phi_flash", "spike_qk_phi_flash_xla")
    assert got.shape == (3, 10) and torch.isfinite(got).all()
    assert torch.equal(got, M.apply(params, cfg, t(x)))


@pytest.mark.parametrize("kh,kw,stride,pad", [(3, 3, 1, "SAME"), (3, 3, 2, "SAME"),
                                              (2, 3, 1, "VALID"), (4, 4, 3, "SAME")])
def test_im2col_bitwise_vs_reference(kh, kw, stride, pad):
    x = np.random.default_rng(kh * 10 + stride).standard_normal((2, 3, 9, 7, 5)).astype(np.float32)
    want = np.asarray(RM.im2col(jnp.asarray(x), kh, kw, stride, pad))
    got = M.im2col(t(x), kh, kw, stride, pad)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["vgg", "resnet", "mlp", "spikformer"])
def test_init_matches_reference_shapes_and_scale(kind):
    rcfg, cfg = _configs(kind)
    ref = RM.init(rcfg, jax.random.PRNGKey(0))
    got = M.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert list(got) == list(ref)
    for name in ref:
        w = got[name]["w"]
        assert tuple(w.shape) == ref[name]["w"].shape and w.dtype == torch.float32
        fan_in = int(np.prod(w.shape[:-1]))
        assert 0.5 < float(w.std()) / (2.0 / fan_in) ** 0.5 < 1.5
