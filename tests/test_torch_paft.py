"""repro_torch PAFT (pattern-aware fine-tuning) held against the JAX reference.

``hamming_to_assigned`` takes its assignment from the matcher's wrapper,
which on CPU tensors is ``assign_patterns``, so its value is compared
exactly (an integer count, exact in float32) and its gradient, a constant
1 − 2p* per entry, bitwise. ``paft_regularizer`` on a captured dict: value
and gradients at 1e-6 relative (float32 sums over the layers in another
order). ``paft_finetune`` against the reference's on the same weights and
PhiState: the first 5 losses at 1e-5 relative, as the training loop's.
The density drop and accuracy bound are the reference test's
(``tests/test_snn_paft.py::test_paft_reduces_density_on_trained_model``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_util import clustered, dyadic, np_tree, t

from repro.core import paft as RP
from repro.core.patterns import PhiConfig as RPhiConfig
from repro.core.patterns import calibrate as rcalibrate
from repro.snn import models as RM
from repro_torch.core import paft as P
from repro_torch.core.assign import phi_stats
from repro_torch.core.patterns import PhiConfig
from repro_torch.interop import params_from_numpy, phi_state_from_numpy
from repro_torch.kernels import matcher
from repro_torch.kernels.phi_fused import pack_patterns
from repro_torch.snn import data as D
from repro_torch.snn import models as M
from repro_torch.snn import train as T


def _bank(rng, rows, T_, q, k):
    pick = rows[rng.integers(0, rows.shape[0], q)]
    return pick.reshape(q, T_, k).transpose(1, 0, 2).astype(np.uint8).copy()


@pytest.mark.parametrize("lead,T_,q,k", [((96,), 4, 16, 16), ((3, 5, 7), 2, 8, 16),
                                         ((64,), 3, 32, 8)])
def test_hamming_to_assigned_value_and_gradient_vs_reference(lead, T_, q, k):
    rng = np.random.default_rng(sum(lead) + q)
    K = T_ * k
    a = clustered(rng, int(np.prod(lead)), K).reshape(*lead, K)
    pats = _bank(rng, a.reshape(-1, K), T_, q, k)
    pats[:, 1] = pats[:, 0]                            # ties go to the first index
    want = float(RP.hamming_to_assigned(jnp.asarray(a), jnp.asarray(pats)))
    want_g = np.asarray(jax.grad(RP.hamming_to_assigned)(jnp.asarray(a), jnp.asarray(pats)))
    x = t(a).requires_grad_()
    before = matcher.matcher_cuda.launches
    got = P.hamming_to_assigned(x, t(pats), packed=pack_patterns(t(pats)))
    assert matcher.matcher_cuda.launches == before     # CPU tensors: the plain version
    got.backward()
    assert float(got.detach()) == want and want > 0
    np.testing.assert_array_equal(x.grad.numpy(), want_g)
    # equal with the bank packed per call
    assert float(P.hamming_to_assigned(t(a), t(pats))) == want


def test_hamming_to_assigned_counts_the_level2_entries():
    rng = np.random.default_rng(3)
    a = clustered(rng, 128, 64)
    pats = _bank(rng, a, 4, 16, 16)
    st = phi_stats(t(a), t(pats))
    assert float(P.hamming_to_assigned(t(a), t(pats))) == round(st.l2_density * a.size)


def _vgg(seed=0):
    kw = dict(kind="vgg", widths=(16, 32), input_size=16, timesteps=2)
    rcfg = RM.SNNConfig(**kw, phi=RPhiConfig(k=16, q=16, iters=4))
    cfg = M.SNNConfig(**kw, phi=PhiConfig(k=16, q=16, iters=4))
    raw = np_tree(RM.init(rcfg, jax.random.PRNGKey(seed)))
    w = {name: {"w": dyadic(leaf["w"] * (1.0 if name == "conv0" else 3.0))}
         for name, leaf in raw.items()}
    x, y = D.synthetic_images(128, size=16, seed=seed)
    return rcfg, cfg, w, dyadic(x), y


def _ref_state(rcfg, w, x):
    """The reference's calibration on the reference's captured activations."""
    cap: dict = {}
    RM.apply(jax.tree.map(jnp.asarray, w), rcfg, jnp.asarray(x), capture=cap)
    patterns = {name: rcalibrate(np.asarray(act), rcfg.phi) for name, act in cap.items()}
    return patterns, RM.PhiState(patterns, {}, {})


def test_paft_regularizer_on_a_captured_dict_vs_reference():
    rcfg, cfg, w, x, _ = _vgg()
    patterns, rstate = _ref_state(rcfg, w, x[:16])
    state = phi_state_from_numpy(patterns, {}, None, "cpu")
    assert sorted(state.patterns) == ["conv1", "head"]
    jw = jax.tree.map(jnp.asarray, w)
    rreg = RP.paft_regularizer(rcfg, rstate, 0.5)

    def ref_reg(act1):                                   # conv1's activations as the input
        cap: dict = {}
        RM.apply(jw, rcfg, jnp.asarray(x[16:32]), capture=cap)
        cap["conv1"] = act1
        return rreg(jw, cap)

    cap: dict = {}
    RM.apply(jw, rcfg, jnp.asarray(x[16:32]), capture=cap)
    want = float(ref_reg(cap["conv1"]))
    want_g = np.asarray(jax.grad(ref_reg)(cap["conv1"]))
    pcap: dict = {}
    with torch.no_grad():
        M.apply(params_from_numpy(w, "cpu"), cfg, t(x[16:32]), capture=pcap)
    assert sorted(pcap) == sorted(cap)
    act1 = pcap["conv1"].clone().requires_grad_()
    pcap["conv1"] = act1
    got = P.paft_regularizer(cfg, state, 0.5)(params_from_numpy(w, "cpu"), pcap)
    got.backward()
    assert want > 0 and abs(float(got.detach()) - want) <= 1e-6 * want
    np.testing.assert_allclose(act1.grad.numpy(), want_g, rtol=0,
                               atol=1e-6 * np.abs(want_g).max())


def test_paft_regularizer_skips_layers_without_patterns():
    rcfg, cfg, w, x, _ = _vgg()
    patterns, _ = _ref_state(rcfg, w, x[:16])
    state = phi_state_from_numpy({"head": patterns["head"]}, {}, None, "cpu")
    cap: dict = {}
    with torch.no_grad():
        M.apply(params_from_numpy(w, "cpu"), cfg, t(x[:16]), capture=cap)
    head = cap["head"]
    K = patterns["head"].shape[0] * 16
    want = 0.5 * float(P.hamming_to_assigned(head[:, :K], state.patterns["head"])) \
        / (head.shape[0] * K)
    got = float(P.paft_regularizer(cfg, state, 0.5)(params_from_numpy(w, "cpu"), cap))
    assert abs(got - want) <= 1e-6 * want


def test_paft_finetune_losses_vs_reference():
    rcfg, cfg, w, x, y = _vgg()
    patterns, rstate = _ref_state(rcfg, w, x[:32])
    state = phi_state_from_numpy(patterns, {}, None, "cpu")
    _, want = RP.paft_finetune(jax.tree.map(jnp.asarray, w), rcfg, rstate, x, y, lam=1.0,
                               lr=5e-4, steps=5, batch=32)
    _, got = P.paft_finetune(params_from_numpy(w, "cpu"), cfg, state, x, y, lam=1.0, lr=5e-4,
                             steps=5, batch=32, device="cpu")
    np.testing.assert_allclose([h[0] for h in got], [h[0] for h in want], rtol=1e-5)
    assert [h[1] for h in got] == [h[1] for h in want]


@pytest.mark.slow
def test_paft_reduces_density_on_trained_model():
    x, y = D.synthetic_images(512, 10, size=16, seed=0)
    cfg = M.SNNConfig(kind="mlp", widths=(96, 96), timesteps=4, input_size=16,
                      phi=PhiConfig(k=16, q=32, iters=8))
    params, _ = T.train(cfg, x, y, steps=150, batch=64, log_every=0, device="cpu")
    phi, acts = M.calibrate_model(params, cfg, t(x[:96]))
    d0 = np.mean([phi_stats(acts[n], phi.patterns[n]).l2_density for n in acts])
    acc0 = T.evaluate(params, cfg, x[:256], y[:256])
    p2, _ = P.paft_finetune(params, cfg, phi, x, y, lam=1.0, lr=5e-4, steps=60, batch=64,
                            device="cpu")
    phi2, acts2 = M.calibrate_model(p2, cfg, t(x[:96]))
    d1 = np.mean([phi_stats(acts2[n], phi2.patterns[n]).l2_density for n in acts2])
    acc1 = T.evaluate(p2, cfg, x[:256], y[:256])
    assert d1 < d0, (d0, d1)
    assert acc1 >= acc0 - 0.05, (acc0, acc1)  # paper: minor accuracy cost


def test_paft_then_phi_apply_stays_lossless_on_the_grid():
    # The workflow after PAFT: recalibrate, then Phi inference equals dense
    # inference bitwise once the weights lie on the 2^-10 grid again.
    rcfg, cfg, w, x, y = _vgg()
    params = params_from_numpy(w, "cpu")
    phi, _ = M.calibrate_model(params, cfg, t(x[:32]))
    p2, hist = P.paft_finetune(params, cfg, phi, x, y, lam=1.0, lr=5e-4, steps=3, batch=32,
                               device="cpu")
    p2 = {n: {"w": torch.round(leaf["w"] * 1024) / 1024} for n, leaf in p2.items()}
    phi2, _ = M.calibrate_model(p2, cfg, t(x[:32]))
    with torch.no_grad():
        assert torch.equal(M.phi_apply(p2, cfg, phi2, t(x[32:48])),
                           M.apply(p2, cfg, t(x[32:48])))
    assert len(hist) == 3 and all(np.isfinite(h[0]) for h in hist)
