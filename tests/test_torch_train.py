"""repro_torch training held against the JAX reference on identical inputs.

The optimizer (``train/optimizer.py``), the loss, one train step's loss and
gradients, the training loop and the event-frame data, each against its
counterpart in ``repro``. Weights come from the reference's ``init`` (×3 but
the encoder's, so spikes live at depth), weights and images on the 2^-10
grid, carried across with ``interop``: the forward's spikes are then
identical in both packages and only the order of the backward's sums
differs.

Tolerances. Optimizer: relative 1e-6 of each tensor's largest magnitude
(float32 rounding of the same formulas; XLA fuses some of them). Loss: 1e-6
relative. First-step gradients: 1e-5 of each gradient's largest magnitude
(the backward sums im2col products in another order; measured ≤ 3e-6).
Training loop: the first 5 losses at 1e-5 relative (a step's rounding
differences move the next step's weights by an ulp or so; measured ≤ 1e-7).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_util import dyadic, np_tree, t

from repro.core.patterns import PhiConfig as RPhiConfig
from repro.snn import data as RD
from repro.snn import models as RM
from repro.snn import train as RT
from repro.train import optimizer as ROPT
from repro_torch.core.patterns import PhiConfig
from repro_torch.interop import params_from_numpy
from repro_torch.snn import data as D
from repro_torch.snn import models as M
from repro_torch.snn import train as T
from repro_torch.train import optimizer as OPT

GAIN = 3.0
SMALL = {
    "vgg": dict(kind="vgg", widths=(16, 32), input_size=16, timesteps=2),
    "resnet": dict(kind="resnet", widths=(16, 32), input_size=8, timesteps=2),
    "mlp": dict(kind="mlp", widths=(64, 32), input_size=8, timesteps=2),
}
FIRST = {"vgg": "conv0", "resnet": "conv0", "mlp": "fc0"}


def _setup(kind, n=64, seed=0):
    kw = SMALL[kind]
    rcfg = RM.SNNConfig(**kw, phi=RPhiConfig(k=16, q=16, iters=4))
    cfg = M.SNNConfig(**kw, phi=PhiConfig(k=16, q=16, iters=4))
    raw = np_tree(RM.init(rcfg, jax.random.PRNGKey(seed)))
    w = {name: {"w": dyadic(leaf["w"] * (1.0 if name == FIRST[kind] else GAIN))}
         for name, leaf in raw.items()}
    x, y = D.synthetic_images(n, size=kw["input_size"], seed=seed)
    return rcfg, cfg, w, dyadic(x), y


def _close(got: torch.Tensor, want, rel: float) -> None:
    want = np.asarray(want)
    atol = rel * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=atol)


# ---------------------------------------------------------------- optimizer ---
@pytest.mark.parametrize("kw", [dict(warmup_steps=5, decay_steps=20),
                                dict(warmup_steps=0, decay_steps=12, min_lr_ratio=0.0),
                                dict(warmup_steps=3, decay_steps=3, lr=1e-2)])
def test_lr_schedule_vs_reference(kw):
    rfn, fn = ROPT.lr_schedule(ROPT.OptConfig(**kw)), OPT.lr_schedule(OPT.OptConfig(**kw))
    for step in range(25):
        want = float(rfn(jnp.asarray(step, jnp.int32)))
        got = float(fn(torch.tensor(step, dtype=torch.int32)))
        assert abs(got - want) <= 1e-6 * abs(want) + 1e-12, (step, got, want)


def _tree(rng, scale=1.0):
    return {"conv0": {"w": (rng.standard_normal((3, 3, 2, 4)) * scale).astype(np.float32)},
            "fc": {"w": (rng.standard_normal((6, 5)) * scale).astype(np.float32),
                   "b": (rng.standard_normal((5,)) * scale).astype(np.float32)}}


@pytest.mark.parametrize("factored", [False, True])
@pytest.mark.parametrize("grad_clip", [0.0, 0.5])
def test_apply_updates_three_steps_vs_reference(factored, grad_clip):
    rng = np.random.default_rng(7)
    params = _tree(rng)
    grads = [_tree(rng, 0.3) for _ in range(3)]
    kw = dict(lr=1e-2, warmup_steps=1, decay_steps=10, weight_decay=0.1, grad_clip=grad_clip,
              factored=factored)
    rcfg, cfg = ROPT.OptConfig(**kw), OPT.OptConfig(**kw)
    rp = jax.tree.map(jnp.asarray, params)
    rstate = ROPT.init(rp, rcfg)
    p = params_from_numpy(params, "cpu")
    state = OPT.init(p, cfg)
    assert state["step"].dtype == torch.int32 and state["step"].shape == ()
    for g in grads:
        rp, rstate = ROPT.apply_updates(rp, jax.tree.map(jnp.asarray, g), rstate, rcfg)
        p, state = OPT.apply_updates(p, params_from_numpy(g, "cpu"), state, cfg)
    assert int(state["step"]) == int(rstate["step"]) == 3
    for name in params:
        for key in params[name]:
            _close(p[name][key], rp[name][key], 1e-6)
            _close(state["m"][name][key], rstate["m"][name][key], 1e-6)
            v, rv = state["v"][name][key], rstate["v"][name][key]
            if isinstance(rv, dict):
                assert sorted(v) == ["vc", "vr"]
                _close(v["vr"], rv["vr"], 1e-6)
                _close(v["vc"], rv["vc"], 1e-6)
            else:
                _close(v, rv, 1e-6)
    _close(OPT.global_norm(p), ROPT.global_norm(rp), 1e-6)


def test_apply_updates_leaves_its_inputs_alone():
    rng = np.random.default_rng(1)
    p = params_from_numpy(_tree(rng), "cpu")
    g = params_from_numpy(_tree(rng), "cpu")
    before = {n: {k: x.clone() for k, x in leaf.items()} for n, leaf in p.items()}
    cfg = OPT.OptConfig(factored=True)
    state = OPT.init(p, cfg)
    new, new_state = OPT.apply_updates(p, g, state, cfg)
    assert int(state["step"]) == 0 and int(new_state["step"]) == 1
    for n, leaf in p.items():
        for k, x in leaf.items():
            assert torch.equal(x, before[n][k]) and not torch.equal(new[n][k], x)


# --------------------------------------------------------------------- loss ---
def test_cross_entropy_vs_reference():
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((16, 10)) * 4).astype(np.float32)
    y = rng.integers(0, 10, 16).astype(np.int32)
    want = float(RT.cross_entropy(jnp.asarray(logits), jnp.asarray(y)))
    got = float(T.cross_entropy(t(logits), t(y)))
    assert abs(got - want) <= 1e-6 * abs(want)


@pytest.mark.parametrize("kind", list(SMALL))
def test_first_step_loss_and_grads_vs_jax_grad(kind):
    rcfg, cfg, w, x, y = _setup(kind, n=32)

    def loss_fn(params, xb, yb):
        return RT.cross_entropy(RM.apply(params, rcfg, xb), yb)

    jw = jax.tree.map(jnp.asarray, w)
    want_loss = float(loss_fn(jw, jnp.asarray(x), jnp.asarray(y)))
    want = jax.grad(loss_fn)(jw, jnp.asarray(x), jnp.asarray(y))
    grads, (loss, acc) = T.loss_and_grads(params_from_numpy(w, "cpu"), cfg, t(x), t(y))
    assert abs(float(loss) - want_loss) <= 1e-6 * abs(want_loss)
    assert 0.0 <= float(acc) <= 1.0
    assert sorted(grads) == sorted(want)
    for name in grads:
        assert float(np.abs(np.asarray(want[name]["w"])).max()) > 0, name
        _close(grads[name]["w"], want[name]["w"], 1e-5)


def test_train_step_runs_the_differentiable_lif_loop_not_the_kernel(monkeypatch):
    from repro_torch.snn import lif as snn_lif

    rcfg, cfg, w, x, y = _setup("vgg", n=8)
    calls = []
    real = snn_lif.lif_sequence_cuda
    monkeypatch.setattr(snn_lif, "lif_sequence_cuda",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    T.loss_and_grads(params_from_numpy(w, "cpu"), cfg, t(x), t(y))
    assert calls == []                     # every spiking layer's input required grad
    with torch.no_grad():
        M.apply(params_from_numpy(w, "cpu"), cfg, t(x))
    assert len(calls) == 2                 # conv1 and the head: the inference path


# --------------------------------------------------------------- the loop ---
def test_train_losses_vs_reference_and_decrease():
    rcfg, cfg, w, x, y = _setup("vgg", n=256)
    _, want = RT.train(rcfg, x, y, steps=40, batch=32, params=jax.tree.map(jnp.asarray, w),
                       log_every=0)
    params, got = T.train(cfg, x, y, steps=40, batch=32, params=params_from_numpy(w, "cpu"),
                          log_every=0, device="cpu")
    assert len(got) == 40 and all(isinstance(v, float) for h in got for v in h)
    np.testing.assert_allclose([h[0] for h in got[:5]], [h[0] for h in want[:5]], rtol=1e-5)
    assert [h[1] for h in got[:5]] == [h[1] for h in want[:5]]
    assert got[-1][0] < got[0][0]          # loss decreased
    assert sorted(params) == sorted(w) and params["conv0"]["w"].device.type == "cpu"
    acc = T.evaluate(params, cfg, x[:64], y[:64])
    assert 0.0 <= acc <= 1.0


def test_evaluate_vs_reference():
    rcfg, cfg, w, x, y = _setup("vgg", n=48)
    want = RT.evaluate(jax.tree.map(jnp.asarray, w), rcfg, x, y, batch=20)
    assert T.evaluate(params_from_numpy(w, "cpu"), cfg, x, y, batch=20) == want


def test_train_runs_on_the_card_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    rcfg, cfg, w, x, y = _setup("mlp", n=8)
    with pytest.raises(RuntimeError, match="CUDA requested"):
        T.train(cfg, x, y, steps=1, batch=4, params=params_from_numpy(w, "cpu"), log_every=0)


def test_train_draws_weights_from_the_seed():
    cfg = M.SNNConfig(**SMALL["mlp"])
    x, y = D.synthetic_images(16, size=8, seed=0)
    p1, h1 = T.train(cfg, x, y, steps=2, batch=4, seed=3, log_every=0, device="cpu")
    p2, h2 = T.train(cfg, x, y, steps=2, batch=4, seed=3, log_every=0, device="cpu")
    assert h1 == h2 and all(torch.equal(p1[n]["w"], p2[n]["w"]) for n in p1)


# ------------------------------------------------------------- event frames ---
def test_synthetic_event_frames_bitwise():
    for kw in (dict(n=32, size=16, timesteps=4, seed=1), dict(n=7, num_classes=3, size=8,
                                                              timesteps=2, seed=5)):
        xr, yr = RD.synthetic_event_frames(**kw)
        xp, yp = D.synthetic_event_frames(**kw)
        assert xp.dtype == xr.dtype and yp.dtype == yr.dtype
        np.testing.assert_array_equal(xp, xr)
        np.testing.assert_array_equal(yp, yr)


def test_event_frames_drive_timesteps():
    x, y = D.synthetic_event_frames(128, 10, size=16, timesteps=4, seed=1)
    cfg = M.SNNConfig(kind="vgg", widths=(16,), timesteps=4, input_size=16,
                      input_channels=2, phi=PhiConfig(k=16, q=8, iters=4))
    params, hist = T.train(cfg, x, y, steps=10, batch=32, log_every=0, device="cpu")
    with torch.no_grad():
        logits = M.apply(params, cfg, t(x[:8]))
    assert logits.shape == (8, 10) and torch.isfinite(logits).all()
    assert all(np.isfinite(h[0]) for h in hist)


def test_event_frame_losses_vs_reference():
    x, y = D.synthetic_event_frames(64, 10, size=16, timesteps=4, seed=1)
    kw = dict(kind="vgg", widths=(16,), timesteps=4, input_size=16, input_channels=2)
    rcfg = RM.SNNConfig(**kw, phi=RPhiConfig(k=16, q=8, iters=4))
    cfg = M.SNNConfig(**kw, phi=PhiConfig(k=16, q=8, iters=4))
    raw = np_tree(RM.init(rcfg, jax.random.PRNGKey(0)))
    w = {name: {"w": dyadic(leaf["w"] * (1.0 if name == "conv0" else GAIN))}
         for name, leaf in raw.items()}
    _, want = RT.train(rcfg, x, y, steps=5, batch=16, params=jax.tree.map(jnp.asarray, w),
                       log_every=0)
    _, got = T.train(cfg, x, y, steps=5, batch=16, params=params_from_numpy(w, "cpu"),
                     log_every=0, device="cpu")
    np.testing.assert_allclose([h[0] for h in got], [h[0] for h in want], rtol=1e-5)
