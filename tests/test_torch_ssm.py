"""The port's Mamba-2, hybrid (Zamba2) and MoE modules against the reference,
on the CPU at smoke sizes.

Units (``causal_conv1d``, ``_segsum``, ``ssd_chunked`` with its final state,
``mamba_prefill`` with its conv rings, ``mamba_decode``, ``_route`` and
``moe_dense``) run in float32 on identical numpy inputs and are held to ATOL
(1e-5): the einsums sum in another order than XLA's and exp/softplus/silu
differ by a rounding. The capture pass keys and counts every Phi site as the
reference's does, and its spike trains are equal. Calibration from the
reference's k-means initial rows gives the reference's patterns, PWPs and
usage exactly. Phi mode is bitwise the port's spiking-dense arm on dyadic
weights, at prefill and at every decode step.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config, phi_variant as ref_phi_variant
from repro.distributed.sharding import init_params as ref_init_params
from repro.models import mamba2 as ref_mamba2
from repro.models import model as ref_model
from repro.models import moe as ref_moe
from repro_torch import interop
from repro_torch.configs import get_config, phi_variant
from repro_torch.distributed.sharding import init_params
from repro_torch.kernels import dispatch
from repro_torch.models import mamba2, model, moe
from torch_parity_util import np_tree, reference_init_idx, t

ATOL = 1e-5
NEW_ARCHS = ["mamba2_2p7b", "zamba2_1p2b", "arctic_480b", "llama4_maverick"]


def _close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=atol)


@pytest.fixture
def fresh_policy():
    prev = dispatch.set_policy(dispatch.PhiExecutionPolicy())
    try:
        yield dispatch.get_policy()
    finally:
        dispatch.set_policy(prev)


def _rand_params(specs, rng):
    """Random float32 values for every leaf of a spec dict (numpy), so norms,
    A_log, D and dt_bias are not at their constant inits: GEMM weights at
    1/sqrt(fan_in) (unit-scale outputs, as ``init_params`` draws them), the
    rest at 0.3."""
    return {n: (rng.standard_normal(s.shape)
                * (s.shape[-2] ** -0.5 if n[0] in "wr" and len(s.shape) >= 2 else 0.3)
                ).astype(np.float32)
            for n, s in specs.items()}


# ---------------------------------------------------------------- mamba2 ---
def test_conv_segsum_and_ssd_match_the_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 11, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    for act in (True, False):
        _close(mamba2.causal_conv1d(t(x), t(w), act),
               ref_mamba2.causal_conv1d(jnp.asarray(x), jnp.asarray(w), act))
    dA = -np.abs(rng.standard_normal((2, 3, 8))).astype(np.float32)
    got = mamba2._segsum(t(dA)).numpy()
    want = np.asarray(ref_mamba2._segsum(jnp.asarray(dA)))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(np.where(np.isinf(got), 0, got),
                               np.where(np.isinf(want), 0, want), rtol=0, atol=ATOL)
    B, S, H, P, N = 2, 24, 3, 4, 5
    xs = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, S, N)).astype(np.float32) for _ in range(2))
    for chunk in (24, 8, 6, 1):                     # one chunk, several, one row each
        y, st = mamba2.ssd_chunked(t(xs), t(dt), t(A), t(Bm), t(Cm), chunk)
        ry, rst = ref_mamba2.ssd_chunked(*(jnp.asarray(a) for a in (xs, dt, A, Bm, Cm)), chunk)
        _close(y, ry)
        _close(st, rst)
    assert [mamba2.ssd_chunk(S, c) for S, c in ((24, 8), (12, 8), (7, 8), (97, 128),
                                                (131, 128))] == [8, 6, 7, 97, 1]


@pytest.mark.parametrize("arch", ["mamba2_2p7b", "zamba2_1p2b"])
def test_mamba_prefill_and_decode_match_the_reference(arch):
    rcfg, cfg = ref_get_config(arch, smoke=True), get_config(arch, smoke=True)
    rng = np.random.default_rng(1)
    p = _rand_params(ref_mamba2.mamba_specs(rcfg), rng)
    p["A_log"] = (rng.standard_normal(p["A_log"].shape) * 0.5).astype(np.float32)
    rp, pp = {n: jnp.asarray(a) for n, a in p.items()}, {n: t(a) for n, a in p.items()}
    S = 12                                          # chunk 8 does not divide: 6
    x = rng.standard_normal((2, S, rcfg.d_model)).astype(np.float32)
    out, (st, conv) = mamba2.mamba_prefill(cfg, pp, t(x))
    rout, (rst, rconv) = ref_mamba2.mamba_prefill(rcfg, rp, jnp.asarray(x))
    _close(out, rout)
    _close(st, rst)
    for k in ("x", "B", "C"):
        assert conv[k].shape == rconv[k].shape
        _close(conv[k], rconv[k])
    state, rstate = (st, conv), (rst, rconv)
    for i in range(3):
        x_t = rng.standard_normal((2, rcfg.d_model)).astype(np.float32)
        out, state = mamba2.mamba_decode(cfg, pp, t(x_t), state)
        rout, rstate = ref_mamba2.mamba_decode(rcfg, rp, jnp.asarray(x_t), rstate)
        _close(out, rout)
        _close(state[0], rstate[0])
        for k in ("x", "B", "C"):
            _close(state[1][k], rstate[1][k])
    want = ref_mamba2.mamba_state_specs(rcfg, 3, 5)
    got = mamba2.mamba_state_specs(cfg, 3, 5)
    assert {k: (tuple(s.shape), str(s.dtype).removeprefix("torch.")) for k, s in got.items()} \
        == {k: (tuple(s.shape), np.dtype(s.dtype).name) for k, s in want.items()}


# ------------------------------------------------------------------- moe ---
@pytest.mark.parametrize("arch,mlp", [("arctic_480b", "swiglu"), ("llama4_maverick", "swiglu"),
                                      ("llama4_maverick", "gelu")])
def test_route_and_moe_dense_match_the_reference(arch, mlp):
    """Top-k on softmax probabilities of continuous random logits: ties are
    measure-zero on these inputs, so ``torch.topk`` and ``lax.top_k`` pick
    the same experts."""
    rcfg = ref_get_config(arch, smoke=True).with_(mlp_type=mlp)
    cfg = get_config(arch, smoke=True).with_(mlp_type=mlp)
    rng = np.random.default_rng(2)
    p = _rand_params(ref_moe.moe_specs(rcfg), rng)
    x = rng.standard_normal((2, 7, rcfg.d_model)).astype(np.float32)
    for k in (1, 2):
        gates, idx = moe._route(cfg.with_(top_k=k), t(p["router"]), t(x))
        rg, ridx = ref_moe._route(rcfg.with_(top_k=k), jnp.asarray(p["router"]), jnp.asarray(x))
        assert idx.dtype == torch.int32 and np.array_equal(idx.numpy(), np.asarray(ridx))
        _close(gates, rg)
    _close(moe.moe_dense(cfg, {n: t(a) for n, a in p.items()}, t(x)),
           ref_moe.moe_dense(rcfg, {n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x)))


# --------------------------------------------------------- capture and Phi ---
def _ref_phi(arch, seed=0):
    rcfg = ref_phi_variant(ref_get_config(arch, smoke=True), timesteps=2, q=16)
    rp = ref_init_params(ref_model.lm_specs(rcfg), jax.random.PRNGKey(seed))
    rp = jax.tree.map(lambda x: jnp.round(x * 1024) / 1024, rp)
    batch = ref_model.dummy_batch(rcfg, 2, 8, with_labels=False, key=jax.random.PRNGKey(2))
    cfg = phi_variant(get_config(arch, smoke=True), timesteps=2, q=16)
    return rcfg, rp, batch, cfg


def _port_batch(batch):
    return {k: t(np.asarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ["olmo_1b"] + NEW_ARCHS)
def test_capture_keys_counts_and_spikes_equal_the_references(arch):
    """Keys (weight name, occurrence in the forward), the number of spike
    arrays under each (one per scan iteration there, per call here) and the
    spikes themselves. Zamba2: the three banks named ``wo`` are the main
    Mamba-2 layers' (#0), the shared block's (#1) and the tail's (#2)."""
    rcfg, rp, batch, cfg = _ref_phi(arch)
    want = ref_model._capture_phi_spikes(rcfg, rp, batch)
    got = model._capture_phi_spikes(cfg, interop.params_from_numpy(np_tree(rp), "cpu"),
                                    _port_batch(batch))
    assert {k: len(v) for k, v in got.items()} == {k: len(v) for k, v in want.items()}
    for key, arrs in want.items():
        for g, w in zip(got[key], arrs):
            assert g.dtype == torch.uint8 and np.array_equal(g.numpy(), np.asarray(w)), key
    if arch == "zamba2_1p2b":
        K = {k: v[0].shape[-1] for k, v in got.items()}
        assert (K["wo#0"], K["wo#1"], K["wo#2"]) == (cfg.d_inner, cfg.d_model, cfg.d_inner)
        assert [len(got[k]) for k in ("wz#0", "wq#0", "wz#1")] == [4, 2, 1]


def _spec_order(tree, specs):
    """``tree`` with every dict's keys in its spec's order (the reference's
    ``init_params`` returns them sorted, as ``jax.tree`` rebuilds dicts)."""
    if not isinstance(tree, dict):
        return tree
    return {k: _spec_order(tree[k], specs[k]) for k in specs}


def _phi_leaves(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if k.startswith("phi_"):
            for leaf in sorted(v):
                yield prefix + (k, leaf), v[leaf]
        elif isinstance(v, dict):
            yield from _phi_leaves(v, prefix + (k,))


def test_calibrate_zamba2_from_the_reference_initial_rows(fresh_policy):
    """Every bank of the hybrid (stacked main and tail layers with pooled
    patterns and per-layer PWPs, the shared block's 2-D weights pooled over
    the sites) equals the reference's, the banks written in place.

    The reference's calibration walks the params tree in dict order and
    keys sites by occurrence in that walk, while its capture keys them in
    forward order. Its ``init_params`` sorts every dict (mamba, mamba_tail,
    shared), so on its own trees the shared block's ``wo`` and the tail's
    swap spikes. It is held here on a tree in spec order, where the walk is
    the forward's; the port keys by the forward in any order."""
    rcfg, rp, batch, cfg = _ref_phi("zamba2_1p2b")
    rp_spec = _spec_order(rp, ref_model.lm_specs(rcfg))
    captured = ref_model._capture_phi_spikes(rcfg, rp_spec, batch)
    init = {key: reference_init_idx(np.concatenate([s.reshape(-1, s.shape[-1]) for s in spk]),
                                    rcfg.phi.k, rcfg.phi.q, seed=rcfg.phi.seed)
            for key, spk in captured.items()}
    want, want_stats = ref_model.calibrate_lm_phi(rcfg, rp_spec, batch)
    params = interop.params_from_numpy(np_tree(rp), "cpu")
    bank = params["decoder"]["mamba"]["phi_wo"]["pwp"]
    got, stats = model.calibrate_lm_phi(cfg, params, _port_batch(batch), init_idx=init)
    assert got["decoder"]["mamba"]["phi_wo"]["pwp"] is bank
    assert sorted(stats) == sorted(want_stats) == sorted(captured)
    for key, st in stats.items():
        assert st.l2_density == pytest.approx(want_stats[key].l2_density, rel=1e-6), key
    want_leaves = dict(_phi_leaves(np_tree(want)))
    got_leaves = dict(_phi_leaves(got))
    assert sorted(got_leaves) == sorted(want_leaves) and len(got_leaves) == 19 * 3
    for path, leaf in got_leaves.items():
        np.testing.assert_array_equal(leaf.numpy(), want_leaves[path], err_msg=str(path))
    # On its own (sorted) tree the reference calibrates the shared wo on the
    # tail's spikes.
    sorted_want, _ = ref_model.calibrate_lm_phi(rcfg, rp, batch)
    shared_wo = ("decoder", "shared", "attn", "phi_wo", "patterns")
    assert not np.array_equal(dict(_phi_leaves(np_tree(sorted_want)))[shared_wo],
                              want_leaves[shared_wo])


def _dyadic_port(arch, seed=5):
    cfg = phi_variant(get_config(arch, smoke=True), timesteps=4, q=32)
    params = init_params(model.lm_specs(cfg), torch.Generator().manual_seed(seed), "cpu")
    train, frozen = model.split_phi_state(params)
    stack = [train]
    while stack:
        for v in stack.pop().values():
            if isinstance(v, dict):
                stack.append(v)
            else:
                v.copy_(torch.round(v * 1024) / 1024)
    return cfg, model.merge_phi_state(train, frozen)


@pytest.mark.parametrize("arch", ["mamba2_2p7b", "zamba2_1p2b"])
def test_port_phi_bitwise_spiking_dense_at_prefill_and_decode(arch, fresh_policy):
    """Init, dyadic rounding and calibration in the port; then train_logits,
    prefill and three decode steps in both arms, bitwise (the decode state
    each arm writes in place too)."""
    cfg, params = _dyadic_port(arch)
    batch = model.dummy_batch(cfg, 2, 12, False, torch.Generator().manual_seed(1), "cpu")
    dense = model.spiking_dense_matmul(cfg)
    with torch.no_grad():
        params, stats = model.calibrate_lm_phi(cfg, params, batch)
        a = model.train_logits(cfg, params, batch)
        b = model.train_logits(cfg, params, batch, matmul=dense)
        assert torch.equal(a, b) and torch.isfinite(a).all() and float(a.std()) > 0
        lp, sp = model.prefill(cfg, params, batch)
        ld, sd = model.prefill(cfg, params, batch, matmul=dense)
        assert torch.equal(lp, a[:, -1]) and torch.equal(lp, ld)
        sp, sd = model.extend_caches(cfg, sp, 16), model.extend_caches(cfg, sd, 16)
        for i in range(3):
            tok = torch.tensor([3 + i, 40 + i], dtype=torch.int32)
            pos = torch.full((2,), 12 + i, dtype=torch.int32)
            lp, sp2 = model.decode_step(cfg, params, tok, pos, sp)
            ld, sd2 = model.decode_step(cfg, params, tok, pos, sd, matmul=dense)
            assert sp2 is sp and sd2 is sd               # written in place
            assert torch.equal(lp, ld), i
            assert all(torch.equal(x, y) for x, y in zip(model.state_leaves(sp),
                                                          model.state_leaves(sd)))
    assert 0 < max(s.l2_density for s in stats.values()) < 0.5
    impls = {i for (s, i, _), n in fresh_policy.decisions().items() if s.startswith("lm.w")}
    assert impls and impls <= {"fused", "fused_stream", "fused_prefetch"}


def test_hybrid_state_batch_axes_and_extend():
    cfg = get_config("zamba2_1p2b", smoke=True)
    state = model.init_decode_state(cfg, 3, 10, device="cpu")
    axes = model.state_batch_axes(cfg, state)
    for leaf, ax in zip(model.state_leaves(state["mamba"]), model.state_leaves(axes["mamba"])):
        assert ax == 2 and leaf.shape[:3] == (2, 2, 3)
    assert set(model.state_leaves(axes["kv"]) + model.state_leaves(axes["tail"])) == {1}
    grown = model.extend_caches(cfg, state, 16)
    assert grown["kv"][0].shape == (2, 3, 16, cfg.kv_heads_padded, cfg.hd)
    assert grown["mamba"] is state["mamba"] and grown["tail"] is state["tail"]
    ssm = get_config("mamba2_2p7b", smoke=True)
    s = model.init_decode_state(ssm, 2, 10, device="cpu")
    assert model.extend_caches(ssm, s, 16) is s
    assert set(model.state_leaves(model.state_batch_axes(ssm, s))) == {1}


def test_moe_phi_mode_leaves_experts_dense(fresh_policy):
    """Arctic: the attention and the parallel dense residual MLP are Phi
    GEMMs, the experts (einsums) are not; Phi is bitwise the spiking-dense
    arm."""
    cfg, params = _dyadic_port("arctic_480b")
    assert "phi_w1" not in params["decoder"]["stack"]["p0"]["moe"]
    assert "phi_w1" in params["decoder"]["stack"]["p0"]["dres"]
    batch = model.dummy_batch(cfg, 2, 10, False, torch.Generator().manual_seed(1), "cpu")
    with torch.no_grad():
        params, stats = model.calibrate_lm_phi(cfg, params, batch)
        a = model.train_logits(cfg, params, batch)
        b = model.train_logits(cfg, params, batch, matmul=model.spiking_dense_matmul(cfg))
    assert sorted(stats) == ["w1#0", "w2#0", "w3#0", "wk#0", "wo#0", "wq#0", "wv#0"]
    assert torch.equal(a, b) and torch.isfinite(a).all()
