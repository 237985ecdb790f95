"""The port's LM stack against the reference, on the CPU at smoke sizes.

Configs, specs and cache specs are compared exactly (they are data). Layers
and dense forwards run in float32 on identical inputs: norms, RoPE and
softmax differ between XLA and PyTorch by a few float32 roundings, so their
outputs are held to ATOL (1e-5 of unit-scale activations) and the logits of
whole forwards to LOGIT_ATOL (1e-4; two layers of such roundings on logits
of magnitude ~1), KV caches to ATOL. The Mamba-2 and hybrid decode states
(SSM states summing a whole prompt, magnitudes ~10) are held to ATOL of each
leaf's largest magnitude. Long prefill (S > 1024) runs the reference's flash
tiles (512 × 1024) in the reference and the attention kernel's own tiles in
the port: the same online softmax summed in another order, held to
LOGIT_ATOL.
Phi mode is bitwise where the reference promises it: on dyadic weights the
port's Phi logits equal its spiking-dense logits bit for bit. Against the
reference's spiking-dense forward the port is held to LOGIT_ATOL: both rate
code the same activations up to those roundings. Calibration from the
reference's k-means initial rows gives the reference's patterns, usage and
PWPs exactly, and ``capture_lm_phi_traces`` its traces to the integer.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_config as ref_get_config, phi_variant as ref_phi_variant
from repro.distributed.sharding import init_params as ref_init_params
from repro.distributed.sharding import is_spec as ref_is_spec
from repro.kernels.dispatch import PhiExecutionPolicy as RefPolicy
from repro.models import layers as ref_ll
from repro.models import model as ref_model
from repro_torch import interop
from repro_torch.configs import get_config, phi_variant
from repro_torch.distributed.sharding import init_params, is_spec, param_bytes
from repro_torch.kernels import dispatch
from repro_torch.models import layers as ll
from repro_torch.models import model
from torch_parity_util import np_tree, ref_spiking_dense_mm, reference_init_idx, t

ATOL = 1e-5
LOGIT_ATOL = 1e-4
ATTN_ARCHS = ["olmo_1b", "h2o_danube3_4b", "yi_34b", "qwen1p5_4b", "pixtral_12b",
              "musicgen_large", "mamba2_2p7b", "zamba2_1p2b", "arctic_480b", "llama4_maverick"]


def _dtype_name(dt) -> str:
    if isinstance(dt, torch.dtype):
        return str(dt).removeprefix("torch.")
    return np.dtype(dt).name


def _field(v):
    if dataclasses.is_dataclass(v):
        return dataclasses.asdict(v)
    if isinstance(v, torch.dtype) or (isinstance(v, type) and hasattr(v, "dtype")):
        return _dtype_name(v)
    return v


def _spec_rows(tree, is_leaf, prefix=()):
    if is_leaf(tree):
        return [(prefix, tuple(tree.shape), tuple(tree.axes), _dtype_name(tree.dtype),
                 tree.init, tree.scale)]
    rows = []
    for k in sorted(tree):
        rows += _spec_rows(tree[k], is_leaf, prefix + (k,))
    return rows


def _port_params(ref_params, device="cpu"):
    return interop.params_from_numpy(np_tree(ref_params), device)


def _port_batch(batch):
    return {k: t(np.asarray(v)) for k, v in batch.items()}


def _close(got: torch.Tensor, want, atol=LOGIT_ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=atol)


@pytest.fixture
def fresh_policy():
    prev = dispatch.set_policy(dispatch.PhiExecutionPolicy())
    try:
        yield dispatch.get_policy()
    finally:
        dispatch.set_policy(prev)


# ------------------------------------------------------------- configs ---
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_fields_properties_and_param_count(arch):
    for smoke in (False, True):
        for phi in (False, True):
            r = ref_get_config(arch, smoke=smoke)
            p = get_config(arch, smoke=smoke)
            if phi:
                r, p = ref_phi_variant(r), phi_variant(p)
            for f in dataclasses.fields(r):
                assert _field(getattr(p, f.name)) == _field(getattr(r, f.name)), (arch, f.name)
            for prop in ("hd", "q_heads_padded", "kv_heads_padded", "kv_rep", "q_per_kv",
                         "d_inner", "ssm_heads", "sub_quadratic"):
                if prop in ("kv_rep", "q_per_kv") and r.n_kv_heads == 0:
                    continue
                assert getattr(p, prop) == getattr(r, prop), (arch, prop)
            for i in range(r.n_layers):
                assert p.is_moe_layer(i) == r.is_moe_layer(i)
                assert p.is_global_layer(i) == r.is_global_layer(i)
            assert p.param_count() == r.param_count()
    assert get_config("olmo-1b").name == "olmo-1b"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_lm_specs_match_the_reference(arch):
    """Shapes, logical axes, dtypes, init laws and key paths, with and
    without Phi, full and smoke; nothing is allocated."""
    for smoke in (False, True):
        for phi in (False, True):
            r = ref_get_config(arch, smoke=smoke)
            p = get_config(arch, smoke=smoke)
            if phi:
                r, p = ref_phi_variant(r), phi_variant(p)
            want = _spec_rows(ref_model.lm_specs(r), ref_is_spec)
            got = _spec_rows(model.lm_specs(p), is_spec)
            assert got == want, arch
            from repro.distributed.sharding import param_bytes as ref_param_bytes
            assert param_bytes(model.lm_specs(p)) == ref_param_bytes(ref_model.lm_specs(r))


def test_unported_families_raise_not_implemented():
    """Expert parallelism (the full MoE configs' ``moe_impl="ep"``) without a
    mesh runs the dense branch, as the reference's ``moe_ep`` does: logits
    bitwise ``moe_impl="dense"``'s. The dense branch on a mesh no longer
    raises: given whole leaves and the global rows it gathers nothing and is
    ``moe_dense`` itself (the sharded case runs in a world of ranks,
    ``tests/test_torch_distributed.py``)."""
    import types

    from repro_torch.distributed.sharding import SERVE_RULES, use_rules
    from repro_torch.models import moe

    for arch in ("llama4_maverick", "arctic_480b"):
        assert get_config(arch).moe_impl == "ep"
        cfg = get_config(arch, smoke=True).with_(moe_impl="ep")
        params = init_params(model.lm_specs(cfg), torch.Generator().manual_seed(0), "cpu")
        batch = {"tokens": torch.arange(4, dtype=torch.int32)[None]}
        with torch.no_grad():
            ep = model.train_logits(cfg, params, batch)
            dense = model.train_logits(cfg.with_(moe_impl="dense"), params, batch)
        assert torch.equal(ep, dense) and torch.isfinite(ep).all()
        grid = types.SimpleNamespace(axis_names=("data", "model"),
                                     shape={"data": 1, "model": 2})
        x = torch.randn((1, 4, cfg.d_model), generator=torch.Generator().manual_seed(1))
        p = next(pos["moe"] for pos in params["decoder"]["stack"].values() if "moe" in pos)
        layer = {k: v[0] for k, v in p.items()}
        dcfg = cfg.with_(moe_impl="dense")
        with torch.no_grad():
            with use_rules(SERVE_RULES, grid):
                got = moe.moe_apply(dcfg, layer, x)
            assert torch.equal(got, moe.moe_dense(dcfg, layer, x))


def test_init_params_laws_and_order():
    cfg = get_config("qwen1p5_4b", smoke=True)
    a = init_params(model.lm_specs(cfg), torch.Generator().manual_seed(3), "cpu")
    b = init_params(model.lm_specs(cfg), torch.Generator().manual_seed(3), "cpu")
    p0 = a["decoder"]["stack"]["p0"]
    assert list(p0) == sorted(p0)
    assert torch.equal(p0["wq"], b["decoder"]["stack"]["p0"]["wq"])
    assert torch.count_nonzero(p0["bq"]) == 0 and torch.all(p0["ln1"]["w"] == 1)
    # default scale 1/sqrt(fan_in); embed scale 0.02
    assert abs(float(p0["wq"].std()) - cfg.d_model ** -0.5) < 0.02
    assert abs(float(a["embed"].std()) - 0.02) < 0.003


def test_interop_carries_every_leaf_dtype():
    """int8 patterns, int32 usage, f32 banks and bf16 weights (the MoE
    configs' param dtype) cross to the same dtypes and values."""
    tree = {"w": jnp.asarray([[0.5, -1.25]], jnp.bfloat16),
            "phi_w": {"patterns": jnp.asarray([[[1, 0]]], jnp.int8),
                      "usage": jnp.asarray([[3, 1]], jnp.int32),
                      "pwp": jnp.asarray([[[0.25], [0.0]]], jnp.float32)}}
    got = interop.params_from_numpy(np_tree(tree), "cpu")
    assert got["w"].dtype == torch.bfloat16 and got["w"].tolist() == [[0.5, -1.25]]
    assert [got["phi_w"][k].dtype for k in ("patterns", "usage", "pwp")] == \
        [torch.int8, torch.int32, torch.float32]
    assert got["phi_w"]["usage"].tolist() == [[3, 1]]


# -------------------------------------------------------------- layers ---
def test_layers_against_the_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    w = rng.standard_normal((16,)).astype(np.float32)
    _close(ll.rmsnorm(t(x), t(w)), ref_ll.rmsnorm(jnp.asarray(x), jnp.asarray(w)), ATOL)
    _close(ll.nonparam_ln(t(x)), ref_ll.nonparam_ln(jnp.asarray(x)), ATOL)
    pos = np.broadcast_to(np.arange(9) + 5, (2, 9)).astype(np.int32)
    _close(ll.rope(t(x), t(pos), 1e4), ref_ll.rope(jnp.asarray(x), jnp.asarray(pos), 1e4), ATOL)

    q, k, v = (rng.standard_normal((2, 12, 4, 8)).astype(np.float32) for _ in range(3))
    Q, K, V = (jnp.asarray(a) for a in (q, k, v))
    for kw in ({}, {"window": 5}, {"q_offset": 3, "causal": True},
               {"kv_len": np.array(7)}, {"causal": False}):
        rk = {k_: (jnp.asarray(v_) if isinstance(v_, np.ndarray) else v_) for k_, v_ in kw.items()}
        pk = {k_: (t(v_) if isinstance(v_, np.ndarray) else v_) for k_, v_ in kw.items()}
        _close(ll.attention_dense(t(q), t(k), t(v), **pk),
               ref_ll.attention_dense(Q, K, V, **rk), ATOL)
    _close(ll.flash_attention(t(q), t(k), t(v), block_q=4, block_kv=6),
           ref_ll.flash_attention(Q, K, V, block_q=4, block_kv=6), ATOL)
    _close(ll.flash_attention(t(q), t(k), t(v), block_q=4, window=5),
           ref_ll.flash_attention(Q, K, V, block_q=4, window=5), ATOL)
    for chunk in (5, 4, 16):
        _close(ll.chunked_local_attention(t(q), t(k), t(v), chunk),
               ref_ll.chunked_local_attention(Q, K, V, chunk), ATOL)

    q1 = rng.standard_normal((3, 1, 4, 8)).astype(np.float32)
    kc, vc = (rng.standard_normal((3, 10, 2, 8)).astype(np.float32) for _ in range(2))
    p = np.array([3, 9, 14], np.int32)
    for mode in ("full", "ring", "chunk_ring"):
        _close(ll.attention_decode(t(q1), t(kc), t(vc), t(p), mode=mode),
               ref_ll.attention_decode(jnp.asarray(q1), jnp.asarray(kc), jnp.asarray(vc),
                                       jnp.asarray(p), mode=mode), ATOL)

    for arch in ("olmo_1b", "musicgen_large"):          # swiglu, gelu
        rc, pc = ref_get_config(arch, smoke=True), get_config(arch, smoke=True)
        mp = {n: rng.standard_normal(s.shape).astype(np.float32) * 0.1
              for n, s in ref_ll.mlp_specs(rc).items()}
        h = rng.standard_normal((2, 5, rc.d_model)).astype(np.float32)
        _close(ll.mlp_apply(pc, {n: t(a) for n, a in mp.items()}, t(h)),
               ref_ll.mlp_apply(rc, {n: jnp.asarray(a) for n, a in mp.items()},
                                jnp.asarray(h)), ATOL)


# ------------------------------------------------------- dense forwards ---
def _batch(rcfg, B, S, seed):
    offs = rcfg.frontend_positions if rcfg.frontend == "patches" else 0
    return ref_model.dummy_batch(rcfg, B, S + offs, with_labels=True,
                                 key=jax.random.PRNGKey(seed)), offs


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_dense_forward_prefill_and_decode_match_the_reference(arch):
    rcfg, cfg = ref_get_config(arch, smoke=True), get_config(arch, smoke=True)
    rp = ref_init_params(ref_model.lm_specs(rcfg), jax.random.PRNGKey(1))
    params = _port_params(rp)
    B, S, extra = 2, 20, 3
    batch, offs = _batch(rcfg, B, S + extra, 2)
    pb = _port_batch(batch)
    with torch.no_grad():
        _close(model.train_logits(cfg, params, pb), ref_model.train_logits(rcfg, rp, batch))
        _close(model.train_loss(cfg, params, pb), ref_model.train_loss(rcfg, rp, batch), ATOL)
        seq = {k: (v[:, :S] if k in ("tokens", "frame_embeds") else v)
               for k, v in batch.items() if k != "labels"}
        lg_r, c_r = ref_model.prefill(rcfg, rp, seq)
        lg_p, c_p = model.prefill(cfg, params, _port_batch(seq))
        _close(lg_p, lg_r)
        leaves_r = jax.tree.leaves(c_r)
        assert len(model.state_leaves(c_p)) == len(leaves_r)
        recurrent = rcfg.family in ("ssm", "hybrid")
        for got, want in zip(model.state_leaves(c_p), leaves_r):
            # An SSM state sums a whole prompt (magnitudes ~10): the states
            # of the recurrent families are held to ATOL of their largest.
            assert got.shape == want.shape
            scale = max(1.0, float(np.abs(want).max())) if recurrent else 1.0
            _close(got.to(torch.float32), want, ATOL * scale)
        total = S + extra + offs
        c_r = ref_model.extend_caches(rcfg, c_r, total)
        c_p = model.extend_caches(cfg, c_p, total)
        for i in range(extra):
            pos = np.full((B,), S + i + offs, np.int32)
            tok = batch["tokens"][:, S + i] if "tokens" in batch else jnp.zeros((B,), jnp.int32)
            emb = batch["frame_embeds"][:, S + i] if rcfg.frontend == "frames" else None
            lg_r, c_r = ref_model.decode_step(rcfg, rp, tok, jnp.asarray(pos), c_r, embeds=emb)
            lg_p, c_p = model.decode_step(cfg, params, t(np.asarray(tok)), t(pos), c_p,
                                          embeds=None if emb is None else t(np.asarray(emb)))
            _close(lg_p, lg_r)


def test_long_prefill_takes_the_flash_branch_and_matches(fresh_policy):
    """S = 2048 > 1024: the policy's flash decision (the attention kernel's
    tiles) in the port, the reference's 512 × 1024 flash tiles there."""
    rcfg, cfg = ref_get_config("olmo_1b", smoke=True), get_config("olmo_1b", smoke=True)
    rp = ref_init_params(ref_model.lm_specs(rcfg), jax.random.PRNGKey(3))
    batch = ref_model.dummy_batch(rcfg, 1, 2048, with_labels=False, key=jax.random.PRNGKey(4))
    with torch.no_grad():
        lg_p, caches = model.prefill(cfg, _port_params(rp), _port_batch(batch))
    lg_r, _ = ref_model.prefill(rcfg, rp, batch)
    _close(lg_p, lg_r)
    assert caches[0][0].shape == (cfg.n_layers, 1, 2048, cfg.n_kv_heads, cfg.hd)
    decs = {(s, i, r): n for (s, i, r), n in fresh_policy.decisions().items()}
    assert decs == {("lm.attn_prefill", "flash", "dense_qk_keeps_flash"): cfg.n_layers}
    from repro_torch.kernels import ops
    assert fresh_policy.last_decision("lm.attn_prefill").blocks == \
        ops.autotune_attn_blocks(2048, cfg.hd, 0, 0, 0)


# ------------------------------------------------------------ Phi mode ---
def _ref_phi_setup(arch="olmo_1b", seed=0):
    rcfg = ref_phi_variant(ref_get_config(arch, smoke=True), timesteps=2, q=16)
    rp = ref_init_params(ref_model.lm_specs(rcfg), jax.random.PRNGKey(seed))
    rp = jax.tree.map(lambda x: jnp.round(x * 1024) / 1024, rp)
    batch = ref_model.dummy_batch(rcfg, 2, 8, with_labels=False, key=jax.random.PRNGKey(2))
    return rcfg, rp, batch


# Phi sites: seven a layer group; Mamba-2's six; Zamba2's six main, seven
# shared and six tail.
PHI_SITES = {"olmo_1b": 7, "yi_34b": 7, "mamba2_2p7b": 6, "zamba2_1p2b": 19}


@pytest.mark.parametrize("arch", list(PHI_SITES))
def test_phi_mode_on_reference_calibrated_params(arch, fresh_policy):
    """The reference calibrates; its params carried across: the port's Phi
    logits equal the port's spiking-dense logits bitwise, and both agree
    with the reference's spiking-dense forward to LOGIT_ATOL."""
    rcfg, rp, batch = _ref_phi_setup(arch)
    rp, _ = ref_model.calibrate_lm_phi(rcfg, rp, batch)
    x, _ = ref_model._forward(rcfg, rp, batch, matmul=ref_spiking_dense_mm(rcfg))
    want = ref_model._logits(rcfg, rp, x)
    cfg = phi_variant(get_config(arch, smoke=True), timesteps=2, q=16)
    params = _port_params(rp)
    assert dispatch.register_usage_from_params(params) == PHI_SITES[arch]
    pb = _port_batch(batch)
    with torch.no_grad():
        phi = model.train_logits(cfg, params, pb)
        dense = model.train_logits(cfg, params, pb, matmul=model.spiking_dense_matmul(cfg))
    assert torch.equal(phi, dense)
    _close(phi, want)
    impls = {i for (s, i, _), n in fresh_policy.decisions().items() if s.startswith("lm.w")}
    assert impls and impls <= {"fused", "fused_stream", "fused_prefetch"}


def test_calibrate_lm_phi_from_the_reference_initial_rows(fresh_policy):
    rcfg, rp, batch = _ref_phi_setup()
    captured = ref_model._capture_phi_spikes(rcfg, rp, batch)
    init = {}
    for key, spk in captured.items():
        a = np.concatenate([s.reshape(-1, s.shape[-1]) for s in spk])
        init[key] = reference_init_idx(a, rcfg.phi.k, rcfg.phi.q, seed=rcfg.phi.seed)
    want, want_stats = ref_model.calibrate_lm_phi(rcfg, rp, batch)
    cfg = phi_variant(get_config("olmo_1b", smoke=True), timesteps=2, q=16)
    params = _port_params(rp)
    bank = params["decoder"]["stack"]["p0"]["phi_wq"]["pwp"]
    got, stats = model.calibrate_lm_phi(cfg, params, _port_batch(batch), init_idx=init)
    assert got["decoder"]["stack"]["p0"]["phi_wq"]["pwp"] is bank     # written in place
    assert sorted(stats) == sorted(want_stats)
    for key, st in stats.items():
        for f in ("bit_density", "l1_density", "l2_pos_density", "l2_neg_density",
                  "idx_density"):
            assert getattr(st, f) == pytest.approx(getattr(want_stats[key], f), rel=1e-6)
    ws = np_tree(want)["decoder"]["stack"]["p0"]
    gs = got["decoder"]["stack"]["p0"]
    for name in ("wq", "wk", "wv", "wo"):
        for leaf in ("patterns", "pwp", "usage"):
            np.testing.assert_array_equal(gs[f"phi_{name}"][leaf].numpy(),
                                          ws[f"phi_{name}"][leaf], err_msg=f"{name} {leaf}")
    for name in ("w1", "w2", "w3"):
        for leaf in ("patterns", "pwp", "usage"):
            np.testing.assert_array_equal(gs["mlp"][f"phi_{name}"][leaf].numpy(),
                                          ws["mlp"][f"phi_{name}"][leaf])
    u = fresh_policy.usage_for("lm.w2")
    np.testing.assert_array_equal(u, ws["mlp"]["phi_w2"]["usage"][0])


def test_port_phi_bitwise_spiking_dense_on_its_own_calibration(fresh_policy):
    """Init, dyadic rounding and calibration all in the port."""
    cfg = phi_variant(get_config("olmo_1b", smoke=True), timesteps=4, q=32)
    params = init_params(model.lm_specs(cfg), torch.Generator().manual_seed(5), "cpu")
    train, frozen = model.split_phi_state(params)
    train = {k: v for k, v in train.items()}
    for leaf in _leaves(train):
        leaf.copy_(torch.round(leaf * 1024) / 1024)
    params = model.merge_phi_state(train, frozen)
    batch = model.dummy_batch(cfg, 2, 12, False, torch.Generator().manual_seed(1), "cpu")
    with torch.no_grad():
        params, stats = model.calibrate_lm_phi(cfg, params, batch)
        a = model.train_logits(cfg, params, batch)
        b = model.train_logits(cfg, params, batch, matmul=model.spiking_dense_matmul(cfg))
        lg, _ = model.prefill(cfg, params, batch)
    assert torch.equal(a, b) and torch.isfinite(a).all()
    assert torch.equal(lg, a[:, -1])
    assert 0 < max(s.l2_density for s in stats.values()) < 0.5


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def test_split_merge_phi_state_and_register_usage(fresh_policy):
    rcfg, rp, batch = _ref_phi_setup()
    rp, _ = ref_model.calibrate_lm_phi(rcfg, rp, batch)
    params = _port_params(rp)
    tr_r, fr_r = ref_model.split_phi_state(np_tree(rp))
    tr_p, fr_p = model.split_phi_state(params)

    def paths(tree, prefix=()):
        if not isinstance(tree, dict):
            return [prefix]
        return [p for k in sorted(tree) for p in paths(tree[k], prefix + (k,))]

    assert paths(tr_p) == paths(tr_r) and paths(fr_p) == paths(fr_r)
    assert not any(p[-2].startswith("phi_") for p in paths(tr_p) if len(p) > 1)
    merged = model.merge_phi_state(tr_p, fr_p)
    assert paths(merged) == paths(params)
    assert model.merge_phi_state(tr_p, {}) is tr_p
    pol = RefPolicy(telemetry=False)
    from repro.kernels import dispatch as ref_dispatch
    prev = ref_dispatch._default_policy
    ref_dispatch._default_policy = pol
    try:
        n_ref = ref_dispatch.register_usage_from_params(rp)
    finally:
        ref_dispatch._default_policy = prev
    assert dispatch.register_usage_from_params(params) == n_ref == 7
    for site in ("lm.wq", "lm.w2"):
        np.testing.assert_array_equal(fresh_policy.usage_for(site), pol.usage_for(site))


def test_capture_lm_phi_traces_equal_the_references_and_feed_the_sim(fresh_policy):
    from repro.sim.accel import PhiAcceleratorSim as RefSim
    from repro_torch.sim import PhiAcceleratorSim, summarize_run

    rcfg, rp, batch = _ref_phi_setup()
    rp, _ = ref_model.calibrate_lm_phi(rcfg, rp, batch)
    want = ref_model.capture_lm_phi_traces(rcfg, rp, batch)
    cfg = phi_variant(get_config("olmo_1b", smoke=True), timesteps=2, q=16)
    got = model.capture_lm_phi_traces(cfg, _port_params(rp), _port_batch(batch))
    assert [g.name for g in got] == [w.name for w in want]
    for g, w in zip(got, want):
        assert (g.m, g.k_dim, g.n, g.k, g.q) == (w.m, w.k_dim, w.n, w.k, w.q)
        for f in ("idx", "tile_pop", "tile_res", "usage"):
            np.testing.assert_array_equal(getattr(g, f), np.asarray(getattr(w, f)))
    res, ref_res = PhiAcceleratorSim().run(got), RefSim().run(want)
    assert [r.cycles for r in res] == [r.cycles for r in ref_res]
    assert summarize_run(res)["cycles"] > 0


# ------------------------------------------------------------ cache specs ---
def _shapes(tree, leaves=model.state_leaves):
    return [(tuple(s.shape), _dtype_name(s.dtype)) for s in leaves(tree)]


@pytest.mark.parametrize("arch", ["olmo_1b", "h2o_danube3_4b", "yi_34b", "qwen1p5_4b",
                                  "mamba2_2p7b", "zamba2_1p2b", "arctic_480b",
                                  "llama4_maverick"])
def test_cache_specs_match_the_reference(arch):
    for smoke in (True, False):
        rcfg, cfg = ref_get_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
        for B, ctx in ((2, 24), (1, 7)):
            assert _shapes(model.decode_state_specs(cfg, B, ctx)) == \
                _shapes(ref_model.decode_state_specs(rcfg, B, ctx), jax.tree.leaves)
        if rcfg.attn_type == "full" and rcfg.family not in ("ssm", "hybrid"):
            assert _shapes(model.paged_state_specs(cfg, 5, 8)) == \
                _shapes(ref_model.paged_state_specs(rcfg, 5, 8), jax.tree.leaves)
        else:
            with pytest.raises(ValueError):
                model.paged_state_specs(cfg, 5, 8)
        if smoke:
            state = model.init_decode_state(cfg, 2, 24, device="cpu")
            assert all(float(x.abs().sum()) == 0 for x in model.state_leaves(state))


# ------------------------------------------------------------- the gate ---
def _usage(T, q, skew):
    u = np.zeros((T, q + 1), np.int64)
    if skew:
        u[:, :8], u[:, 8:q], u[:, q] = 1000, 1, 100
    else:
        u[:, :q], u[:, q] = 100, 100
    return u


# The port's answer differs from the reference's at one OLMo-1B site: a
# skewed w2 (T = 512). The reference's VMEM model holds the compact bank of
# every partition resident and streams there; the Hopper prefetching kernel
# matches T >= 96 in even chunks of <= 95 partitions, so its shared memory
# does not grow with T and it takes the site. Every lowering is exact.
GATE_DIFFERENCES = {("w2", True): ("fused_stream", "fused_prefetch")}


def test_gate_decisions_at_olmo_1b_prefill_and_decode():
    cfg = get_config("olmo_1b")
    d, ff, q = cfg.d_model, cfg.d_ff, 128
    sites = {"wq": (d, d), "wk": (d, d), "wv": (d, d), "wo": (d, d),
             "w1": (d, ff), "w3": (d, ff), "w2": (ff, d)}
    ref_pol, pol = RefPolicy(telemetry=False), dispatch.PhiExecutionPolicy(telemetry=False)
    for M in (4 * 2048, 4 * 4):                     # prefill B·S·T, decode slots·T
        for skew in (False, True):
            for name, (K, N) in sites.items():
                T = K // 16
                u = _usage(T, q, skew)
                r = ref_pol.resolve(site=f"lm.{name}", m=M, k_dim=K, n=N, t=T, q=q, usage=u)
                p = pol.resolve(site=f"lm.{name}", m=M, k_dim=K, n=N, t=T, q=q, usage=u)
                want = GATE_DIFFERENCES.get((name, skew), (r.impl, r.impl))
                assert (r.impl, p.impl) == want, (M, name, skew)
                if r.impl == p.impl:
                    assert p.reason == r.reason
                assert p.blocks[0] == r.blocks[0] or p.impl != r.impl
