"""LM training and checkpoints of the port against the reference, on the CPU.

The Phi-mode train step on OLMo-1B smoke is held to the reference's
``_forward`` (loss within LOSS_REL, each gradient leaf within GRAD_REL of its
largest magnitude plus GRAD_ATOL: ``torch_parity_util``; the dense step of
every arch is ``tests/test_torch_lm_train_archs.py``'s)
with a matmul that rate-codes as the reference's ``make_matmul`` and calls
its ``ops.phi_matmul(impl="coo")``, the lowering its policy resolves under
autodiff (its policy-dispatched path dies on jax 0.9.0). Twelve steps of
the port's step over its loader from the reference's initial params against
the reference's ``train_loop``: losses within TRAIN_RTOL. Crash and resume
mirrors ``tests/test_fault_tolerance.py``, with its rtol 1e-4 / atol 1e-5;
the checkpoint it resumes from restores bitwise.
"""
from __future__ import annotations

import json
import logging
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config, phi_variant as ref_phi_variant
from repro.distributed.sharding import init_params as ref_init_params
from repro.kernels import dispatch as ref_dispatch
from repro.kernels import ops as ref_ops
from repro.launch.train import train_loop as ref_train_loop
from repro.models import model as ref_model
from repro.snn.lif import LIFConfig as RefLIFConfig
from repro.snn.lif import lif_update as ref_lif_update
from repro.train import optimizer as ref_opt
from repro.train import step as ref_step
from repro_torch import interop
from repro_torch.checkpoint import CheckpointManager, restore_tree
from repro_torch.configs import get_config, phi_variant
from repro_torch.data.pipeline import DataConfig, ShardedLoader
from repro_torch.kernels import dispatch, ops
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch
from repro_torch.launch.train import train_loop
from repro_torch.models import model
from repro_torch.train import optimizer as opt
from repro_torch.train import step as step_lib
from torch_parity_util import assert_grads_close, assert_loss_close, np_tree

TRAIN_RTOL = 1e-5   # twelve steps' losses (both runs agree to ~1e-7 here)
RESUME_RTOL, RESUME_ATOL = 1e-4, 1e-5   # tests/test_fault_tolerance.py's


@pytest.fixture
def fresh_policy():
    prev = dispatch.set_policy(dispatch.PhiExecutionPolicy())
    try:
        yield dispatch.get_policy()
    finally:
        dispatch.set_policy(prev)


def _port_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


# ------------------------------------------------------- one step, dense ---
def test_train_step_is_functional_and_updates_as_apply_updates(fresh_policy):
    cfg = get_config("olmo_1b", smoke=True)
    ocfg = opt.OptConfig(lr=1e-2, warmup_steps=0)
    bundle, p_specs, o_specs = step_lib.make_train_step(cfg, ocfg)
    params = interop.params_from_numpy(np_tree(ref_init_params(
        ref_model.lm_specs(ref_get_config("olmo_1b", smoke=True)), jax.random.PRNGKey(0))),
        "cpu")
    before = {id(x): x.clone() for x in model.state_leaves(params)}
    state = opt.init(params, ocfg)
    batch = model.dummy_batch(cfg, 2, 12, True, torch.Generator().manual_seed(3), "cpu")
    new, new_state, loss = bundle.fn(params, state, batch)
    for x in model.state_leaves(params):
        assert torch.equal(x, before[id(x)])                   # inputs not written
    loss2, grads = bundle.grads(params, batch)
    want, want_state = opt.apply_updates(params, grads, state, ocfg)
    assert float(loss) == float(loss2)
    for a, b in zip(model.state_leaves(new), model.state_leaves(want)):
        assert torch.equal(a, b)
    assert int(new_state["step"]) == 1 and new_state["step"].dtype == torch.int32


def _spec_table(tree, is_leaf, prefix=()):
    if is_leaf(tree):
        return [(prefix, tuple(tree.shape), tree.dtype, tree.init)]
    return [row for k in sorted(tree) for row in _spec_table(tree[k], is_leaf, prefix + (k,))]


@pytest.mark.parametrize("factored", [False, True])
def test_opt_state_specs_match_the_reference_and_skip_the_phi_state(factored):
    from repro.distributed.sharding import is_spec as ref_is_spec
    from repro_torch.distributed.sharding import is_spec

    rcfg = ref_phi_variant(ref_get_config("olmo_1b", smoke=True), timesteps=2, q=16)
    cfg = phi_variant(get_config("olmo_1b", smoke=True), timesteps=2, q=16)
    ours = step_lib.opt_state_specs(model.split_phi_state(model.lm_specs(cfg))[0],
                                    opt.OptConfig(factored=factored, grad_compress=True))
    theirs = ref_step.opt_state_specs(ref_model.split_phi_state(ref_model.lm_specs(rcfg))[0],
                                      ref_opt.OptConfig(factored=factored, grad_compress=True))
    assert [(p, s, str(d).removeprefix("torch."), i) for p, s, d, i in
            _spec_table(ours, is_spec)] == [
        (p, s, jnp.dtype(d).name, i) for p, s, d, i in _spec_table(theirs, ref_is_spec)]
    assert not any("phi_" in "/".join(p) for p, *_ in _spec_table(ours, is_spec))


# -------------------------------------------------------- one step, Phi ---
def _ref_phi_loss(rcfg, batch):
    """The reference's Phi-mode loss with its autodiff lowering injected:
    ``make_matmul``'s rate coding, then ``ops.phi_matmul(impl="coo")`` with
    the call its policy makes under autodiff."""
    lif = RefLIFConfig(decay=0.5, threshold=1.0)
    phi = rcfg.phi

    def mm(x, p, name):
        xf = x.astype(jnp.float32)

        def step(v, _):
            s, v2 = ref_lif_update(v, xf, lif)
            return v2, s

        _, spikes = jax.lax.scan(step, jnp.zeros_like(xf), None, length=phi.timesteps)
        phi_p = p["phi_" + name]
        out = ref_ops.phi_matmul(spikes, p[name].astype(jnp.float32), phi_p["patterns"],
                                 phi_p["pwp"].astype(jnp.float32), impl="coo",
                                 nnz_budget=phi.nnz_budget, gather_dtype=rcfg.compute_dtype)
        return (out.mean(0) * 2.0).astype(x.dtype)

    def loss(trainable, frozen):
        p = ref_model.merge_phi_state(trainable, frozen)
        x, _ = ref_model._forward(rcfg, p, batch, matmul=mm)
        logits = ref_model._logits(rcfg, p, x)
        labels = batch["labels"]
        logp = jax.nn.log_softmax(logits, axis=-1)
        take = jnp.take_along_axis(logp, jnp.maximum(labels, 0)[..., None], -1)[..., 0]
        mask = (labels >= 0).astype(jnp.float32)
        return -(take * mask).sum() / jnp.maximum(mask.sum(), 1.0)

    return loss


def test_phi_train_step_matches_the_reference_coo_lowering(fresh_policy):
    rcfg = ref_phi_variant(ref_get_config("olmo_1b", smoke=True), timesteps=2, q=16)
    rp = ref_init_params(ref_model.lm_specs(rcfg), jax.random.PRNGKey(0))
    rp = jax.tree.map(lambda x: jnp.round(x * 1024) / 1024, rp)
    batch = ref_model.dummy_batch(rcfg, 2, 8, with_labels=True, key=jax.random.PRNGKey(2))
    rp, _ = ref_model.calibrate_lm_phi(rcfg, rp, {"tokens": batch["tokens"]})
    tr, fr = ref_model.split_phi_state(rp)
    want_loss, want = jax.jit(jax.value_and_grad(_ref_phi_loss(rcfg, batch)))(tr, fr)

    cfg = phi_variant(get_config("olmo_1b", smoke=True), timesteps=2, q=16)
    params = interop.params_from_numpy(np_tree(rp), "cpu")
    ocfg = opt.OptConfig()
    bundle, _, _ = step_lib.make_train_step(cfg, ocfg)
    loss, grads = bundle.grads(params, _port_batch(batch))
    assert_loss_close(loss, want_loss)
    assert_grads_close(grads, np_tree(want))
    # every spiking GEMM on the differentiable lowering
    decs = fresh_policy.decisions()
    assert decs and set(decs) == {(f"lm.{w}", "coo", "autodiff_or_vmap")
                                  for w in ("wq", "wk", "wv", "wo", "w1", "w2", "w3")}
    assert all(n == cfg.n_layers for n in decs.values())
    # the frozen Phi state: no grad, no optimizer state, not copied by the step
    state = opt.init(model.split_phi_state(params)[0], ocfg)
    new, new_state, _ = bundle.fn(params, state, _port_batch(batch))
    frozen = model.split_phi_state(params)[1]
    new_frozen = model.split_phi_state(new)[1]
    for a, b in zip(model.state_leaves(frozen), model.state_leaves(new_frozen)):
        assert a is b and not a.requires_grad
    assert "phi_wq" not in new_state["m"]["decoder"]["stack"]["p0"]


# --------------------------------------------- many steps and the loop ---
def test_twelve_steps_match_the_reference_train_loop(fresh_policy):
    rcfg, cfg = ref_get_config("olmo_1b", smoke=True), get_config("olmo_1b", smoke=True)
    kw = dict(lr=1e-3, warmup_steps=2, decay_steps=30)
    _, want = ref_train_loop(rcfg, ref_opt.OptConfig(**kw), steps=12, global_batch=4, seq=32,
                             log_every=0)
    ocfg = opt.OptConfig(**kw)
    params = interop.params_from_numpy(
        np_tree(ref_init_params(ref_model.lm_specs(rcfg), jax.random.PRNGKey(0))), "cpu")
    bundle, _, _ = step_lib.make_train_step(cfg, ocfg)
    state = opt.init(params, ocfg)
    it = iter(ShardedLoader(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=0)))
    got = []
    for _ in range(12):
        params, state, loss = bundle.fn(params, state, _port_batch(next(it)))
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=TRAIN_RTOL, atol=0)
    assert got[-1] < got[0]


def test_crash_resume_is_exact_and_restores_bitwise(fresh_policy):
    cfg = get_config("olmo_1b", smoke=True)
    ocfg = opt.OptConfig(lr=1e-3, warmup_steps=2, decay_steps=30)
    kw = dict(global_batch=4, seq=32, log_every=0, device="cpu")
    with tempfile.TemporaryDirectory() as d:
        _, full = train_loop(cfg, ocfg, steps=12, ckpt_dir=None, **kw)
        p6, l1 = train_loop(cfg, ocfg, steps=6, ckpt_dir=d, ckpt_every=3, **kw)
        mgr = CheckpointManager(d)
        assert mgr.all_steps() == [3, 6]
        assert mgr.latest_extra() == {"loader": {"step": 6}}
        step, tree, _ = mgr.restore_latest({"params": p6})
        for a, b in zip(model.state_leaves(tree["params"]), model.state_leaves(p6)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        _, l2 = train_loop(cfg, ocfg, steps=12, ckpt_dir=d, ckpt_every=100, **kw)
        assert len(l1) == 6 and len(l2) == 6
        np.testing.assert_allclose(l1 + l2, full, rtol=RESUME_RTOL, atol=RESUME_ATOL)


def test_resume_skips_completed_work(fresh_policy):
    cfg = get_config("olmo_1b", smoke=True)
    ocfg = opt.OptConfig(lr=1e-3, warmup_steps=0, decay_steps=10)
    kw = dict(global_batch=2, seq=16, ckpt_every=100, log_every=0, device="cpu")
    with tempfile.TemporaryDirectory() as d:
        train_loop(cfg, ocfg, steps=5, ckpt_dir=d, **kw)
        _, losses = train_loop(cfg, ocfg, steps=5, ckpt_dir=d, **kw)
        assert losses == []


def test_the_port_resumes_a_reference_checkpoint(fresh_policy):
    """The reference trains 3 steps and checkpoints; the port's loop takes its
    params, optimizer state and cursor and runs steps 4-6 as the
    reference's own resume does."""
    rcfg, cfg = ref_get_config("olmo_1b", smoke=True), get_config("olmo_1b", smoke=True)
    kw = dict(lr=1e-3, warmup_steps=2, decay_steps=30)
    with tempfile.TemporaryDirectory() as d:
        ref_train_loop(rcfg, ref_opt.OptConfig(**kw), steps=3, global_batch=2, seq=16,
                       ckpt_dir=os.path.join(d, "ref"), ckpt_every=100, log_every=0)
        _, want = ref_train_loop(rcfg, ref_opt.OptConfig(**kw), steps=6, global_batch=2,
                                 seq=16, ckpt_dir=os.path.join(d, "ref"), ckpt_every=100,
                                 log_every=0)
        ref_train_loop(rcfg, ref_opt.OptConfig(**kw), steps=3, global_batch=2, seq=16,
                       ckpt_dir=os.path.join(d, "port"), ckpt_every=100, log_every=0)
        _, got = train_loop(cfg, opt.OptConfig(**kw), steps=6, global_batch=2, seq=16,
                            ckpt_dir=os.path.join(d, "port"), ckpt_every=100, log_every=0,
                            device="cpu")
    np.testing.assert_allclose(got, want, rtol=TRAIN_RTOL, atol=0)


def test_train_loop_refuses_a_mesh():
    """``train_loop`` trains on a mesh (``tests/test_torch_distributed_train.py``)
    but refuses one whose batch axes do not split the global batch: each data
    rank must run rows of its own. The mesh is built by hand (no world): the
    refusal comes before any collective."""
    from repro_torch.distributed.collectives import Mesh

    mesh = Mesh(("data", "model"), (2, 1), rank=0, device="cpu", backend="gloo")
    with pytest.raises(ValueError, match="does not split"):
        train_loop(get_config("olmo_1b", smoke=True), opt.OptConfig(), steps=1,
                   global_batch=1, seq=8, mesh=mesh, device="cpu")


# ------------------------------------------------------- the launchers ---
def test_phi_train_then_serve_from_the_checkpoint(tmp_path, fresh_policy, caplog):
    ckpt = str(tmp_path / "ckpt")
    prom, trace = str(tmp_path / "m.prom"), str(tmp_path / "t.jsonl")
    train_launch.main(["--device", "cpu", "--smoke", "--phi", "--ckpt-dir", ckpt,
                       "--steps", "3", "--batch", "2", "--seq", "16", "--ckpt-every", "2",
                       "--metrics-out", prom, "--trace-out", trace])
    mgr = CheckpointManager(ckpt)
    assert mgr.all_steps() == [2, 3] and mgr.latest_extra() == {"loader": {"step": 3}}
    with open(trace) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs if r["kind"] == "train_step"] == [1, 2, 3]
    # calibration captures with dense math: every Phi GEMM record is a step's
    assert {(r["impl"], r["reason"]) for r in recs if r["kind"] == "dispatch"
            and r["site"].startswith("lm.w")} == {("coo", "autodiff_or_vmap")}
    with open(prom) as f:
        body = f.read()
    assert "\ntrain_steps 3" in body and "autodiff_or_vmap" in body
    cfg = phi_variant(get_config("olmo_1b", smoke=True), timesteps=2, q=16)
    tree, _ = restore_tree(os.path.join(ckpt, "step_0000000003"),
                           {"params": _spec_like(model.lm_specs(cfg))})
    usage = tree["params"]["decoder"]["stack"]["p0"]["phi_wq"]["usage"]
    assert usage.dtype == torch.int32 and int(usage.sum()) > 0
    caplog.set_level(logging.INFO, logger="repro_torch")
    serve_launch.main(["--device", "cpu", "--arch", "olmo_1b", "--phi", "--ckpt-dir", ckpt,
                       "--requests", "2", "--slots", "2", "--max-new", "3"])
    assert "restored params from step 3 (7 phi usage histograms)" in caplog.text
    assert "served 2/2 requests" in caplog.text


def _spec_like(specs):
    if isinstance(specs, dict):
        return {k: _spec_like(v) for k, v in specs.items()}
    return model.TensorSpec(specs.shape, specs.dtype)


def test_serve_restore_params_zero_fills_usage_and_applies_the_extra(tmp_path, fresh_policy):
    cfg = phi_variant(get_config("olmo_1b", smoke=True), timesteps=2, q=16)
    params = model.lm_specs(cfg)
    from repro_torch.distributed.sharding import init_params
    params = init_params(params, torch.Generator().manual_seed(0), "cpu")
    train, frozen = model.split_phi_state(params)

    def drop_usage(node):
        if not isinstance(node, dict):
            return node
        return {k: drop_usage(v) for k, v in node.items() if k != "usage"}

    CheckpointManager(str(tmp_path), async_save=False).save(
        7, {"params": model.merge_phi_state(train, drop_usage(frozen))}, {"phi_impl": "coo"})
    got_cfg, got, step = serve_launch.restore_params(cfg, params, str(tmp_path))
    assert step == 7 and got_cfg.phi.impl == "coo"
    assert int(got["decoder"]["stack"]["p0"]["phi_wq"]["usage"].abs().sum()) == 0
    assert serve_launch.restore_params(cfg, params, str(tmp_path / "none"))[2] is None


def test_make_prefill_and_make_decode_step_match_the_model(fresh_policy):
    cfg = get_config("olmo_1b", smoke=True)
    prefill_fn, specs = step_lib.make_prefill(cfg)
    decode_fn, _ = step_lib.make_decode_step(cfg)
    from repro_torch.distributed.sharding import init_params
    params = init_params(specs, torch.Generator().manual_seed(1), "cpu")
    batch = model.dummy_batch(cfg, 2, 9, False, torch.Generator().manual_seed(2), "cpu")
    lg, caches = prefill_fn(params, batch)
    with torch.no_grad():
        want, _ = model.prefill(cfg, params, batch)
    assert torch.equal(lg, want) and not lg.requires_grad
    caches = model.extend_caches(cfg, caches, 12)
    tok = torch.tensor([5, 6], dtype=torch.int32)
    pos = torch.tensor([9, 9], dtype=torch.int32)
    out, _ = decode_fn(params, tok, pos, caches)
    assert out.shape == (2, cfg.vocab) and torch.isfinite(out).all()


# ----------------------------------------------------------- the step-0 fault ---
def test_dense_training_step_at_s2048_records_autodiff_keeps_flash(fresh_policy):
    """S = 2048 > 1024 takes the flash branch. Under autograd the site
    records ``autodiff_keeps_flash``, as the reference's ``train_loss`` under
    ``autodiff_region()`` does; the reference's scan traces its layer body
    once (one record), the port's loop visits each layer (one each)."""
    rcfg, cfg = ref_get_config("olmo_1b", smoke=True), get_config("olmo_1b", smoke=True)
    rp = ref_init_params(ref_model.lm_specs(rcfg), jax.random.PRNGKey(0))
    batch = ref_model.dummy_batch(rcfg, 1, 2048, with_labels=True, key=jax.random.PRNGKey(1))
    pol = ref_dispatch.PhiExecutionPolicy(telemetry=False)
    prev = ref_dispatch._default_policy
    ref_dispatch._default_policy = pol
    try:
        with ref_dispatch.autodiff_region():
            want_loss, _ = jax.value_and_grad(
                lambda p: ref_model.train_loss(rcfg, p, batch))(rp)
    finally:
        ref_dispatch._default_policy = prev
    bundle, _, _ = step_lib.make_train_step(cfg, opt.OptConfig())
    params = interop.params_from_numpy(np_tree(rp), "cpu")
    loss, grads = bundle.grads(params, _port_batch(batch))
    want = pol.decisions()
    assert set(want) == {("lm.attn_prefill", "flash", "autodiff_keeps_flash")}
    assert fresh_policy.decisions() == {key: cfg.n_layers for key in want}
    dec, ref_dec = fresh_policy.last_decision("lm.attn_prefill"), pol.last_decision(
        "lm.attn_prefill")
    assert tuple(dec.shape) == tuple(ref_dec.shape)
    assert dec.blocks == ops.autotune_attn_blocks(2048, cfg.hd, 0, 0, 0)
    assert abs(float(loss) - float(want_loss)) <= 1e-4 * abs(float(want_loss))
    assert all(torch.isfinite(g).all() for g in model.state_leaves(grads))
    # the same prefill without autograd keeps its dense-Q/K row
    with torch.no_grad():
        model.train_logits(cfg, params, _port_batch(batch))
    assert fresh_policy.last_decision("lm.attn_prefill").reason == "dense_qk_keeps_flash"


def test_coo_lowering_weight_gradient_keeps_only_the_entries():
    """Under autograd the ``coo`` lowering's L2 half keeps its COO entries,
    not its gathered slabs: d w = residualᵀ · d out (the L1 half reads the
    frozen PWP bank and gives w no gradient). Binary activations and a budget
    that keeps every entry; float32 sums in another order (rel 1e-6)."""
    from repro_torch.core.assign import assign_patterns
    from repro_torch.core.patterns import PhiConfig, calibrate, pattern_weight_products

    g = torch.Generator().manual_seed(0)
    a = (torch.rand((300, 64), generator=g) < 0.3).float()
    w = torch.randn((64, 40), generator=g)
    pats = calibrate(a, PhiConfig(k=16, q=8, iters=3), device="cpu")
    pwp = pattern_weight_products(pats, w)
    cot = torch.randn((300, 40), generator=g)
    wr = w.clone().requires_grad_()
    out = ops.phi_matmul(a, wr, pats, pwp, impl="coo", nnz_budget=1.0)
    (dw,) = torch.autograd.grad((out * cot).sum(), wr)
    _, residual = assign_patterns(a, pats)
    want = residual.to(torch.float32).T @ cot
    assert float(residual.abs().sum()) > 0
    torch.testing.assert_close(dw, want, rtol=0, atol=1e-6 * float(want.abs().max()))
    with torch.no_grad():
        assert torch.equal(out, ops.phi_matmul(a, w, pats, pwp, impl="coo", nnz_budget=1.0))
