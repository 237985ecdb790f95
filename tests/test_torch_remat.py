"""``cfg.remat``: the reference's ``_maybe_remat`` in the port's training.

Under autograd each layer-group body of a prefill (attention stack group,
Mamba-2 layer, hybrid site) runs under ``torch.utils.checkpoint``: "full"
keeps only its input, "dots" also the matmuls without a batch dimension.
The recomputed forward repeats the same calls, so one step's loss and
gradients are bitwise those of ``remat="none"``; against the reference's
``jax.checkpoint``-ed step they are held to ``torch_parity_util``'s
tolerances. Off autograd nothing is checkpointed. A dry-run trace of a train
step (fake CPU tensors) shows the temporaries fall.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.distributed.sharding import init_params as ref_init_params
from repro.models import model as ref_model
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import init_params
from repro_torch.kernels import dispatch
from repro_torch.launch import dryrun
from repro_torch.models import model
from repro_torch.train import optimizer as opt
from repro_torch.train import step as step_lib
from torch_parity_util import assert_grads_close, assert_loss_close, np_tree


@pytest.fixture
def fresh_policy():
    prev = dispatch.set_policy(dispatch.PhiExecutionPolicy())
    try:
        yield dispatch.get_policy()
    finally:
        dispatch.set_policy(prev)


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{pre}/{k}")
    else:
        yield pre, tree


def _step(cfg, params, batch):
    bundle, _, _ = step_lib.make_train_step(cfg, opt.OptConfig())
    return bundle.grads(params, batch)


@pytest.mark.parametrize("arch", ["olmo_1b", "zamba2_1p2b", "mamba2_2p7b"])
def test_remat_full_and_dots_give_bitwise_the_steps_of_none(arch, fresh_policy):
    cfg = get_config(arch, smoke=True)
    assert cfg.remat == "none"
    params = init_params(model.lm_specs(cfg), torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 16), generator=g),
             "labels": torch.randint(0, cfg.vocab, (2, 16), generator=g)}
    loss0, grads0 = _step(cfg, params, batch)
    for remat in ("full", "dots"):
        loss, grads = _step(cfg.with_(remat=remat), params, batch)
        assert torch.equal(loss, loss0), remat
        pairs = list(zip(_flat(grads), _flat(grads0)))
        assert pairs and all(ka == kb and torch.equal(a, b) for (ka, a), (kb, b) in pairs), remat


def test_remat_full_matches_the_references_checkpointed_step(fresh_policy):
    """OLMo smoke's dense step at ``remat="full"`` against
    ``jax.value_and_grad`` of the reference's loss, whose scan bodies run
    under ``jax.checkpoint`` (its non-spiking path: the policy-dispatched Phi
    path dies on this jax)."""
    rcfg = dataclasses.replace(ref_get_config("olmo_1b", smoke=True), remat="full")
    cfg = get_config("olmo_1b", smoke=True).with_(remat="full")
    rp = ref_init_params(ref_model.lm_specs(rcfg), jax.random.PRNGKey(1))
    batch = ref_model.dummy_batch(rcfg, 2, 16, with_labels=True, key=jax.random.PRNGKey(2))
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: ref_model.train_loss(rcfg, p, batch)))(rp)
    params = interop.params_from_numpy(np_tree(rp), "cpu")
    loss, grads = _step(cfg, params, {k: torch.from_numpy(np.array(v))
                                      for k, v in batch.items()})
    assert_loss_close(loss, want_loss)
    assert_grads_close(grads, np_tree(want))


def test_remat_checkpoints_nothing_off_autograd(monkeypatch, fresh_policy):
    from torch.utils import checkpoint

    cfg = get_config("olmo_1b", smoke=True)
    params = init_params(model.lm_specs(cfg), torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 12),
                                     generator=torch.Generator().manual_seed(3))}
    with torch.no_grad():
        want, _ = model.prefill(cfg, params, batch)

    def refuse(*a, **k):
        raise AssertionError("checkpointed off autograd")

    monkeypatch.setattr(checkpoint, "checkpoint", refuse)
    with torch.no_grad():
        got, _ = model.prefill(cfg.with_(remat="full"), params, batch)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="remat"):
        _step(cfg.with_(remat="some"), params, dict(batch, labels=batch["tokens"]))


def test_traced_train_step_temporaries_fall_with_remat(fresh_policy):
    """A dry-run trace of OLMo smoke's train step (4 layers, B 4 x S 256) on
    fake CPU tensors: "full" keeps each group's input only, "dots" its
    weight GEMMs' outputs too; both below "none"."""
    cfg = get_config("olmo_1b", smoke=True).with_(n_layers=4)
    temp = {r: dryrun.trace_step(cfg.with_(remat=r), "train", 4, 256, None,
                                 device="cpu")["memory"]["temp_bytes"]
            for r in ("none", "full", "dots")}
    assert temp["full"] < temp["dots"] < temp["none"], temp
    assert temp["full"] < 0.5 * temp["none"], temp


def test_the_recompute_runs_under_the_forwards_context_on_another_thread():
    """On the card autograd runs a backward, and so a checkpointed body's
    recompute, on its own device thread, where the thread-local rules, mesh,
    batch rows and SPMD region are unset: the body re-enters the forward's.
    Here the backward runs on a new thread."""
    import threading
    import types

    from repro_torch.distributed import sharding as shd
    from repro_torch.models import transformer

    seen = []

    def body(x, w):
        seen.append((shd.current_mesh(), shd.batch_rows(), dispatch.in_spmd_body()))
        return x * w, None

    mesh = types.SimpleNamespace(axis_names=("data", "model"), shape={"data": 2, "model": 2})
    run = transformer._maybe_remat(get_config("olmo_1b", smoke=True).with_(remat="full"), body)
    x = torch.ones(2, 4, requires_grad=True)
    w = torch.full((2, 4), 3.0, requires_grad=True)
    with shd.use_rules(dict(shd.TRAIN_RULES, saved_seq=None), mesh), \
            shd.use_batch_rows(8, 2), dispatch.spmd_body(4):
        y, _ = run(x, w)
    grads = {}
    t = threading.Thread(target=lambda: grads.update(g=torch.autograd.grad(y.sum(), [x, w])))
    t.start()
    t.join()
    assert seen == [(mesh, (8, 2), True)] * 2
    assert torch.equal(grads["g"][0], w.detach()) and torch.equal(grads["g"][1], x.detach())
