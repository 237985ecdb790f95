"""One dense LM train step of the port at every arch's smoke config against
``jax.value_and_grad(model.train_loss)`` on the reference's params carried
across by ``interop.params_from_numpy``: the loss within LOSS_REL, each
gradient leaf within GRAD_REL of its largest magnitude plus GRAD_ATOL
(``torch_parity_util``). Apart from ``tests/test_torch_lm_train.py`` so that
``--dist loadfile`` spreads the reference's compile time.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_config as ref_get_config
from repro.distributed.sharding import init_params as ref_init_params
from repro.models import model as ref_model
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.kernels import dispatch
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


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_loss_and_grads_match_jax(arch, fresh_policy):
    rcfg, cfg = ref_get_config(arch, smoke=True), get_config(arch, smoke=True)
    rp = ref_init_params(ref_model.lm_specs(rcfg), jax.random.PRNGKey(1))
    offs = rcfg.frontend_positions if rcfg.frontend == "patches" else 0
    batch = ref_model.dummy_batch(rcfg, 2, 16 + offs, with_labels=True,
                                  key=jax.random.PRNGKey(2))
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: ref_model.train_loss(rcfg, p, batch)))(rp)
    bundle, _, _ = step_lib.make_train_step(cfg, opt.OptConfig())
    params = interop.params_from_numpy(np_tree(rp), "cpu")
    pb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    loss, grads = bundle.grads(params, pb)
    assert_loss_close(loss, want_loss)
    assert_grads_close(grads, np_tree(want))
    assert not any(x.requires_grad for x in model.state_leaves(params))
