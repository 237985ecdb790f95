"""The decode attention kernel's plain version and its shape-only path, the
attention wrappers' shape-only path, and the dry run's production cells the
decode kernel, the windowed prefill on the attention kernel and the PWP
banks split over ``data`` bring within a card.

The plain version (``kernels.decode_attention.decode_attention_plain``, the
body ``layers.attention_decode`` had) against the reference's
``repro.models.layers.attention_decode`` in its three masks, float32 within
DECODE_ATOL (one einsum order against another); bf16 within one bf16 ulp of
max|V|. The kernel itself is held against the plain version on the card
(``tests/test_torch_cuda.py``).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as ref_layers
from repro_torch.kernels import costs
from repro_torch.kernels.decode_attention import (
    decode_attention_cuda, decode_attention_plain, plan)
from repro_torch.launch import dryrun
from repro_torch.models import layers as ll

DECODE_ATOL = 2e-6
GIB = 2 ** 30


def _inputs(B, S, Hq, Hkv, D, mode, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, 1, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    hi = S if mode == "full" else 2 * S
    pos = rng.integers(0, hi, size=(B,)).astype(np.int32)
    pos[0] = 0 if mode == "full" else S + 3
    return q, k, v, pos


@pytest.mark.parametrize("mode", ["full", "ring", "chunk_ring"])
@pytest.mark.parametrize("B,S,Hq,Hkv,D", [(3, 20, 4, 2, 16), (2, 33, 6, 6, 8)])
def test_decode_plain_matches_the_reference(mode, B, S, Hq, Hkv, D):
    q, k, v, pos = _inputs(B, S, Hq, Hkv, D, mode)
    want = np.asarray(ref_layers.attention_decode(jnp.asarray(q), jnp.asarray(k),
                                                  jnp.asarray(v), jnp.asarray(pos), mode=mode))
    t = [torch.from_numpy(x) for x in (q, k, v, pos)]
    got = decode_attention_plain(*t, mode=mode)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=DECODE_ATOL)
    # the wrapper on CPU tensors runs it; layers.attention_decode routes there
    assert torch.equal(decode_attention_cuda(*t, mode=mode), got)
    assert torch.equal(ll.attention_decode(*t, mode=mode), got)


def test_decode_plain_bf16_within_a_bf16_ulp_of_the_reference():
    q, k, v, pos = _inputs(2, 24, 4, 1, 16, "full", seed=1)
    bf = [jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)]
    want = np.asarray(ref_layers.attention_decode(*bf, jnp.asarray(pos), mode="full")
                      .astype(jnp.float32))
    t = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    got = decode_attention_plain(*t, torch.from_numpy(pos), mode="full")
    assert got.dtype == torch.bfloat16
    tol = 2.0 ** -8 * float(np.abs(np.asarray(bf[2].astype(jnp.float32))).max())
    assert float(np.abs(got.float().numpy() - want).max()) <= tol


def test_decode_on_a_ranks_block_on_the_cpu_is_one_devices_call():
    """On the CPU a rank's rows and heads still go through one device's call
    shape (``block``): the plain version's bits depend on the batch and head
    counts, the kernel's (on the card) do not."""
    q, k, v, pos = (torch.from_numpy(x) for x in _inputs(4, 20, 8, 2, 16, "full", seed=2))
    whole = ll.attention_decode(q, k, v, pos)
    part = ll.attention_decode(q[2:, :, 4:], k[2:, :, 1:], v[2:, :, 1:], pos[2:],
                               block=(4, 2, 8, 4))
    assert torch.equal(part, whole[2:, :, 4:])


def test_decode_kernel_plan_and_cost():
    p = plan(200, 120)
    assert p["chunks"] == 4 and p["chunks"] * p["chunk"] >= 200
    assert p["smem_bytes"] == 4 * (120 + 64 * 121 + 64) and p["ws_floats"] == 4 * 122
    ops, nbytes = costs.decode_attention(2, 8, 2, 64, 2 * 200, 2, 2)
    assert nbytes == 2 * 2 * 8 * 64 * 2 + 2 * 400 * 2 * 64 * 2
    assert ops == 8 * 400 * (4 * 64 + 5) + 2 * 8 * 64


# ------------------------------------------------- the shape-only path ---
def test_decode_and_attention_wrappers_on_fake_cuda_log_their_cost_and_launch_nothing():
    from repro_torch.kernels.phi_attention import flash_attention_cuda

    before = (decode_attention_cuda.launches, flash_attention_cuda.launches)
    with costs.recording() as log, dryrun.tracing("cuda"):
        q = torch.zeros(3, 1, 8, 64, dtype=torch.bfloat16, device="cuda")
        kv = torch.zeros(3, 100, 2, 64, dtype=torch.bfloat16, device="cuda")
        pos = torch.zeros(3, dtype=torch.int32, device="cuda")
        out = ll.attention_decode(q, kv, kv, pos, mode="ring", block=(6, 0, 16, 0))
        qp = torch.zeros(1, 9000, 4, 32, device="cuda")
        from repro_torch.configs import get_config

        cfg = get_config("h2o_danube3_4b", smoke=True)
        pre = ll.attention_prefill(cfg, 0, qp, qp, qp, layer_global=False,
                                   block=(2, 0, 8, 0))
    assert out.shape == q.shape and out.dtype == q.dtype and pre.shape == qp.shape
    assert [x.name for x in log] == ["decode_attention_cuda", "flash_attention_cuda"]
    assert log[0].bytes == costs.decode_attention(3, 8, 2, 64, 300, 2, 2)[1]
    # the window's scores only: O(S·W)
    assert log[1].ops == costs.dense_attention(1, 9000, 4, 32, True, cfg.window)[0]
    assert (decode_attention_cuda.launches, flash_attention_cuda.launches) == before


# ------------------------------------------------- production dry-run cells ---
def test_olmo_decode_32k_fits_on_the_decode_kernel():
    rec = dryrun.run_cell("olmo_1b", "decode_32k", False, phi=True)
    assert rec["memory"]["temp_bytes"] < 8 * GIB
    n = rec["launches"]["kernels"]["decode_attention_cuda"]
    assert n == 16                 # a launch a layer, at the rank's own rows and heads


def test_h2o_danube3_prefill_32k_windowed_attention_fits():
    rec = dryrun.run_cell("h2o_danube3_4b", "prefill_32k", False)
    assert rec["memory"]["temp_bytes"] < 16 * GIB
    assert rec["launches"]["kernels"]["flash_attention_cuda"] == 24


def test_yi_34b_phi_decode_32k_banks_split_over_data():
    rec = dryrun.run_cell("yi_34b", "decode_32k", False, phi=True)
    assert rec["memory"]["argument_bytes"] < 30 * GIB
    assert rec["collectives"]["all-gather"] > 0
