"""Hopper kernels of repro_torch against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA card: a CUDA
kernel has no CPU mode. The file imports neither JAX nor the reference
package, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance 0 throughout: with dyadic weights every partial sum is exact, and
the kernels round each product and sum separately as the plain versions do.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core.patterns import PhiConfig, calibrate, pattern_weight_products, quantize_pwp
from repro_torch.kernels import ref
from repro_torch.kernels.lif import lif_sequence_cuda, lif_sequence_plain, lif_step_cuda
from repro_torch.kernels.phi_fused import phi_fused_cuda, phi_fused_plain
from repro_torch.snn import models as M
from repro_torch.snn.data import synthetic_images

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (a CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _setup(M_, K, N, q, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    protos = (torch.rand((8, K), generator=g) < 0.3).float()
    a = protos[torch.randint(0, 8, (M_,), generator=g)]
    a = (a - (torch.rand((M_, K), generator=g) < 0.03).float()).abs()
    a = a.to(dev)
    w = (torch.round(torch.randn((K, N), generator=g) * 0.3 * 1024) / 1024).to(dev)
    pats = calibrate(a, PhiConfig(k=16, q=q, iters=3), device=dev)
    return a, w, pats, pattern_weight_products(pats, w)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("M_", [256, 293])
def test_fused_kernel_matches_plain(dev, kind, M_):
    a, w, pats, pwp = _setup(M_, 96, 72, 16, dev, seed=M_)
    scale = torch.ones(pwp.shape[:2], device=dev)
    if kind == "bf16":
        pwp = pwp.to(torch.bfloat16)
    elif kind == "int8":
        pwp, scale = quantize_pwp(pwp)
    before = phi_fused_cuda.launches
    out, nnz = phi_fused_cuda(a, pats, pwp, scale, w, block_m=64)
    assert phi_fused_cuda.launches == before + 1
    pout, pnnz = phi_fused_plain(a, pats, pwp, scale, w, block_m=64)
    torch.cuda.synchronize()
    assert torch.equal(out, pout) and torch.equal(nnz, pnnz) and int(nnz.sum()) > 0


def test_fused_kernel_refuses_k_above_64(dev):
    with pytest.raises(ValueError, match="k <= 64"):
        phi_fused_cuda(torch.zeros((8, 128), device=dev), torch.zeros((1, 4, 128), device=dev),
                       torch.zeros((1, 5, 8), device=dev), torch.ones((1, 5), device=dev),
                       torch.zeros((128, 8), device=dev), block_m=8)


@pytest.mark.parametrize("reset", ["hard", "soft"])
def test_lif_kernels_match_plain(dev, reset):
    g = torch.Generator().manual_seed(0)
    x = (torch.randn((4, 3000), generator=g) * 1.5).to(dev)
    v = torch.randn((3000,), generator=g).to(dev)
    s, vn = lif_step_cuda(v, x[0], reset=reset)
    rs, rv = ref.lif_ref(v, x[0], 0.5, 1.0, reset)
    assert torch.equal(s, rs) and torch.equal(vn, rv)
    got = lif_sequence_cuda(x, reset=reset)
    torch.cuda.synchronize()
    assert torch.equal(got, lif_sequence_plain(x, reset=reset))


def test_vgg16_widths_phi_apply_equals_apply(dev):
    """One batch of the slice's configuration through the Hopper kernels."""
    cfg = M.SNNConfig(kind="vgg", widths=(64, 128, 256, 512, 512), input_size=32,
                      phi=PhiConfig(k=16, q=128, iters=20))
    params = M.init(cfg, torch.Generator().manual_seed(0), device=dev)
    for name, leaf in params.items():
        gain = 1.0 if name == "conv0" else 3.0      # keeps spikes alive at depth
        leaf["w"] = torch.round(leaf["w"] * gain * 1024) / 1024
    x, _ = synthetic_images(16, size=32, seed=1)
    x = torch.from_numpy(np.round(x * 1024) / 1024).to(dev)
    with torch.no_grad():
        state, acts = M.calibrate_model(params, cfg, x)
        launches = phi_fused_cuda.launches, lif_sequence_cuda.launches
        got = M.phi_apply(params, cfg, state, x)
        assert phi_fused_cuda.launches - launches[0] == 5
        assert lif_sequence_cuda.launches > launches[1]
        assert torch.equal(got, M.apply(params, cfg, x))
    for act in acts.values():
        assert float(act.mean()) >= 0.01
