"""Shared helpers of the repro_torch parity tests (not collected by pytest).

Inputs are made with numpy from a seed and handed to both packages, so the
JAX reference and the PyTorch port see identical values. "Dyadic" values lie
on the 2^-10 grid: with binary activations every partial sum of a Phi
matmul is then exact in float32, and summation order cannot change a bit.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.patterns import _kmeans_binary_jit
from repro_torch.core.patterns import kmeans_unique_rows


# One train step's loss, and each gradient leaf of its largest magnitude
# (float32 forwards that differ by a few roundings in norms, RoPE and
# softmax, and a backward summed in another order), plus GRAD_ATOL: a leaf
# whose exact gradient is zero holds rounding noise (Llama-4's top-1 router:
# a weight normalised over one expert is 1 whatever the logits; both sides
# give ~1e-9).
LOSS_REL = 1e-6
GRAD_REL = 1e-5
GRAD_ATOL = 1e-7


def dyadic(x: np.ndarray) -> np.ndarray:
    """Round onto the 2^-10 grid (float32)."""
    return (np.round(np.asarray(x, np.float64) * 1024) / 1024).astype(np.float32)


def binary(rng: np.random.Generator, shape, p: float = 0.3) -> np.ndarray:
    return (rng.random(shape) < p).astype(np.float32)


def clustered(rng: np.random.Generator, m: int, K: int, protos: int = 12,
              flip: float = 0.03, p: float = 0.3) -> np.ndarray:
    """Binary rows drawn around a few prototypes, so patterns match often."""
    base = binary(rng, (protos, K), p)
    rows = base[rng.integers(0, protos, m)]
    return np.abs(rows - binary(rng, (m, K), flip)).astype(np.float32)


def t(x, dtype=None) -> torch.Tensor:
    """numpy/jax array -> CPU tensor (a copy)."""
    return torch.from_numpy(np.array(x, copy=True)).to(dtype=dtype)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def reference_init_idx(acts: np.ndarray, k: int, q: int, seed: int = 0) -> list:
    """The reference k-means' initial row indices for every K-partition.

    ``_kmeans_binary_jit(..., iters=0, key)`` returns exactly the initial
    centres; the unique rows are unique, so each centre names one row.
    """
    a = np.asarray(acts).reshape(-1, acts.shape[-1])
    T = a.shape[1] // k
    out = []
    for ti in range(T):
        uniq, counts = kmeans_unique_rows(a[:, ti * k:(ti + 1) * k])
        if uniq.shape[0] <= q:
            out.append(None)
            continue
        c0 = np.asarray(_kmeans_binary_jit(
            jnp.asarray(uniq, jnp.float32), jnp.asarray(counts, jnp.float32), q, 0,
            jax.random.PRNGKey(seed + ti)), np.uint8)
        match = (c0[:, None, :] == uniq[None, :, :]).all(-1)
        assert (match.sum(1) == 1).all()
        out.append(match.argmax(1))
    return out


def assert_grads_close(got: dict, want: dict, path: str = ""):
    """Each gradient leaf (a tensor tree) within GRAD_REL of the largest
    magnitude of its reference leaf (a numpy tree), plus GRAD_ATOL."""
    assert sorted(got) == sorted(want), path
    for k in want:
        if isinstance(want[k], dict):
            assert_grads_close(got[k], want[k], f"{path}/{k}")
            continue
        w = np.asarray(want[k], np.float32)
        g = got[k].detach().to(torch.float32).numpy()
        assert g.shape == w.shape, f"{path}/{k}"
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_REL * scale + GRAD_ATOL,
                                   err_msg=f"{path}/{k}")


def assert_loss_close(got, want):
    """A loss within LOSS_REL of the reference's."""
    assert abs(float(got) - float(want)) <= LOSS_REL * abs(float(want)), (float(got),
                                                                          float(want))


def ref_spiking_dense_mm(cfg):
    """The reference's spiking-dense ``matmul`` (``tests/test_archs.py``'s
    oracle): each operand rate-coded by its LIF over ``phi.timesteps`` steps,
    a float32 matmul of the spikes with the weight, the mean rescaled."""
    from repro.snn.lif import LIFConfig, lif_update

    lif = LIFConfig()

    def dense_mm(x, p, name):
        xf = x.astype(jnp.float32)

        def step(v, _):
            s, v2 = lif_update(v, xf, lif)
            return v2, s

        _, spikes = jax.lax.scan(step, jnp.zeros_like(xf), None, length=cfg.phi.timesteps)
        out = jnp.einsum("t...k,kn->t...n", spikes, p[name].astype(jnp.float32))
        return (out.mean(0) * 2.0).astype(x.dtype)

    return dense_mm
