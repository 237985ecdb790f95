"""Mamba-2 and the Zamba2 hybrid on a mesh of ranks, against one device and
the reference, on the CPU.

One 4-rank gloo world of CPU processes (``launch.mesh.spawn_ranks``, one
thread a rank, under a deadline; bodies in ``tests/torch_mesh_ranks.py``,
which imports no JAX) runs every mesh check on the smoke configs of Zamba2
(4 attention heads, 8 SSM heads, 5 layers: 2 sites of 2 Mamba-2 layers and
the shared block, then 1 tail layer) and Mamba-2 (8 SSM heads, 2 layers),
each ``.with_(tp=<model axis>)``:

* Serving on (data 2, model 2) and (data 1, model 4), from the reference's
  dyadic params calibrated there on a params tree in spec order (on its own
  sorted tree the reference swaps Zamba2's shared and tail ``wo`` spikes):
  in Phi mode (T = 2, q = 16) and in the spiking-dense arm, a 2 × 8 prefill
  and 2 greedy decode steps bitwise the port's one-device run, and the
  engine's tokens equal; the prefill 1e-4 of the reference's ``_forward``
  with its spiking-dense ``matmul`` (as ``test_torch_lm.py`` holds one
  device); the plain dense mode (no spiking) within DENSE_ATOL: its
  row-parallel partial sums of unrounded products sum in another order.
* One dense train step on (data 2, model 2): loss and params after it
  against the reference's sharded ``make_train_step`` on an ``Auto``-axes
  ``jax.sharding.Mesh`` (a subprocess with 4 host devices, beside the
  world) and the port's one-device step, at ``test_torch_distributed_train``'s
  LOSS_TOL and PARAM_TOL; every gathered gradient leaf against the port's
  one-device step's, in float32 and float64, within GRAD_REL of its largest
  entry (float32's ``wB`` and ``wC`` within BC_GRAD_REL), and in float32
  against the reference's own sharded gradients within REF_GRAD_REL.
* ``train_loop(mesh=)`` on Zamba2 crashed at step 2 on (data 2, model 2)
  and resumed on (data 1, model 4).

Pure functions beside it: the hybrid's decode-state placements leaf by
leaf, ``param_shardings`` of the Mamba-2 sites' Phi state,
``_layout``'s two Zamba2 ``wo``s, ``shard_usage_for``'s length guard; and
the serve launcher on 4 host ranks, for both families.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config, phi_variant as ref_phi_variant
from repro.distributed import sharding as ref_shd
from repro.models import model as ref_model
from repro_torch import interop
from repro_torch.configs import get_config, phi_variant
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import dispatch
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve as serve_launch
from repro_torch.models import model
from repro_torch.train import optimizer as opt
from repro_torch.train import step as step_lib

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_mesh_ranks as ranks  # noqa: E402
from test_torch_distributed_train import LOSS_TOL, GRAD_REL, PARAM_TOL, OCFG  # noqa: E402
from torch_parity_util import np_tree, ref_spiking_dense_mm  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD_TIMEOUT = 240.0
ARCHS = ["zamba2_1p2b", "mamba2_2p7b"]
MESHES = [(2, 2), (1, 4)]
ARMS = ["phi", "spiking_dense", "dense"]
REF_ATOL = 1e-4      # the mesh's Phi prefill against the reference's forward
DENSE_ATOL = 1e-4    # plain dense mode: row-parallel sums in another order
RESUME_RTOL, RESUME_ATOL = 1e-4, 1e-5   # the reference's crash-resume test
SERVE_KW = dict(slots=4, max_new=4, max_context=32)
# Zamba2 smoke's float32 step-1 gradients are ill-conditioned. Measured on
# the CPU, as a share of each leaf's largest entry: the port's one-device
# float32 gradients lie up to 4.7e-5 (wB) from a float64 run of the same
# params, the reference's up to 5.9e-5, so the two lie up to 1.06e-4 apart
# (wB; the mesh and the reference 9.6e-5). The mesh and one device lie
# 1.04e-5 (wB) and 1.11e-5 (wC) apart, every other leaf within 8.9e-6; in
# float64 (float32 only where both cast, as in the SSD's dt) 7.1e-6 and
# 4.7e-6. Mamba-2 smoke's gaps are all within 2.1e-6.
BC_GRAD_REL = 4 * GRAD_REL     # the mesh against one device: float32 wB, wC
REF_GRAD_REL = 2e-4            # the mesh against the reference's sharded step

ORACLE = textwrap.dedent('''
    import sys
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.configs import get_config
    from repro.distributed import sharding as shd
    from repro.kernels import dispatch
    from repro.models import model
    from repro.train import optimizer as opt, step as step_lib

    d = np.load(sys.argv[1])
    res = {}
    ocfg = opt.OptConfig(lr=1e-3, warmup_steps=0, decay_steps=10)
    # Auto axes: jax.make_mesh's Explicit axes refuse with_sharding_constraint on jax 0.9
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ('data', 'model'))

    def step_grads(cfg):
        """The gradient make_train_step's step takes, under the same mesh."""
        def fn(params, batch):
            with shd.use_rules(shd.TRAIN_RULES, mesh), dispatch.spmd_region(), \
                    dispatch.autodiff_region():
                trainable, phi_state = model.split_phi_state(params)
                return jax.grad(lambda t: model.train_loss(
                    cfg, model.merge_phi_state(t, phi_state), batch))(trainable)
        return fn

    for arch in sys.argv[3:]:
        cfg = get_config(arch, smoke=True).with_(tp=2)
        params = jax.tree_util.tree_map_with_path(
            lambda path, s: jnp.asarray(d[f'{arch}/' + '/'.join(p.key for p in path)]),
            model.lm_specs(cfg), is_leaf=shd.is_spec)
        batch = {k: jnp.asarray(d[f'{arch}_batch_{k}']) for k in ('tokens', 'labels')}
        bundle, p_specs, o_specs, _ = step_lib.make_train_step(cfg, ocfg, mesh)
        state = opt.init(params, ocfg)
        p_sh = shd.specs_to_shardings(p_specs, mesh, shd.TRAIN_RULES)
        o_sh = shd.specs_to_shardings(o_specs, mesh, shd.TRAIN_RULES)
        with mesh:
            new, _, loss = jax.jit(bundle.fn, in_shardings=(p_sh, o_sh, None))(
                params, state, batch)
            grads = jax.jit(step_grads(cfg), in_shardings=(p_sh, None))(params, batch)
        res[f'{arch}_loss'] = np.asarray(loss)
        for name, tree in (('after', new), ('grads', grads)):
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
                res[f'{arch}_{name}/' + '/'.join(str(p.key) for p in path)] = np.asarray(x)
    np.savez(sys.argv[2], **res)
''')


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _spec_order(tree, specs):
    """``tree`` with every dict's keys in its spec's order."""
    if not isinstance(tree, dict):
        return tree
    return {k: _spec_order(tree[k], specs[k]) for k in specs}


def _cfgs(arch: str, m: int) -> dict:
    """The arms' configs at ``tp = m``; the Phi budget set by the caller."""
    base = get_config(arch, smoke=True).with_(tp=m)
    return {"phi": phi_variant(base, timesteps=2, q=16),
            "spiking_dense": phi_variant(base, timesteps=2, q=16), "dense": base}


def _serving_setup(arch: str) -> dict:
    """The reference's dyadic params calibrated there on a tree in spec
    order, carried across; the nnz budget from its calibration (no coo
    drop); its spiking-dense forward's prefill logits; batch and prompts."""
    rcfg = ref_phi_variant(ref_get_config(arch, smoke=True).with_(tp=2), timesteps=2, q=16)
    rp = ref_shd.init_params(ref_model.lm_specs(rcfg), jax.random.PRNGKey(1))
    rp = jax.tree.map(lambda x: jnp.round(x * 1024) / 1024, rp)
    rp = _spec_order(rp, ref_model.lm_specs(rcfg))
    rng = np.random.default_rng(2)
    tokens = rng.integers(3, rcfg.vocab, (2, 8)).astype(np.int32)
    rp, stats = ref_model.calibrate_lm_phi(rcfg, rp, {"tokens": jnp.asarray(tokens)})
    x, _ = ref_model._forward(rcfg, rp, {"tokens": jnp.asarray(tokens)},
                              matmul=ref_spiking_dense_mm(rcfg))
    budget = min(0.9, 2 * max(s.l2_density for s in stats.values()) + 0.05)
    params = interop.params_from_numpy(np_tree(rp), "cpu")
    prompts = [rng.integers(3, rcfg.vocab, int(n)) for n in rng.integers(3, 10, 6)]
    return {"params": params, "budget": budget, "batch": {"tokens": torch.from_numpy(tokens)},
            "prompts": prompts,
            "ref_prefill": np.asarray(ref_model._logits(rcfg, rp, x[:, -1:]))[:, 0]}


def _arm(cfg, arm: str, budget: float):
    if arm == "dense":
        return cfg
    return cfg.with_(phi=dataclasses.replace(cfg.phi, nnz_budget=budget))


def _arm_params(params, arm: str):
    return model.split_phi_state(params)[0] if arm == "dense" else params


def _train_inputs(arch: str, dtype) -> tuple:
    cfg = get_config(arch, smoke=True).with_(tp=2)
    if dtype == torch.float64:
        cfg = cfg.with_(param_dtype=dtype, compute_dtype=dtype)
    p = shd.init_params(model.lm_specs(cfg), torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)
    lab[:, -3:] = -1
    return cfg, p, {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)}


def _single_step(cfg, params, batch) -> dict:
    bundle, _, _ = step_lib.make_train_step(cfg, OCFG)
    loss, grads = bundle.grads(params, batch)
    new, _, _ = bundle.fn(params, opt.init(params, OCFG), batch)
    return {"loss": float(loss), "grads": dict(_flat(grads)), "after": dict(_flat(new))}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_ssm")
    train = {}
    oracle_in = {}
    for arch in ARCHS:
        for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
            train[(arch, name)] = _train_inputs(arch, dtype)
        cfg, p, b = train[(arch, "f32")]
        oracle_in.update({f"{arch}/{k}": v.numpy() for k, v in _flat(p)})
        oracle_in.update({f"{arch}_batch_{k}": v.numpy() for k, v in b.items()})
    np.savez(tmp / "in.npz", **oracle_in)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    oracle = subprocess.Popen([sys.executable, "-c", ORACLE, str(tmp / "in.npz"),
                               str(tmp / "ref.npz"), *ARCHS], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        setups = {arch: _serving_setup(arch) for arch in ARCHS}
        single, serve_runs = {}, {shape: [] for shape in MESHES}
        for arch, su in setups.items():
            for arm in ARMS:
                for shape in MESHES:
                    cfg = _arm(_cfgs(arch, shape[1])[arm], arm, su["budget"])
                    params = _arm_params(su["params"], arm)
                    serve_runs[shape].append(((arch, arm), cfg, params, arm, su["batch"],
                                              su["prompts"]))
                prev = dispatch.set_policy(dispatch.PhiExecutionPolicy())
                try:
                    dispatch.register_usage_from_params(params)
                    mm = model.spiking_dense_matmul(cfg) if arm == "spiking_dense" else None
                    logits, shapes = ranks.decode_run(cfg, params, su["batch"], 2, matmul=mm)
                    tokens = ranks.serve(cfg, params, su["prompts"], matmul=mm, **SERVE_KW)
                finally:
                    dispatch.set_policy(prev)
                single[(arch, arm)] = {"logits": logits, "cache_shapes": shapes,
                                       "tokens": tokens}
        single_train = {key: _single_step(*args) for key, args in train.items()}
        loop_cfg = get_config("zamba2_1p2b", smoke=True).with_(tp=2)
        loop_ocfg = opt.OptConfig(lr=1e-3, warmup_steps=1, decay_steps=4)
        train_runs = [(key, cfg, OCFG, p, b) for key, (cfg, p, b) in train.items()]
        args = (serve_runs, train_runs, (loop_cfg, loop_ocfg), str(tmp))
        out = mesh_lib.spawn_ranks(ranks.ssm_world, 4, [args] * 4, device="cpu",
                                   timeout=WORLD_TIMEOUT)
        _, err = oracle.communicate(timeout=WORLD_TIMEOUT)
    finally:
        if oracle.poll() is None:
            oracle.kill()
            oracle.wait()
    assert oracle.returncode == 0, err[-4000:]
    from repro_torch.launch.train import train_loop

    _, loop_one = train_loop(loop_cfg, loop_ocfg, steps=1, global_batch=4, seq=32,
                             log_every=0, device="cpu")
    return dict(ranks=out, single=single, setups=setups, single_train=single_train,
                ref=dict(np.load(tmp / "ref.npz")), loop_one=loop_one)


def _grid(shape):
    """A (data, model) mesh's axis names and sizes, as placements read them."""
    return types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": shape[0], "model": shape[1]})


def _rank_grid(shape):
    """The same, with the device a rank's state is allocated on."""
    return types.SimpleNamespace(**vars(_grid(shape)), device=torch.device("cpu"))


def _run(world, r, shape, arch, arm):
    return world["ranks"][r]["serve"][shape][(arch, arm)]


# ---------------------------------------------------------------- serving ---
@pytest.mark.parametrize("arm", ARMS[:2])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_prefill_and_decode_equal_one_device_bitwise(world, arch, shape, arm):
    want = world["single"][(arch, arm)]["logits"]
    for r in range(4):
        got = _run(world, r, shape, arch, arm)["logits"]
        assert len(got) == len(want) == 3
        for step, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape == (2, 128)
            assert np.array_equal(g, w), (r, step, float(np.abs(g - w).max()))


@pytest.mark.parametrize("arm", ARMS)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_engine_tokens_equal_one_devices(world, arch, shape, arm):
    want = world["single"][(arch, arm)]["tokens"]
    assert len(want) == 6 and all(len(v) == SERVE_KW["max_new"] for v in want.values())
    for r in range(4):
        assert _run(world, r, shape, arch, arm)["tokens"] == want, r


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_dense_mode_is_within_tolerance_of_one_device(world, arch, shape):
    want = world["single"][(arch, "dense")]["logits"]
    for r in range(4):
        for g, w in zip(_run(world, r, shape, arch, "dense")["logits"], want):
            np.testing.assert_allclose(g, w, rtol=0, atol=DENSE_ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_prefill_matches_the_references_forward(world, arch):
    want = world["setups"][arch]["ref_prefill"]
    for shape in MESHES:
        got = _run(world, 0, shape, arch, "phi")["logits"][0]
        np.testing.assert_allclose(got, want, rtol=0, atol=REF_ATOL)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_states_are_the_ranks_rows_and_heads(world, arch, shape):
    """Every decode-state leaf a rank keeps has the local shape of its
    placement (``train.step.decode_state_shardings``): rows over ``data``,
    SSM heads, ``conv_x`` channels and KV heads over ``model``; ``conv_B``
    and ``conv_C`` whole."""
    cfg = _cfgs(arch, shape[1])["phi"]
    specs = model.state_leaves(model.decode_state_specs(cfg, 2, 11))
    state, _ = step_lib.init_decode_state(cfg, 2, 11, _rank_grid(shape))
    want = [tuple(leaf.shape) for leaf in model.state_leaves(state)]
    assert world["single"][(arch, "phi")]["cache_shapes"] == [s.shape for s in specs]
    assert any(w != s.shape for w, s in zip(want, specs))
    for r in range(4):
        assert _run(world, r, shape, arch, "phi")["cache_shapes"] == want


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_phi_gemms_run_in_the_per_rank_body(world, arch, shape):
    """Every Phi GEMM resolves at its ``lm.{name}.spmd`` site, a fused
    kernel on the rank's local shape, with the world's 4 ranks: the Mamba-2
    GEMMs, and Zamba2's shared block's."""
    names = {"wz", "wx", "wB", "wC", "wdt", "wo"}
    if arch == "zamba2_1p2b":
        names |= {"wq", "wk", "wv", "w1", "w2", "w3"}
    for r in range(4):
        run = _run(world, r, shape, arch, "phi")
        assert {s for (s, _, _) in run["decisions"]} == {f"lm.{n}.spmd" for n in names}
        assert {i for (_, i, _) in run["decisions"]} <= {"fused", "fused_stream",
                                                          "fused_prefetch"}
        assert all(reason.startswith("spmd_local_") for (_, _, reason) in run["decisions"])
        assert set(run["shards"].values()) == {4}


# --------------------------------------------------------------- training ---
def _grad_rel(key: str, dtype: str) -> float:
    return BC_GRAD_REL if dtype == "f32" and key.split("/")[-1] in ("wB", "wC") else GRAD_REL


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_gradients_match_the_references_sharded_step(world, arch):
    """Every gathered float32 gradient leaf of the mesh's step 1 against
    ``jax.grad`` of the reference's loss under its sharded step's mesh and
    rules, within REF_GRAD_REL of the leaf's largest entry."""
    ref = world["ref"]
    prefix = f"{arch}_grads/"
    want = {k[len(prefix):]: v for k, v in ref.items() if k.startswith(prefix)}
    assert sum(float(np.abs(w).max()) > 0 for w in want.values()) >= 8
    for r, out in enumerate(world["ranks"]):
        grads = dict(_flat(out["train"][(arch, "f32")]["grads"]))
        assert sorted(grads) == sorted(want)
        for key, g in grads.items():
            d = float(np.abs(g - want[key]).max())
            assert d <= REF_GRAD_REL * float(np.abs(want[key]).max()), (r, key, d)


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_train_step_matches_the_references_sharded_step(world, arch):
    ref = world["ref"]
    for r, out in enumerate(world["ranks"]):
        got = out["train"][(arch, "f32")]
        assert abs(got["loss"] - float(ref[f"{arch}_loss"])) < LOSS_TOL, (r, got["loss"])
        leaves = dict(_flat(got["after"]))
        prefix = f"{arch}_after/"
        assert sorted(leaves) == sorted(k[len(prefix):] for k in ref if k.startswith(prefix))
        for key, a in leaves.items():
            d = float(np.abs(a - ref[prefix + key]).max())
            assert d < PARAM_TOL, (r, key, d)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_train_step_matches_one_device_leaf_by_leaf(world, arch, dtype):
    """Loss and params after the step against one device's (f32 and f64);
    every gathered gradient leaf within GRAD_REL of one device's largest
    entry, float32's ``wB`` and ``wC`` within BC_GRAD_REL (the gaps
    measured are beside the constants)."""
    single = world["single_train"][(arch, dtype)]
    for r, out in enumerate(world["ranks"]):
        got = out["train"][(arch, dtype)]
        assert abs(got["loss"] - single["loss"]) < LOSS_TOL, (r, got["loss"], single["loss"])
        for key, a in _flat(got["after"]):
            assert float(np.abs(a - single["after"][key].numpy()).max()) < PARAM_TOL, (r, key)
        grads = dict(_flat(got["grads"]))
        assert sorted(grads) == sorted(single["grads"])
        for key, g in grads.items():
            w = single["grads"][key].numpy()
            assert float(np.abs(g - w).max()) <= _grad_rel(key, dtype) * float(np.abs(w).max()), \
                (r, key)
    assert sum(float(g.abs().max()) > 0 for g in single["grads"].values()) >= 8


def test_train_loop_resumes_the_hybrid_on_another_mesh(world):
    """Zamba2 through ``train_loop(mesh=)``: 2 steps on (data 2, model 2)
    checkpointed, resumed on (data 1, model 4) to 4, against 4
    uninterrupted steps; the first loss one device's loop's."""
    for out in world["ranks"]:
        got = out["crash_resume"]
        assert len(got["full"]) == len(got["resumed"]) == 4
        assert np.all(np.isfinite(got["full"]))
        np.testing.assert_allclose(got["resumed"], got["full"], rtol=RESUME_RTOL,
                                   atol=RESUME_ATOL)
        assert abs(got["full"][0] - world["loop_one"][0]) < LOSS_TOL




def test_hybrid_decode_state_placements_leaf_by_leaf():
    """Zamba2 smoke at 4 slots on (data 2, model 2): the main layers' SSM
    states (n_sites, g, B, H, P, N) and conv rings at their batch axis 2,
    the shared block's KV caches and the tail's at axis 1; heads, ``conv_x``
    channels and KV heads over ``model``."""
    cfg = get_config("zamba2_1p2b", smoke=True).with_(tp=2)
    specs = model.decode_state_specs(cfg, 4, 16)
    got = step_lib.decode_state_shardings(cfg, specs, _grid((2, 2)), shd.SERVE_RULES, 4)

    def ssm_leaves(lead):
        return (lead + ("data", "model", None, None),
                {k: lead + ("data", None, "model" if k == "x" else None) for k in "BCx"})

    kv = (None, "data", None, "model", None)
    main, tail = ssm_leaves((None, None)), ssm_leaves((None,))
    assert got == {"kv": (kv, kv), "mamba": main, "tail": tail}
    state, placements = step_lib.init_decode_state(cfg, 4, 16, _rank_grid((2, 2)))
    assert placements == [kv, kv, main[0], *main[1].values(), tail[0], *tail[1].values()]
    for leaf, s, p in zip(model.state_leaves(state), model.state_leaves(specs), placements):
        assert tuple(leaf.shape) == shd.local_shape(s.shape, p, _grid((2, 2)))


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_param_shardings_place_the_mamba_phi_state(shape):
    """Zamba2 smoke in Phi mode: each Mamba-2 GEMM and its Phi state as its
    per-rank body reads them. wz, wx, wdt column-parallel (weight and bank
    columns over ``model``, patterns whole); wo row-parallel (weight rows,
    patterns and bank K-partitions over ``model``); wB, wC whole; usage
    whole; each bank's K-partitions also over ``data`` within K's block
    where data divides them (``pwp_tiles``, gathered at each call); the
    per-head leaves and ``conv_x`` over ``model``, ``conv_B`` and
    ``conv_C`` whole; ``lora_b`` over the heads, ``lora_a`` whole."""
    cfg = phi_variant(get_config("zamba2_1p2b", smoke=True).with_(tp=shape[1]), 2, 16)
    placed = model.param_shardings(cfg, _grid(shape), shd.SERVE_RULES)
    specs = model.lm_specs(cfg)["decoder"]
    dec = placed["decoder"]
    m = "model"

    def tiles(k_ax, bank):
        T = bank.shape[-3] // (1 if k_ax is None else shape[1])
        if T % shape[0]:
            return k_ax
        return "data" if k_ax is None else (k_ax, "data")

    def trim(p):
        p = list(p)
        while p and p[-1] is None:
            p.pop()
        return tuple(p)

    for stack in ("mamba", "mamba_tail"):
        st, sp = dec[stack], specs[stack]
        for name in ("wz", "wx", "wdt"):
            assert st[name] == (None, None, m)
            assert st["phi_" + name] == {
                "patterns": (), "pwp": (None, tiles(None, sp["phi_" + name]["pwp"]), None, m),
                "usage": ()}
        assert st["wo"] == (None, m)
        assert st["phi_wo"] == {"patterns": (None, m),
                                "pwp": trim((None, tiles(m, sp["phi_wo"]["pwp"]))),
                                "usage": ()}
        for name in ("wB", "wC"):
            assert st[name] == () and st["phi_" + name] == {
                "patterns": (), "pwp": trim((None, tiles(None, sp["phi_" + name]["pwp"]))),
                "usage": ()}
        for name in ("A_log", "D", "dt_bias", "norm_w"):
            assert st[name] == (None, m)
        assert st["conv_x"] == (None, None, m)
        assert st["conv_B"] == st["conv_C"] == ()
    assert dec["lora_a"] == () and dec["lora_b"] == (None, None, m)
    assert dec["shared"]["attn"]["wo"] == (m,)
    assert dec["shared"]["attn"]["phi_wo"]["pwp"] == (
        tiles(m, specs["shared"]["attn"]["phi_wo"]["pwp"]),)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_layout_tells_zamba2s_two_wo_apart(shape):
    """Zamba2-1.2B at full width: the Mamba-2 ``wo`` (4096 -> 2048) and the
    shared block's (2048 -> 2048) are both row-parallel, at local K
    4096 / m and 2048 / m."""
    cfg = get_config("zamba2_1p2b").with_(tp=shape[1])
    m = shape[1]
    table = model._layout(cfg, _grid(shape), shd.SERVE_RULES)
    wos = {loc: axes for loc, axes in table.items() if loc[0] == "wo"}
    assert wos == {("wo", 4096 // m, 2048): ("model", None),
                   ("wo", 2048 // m, 2048): ("model", None)}


def test_shard_usage_for_refuses_a_histogram_of_another_length():
    """Three banks share ``lm.wo`` in Zamba2: a rank's slice of the
    registered histogram is taken only where its length is the rank's
    K-partitions times the shards."""
    pol = dispatch.PhiExecutionPolicy()
    usage = np.random.default_rng(0).integers(0, 50, (8, 17))
    pol.register_usage("lm.wo", usage)
    want = dispatch.shard_usage_histogram(usage, 2)
    assert np.array_equal(pol.shard_usage_for("lm.wo", 2, 4), want)
    assert pol.shard_usage_for("lm.wo", 2, 2) is None       # a bank of 4 partitions
    assert pol.shard_usage_for("lm.wo", 4, 4) is None
    assert pol.shard_usage_for("lm.wq", 2, 4) is None       # nothing registered


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_on_a_mesh_of_host_ranks_serves_the_recurrent_families(arch):
    flags = ["--arch", arch, "--smoke", "--phi", "--device", "cpu", "--requests",
             "4", "--max-new", "4", "--max-context", "32"]
    prev = dispatch.set_policy(dispatch.PhiExecutionPolicy())
    try:
        one = serve_launch.main(flags)
        mesh = serve_launch.main(flags + ["--host-devices", "4", "--mesh-model", "2",
                                          "--timeout", str(WORLD_TIMEOUT)])
    finally:
        dispatch.set_policy(prev)
    assert len(one) == 4 and mesh == one
