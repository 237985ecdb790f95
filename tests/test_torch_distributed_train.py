"""The port's training on a mesh against the reference's, on the CPU.

One 8-rank gloo world of CPU processes (``launch.mesh.spawn_ranks``, one
thread a rank, under a deadline; bodies in ``tests/torch_mesh_ranks.py``,
which imports no JAX) runs every mesh check, and one subprocess with
``XLA_FLAGS`` (8 host devices, a ``jax.sharding.Mesh`` with ``Auto`` axes:
on jax 0.9.0 ``make_mesh`` gives ``Explicit`` axes, which the reference's
``with_sharding_constraint`` refuses) runs every reference oracle, beside
it. Inputs are made here with numpy and the port (params drawn from a seed,
the Phi config calibrated) and handed to both.

* Dense step: OLMo-1B smoke ``.with_(tp=2)``, batch 8 × 32 (three label
  columns padded), on (data 4, model 2): step 1's loss and every parameter
  leaf after it against the reference's sharded ``make_train_step`` and the
  port's single-device step; every gradient leaf against the single-device
  one; after 3 steps every leaf's replicas bitwise equal.
* Phi step: ``phi_variant(timesteps=2, q=16)``, batch 8 × 16, the same
  checks; every ``lm.*.spmd`` decision ``coo`` with the reference's reason.
* Arctic step: Arctic-480B smoke ``.with_(tp=2)`` (``moe_impl="dense"``:
  each rank gathers the experts and the rows), batch 8 × 16, its loss,
  gradients and params after one step against the port's single-device
  step.
* ``pod_compressed_grads`` on (pod 2, data 2, model 2): the reference
  test's case and a leaf split over ``model`` whose columns differ in scale
  by 64×: loss, grads and ``new_ef`` within one quantisation step.
* ``pipeline_apply``: S = 4, M = 6, B = 2, D = 16 on (pod 4, data 2).
* Elastic checkpoint: the reference test's leaf saved from (4, 2), the
  files byte-identical to the reference's, restored on (2, 4); a
  ``train_loop(mesh=)`` crashed at 2 of 4 steps and resumed on (2, 4).
* ``moe_ep``'s gradients on (data 2, model 4) against ``moe_dense``'s.
"""
from __future__ import annotations

import filecmp
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as ref_ckpt
from repro_torch.configs import get_config, phi_variant
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.pipeline import bubble_fraction
from repro_torch.kernels import dispatch
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model, moe
from repro_torch.models.config import ModelConfig
from repro_torch.train import optimizer as opt
from repro_torch.train import step as step_lib

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_mesh_ranks as ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD_TIMEOUT = 240.0
OCFG = opt.OptConfig(lr=1e-3, warmup_steps=0, decay_steps=10)   # the reference test's
# Measured gaps, on the CPU in float32 (the mesh sums the data ranks' and the
# row-parallel partials in another order): loss at most 9.5e-7 of ~5.3,
# grads 1.1e-6 of their largest entries, params after one AdamW step 5.4e-5
# (against the reference's sharded step and one device's alike). A step's
# update is ±lr where |g| >> eps, so where a rounding moves a near-zero
# gradient two runs may differ by up to 2·lr = 2e-3; the params are held to
# a quarter of lr. The reference's own test holds 1e-3 (loss), 5e-3 (params).
LOSS_TOL = 1e-5
GRAD_REL = 1e-5
PARAM_TOL = OCFG.lr / 4
MOE_TOL = 2e-4       # the reference's EP-vs-dense test, float32 compute
PIPE_TOL = 1e-5      # the reference's pipeline test
RESUME_RTOL, RESUME_ATOL = 1e-4, 1e-5   # the reference's crash-resume test

ORACLE = textwrap.dedent('''
    import json, sys
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.checkpoint import CheckpointManager
    from repro.configs import get_config, phi_variant
    from repro.distributed import sharding as shd
    from repro.distributed.pipeline import pipeline_apply
    from repro.kernels import dispatch
    from repro.models import model
    from repro.train import optimizer as opt, step as step_lib
    from repro.train.grad_compress import pod_compressed_grads

    d = np.load(sys.argv[1])
    res = {}

    def mesh_of(shape, axes):   # Auto axes (jax.make_mesh's are Explicit on jax 0.9)
        return Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape), axes)

    def put(prefix, tree):
        for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
            res[prefix + '/'.join(str(p.key) for p in path)] = np.asarray(x)

    ocfg = opt.OptConfig(lr=1e-3, warmup_steps=0, decay_steps=10)
    mesh = mesh_of((4, 2), ('data', 'model'))
    base = get_config('olmo_1b', smoke=True).with_(tp=2)
    for name, cfg in (('dense', base), ('phi', phi_variant(base, timesteps=2, q=16))):
        pol = dispatch.PhiExecutionPolicy()
        dispatch.set_policy(pol)
        params = jax.tree_util.tree_map_with_path(
            lambda path, s: jnp.asarray(d[f'{name}_params/' + '/'.join(p.key for p in path)]),
            model.lm_specs(cfg), is_leaf=shd.is_spec)
        batch = {k: jnp.asarray(d[f'{name}_batch_{k}']) for k in ('tokens', 'labels')}
        bundle, p_specs, o_specs, _ = step_lib.make_train_step(cfg, ocfg, mesh)
        opt_state = opt.init(model.split_phi_state(params)[0], ocfg)
        p_sh = shd.specs_to_shardings(p_specs, mesh, shd.TRAIN_RULES)
        o_sh = shd.specs_to_shardings(o_specs, mesh, shd.TRAIN_RULES)
        with mesh:
            sp, so, sloss = jax.jit(bundle.fn, in_shardings=(p_sh, o_sh, None))(
                params, opt_state, batch)
        res[f'{name}_loss'] = np.asarray(sloss)
        put(f'{name}_after/', model.split_phi_state(sp)[0])
        res[f'{name}_decisions'] = np.array(json.dumps(sorted(
            [list(k) + [v] for k, v in pol.decisions().items()])))

    mesh3 = mesh_of((2, 2, 2), ('pod', 'data', 'model'))

    def loss_fn(p, b):
        return jnp.mean((b['x'] @ p['w']) ** 2)

    for case in ('c0', 'c1'):
        p = {'w': jnp.asarray(d[f'{case}_w'])}
        b = {'x': jnp.asarray(d[f'{case}_x'])}
        e = {'w': jnp.asarray(d[f'{case}_ef'])}
        with shd.use_rules(shd.TRAIN_RULES, mesh3), mesh3:
            loss, grads, new_ef = jax.jit(
                lambda p, b, e: pod_compressed_grads(loss_fn, p, b, e, mesh3))(p, b, e)
        res[f'{case}_loss'] = np.asarray(loss)
        res[f'{case}_grads'] = np.asarray(grads['w'])
        res[f'{case}_new_ef'] = np.asarray(new_ef['w'])
        res[f'{case}_want'] = np.asarray(jax.grad(loss_fn)(p, b)['w'])

    meshp = mesh_of((4, 2), ('pod', 'data'))
    pp = {'w': jnp.asarray(d['pipe_w']), 'b': jnp.asarray(d['pipe_b'])}
    res['pipe_out'] = np.asarray(pipeline_apply(
        lambda p, x: jnp.tanh(x @ p['w'] + p['b']), pp, jnp.asarray(d['pipe_x']), meshp,
        axis='pod'))

    tree = {'w': jnp.arange(64, dtype=jnp.float32).reshape(8, 8)}
    mgr = CheckpointManager(sys.argv[3], keep=2, async_save=False)
    sh1 = {'w': NamedSharding(mesh, P('data', 'model'))}
    mgr.save(10, jax.tree.map(lambda x, s: jax.device_put(x, s), tree, sh1),
             {'loader': {'step': 7}})
    np.savez(sys.argv[2], **res)
''')


def _base():
    return get_config("olmo_1b", smoke=True).with_(tp=2)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _np(tree):
    return {k: np.asarray(v.detach()) for k, v in _flat(tree)}


def _moe_cfg(shared: bool = False) -> ModelConfig:
    return ModelConfig(name="t", family="moe", n_layers=1, d_model=32, n_heads=4,
                       n_kv_heads=4, d_ff=64, vocab=64, n_experts=8, top_k=2,
                       capacity_factor=8.0, compute_dtype=torch.float32,
                       shared_expert=shared)


def _inputs():
    """Numpy inputs of both packages, and the port's tensors."""
    rng = np.random.default_rng(0)
    out, torch_side = {}, {}
    for name, cfg, S, seed in (("dense", _base(), 32, 0),
                               ("phi", phi_variant(_base(), timesteps=2, q=16), 16, 1)):
        p = shd.init_params(model.lm_specs(cfg), torch.Generator().manual_seed(seed), "cpu")
        if cfg.phi is not None:
            calib = model.dummy_batch(cfg, 2, 16, with_labels=False, device="cpu")
            with torch.no_grad():
                p, _ = model.calibrate_lm_phi(cfg, p, calib)
        out.update({f"{name}_params/{k}": v for k, v in _np(p).items()})
        tok = rng.integers(0, cfg.vocab, (8, S)).astype(np.int32)
        lab = rng.integers(0, cfg.vocab, (8, S)).astype(np.int32)
        lab[:, -3:] = -1
        out[f"{name}_batch_tokens"], out[f"{name}_batch_labels"] = tok, lab
        torch_side[name] = (cfg, p, {"tokens": torch.from_numpy(tok),
                                     "labels": torch.from_numpy(lab)})
    acfg = get_config("arctic_480b", smoke=True).with_(tp=2)
    arng = np.random.default_rng(2)
    tok, lab = (arng.integers(0, acfg.vocab, (8, 16)).astype(np.int32) for _ in range(2))
    lab[:, -3:] = -1
    torch_side["arctic"] = (acfg, shd.init_params(model.lm_specs(acfg),
                                                  torch.Generator().manual_seed(2), "cpu"),
                            {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)})
    out["c0_w"] = np.full((4, 8), 0.5, np.float32)
    out["c0_x"] = rng.normal(size=(8, 4)).astype(np.float32)
    out["c0_ef"] = np.zeros((4, 8), np.float32)
    out["c1_w"] = (rng.normal(size=(4, 8)) * np.repeat([1.0, 64.0], 4)).astype(np.float32)
    out["c1_x"] = rng.normal(size=(8, 4)).astype(np.float32)
    out["c1_ef"] = (rng.normal(size=(4, 8)) * 0.01).astype(np.float32)
    out["pipe_w"] = (rng.normal(size=(4, 16, 16)) * 0.3).astype(np.float32)
    out["pipe_b"] = (rng.normal(size=(4, 16)) * 0.1).astype(np.float32)
    out["pipe_x"] = rng.normal(size=(6, 2, 16)).astype(np.float32)
    return out, torch_side


def _single(cfg, params, batch, steps):
    """The port's single-device run: step 1's loss and grads, the params
    after step 1, every step's loss."""
    bundle, _, _ = step_lib.make_train_step(cfg, OCFG)
    loss, grads = bundle.grads(params, batch)
    state = opt.init(model.split_phi_state(params)[0], OCFG)
    out = {"loss": float(loss), "grads": _np(grads), "losses": []}
    p = params
    for i in range(steps):
        p, state, loss = bundle.fn(p, state, batch)
        out["losses"].append(float(loss))
        if i == 0:
            out["after"] = _np(model.split_phi_state(p)[0])
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_train")
    inputs, side = _inputs()
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    oracle = subprocess.Popen(
        [sys.executable, "-c", ORACLE, str(tmp / "in.npz"), str(tmp / "ref.npz"),
         str(tmp / "ref_ckpt")], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        prev = dispatch.set_policy(dispatch.PhiExecutionPolicy())
        try:
            single = {name: _single(cfg, p, b, 3 if name == "dense" else 1)
                      for name, (cfg, p, b) in side.items()}
        finally:
            dispatch.set_policy(prev)
        rng = np.random.default_rng(5)
        moe_args = []
        for shared in (False, True):
            mcfg = _moe_cfg(shared)
            moe_args.append((mcfg, shd.init_params(moe.moe_specs(mcfg),
                                                   torch.Generator().manual_seed(7), "cpu"),
                             torch.from_numpy(rng.normal(size=(4, 8, 32)).astype(np.float32)),
                             torch.from_numpy(rng.normal(size=(4, 8, 32)).astype(np.float32))))
        loop_cfg = _base()
        loop_ocfg = opt.OptConfig(lr=1e-3, warmup_steps=1, decay_steps=4)
        args = [(side["dense"][0], OCFG, side["dense"][1], side["dense"][2]),
                (side["phi"][0], OCFG, side["phi"][1], side["phi"][2]),
                inputs, str(tmp), moe_args, (loop_cfg, loop_ocfg),
                (side["arctic"][0], OCFG, side["arctic"][1], side["arctic"][2])]
        out = mesh_lib.spawn_ranks(ranks.train_world, 8, [tuple(args)] * 8, device="cpu",
                                   timeout=WORLD_TIMEOUT)
        _, err = oracle.communicate(timeout=WORLD_TIMEOUT)
    finally:
        if oracle.poll() is None:
            oracle.kill()
            oracle.wait()
    assert oracle.returncode == 0, err[-4000:]
    moe_dense = []
    for mcfg, mp, mx, mg in moe_args:
        mleaves = {k: v.clone().requires_grad_() for k, v in mp.items()}
        xg = mx.clone().requires_grad_()
        gs = torch.autograd.grad((moe.moe_dense(mcfg, mleaves, xg) * mg).sum(),
                                 [xg, *mleaves.values()])
        moe_dense.append({"x": gs[0].numpy(), **{k: g.numpy() for k, g in zip(mleaves, gs[1:])}})
    return dict(ranks=out, single=single, ref=dict(np.load(tmp / "ref.npz")), tmp=tmp,
                moe_dense=moe_dense)


def _rel(got, want) -> float:
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


@pytest.mark.parametrize("name", ["dense", "phi"])
def test_mesh_step_matches_the_references_sharded_step(world, name):
    """Step 1's loss and every trainable leaf after it, on (data 4, model
    2), against the reference's sharded ``make_train_step`` on the same
    numpy params and batch."""
    ref = world["ref"]
    for r, out in enumerate(world["ranks"]):
        got = out[name]
        assert abs(got["loss"] - float(ref[f"{name}_loss"])) < LOSS_TOL, (r, got["loss"])
        leaves = dict(_flat(got["after"]))
        assert sorted(leaves) == sorted(k.removeprefix(f"{name}_after/")
                                        for k in ref if k.startswith(f"{name}_after/"))
        for key, a in leaves.items():
            d = float(np.abs(a - ref[f"{name}_after/{key}"]).max())
            assert d < PARAM_TOL, (r, key, d)


@pytest.mark.parametrize("name", ["dense", "phi", "arctic"])
def test_mesh_step_matches_one_device_leaf_by_leaf(world, name):
    """Step 1's loss, every gradient leaf (gathered to its global value) and
    every leaf after the step against the port's single-device step."""
    single = world["single"][name]
    for r, out in enumerate(world["ranks"]):
        got = out[name]
        assert abs(got["loss"] - single["loss"]) < LOSS_TOL, (r, got["loss"], single["loss"])
        grads = dict(_flat(got["grads"]))
        assert sorted(grads) == sorted(single["grads"])
        # (in Phi mode the rate coding passes no gradient to the GEMM inputs,
        # so the weights before it get exact zeros, on the mesh as on one device)
        assert sum(float(np.abs(g).max()) > 0 for g in single["grads"].values()) >= 4
        for key, g in grads.items():
            assert _rel(g, single["grads"][key]) < GRAD_REL, (r, key)
        for key, a in _flat(got["after"]):
            assert float(np.abs(a - single["after"][key]).max()) < PARAM_TOL, (r, key)
    if name == "dense":
        for r, out in enumerate(world["ranks"]):
            np.testing.assert_allclose(out["dense"]["losses"], single["losses"], rtol=1e-5)


def test_rematerialised_mesh_step_keeps_a_sequence_block_and_matches_one_device(world):
    """``cfg.remat = "full"`` on (data 4, model 2) under TRAIN_RULES: each
    layer group recomputed in the backward from its input, kept as the
    rank's block of the sequence over ``saved_seq`` (model) and gathered in
    the body; step 1's loss and every gathered gradient leaf within the
    dense step's tolerances of one device's (no remat)."""
    single = world["single"]["dense"]
    for r, out in enumerate(world["ranks"]):
        got = out["dense_remat"]
        assert abs(got["loss"] - single["loss"]) < LOSS_TOL, (r, got["loss"])
        grads = dict(_flat(got["grads"]))
        assert sorted(grads) == sorted(single["grads"])
        for key, g in grads.items():
            assert _rel(g, single["grads"][key]) < GRAD_REL, (r, key)
        for key, a in _flat(got["after"]):
            assert float(np.abs(a - single["after"][key]).max()) < PARAM_TOL, (r, key)


def test_replicated_leaves_stay_bitwise_equal_across_ranks(world):
    """After 3 steps, every rank holding the same block of a leaf (its
    replicas over the axes the leaf is not split over) holds the same bits.
    Under ``TRAIN_RULES`` (ZeRO-3) every leaf of OLMo smoke is split over
    both axes, so none replicates; this run takes the rules without
    ``fsdp``, where every leaf is replicated over ``data`` and each replica
    takes its own update. Its steps also match one device's."""
    run = "dense_dp"
    outs = world["ranks"]
    grid = type("G", (), {"axis_names": ("data", "model"), "shape": {"data": 4, "model": 2}})
    checked = 0
    for key, pl in _flat(outs[0][run]["placements"]):
        blocks: dict = {}
        for out in outs:
            a = dict(_flat(out[run]["local"]))[key]
            ents = tuple(pl) + (None,) * (a.ndim - len(pl))
            whole = tuple(n * shd.axis_size(grid, ax) for n, ax in zip(a.shape, ents))
            sl = shd.shard_slices(whole, pl, grid, out["coords"])
            blocks.setdefault(repr(sl), []).append(a)
        for reps in blocks.values():
            for a in reps[1:]:
                assert np.array_equal(a, reps[0]), key
            checked += len(reps) - 1
    assert checked == 3 * 2 * len(list(_flat(outs[0][run]["placements"])))
    single = world["single"]["dense"]
    for out in outs:
        np.testing.assert_allclose(out[run]["losses"], single["losses"], rtol=1e-5)
        for key, a in _flat(out[run]["after"]):
            assert float(np.abs(a - single["after"][key]).max()) < PARAM_TOL, key


def test_phi_mesh_step_resolves_coo_as_the_reference(world):
    """Every ``lm.*.spmd`` decision of the Phi mesh step is ``coo`` with the
    reference's reason, at the reference's sites."""
    want = {(s, i, r) for s, i, r, _ in json.loads(str(world["ref"]["phi_decisions"]))}
    assert want and {i for _, i, _ in want} == {"coo"}
    for out in world["ranks"]:
        got = {key for key in out["phi"]["decisions"] if key[0].endswith(".spmd")}
        assert got == want, got


@pytest.mark.parametrize("case", ["c0", "c1"])
def test_compressed_grads_match_the_reference(world, case):
    """``pod_compressed_grads`` on (pod 2, data 2, model 2): loss, grads and
    ``new_ef`` within one quantisation step of the reference's (c1: the leaf
    split over ``model``, one scale for the whole leaf), grads within the
    reference test's 5% of the exact gradient.

    Each pod keeps its own residual, as error feedback needs; the
    reference's replicated ``new_ef`` is pod 0's (its ``shard_map`` returns
    one pod's value of a replicated output). Pod 0's residual is held within
    one step of it, pod 1's within the larger of the two pods' steps (each
    residual is at most half its own step)."""
    ref = world["ref"]
    scales: dict = {}
    for out in world["ranks"]:
        got = out["compressed"]
        scales.setdefault(got["coords"]["pod"], set()).add(got[case]["scale"])
    assert all(len(s) == 1 for s in scales.values()), scales    # one scale a pod
    step0, top = min(scales[0]), max(min(s) for s in scales.values())
    for r, out in enumerate(world["ranks"]):
        got = out["compressed"][case]
        assert abs(got["loss"] - float(ref[f"{case}_loss"])) <= 1e-5 * abs(
            float(ref[f"{case}_loss"])), (r, got["loss"])
        assert float(np.abs(got["grads"] - ref[f"{case}_grads"]).max()) <= step0, r
        ef_tol = step0 if out["compressed"]["coords"]["pod"] == 0 else top
        assert float(np.abs(got["new_ef"] - ref[f"{case}_new_ef"]).max()) <= ef_tol, r
        want = ref[f"{case}_want"]
        assert float(np.abs(got["grads"] - want).max()) / float(np.abs(want).max()) < 0.05
    if case == "c1":
        # the leaf's columns differ 64x in size: a scale per shard would
        # quantise the small half of the columns far finer than the
        # reference, and miss its grads by more than a step
        want = ref["c1_want"]
        assert np.abs(want[:, 4:]).max() > 8 * np.abs(want[:, :4]).max()


def test_pipeline_matches_the_reference_and_the_sequential_loop(world):
    inp = np.load(world["tmp"] / "in.npz")
    want = inp["pipe_x"]
    for s in range(4):
        want = np.tanh(want @ inp["pipe_w"][s] + inp["pipe_b"][s])
    for out in world["ranks"]:
        np.testing.assert_allclose(out["pipeline"], world["ref"]["pipe_out"], rtol=PIPE_TOL,
                                   atol=PIPE_TOL)
        np.testing.assert_allclose(out["pipeline"], want, rtol=PIPE_TOL, atol=PIPE_TOL)
    assert abs(bubble_fraction(6, 4) - 3 / 9) < 1e-12


def test_elastic_checkpoint_is_the_references_and_reshards(world):
    """Saved from (4, 2) placed (data, model): the files are byte for byte
    the reference's, the reference restores them; restored placed (model,
    data) on (2, 4), each rank holds its block."""
    ours = world["tmp"] / "elastic" / "step_0000000010"
    theirs = world["tmp"] / "ref_ckpt" / "step_0000000010"
    names = sorted(os.listdir(ours))
    assert names == sorted(os.listdir(theirs)) == ["leaf_00000.npy", "manifest.json"]
    for n in names:
        assert filecmp.cmp(ours / n, theirs / n, shallow=False), n
    tree, extra = ref_ckpt.restore_tree(str(ours), {"w": np.zeros((8, 8), np.float32)})
    assert np.array_equal(np.asarray(tree["w"]), np.arange(64, dtype=np.float32).reshape(8, 8))
    assert extra == {"loader": {"step": 7}}
    for out in world["ranks"]:
        got = out["checkpoint"]
        assert got["step"] == 10 and got["extra"] == {"loader": {"step": 7}}
        assert got["w"].shape == (2, 4) and np.array_equal(got["w"], got["want"])


def test_train_loop_resumes_on_another_mesh(world):
    """``train_loop(mesh=)``: 2 steps on (4, 2) checkpointed, resumed on
    (2, 4) for 2 more, against 4 uninterrupted steps on (4, 2)."""
    for out in world["ranks"]:
        got = out["crash_resume"]
        assert len(got["full"]) == len(got["resumed"]) == 4
        assert np.all(np.isfinite(got["full"]))
        np.testing.assert_allclose(got["resumed"], got["full"], rtol=RESUME_RTOL,
                                   atol=RESUME_ATOL)


def test_train_loop_on_a_mesh_starts_from_one_devices_params(world):
    """The mesh loop's first loss is one device's loop's on the same seed."""
    from repro_torch.launch.train import train_loop

    _, losses = train_loop(_base(), opt.OptConfig(lr=1e-3, warmup_steps=1, decay_steps=4),
                           steps=1, global_batch=8, seq=32, log_every=0, device="cpu")
    for out in world["ranks"]:
        assert abs(out["crash_resume"]["full"][0] - losses[0]) < LOSS_TOL


@pytest.mark.parametrize("case", [0, 1], ids=["experts", "shared_expert"])
def test_moe_ep_gradients_match_dense(world, case):
    """``moe_ep`` on (data 2, model 4) under autograd: each rank's input
    gradient is its rows of ``moe_dense``'s, its expert (and shared-expert)
    shards' gradients its blocks of the dense ones, and the router's summed
    over ``data`` the dense one."""
    dense = world["moe_dense"][case]
    grid = type("G", (), {"axis_names": ("data", "model"), "shape": {"data": 2, "model": 4}})
    router, shared = {}, {}
    for out in world["ranks"]:
        got, c = out["moe"][case], out["coords"]
        coords = {"data": (c["data"] * 2 + c["model"]) // 4, "model": (c["data"] * 2
                                                                       + c["model"]) % 4}
        rows = dense["x"].shape[0] // 2
        np.testing.assert_allclose(got["x"], dense["x"][coords["data"] * rows:
                                                        (coords["data"] + 1) * rows],
                                   rtol=MOE_TOL, atol=MOE_TOL)
        for k in ("w1", "w2", "w3"):
            want = dense[k][shd.shard_slices(dense[k].shape, got["placements"][k], grid,
                                             coords)]
            np.testing.assert_allclose(got[k], want, rtol=MOE_TOL, atol=MOE_TOL)
        router.setdefault(coords["model"], []).append(got["router"])
        for k in ("sw1", "sw2", "sw3"):     # replicated over data: summed there
            if k in got:
                sl = shd.shard_slices(dense[k].shape, got["placements"][k], grid, coords)
                shared.setdefault((k, coords["model"]), [sl]).append(got[k])
    for parts in router.values():
        np.testing.assert_allclose(sum(parts), dense["router"], rtol=MOE_TOL, atol=MOE_TOL)
    for (k, _), (sl, *parts) in shared.items():
        np.testing.assert_allclose(sum(parts), dense[k][sl], rtol=MOE_TOL, atol=MOE_TOL)
    assert bool(shared) == bool(case)
