"""The port's mesh half against the reference's, on the CPU.

Pure functions (rule tables, ``resolve_spec``, ``shape_aware_spec``,
``specs_to_shardings``, ``state_sharding_for_leaf``,
``shard_usage_histogram``, the production mesh's shapes) are held against
the reference's in-process: those read only a mesh's axis names and sizes,
so a ``jax.sharding.AbstractMesh`` stands in for a 512-device world, and
placements compare as tuples.

Meshes of ranks run as gloo worlds of CPU processes (``launch.mesh.
spawn_ranks``, one thread a rank, every world under a timeout), their bodies
in ``tests/torch_mesh_ranks.py``. One 8-rank world (2 data × 4 model) serves
OLMo-1B smoke in Phi spiking mode (T = 2, q = 16) on the reference's
calibrated dyadic params: prefill and two decode steps bitwise the port's
single-device run and the forced-``coo`` mesh run, the prefill 1e-4 of the
reference's single-device ``_forward`` (as ``test_torch_lm.py`` holds it),
the policy's ``spmd_local_*`` decisions with ``shards == 8``, and the mesh
engine's tokens equal to one device's. The same world runs ``moe_ep`` on a
2 × 4 mesh (the hidden dim gathered over ``data``) and a 1 × 8 one (no
gather), each against the reference's ``moe_ep`` on an 8-device mesh (a
subprocess with ``XLA_FLAGS``, as ``tests/test_distributed.py`` runs it) and
the port's ``moe_dense``, at the reference test's rtol/atol 2e-4 in float32;
``moe_impl="dense"`` of the Arctic and Llama-4 smoke layers on the 2 × 4
mesh bitwise one device's; and the collectives on a 2 × 2 × 2 mesh against
their definitions. The world's OLMo rank also serves the requests through
two paged engines (``torch_mesh_ranks.PAGED_RUNS``: the default pool and one
that preempts), bitwise one device's paged engines and the mesh's
contiguous engine. Its ranks also run the dry run's (data 2, model 2) cells
for real on two hand-built meshes (``torch_mesh_ranks.dryrun_checks_run``),
each equal to ``launch.dryrun.trace_step`` on fake CPU tensors.
"""
from __future__ import annotations

import ast
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
from jax.sharding import AbstractMesh

from repro.configs import get_config as ref_get_config, phi_variant as ref_phi_variant
from repro.distributed import sharding as ref_shd
from repro.kernels import dispatch as ref_dispatch
from repro.models import model as ref_model
from repro.train import step as ref_step
from repro_torch import interop
from repro_torch.configs import get_config, phi_variant
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import dispatch
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve as serve_launch
from repro_torch.models import model, moe
from repro_torch.models.config import ModelConfig
from repro_torch.train import step as step_lib

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_mesh_ranks as ranks  # noqa: E402
from torch_parity_util import np_tree, ref_spiking_dense_mm  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD_TIMEOUT = 240.0
MESHES = [((2, 4), ("data", "model")), ((4, 2), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model"))]
ARCHS = ["olmo_1b", "arctic_480b", "zamba2_1p2b"]
RULES = {"train": (shd.TRAIN_RULES, ref_shd.TRAIN_RULES),
         "serve": (shd.SERVE_RULES, ref_shd.SERVE_RULES)}
MOE_TOL = 2e-4      # the reference's EP-vs-dense test, float32 compute
WIDE_ROWS = 72      # a batch past 64 rows: 36 a data rank


@pytest.fixture
def fresh_policy():
    prev = dispatch.set_policy(dispatch.PhiExecutionPolicy())
    try:
        yield dispatch.get_policy()
    finally:
        dispatch.set_policy(prev)


def _grid(shape, axes):
    """A mesh's axis names and sizes, as both packages' functions read them."""
    return AbstractMesh(tuple(shape), tuple(axes))


def _leaves(tree, prefix=()):
    if shd.is_spec(tree):
        yield prefix, tree
        return
    for k in sorted(tree):
        yield from _leaves(tree[k], prefix + (k,))


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# ------------------------------------------------------- pure functions ---
def test_rule_tables_are_the_references():
    assert shd.TRAIN_RULES == ref_shd.TRAIN_RULES
    assert shd.SERVE_RULES == ref_shd.SERVE_RULES


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m[0])))
@pytest.mark.parametrize("rules", list(RULES))
def test_specs_resolve_as_the_references(rules, mesh, arch):
    """resolve_spec, shape_aware_spec and specs_to_shardings at every leaf
    of the smoke ``lm_specs``, plain and Phi."""
    grid = _grid(*mesh)
    port_rules, ref_rules = RULES[rules]
    for phi in (False, True):
        cfg, rcfg = get_config(arch, smoke=True), ref_get_config(arch, smoke=True)
        if phi:
            cfg, rcfg = phi_variant(cfg, timesteps=2, q=16), ref_phi_variant(rcfg, 2, q=16)
        specs, rspecs = model.lm_specs(cfg), ref_model.lm_specs(rcfg)
        placed = shd.specs_to_shardings(specs, grid, port_rules)
        rplaced = ref_shd.specs_to_shardings(rspecs, grid, ref_rules)
        for path, spec in _leaves(specs):
            rspec = _at(rspecs, path)
            assert shd.resolve_spec(spec.axes, port_rules, grid) == \
                tuple(ref_shd.resolve_spec(rspec.axes, ref_rules, grid)), path
            want = tuple(ref_shd.shape_aware_spec(rspec.shape, rspec.axes, grid, ref_rules))
            assert shd.shape_aware_spec(spec.shape, spec.axes, grid, port_rules) == want, path
            assert _at(placed, path) == tuple(_at(rplaced, path).spec), path


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m[0])))
@pytest.mark.parametrize("rules", list(RULES))
def test_state_sharding_for_leaf_matches_the_reference(rules, mesh, arch):
    """Every decode-state leaf at batch 1, 2, 4 and 8 (context 16): the
    port's placement is the reference's, the first dim of the batch's size
    taken as the batch dim, as there."""
    grid = _grid(*mesh)
    port_rules, ref_rules = RULES[rules]
    cfg, rcfg = get_config(arch, smoke=True), ref_get_config(arch, smoke=True)
    for batch in (1, 2, 4, 8):
        for s in model.state_leaves(model.decode_state_specs(cfg, batch, 16)):
            want = ref_step.state_sharding_for_leaf(rcfg, s.shape, grid, ref_rules, batch)
            got = step_lib.state_sharding_for_leaf(cfg, s.shape, grid, port_rules, batch)
            assert got == tuple(want.spec), (batch, s.shape)


def test_decode_state_shardings_take_each_leafs_own_batch_dim():
    """With as many stacked layer groups as batch rows (OLMo smoke: 2 and
    2), the reference's first-match rule places the layer axis on ``data``;
    the port's tree function takes each leaf's batch dim from the model and
    places rows on ``data``, heads on ``model``."""
    grid = _grid((2, 2), ("data", "model"))
    cfg, rcfg = get_config("olmo_1b", smoke=True), ref_get_config("olmo_1b", smoke=True)
    specs = model.decode_state_specs(cfg, 2, 16)
    s = model.state_leaves(specs)[0]                        # (2 layers, 2 rows, 16, 4, 16)
    assert s.shape[:2] == (2, 2)
    ref = tuple(ref_step.state_sharding_for_leaf(rcfg, s.shape, grid, ref_shd.SERVE_RULES,
                                                 2).spec)
    assert ref == ("data", None, None, None, None)          # the layer axis
    got = step_lib.decode_state_shardings(cfg, specs, grid, shd.SERVE_RULES, 2)
    assert got == (((None, "data", None, "model", None),) * 2,)


@pytest.mark.parametrize("shards", [1, 2, 3, 4, 8])
def test_shard_usage_histogram_matches_the_reference(shards):
    rng = np.random.default_rng(shards)
    usage = rng.integers(0, 50, (8, 17))
    want = ref_dispatch.shard_usage_histogram(usage, shards)
    got = dispatch.shard_usage_histogram(usage, shards)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, want)
    assert dispatch.shard_usage_histogram(None, shards) is None


def test_production_mesh_shapes_match_the_reference():
    """The reference's meshes on 512 placeholder devices (a subprocess);
    the port's table, and its refusal of a world of another size."""
    code = textwrap.dedent("""
        from repro.launch.mesh import make_production_mesh
        for mp in (False, True):
            m = make_production_mesh(multi_pod=mp)
            print(repr((mp, tuple(m.axis_names), tuple(m.shape.values()))))
    """)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=512",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    rows = [ast.literal_eval(line) for line in res.stdout.strip().splitlines()]
    assert [mp for mp, _, _ in rows] == [False, True]
    for mp, axes, shape in rows:
        got_shape, got_axes = mesh_lib.PRODUCTION_SHAPES[mp]
        assert (got_axes, got_shape) == (axes, shape)
    for mp in (False, True):
        with pytest.raises(ValueError, match="needs a world of"):
            mesh_lib.make_production_mesh(multi_pod=mp)


@pytest.mark.parametrize("mesh", MESHES[:2], ids=lambda m: "x".join(map(str, m[0])))
def test_param_shardings_place_the_phi_state_as_the_gemm_reads_it(mesh):
    """OLMo smoke in Phi mode under SERVE_RULES: each leaf off the GEMMs as
    the reference's specs_to_shardings; each GEMM weight and its Phi state
    as the reference's shard_map in-specs (``_phi_sharded_matmul``): weight
    (k_ax, n_ax), patterns (k_ax,), usage whole; the bank stored as the
    reference stores it, its K-partitions over ``pwp_tiles`` (``data``)
    within K's block, (k_ax + data, None, n_ax), gathered at each call."""
    grid = _grid(*mesh)
    cfg, rcfg = (phi_variant(get_config("olmo_1b", smoke=True), 2, 16),
                 ref_phi_variant(ref_get_config("olmo_1b", smoke=True), 2, 16))
    placed = model.param_shardings(cfg, grid, shd.SERVE_RULES)
    rplaced = ref_shd.specs_to_shardings(ref_model.lm_specs(rcfg), grid, ref_shd.SERVE_RULES)

    def ax(logical, dim):
        p = ref_shd.resolve_spec((logical,), ref_shd.SERVE_RULES, grid)
        a = p[0] if len(p) else None
        return a if a is not None and dim % ref_shd.axis_size(grid, a) == 0 else None

    checked = 0
    for path, spec in _leaves(model.lm_specs(cfg)):
        name = path[-2] if len(path) > 1 and path[-2].startswith("phi_") else path[-1]
        weight = name.removeprefix("phi_")
        if weight not in model._WEIGHT_AXES:
            assert _at(placed, path) == tuple(_at(rplaced, path).spec), path
            continue
        w = _at(model.lm_specs(cfg), path[:-2] + (weight,)) if name != weight else spec
        k_ax = ax(model._WEIGHT_AXES[weight][0], w.shape[-2])
        n_ax = ax(model._WEIGHT_AXES[weight][1], w.shape[-1])
        t_ax = k_ax
        if name != weight and (spec.shape[-3] // (1 if k_ax is None else grid.shape[k_ax])) \
                % grid.shape["data"] == 0:
            t_ax = "data" if k_ax is None else (k_ax, "data")
        want = {"patterns": (None, k_ax), "pwp": (None, t_ax, None, n_ax),
                "usage": ()}.get(path[-1], (None, k_ax, n_ax))
        want = list(want)
        while want and want[-1] is None:
            want.pop()
        assert _at(placed, path) == tuple(want), path
        checked += 1
    assert checked == 7 * 4      # seven GEMMs: the weight, patterns, bank, usage


def test_local_shard_cuts_row_major_blocks():
    grid = types.SimpleNamespace(axis_names=("pod", "data", "model"),
                                 shape={"pod": 2, "data": 2, "model": 2})
    x = torch.arange(8 * 6).reshape(8, 6)
    for r in range(8):
        c = dict(zip(grid.axis_names, np.unravel_index(r, (2, 2, 2))))
        got = shd.local_shard(x, (("pod", "data"), "model"), grid, c)
        i = c["pod"] * 2 + c["data"]
        assert torch.equal(got, x[2 * i:2 * i + 2, 3 * c["model"]:3 * c["model"] + 3])
    assert shd.local_shape((8, 6), (("pod", "data"), "model"), grid) == (2, 3)


# ------------------------------------------------------- a world of ranks ---
def _moe_cfg(torch_dtype=True):
    kw = dict(name="t", family="moe", n_layers=1, d_model=32, n_heads=4, n_kv_heads=4,
              d_ff=64, vocab=64, n_experts=8, top_k=2, capacity_factor=8.0)
    if torch_dtype:
        return ModelConfig(**kw, compute_dtype=torch.float32)
    from repro.models.config import ModelConfig as RefModelConfig
    return RefModelConfig(**kw, compute_dtype=jnp.float32)


def _moe_inputs():
    rng = np.random.default_rng(11)
    p = {"router": rng.normal(0, 0.02, (32, 8)),
         "w1": rng.normal(0, 32 ** -0.5, (8, 32, 64)),
         "w2": rng.normal(0, 64 ** -0.5, (8, 64, 32)),
         "w3": rng.normal(0, 32 ** -0.5, (8, 32, 64))}
    x = rng.normal(0, 1, (4, 8, 32))
    return {k: v.astype(np.float32) for k, v in p.items()}, x.astype(np.float32)


MOE_MESHES = [((2, 4), ("data", "model")), ((1, 8), ("data", "model"))]
# moe_impl="dense" on a mesh: the smoke configs that run it (Llama-4's has the
# shared expert), their layer on (data 2, model 4), a batch of 4 x 6 rows.
MOE_DENSE_ARCHS = ["arctic_480b", "llama4_maverick"]
MOE_DENSE_MESH = ((2, 4), ("data", "model"))


def _moe_dense_inputs(arch: str):
    """(cfg, one layer's params drawn from a seed, a (4, 6, D) batch)."""
    cfg = get_config(arch, smoke=True)
    p = shd.init_params(moe.moe_specs(cfg), torch.Generator().manual_seed(13), "cpu")
    x = np.random.default_rng(13).normal(0, 1, (4, 6, cfg.d_model)).astype(np.float32)
    return cfg, p, torch.from_numpy(x)


def _reference_moe_ep(tmp_path) -> list[np.ndarray]:
    """The reference's moe_ep on each of MOE_MESHES, 8 placeholder devices."""
    p, x = _moe_inputs()
    np.savez(tmp_path / "moe_in.npz", x=x, **p)
    code = textwrap.dedent(f"""
        import numpy as np, jax, jax.numpy as jnp
        from repro.models.config import ModelConfig
        from repro.models import moe
        from repro.distributed import sharding as shd
        from repro.launch.mesh import make_mesh
        d = np.load({str(tmp_path / 'moe_in.npz')!r})
        cfg = ModelConfig(name='t', family='moe', n_layers=1, d_model=32, n_heads=4,
                          n_kv_heads=4, d_ff=64, vocab=64, n_experts=8, top_k=2,
                          capacity_factor=8.0, compute_dtype=jnp.float32)
        p = {{k: jnp.asarray(d[k]) for k in ('router', 'w1', 'w2', 'w3')}}
        out = {{}}
        for i, (shape, axes) in enumerate({MOE_MESHES!r}):
            mesh = make_mesh(shape, axes)
            with shd.use_rules(shd.TRAIN_RULES, mesh), mesh:
                out[f'ep{{i}}'] = np.asarray(jax.jit(lambda p, x: moe.moe_ep(cfg, p, x))(
                    p, jnp.asarray(d['x'])))
        np.savez({str(tmp_path / 'moe_out.npz')!r}, **out)
    """)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    out = np.load(tmp_path / "moe_out.npz")
    return [out[f"ep{i}"] for i in range(len(MOE_MESHES))]


def _olmo_setup():
    """OLMo smoke in Phi mode: the reference's dyadic params calibrated there,
    carried across; the nnz budget from the calibration (no coo drop)."""
    rcfg = ref_phi_variant(ref_get_config("olmo_1b", smoke=True), timesteps=2, q=16)
    rp = ref_shd.init_params(ref_model.lm_specs(rcfg), jax.random.PRNGKey(1))
    rp = jax.tree.map(lambda x: jnp.round(x * 1024) / 1024, rp)
    rbatch = ref_model.dummy_batch(rcfg, 2, 8, with_labels=False, key=jax.random.PRNGKey(2))
    rp, stats = ref_model.calibrate_lm_phi(rcfg, rp, rbatch)
    maxd = max(s.l2_density for s in stats.values())
    cfg = phi_variant(get_config("olmo_1b", smoke=True), timesteps=2, q=16)
    cfg = cfg.with_(phi=dataclasses.replace(cfg.phi, nnz_budget=min(0.9, 2 * maxd + 0.05)))
    params = interop.params_from_numpy(np_tree(rp), "cpu")
    batch = {k: torch.from_numpy(np.array(v)) for k, v in rbatch.items()}
    return rcfg, rp, rbatch, cfg, params, batch


# The dry run's cells on (data 2, model 2), held against the same steps run
# for real by every rank (two such meshes in the 8-rank world).
DRY_MESH = ((2, 2), ("data", "model"))
DRY_DECODE = (2, 16)         # B, context of the decode step
DRY_TRAIN = (2, 8)           # B, S of the dense train step


def _dryrun_setup(cfg, params, batch) -> dict:
    """The Phi smoke prefill (the world's batch) and decode, and one dense
    train step of OLMo smoke: each rank's arguments for
    ``torch_mesh_ranks.dryrun_checks_run``, and the cells' shapes."""
    from repro_torch.train import optimizer as opt

    shape, axes = DRY_MESH
    grid = types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)))
    dcfg = get_config("olmo_1b", smoke=True)
    ocfg = opt.OptConfig(factored=False)      # the dry run's for float32 params
    dparams = shd.init_params(model.lm_specs(dcfg), torch.Generator().manual_seed(5), "cpu")
    bundle = step_lib.make_train_step(dcfg, ocfg, grid)[0]
    tbatch = model.dummy_batch(dcfg, *DRY_TRAIN, True, torch.Generator().manual_seed(6), "cpu")
    phi_placed = model.param_shardings(cfg, grid, shd.SERVE_RULES)

    def rank_args(r: int) -> tuple:
        coords = dict(zip(axes, np.unravel_index(r % 4, shape)))
        return (cfg, shd.place(params, phi_placed, grid, coords), batch, DRY_DECODE, dcfg, ocfg,
                shd.place(dparams, bundle.in_shardings[0], grid, coords), tbatch)

    return dict(rank_args=rank_args, cfg=cfg, dcfg=dcfg, prefill=tuple(batch["tokens"].shape))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One 8-rank world: the OLMo smoke runs, moe_ep on MOE_MESHES and the
    collectives; beside it the single-device runs and the references'."""
    tmp = tmp_path_factory.mktemp("mesh")
    rcfg, rp, rbatch, cfg, params, batch = _olmo_setup()
    prev = dispatch.set_policy(dispatch.PhiExecutionPolicy())
    try:
        dispatch.register_usage_from_params(params)
        single, single_shapes = ranks.decode_run(cfg, params, batch, 2)
        wide = {"tokens": torch.from_numpy(
            np.random.default_rng(4).integers(3, cfg.vocab, (WIDE_ROWS, 6)).astype(np.int32))}
        single_wide, _ = ranks.decode_run(cfg, params, wide, 1)
        single_wide_paged = ranks.paged_decode_run(cfg, params, wide, 4)
        rng = np.random.default_rng(3)
        prompts = [rng.integers(3, cfg.vocab, int(n)) for n in rng.integers(3, 10, 6)]
        serve_kw = dict(slots=4, max_new=4, max_context=32)
        single_tokens = ranks.serve(cfg, params, prompts, **serve_kw)
        single_paged = {name: ranks.engine_run(cfg, params, prompts, paged=True, **serve_kw,
                                               **kw)
                        for name, kw in ranks.PAGED_RUNS.items()}
    finally:
        dispatch.set_policy(prev)
    x, _ = ref_model._forward(rcfg, rp, rbatch, matmul=ref_spiking_dense_mm(rcfg))
    ref_prefill = np.asarray(ref_model._logits(rcfg, rp, x[:, -1:]))[:, 0]

    shape, axes = (2, 4), ("data", "model")
    grid = types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)))
    placed = model.param_shardings(cfg, grid, shd.SERVE_RULES)
    mcfg = _moe_cfg()
    mp, mx = _moe_inputs()
    mp = {k: torch.from_numpy(v) for k, v in mp.items()}
    mx = torch.from_numpy(mx)
    dshape, daxes = MOE_DENSE_MESH
    dgrid = types.SimpleNamespace(axis_names=daxes, shape=dict(zip(daxes, dshape)))
    dense_inputs = {arch: _moe_dense_inputs(arch) for arch in MOE_DENSE_ARCHS}
    dry = _dryrun_setup(cfg, params, batch)
    args = []
    for r in range(8):
        coords = dict(zip(axes, np.unravel_index(r, shape)))
        dc = dict(zip(daxes, np.unravel_index(r, dshape)))
        dense_runs = []
        for arch, (dcfg, dp, dx) in dense_inputs.items():
            dpl = shd.specs_to_shardings(moe.moe_specs(dcfg), dgrid, shd.SERVE_RULES)
            n = dx.shape[0] // dshape[0]
            dense_runs.append((arch, dshape, daxes, dcfg, shd.place(dp, dpl, dgrid, dc),
                               dx[dc["data"] * n:(dc["data"] + 1) * n].clone(), dx.shape[0]))
        moe_runs = []
        for mshape, maxes in MOE_MESHES:
            mgrid = types.SimpleNamespace(axis_names=maxes, shape=dict(zip(maxes, mshape)))
            mc = dict(zip(maxes, np.unravel_index(r, mshape)))
            mpl = shd.specs_to_shardings(moe.moe_specs(mcfg), mgrid, shd.TRAIN_RULES)
            rows = mx.shape[0] // mshape[0]
            moe_runs.append((mshape, maxes, shd.place(mp, mpl, mgrid, mc),
                             mx[mc["data"] * rows:(mc["data"] + 1) * rows].clone()))
        args.append(((shape, axes, cfg, shd.place(params, placed, grid, coords), batch, 2,
                      prompts, serve_kw, wide), (mcfg, moe_runs, dense_runs),
                     dry["rank_args"](r)))
    out = mesh_lib.spawn_ranks(ranks.world_rank, 8, args, device="cpu",
                               timeout=WORLD_TIMEOUT)
    with torch.no_grad():
        dense = moe.moe_dense(mcfg, mp, mx).numpy()
        dense_one = {arch: moe.moe_dense(c, p, x).numpy()
                     for arch, (c, p, x) in dense_inputs.items()}
    return dict(ranks=out, single=single, single_wide=single_wide,
                single_wide_paged=single_wide_paged, single_shapes=single_shapes,
                single_tokens=single_tokens, single_paged=single_paged, ref_prefill=ref_prefill,
                moe_dense=dense, moe_dense_one=dense_one, moe_ref=_reference_moe_ep(tmp),
                cfg=cfg, dry=dry)


def test_mesh_prefill_and_decode_equal_one_device_bitwise(world):
    single = world["single"]
    for r, out in enumerate(world["ranks"]):
        lm = out["lm"]
        assert len(lm["policy"]) == len(single) == 3
        for step, (got, want) in enumerate(zip(lm["policy"], single)):
            assert got.shape == want.shape == (2, world["cfg"].vocab)
            assert np.array_equal(got, want), (r, step, np.abs(got - want).max())


def test_split_banks_give_the_replicated_banks_steps_bitwise(world):
    """Under SERVE_RULES each rank stores its PWP banks split over data
    (``pwp_tiles``) and gathers them at each Phi GEMM: the prefill and decode
    steps equal, bitwise, those from the banks gathered whole over data
    beforehand (``pwp_tiles=None``), and each stored bank holds 1 / data of
    the K-partitions its patterns cover where data divides them."""
    for out in world["ranks"]:
        lm = out["lm"]
        assert len(lm["replicated_banks"]) == len(lm["policy"])
        for got, want in zip(lm["policy"], lm["replicated_banks"]):
            assert np.array_equal(got, want)
        data = dict(zip(MESHES[0][1], MESHES[0][0]))["data"]
        split = 0
        for stored, whole, pats in lm["bank_shapes"].values():
            assert whole[-3] == pats[-3]
            # split where data divides the rank's K-partitions (wq..w3, w2),
            # whole where it does not (wo: one partition a model rank)
            assert stored[-3] == (pats[-3] // data if pats[-3] % data == 0 else pats[-3])
            split += stored[-3] < pats[-3]
        assert split >= 6


def test_mesh_logits_equal_one_device_bitwise_at_many_rows(world):
    """At 72 rows (36 a data rank) too: a rank's attention and head make one
    device's library call, whatever the row count."""
    for r, out in enumerate(world["ranks"]):
        got_all = out["lm"]["wide"]
        assert len(got_all) == len(world["single_wide"]) == 2
        for step, (got, want) in enumerate(zip(got_all, world["single_wide"])):
            assert got.shape == want.shape == (WIDE_ROWS, world["cfg"].vocab)
            assert np.array_equal(got, want), (r, step, np.abs(got - want).max())


def test_serving_step_builders_on_the_mesh_run_the_same_steps(world):
    """``make_prefill`` and ``make_decode_step`` with a mesh: the policy
    run's prefill and first decode step bitwise, and their placements."""
    for out in world["ranks"]:
        lm = out["lm"]
        for got, want in zip(lm["builders"], lm["policy"][:2]):
            assert np.array_equal(got, want)
        assert lm["builder_placements"] == {"params": True, "tokens": ("data", None),
                                            "token": ("data",), "embeds": ("data", None)}


def test_mesh_prefill_matches_the_references_single_device_forward(world):
    np.testing.assert_allclose(world["ranks"][0]["lm"]["policy"][0], world["ref_prefill"],
                               rtol=0, atol=1e-4)


def test_mesh_forced_coo_run_is_bitwise_the_policys(world):
    for out in world["ranks"]:
        for got, want in zip(out["lm"]["coo"], out["lm"]["policy"]):
            assert np.array_equal(got, want)


def test_mesh_phi_gemms_resolve_spmd_local_kernels_with_shards(world):
    """Column-parallel w1 and row-parallel w2 keep the fused dataflow in the
    per-rank body, every decision there carrying the 8 ranks; the forced-coo
    run's config override is honoured there."""
    for out in world["ranks"]:
        dec = out["lm"]["decisions"]
        fused = {s for (s, i, r) in dec
                 if i in ("fused", "fused_stream", "fused_prefetch")
                 and r.startswith("spmd_local_")}
        assert {"lm.w1.spmd", "lm.w2.spmd"} <= fused, dec
        assert ("lm.w2.spmd", "coo", "config_override") in dec
        assert not {s for (s, _, _) in dec if s.startswith("lm.w") and not s.endswith(".spmd")}
        assert out["lm"]["shards"] == {"lm.w1.spmd": 8, "lm.w2.spmd": 8}


def test_mesh_caches_are_the_ranks_rows_and_heads(world):
    """Batch 2 over data 2, 4 heads over model 4: each rank keeps one row's
    caches of one head."""
    L, B, S, H, hd = world["single_shapes"][0]
    for out in world["ranks"]:
        assert out["lm"]["cache_shapes"] == [(L, B // 2, S, H // 4, hd)] * 2


def test_mesh_engine_tokens_equal_one_devices(world):
    assert len(world["single_tokens"]) == 6
    for out in world["ranks"]:
        assert out["lm"]["tokens"] == world["single_tokens"]


def _same_rows(got: dict, want: dict, skip=()) -> None:
    """Every request's recorded logits rows bitwise equal (but ``skip``'s)."""
    assert sorted(got) == sorted(want)
    for rid in want:
        if rid not in skip:
            assert got[rid].shape == want[rid].shape
            assert np.array_equal(got[rid], want[rid]), (rid, np.abs(got[rid] - want[rid]).max())


def test_mesh_paged_decode_equals_one_devices_at_many_rows(world):
    """A paged decode step at 72 rows (36 a data rank), from pools holding a
    rank's KV heads and every page: bitwise one device's paged step and one
    device's contiguous step (the attention makes one device's call at the
    gathered view's shape)."""
    want = world["single_wide_paged"]
    assert np.array_equal(want, world["single_wide"][1])
    for r, out in enumerate(world["ranks"]):
        got = out["lm"]["wide_paged"]
        assert got.shape == want.shape == (WIDE_ROWS, world["cfg"].vocab)
        assert np.array_equal(got, want), (r, np.abs(got - want).max())


@pytest.mark.parametrize("run", list(ranks.PAGED_RUNS))
def test_mesh_paged_engine_equals_one_devices_paged_engine_bitwise(world, run):
    """The paged engine on (data 2, model 4), each rank from its pools,
    against one device's paged engine with the same pool: the tokens and
    every recorded logits row bitwise, the same requests preempted."""
    want = world["single_paged"][run]
    assert want["paged"] and len(want["tokens"]) == 6
    for r, out in enumerate(world["ranks"]):
        got = out["lm"]["paged"][run]
        assert got["paged"], r
        assert got["tokens"] == want["tokens"] == world["single_tokens"], r
        assert got["preempted"] == want["preempted"], r
        _same_rows(got["logits"], want["logits"])


@pytest.mark.parametrize("run", list(ranks.PAGED_RUNS))
def test_mesh_paged_engine_equals_the_mesh_contiguous_engine(world, run):
    """Against the mesh's contiguous engine: the tokens, and every logits
    row bitwise but a preempted request's (it resumes with a prefill over
    its prompt and prefix, whose row for the next token is the prefill's,
    not a decode step's)."""
    for r, out in enumerate(world["ranks"]):
        got, want = out["lm"]["paged"][run], out["lm"]["engine"]
        assert not want["paged"] and not want["preempted"]
        assert got["tokens"] == want["tokens"], r
        _same_rows(got["logits"], want["logits"], skip=got["preempted"])


def test_mesh_tight_pool_preempts_and_the_default_does_not(world):
    """One full lane of pages for 4 slots: the page manager, host-side and
    the same on every rank, preempts; the default pool never does. Pages
    freed by one data rank's slots (0, 1 on data 0; 2, 3 on data 1) go to
    the other's, whose copies of them are stale."""
    for out in world["ranks"]:
        paged = out["lm"]["paged"]
        assert len(paged["tight"]["preempted"]) >= 1
        assert paged["default"]["preempted"] == []
        assert paged["tight"]["cache"]["hwm_pages"] == 4
        assert paged["tight"]["page_slots"] == world["single_paged"]["tight"]["page_slots"]
    assert world["single_paged"]["tight"]["preempted"] == \
        world["ranks"][0]["lm"]["paged"]["tight"]["preempted"]
    crossed = [page for page, slots in world["single_paged"]["tight"]["page_slots"].items()
               if len({s // 2 for s in slots}) == 2]
    assert crossed, world["single_paged"]["tight"]["page_slots"]


def test_mesh_pools_hold_the_ranks_kv_heads_and_every_page(world):
    """Each pool leaf (n_groups, P + 1, page_size, Hkv, hd) on a rank: its
    KV heads (4 over model 4) and every page, the scratch page too, as
    ``paged_state_shardings`` places it; the cache report says the bytes are
    the rank's."""
    grid = _grid((2, 4), ("data", "model"))
    specs = model.paged_state_specs(world["cfg"], 4, 8)
    assert model.paged_state_shardings(world["cfg"], specs, grid, shd.SERVE_RULES) == \
        [(None, None, None, "model", None)] * 2
    for run, kw in ranks.PAGED_RUNS.items():
        one = world["single_paged"][run]
        for r, out in enumerate(world["ranks"]):
            got = out["lm"]["paged"][run]
            assert got["pool_shapes"] == [(L, P1, ps, H // 4, hd)
                                          for (L, P1, ps, H, hd) in one["pool_shapes"]], r
            L, P1, ps, H, hd = one["pool_shapes"][0]
            assert P1 == got["cache"]["num_pages"] + 1 and ps == kw["page_size"]
            assert got["cache"]["bytes_of"] == f"rank {r}"
            assert got["cache"]["pool_bytes"] * 4 == one["cache"]["pool_bytes"]
            assert "bytes_of" not in one["cache"]
            contig = out["lm"]["engine"]["cache"]["contig_cache_bytes"]
            assert got["cache"]["contig_cache_bytes"] == contig
            assert contig * 8 == one["cache"]["contig_cache_bytes"]


def test_paged_pools_refuse_kv_heads_the_model_axis_does_not_split():
    """OLMo smoke's 4 KV heads over model 8: no rank's block of heads, so
    the pools cannot be placed (a paged mesh engine places them here)."""
    cfg = get_config("olmo_1b", smoke=True)
    specs = model.paged_state_specs(cfg, 4, 8)
    with pytest.raises(ValueError, match="4 KV heads do not split over model = 8"):
        model.paged_state_shardings(cfg, specs, _grid((1, 8), ("data", "model")),
                                    shd.SERVE_RULES)


@pytest.mark.parametrize("arch", MOE_DENSE_ARCHS)
def test_moe_dense_on_a_mesh_is_one_devices_bitwise(world, arch):
    """``moe_impl="dense"`` on (data 2, model 4) under the serving rules: a
    rank holds 1 of 4 experts and half their hidden dim (Llama-4's shared
    expert a quarter of its own); it gathers the layer and the rows and
    makes one device's call, so its rows are bitwise one device's."""
    want = world["moe_dense_one"][arch]
    n = want.shape[0] // MOE_DENSE_MESH[0][0]
    for r, out in enumerate(world["ranks"]):
        d = np.unravel_index(r, MOE_DENSE_MESH[0])[0]
        got = out["moe_dense"][arch]
        assert got.shape == (n,) + want.shape[1:]
        assert np.array_equal(got, want[d * n:(d + 1) * n]), (r, np.abs(
            got - want[d * n:(d + 1) * n]).max())


@pytest.mark.parametrize("which", range(len(MOE_MESHES)),
                         ids=["2x4_gathers_expert_mlp", "1x8"])
def test_moe_ep_matches_the_references_and_dense(world, which):
    """Each rank's rows of the port's moe_ep against the reference's moe_ep
    on its 8-device mesh and the port's moe_dense, nothing dropped."""
    rows = MOE_MESHES[which][0][0]
    ref, dense = world["moe_ref"][which], world["moe_dense"]
    n = ref.shape[0] // rows
    for r, out in enumerate(world["ranks"]):
        y, stats = out["moe"][which]
        d = np.unravel_index(r, MOE_MESHES[which][0])[0]
        assert stats["dropped"] == 0
        np.testing.assert_allclose(y, ref[d * n:(d + 1) * n], rtol=MOE_TOL, atol=MOE_TOL)
        np.testing.assert_allclose(y, dense[d * n:(d + 1) * n], rtol=MOE_TOL, atol=MOE_TOL)


def test_collectives_on_a_three_axis_mesh(world):
    """all_reduce, all_gather and all_to_all over one axis and over a tuple
    of axes, against their definitions on every rank's input."""
    shape = (2, 2, 2)
    inputs = [ranks.collective_input(r) for r in range(8)]
    for r, out in enumerate(world["ranks"]):
        c = np.unravel_index(r, shape)
        for ax, got in out["collectives"].items():
            idx = [i for i, a in enumerate(("pod", "data", "model")) if a in ax]
            peers = [q for q in range(8)
                     if all(np.unravel_index(q, shape)[i] == c[i]
                            for i in range(3) if i not in idx)]
            np.testing.assert_array_equal(got["all_reduce"], sum(inputs[q] for q in peers))
            np.testing.assert_array_equal(got["all_gather"],
                                          np.concatenate([inputs[q] for q in peers]))
            me = peers.index(r)
            n = len(peers)
            blocks = [np.split(inputs[q], n)[me] for q in peers]
            np.testing.assert_array_equal(got["all_to_all"], np.concatenate(blocks))


# ------------------------------------------------- the dry run against ranks ---
def _dry_cell(cfg, kind: str, batch: int, seq: int) -> dict:
    """The dry run of one (data 2, model 2) cell on fake cpu tensors."""
    from repro_torch.launch import dryrun

    shape, axes = DRY_MESH
    with dryrun.fake_world(4):
        mesh = mesh_lib.make_mesh(shape, axes, "cpu")
        return dryrun.trace_step(cfg, kind, batch, seq, mesh, device="cpu")


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_dry_run_equals_the_ranks_real_steps(world, kind):
    """Collective calls and result bytes by kind, FLOPs (``FlopCounterMode``'s:
    on the CPU no kernel launches) and argument bytes: the dry run of the
    cell against every rank's real step, exactly."""
    dry = world["dry"]
    if kind == "train":
        rec = _dry_cell(dry["dcfg"], "train", *DRY_TRAIN)
    else:
        rec = _dry_cell(dry["cfg"], kind, *(dry["prefill"] if kind == "prefill" else DRY_DECODE))
    assert rec["cost"]["ops_kernels"] == 0 and rec["launches"]["kernels"] == {}
    assert sum(rec["collective_calls"].values()) > 0
    for r, out in enumerate(world["ranks"]):
        got = out["dryrun"][kind]
        assert got["collective_calls"] == rec["collective_calls"], (r, kind)
        assert got["collectives"] == rec["collectives"], (r, kind)
        assert got["flops"] == rec["cost"]["flops_aten"] == rec["cost"]["flops"], (r, kind)
        assert got["argument_bytes"] == rec["memory"]["argument_bytes"], (r, kind)


# Kinds whose collective bytes the port's step and the reference's compiled
# step count differently, on the dense OLMo smoke decode step on (data 2,
# model 2), and why. Every other kind is asserted equal.
COLLECTIVE_DIFFERENCES = {
    "all-gather": "the port's head makes one device's call (model._logits): it gathers the "
                  "batch rows over data and the vocab-parallel logits over model; XLA keeps "
                  "the logits split over model and instead gathers the KV-cache scatter's "
                  "updates and indices inside its layer loop, where each rank here writes "
                  "its own rows and heads",
    "all-to-all": "with one batch row a data rank, XLA's partitioner moves each layer's KV "
                  "cache (16 slots x 2 heads x 16) between the data and model layouts with "
                  "an all-to-all inside its layer loop; here a rank keeps its rows and heads "
                  "of the cache and exchanges nothing",
}

_REF_DECODE_COLLECTIVES = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding
    from repro.configs import get_config
    from repro.distributed import sharding as shd
    from repro.distributed.hlo_analysis import collective_bytes
    from repro.models import model
    from repro.train import step as step_lib
    B, S = {B}, {S}
    cfg = get_config("olmo_1b", smoke=True)
    mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
    rules = shd.SERVE_RULES
    with mesh:
        fn, p_specs, p_sh, _, _ = step_lib.make_decode_step(cfg, mesh, rules)
        with shd.use_rules(rules, None):
            state = model.decode_state_specs(cfg, B, S)
        st_sh = step_lib.decode_state_shardings(cfg, state, mesh, rules, B)
        tok = jax.ShapeDtypeStruct((B,), jnp.int32)
        tok_sh = NamedSharding(mesh, shd.shape_aware_spec((B,), ("batch",), mesh, rules))
        comp = jax.jit(fn, in_shardings=(p_sh, tok_sh, tok_sh, st_sh, None),
                       donate_argnums=(3,)).lower(shd.specs_to_sds(p_specs), tok, tok, state,
                                                  None).compile()
    print(json.dumps(collective_bytes(comp.as_text())))
""")


def test_dry_run_collectives_against_the_references_compiled_decode():
    """The dense OLMo smoke decode step on (data 2, model 2): the dry run's
    collective result bytes by kind against the reference's compiled step on
    4 host devices (``Auto`` axes), equal for every kind both count the same
    way; :data:`COLLECTIVE_DIFFERENCES` names the others."""
    B, S = DRY_DECODE
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REF_DECODE_COLLECTIVES.format(B=B, S=S)],
                         capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    want = ast.literal_eval(out.stdout.strip().splitlines()[-1])
    got = _dry_cell(get_config("olmo_1b", smoke=True), "decode", B, S)["collectives"]
    assert set(got) == set(want)
    differ = {k for k in got if got[k] != want[k]}
    assert differ == set(COLLECTIVE_DIFFERENCES), (got, want)
    assert got["all-reduce"] == want["all-reduce"] > 0


# ----------------------------------------------------------- the launcher ---
def test_serve_launcher_on_a_mesh_of_host_ranks_gives_one_devices_tokens(fresh_policy):
    flags = ["--arch", "olmo_1b", "--smoke", "--phi", "--device", "cpu", "--requests", "4",
             "--max-new", "4", "--max-context", "32"]
    one = serve_launch.main(flags)
    mesh = serve_launch.main(flags + ["--host-devices", "4", "--mesh-model", "2",
                                      "--timeout", str(WORLD_TIMEOUT)])
    assert len(one) == 4 and mesh == one
    with pytest.raises(SystemExit, match="does not divide"):
        serve_launch.main(flags + ["--host-devices", "4", "--mesh-model", "3"])


def test_serve_launcher_serves_paged_on_a_mesh_with_one_devices_tokens(fresh_policy):
    """``--paged`` with ``--host-devices 4 --mesh-model 2``, from a pool of
    one full lane: the tokens one device's paged launcher gives."""
    flags = ["--arch", "olmo_1b", "--smoke", "--phi", "--device", "cpu", "--requests", "6",
             "--max-new", "6", "--max-context", "32", "--paged", "--page-size", "8",
             "--pages", "4"]
    one = serve_launch.main(flags)
    mesh = serve_launch.main(flags + ["--host-devices", "4", "--mesh-model", "2",
                                      "--timeout", str(WORLD_TIMEOUT)])
    assert len(one) == 6 and mesh == one


# ----------------------------------------------------------- the SPMD rows ---
# (m, k_dim, n, t, q) where the Hopper gate and the reference's VMEM gate
# agree (``tests/test_torch_dispatch.py``'s shapes).
_SMALL = dict(m=256, k_dim=96, n=72, t=6, q=16)
_LONG_K = dict(m=2048, k_dim=2304, n=512, t=144, q=128)
_NO_KERNEL = dict(m=256, k_dim=64, n=128, t=4, q=16384)
_SKEWED = np.zeros((6, 17), np.int64)
_SKEWED[:, :4], _SKEWED[:, 16] = 100, 10
SPMD_ROWS = {
    "default_fused": dict(_SMALL),
    "default_stream": dict(_LONG_K),
    "default_prefetch": dict(_SMALL, usage=_SKEWED),
    "no_kernel": dict(_NO_KERNEL),
    "override_coo": dict(_SMALL, config_override="coo"),
    "override_fused": dict(_SMALL, config_override="fused"),
    "override_pallas": dict(_SMALL, override="pallas"),
    "override_fused_on_long_k": dict(_LONG_K, override="fused"),
    "override_prefetch": dict(_SMALL, override="fused_prefetch", usage=_SKEWED),
    "autodiff": dict(_SMALL, transform=True),
    "autodiff_override_fused": dict(_SMALL, override="fused", transform=True),
}


@pytest.mark.parametrize("body", [True, False], ids=["body", "region"])
@pytest.mark.parametrize("row", list(SPMD_ROWS))
def test_spmd_rows_row_for_row_vs_reference(row, body, monkeypatch):
    """Under an SPMD region, in a per-rank body (the reference's shard_map
    axis environment, probed by its ``_axis_env_*``) or outside one (its
    pjit region): impl, reason, shape and ``shards`` as the reference's."""
    monkeypatch.delenv("PHI_IMPL", raising=False)
    monkeypatch.setattr(ref_dispatch, "_axis_env_nonempty", lambda: body)
    monkeypatch.setattr(ref_dispatch, "_axis_env_shards", lambda: 8)
    kw = SPMD_ROWS[row]
    with ref_dispatch.spmd_region():
        want = ref_dispatch.PhiExecutionPolicy(telemetry=False).resolve(site="lm.w1.spmd", **kw)
    pol = dispatch.PhiExecutionPolicy()
    with dispatch.spmd_region():
        if body:
            with dispatch.spmd_body(8):
                got = pol.resolve(site="lm.w1.spmd", **kw)
        else:
            got = pol.resolve(site="lm.w1.spmd", **kw)
    assert (got.impl, got.reason, got.shards) == (want.impl, want.reason, want.shards)
    assert got.shape == want.shape and (got.usage_ratio, got.p_active) == (
        want.usage_ratio, want.p_active)
    assert pol.last_decision("lm.w1.spmd").shards == want.shards
    if body and not kw.get("transform") and got.impl == "coo" and "override" not in row:
        with dispatch.spmd_body(8), pytest.raises(ValueError, match="no Phi kernel takes"):
            pol.resolve(site="lm.w1.spmd", device="cuda", **kw)


@pytest.mark.parametrize("body", [True, False], ids=["body", "region"])
def test_spmd_attention_rows_vs_reference(body, monkeypatch):
    monkeypatch.setattr(ref_dispatch, "_axis_env_nonempty", lambda: body)
    monkeypatch.setattr(ref_dispatch, "_axis_env_shards", lambda: 4)
    site = dict(s=64, d=32, heads=12, batch=8, t=2, q=128, kp=16)
    for kw in (dict(spike_qk=True, has_patterns=True), dict(has_patterns=True),
               dict(has_patterns=True, override="phi_flash"),
               dict(spike_qk=True, has_patterns=True, transform=True)):
        with ref_dispatch.spmd_region():
            want = ref_dispatch.PhiExecutionPolicy(telemetry=False).resolve_attention(
                site="snn.attn", **site, **kw)
        with dispatch.spmd_region():
            if body:
                with dispatch.spmd_body(4):
                    got = dispatch.PhiExecutionPolicy().resolve_attention(site="snn.attn",
                                                                          **site, **kw)
            else:
                got = dispatch.PhiExecutionPolicy().resolve_attention(site="snn.attn",
                                                                      **site, **kw)
        assert (got.impl, got.reason, got.shards) == (want.impl, want.reason, want.shards), kw


def test_a_mesh_alone_makes_an_spmd_region():
    """``use_rules`` with a mesh is an SPMD region without an explicit one,
    as in the reference; the rows then demote a kernel outside a body."""
    grid = _grid((2, 2), ("data", "model"))
    pol = dispatch.PhiExecutionPolicy()
    assert not dispatch.in_spmd_region()
    with shd.use_rules(shd.SERVE_RULES, grid):
        assert dispatch.in_spmd_region() and not dispatch.in_spmd_body()
        d = pol.resolve(site="s", **_SMALL)
    assert (d.impl, d.reason, d.shards) == ("coo", "spmd_region", None)
    assert shd.current_mesh() is None
