"""Rank bodies of the mesh tests (``tests/test_torch_distributed*.py``).

``launch.mesh.spawn_ranks`` runs these in new processes; they import the
port only (no JAX), so each rank starts in a second or two. Each takes its
rank's shards and returns numpy arrays and plain values.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.distributed.sharding import SERVE_RULES, TRAIN_RULES, use_rules
from repro_torch.kernels import dispatch
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model, moe
from repro_torch.serve.engine import Engine, Request


def decode_run(cfg, params, batch, steps: int, mesh=None, matmul=None):
    """Prefill ``batch`` and ``steps`` greedy decode steps: every step's
    logits (numpy), and the caches' local shapes. ``matmul`` as the entry
    points take it (default: the config's own)."""
    B, S = batch["tokens"].shape
    with torch.no_grad(), use_rules(SERVE_RULES, mesh):
        logits, caches = model.prefill(cfg, params, batch, matmul=matmul)
        caches = model.extend_caches(cfg, caches, S + steps + 1)
        outs = [logits.numpy()]
        tok = logits.argmax(-1).to(torch.int32)
        for t in range(steps):
            pos = torch.full((B,), S + t, dtype=torch.int32)
            logits, caches = model.decode_step(cfg, params, tok, pos, caches, matmul=matmul)
            outs.append(logits.numpy())
            tok = logits.argmax(-1).to(torch.int32)
    return outs, [tuple(c.shape) for c in model.state_leaves(caches)]


def paged_decode_run(cfg, params, batch, page_size: int, mesh=None) -> np.ndarray:
    """Prefill ``batch`` (B, S), splice each row's caches into its pages of
    fresh pools (row b's logical pages at physical b·Lp to (b + 1)·Lp - 1,
    Lp·page_size = S + 2, the contiguous ``decode_run``'s one-step cache) and
    take one greedy step through ``decode_step_paged``: its logits."""
    B, S = batch["tokens"].shape
    lp = (S + 2) // page_size
    table = torch.arange(B * lp, dtype=torch.int32).reshape(B, lp)
    with torch.no_grad(), use_rules(SERVE_RULES, mesh):
        logits, caches = model.prefill(cfg, params, batch)
        pools, _ = model.init_paged_state(cfg, B * lp, page_size, "cpu", mesh)
        rows = model.local_rows(table, model.batch_axis(B)).long()
        for pool, c in zip(model.state_leaves(pools), model.state_leaves(caches)):
            c = torch.nn.functional.pad(c, [0, 0, 0, 0, 0, lp * page_size - S])
            pool[:, rows] = c.reshape(c.shape[:2] + (lp, page_size) + c.shape[3:])
        step, _ = model.decode_step_paged(cfg, params, logits.argmax(-1).to(torch.int32),
                                          torch.full((B,), S, dtype=torch.int32), pools, table)
    return step.numpy()


def builders_run(cfg, params, batch, mesh):
    """``train.step``'s serving builders on the mesh: the prefill's logits
    and one greedy decode step's, and their placements."""
    from repro_torch.train import step as step_lib

    prefill_fn, _, p_sh, bspec = step_lib.make_prefill(cfg, mesh)
    decode_fn, _, p_sh2, tok_sh, emb_sh = step_lib.make_decode_step(cfg, mesh)
    B, S = batch["tokens"].shape
    logits, caches = prefill_fn(params, batch)
    caches = model.extend_caches(cfg, caches, S + 2)
    step, _ = decode_fn(params, logits.argmax(-1).to(torch.int32),
                        torch.full((B,), S, dtype=torch.int32), caches)
    placements = {"params": p_sh == p_sh2 == model.param_shardings(cfg, mesh, SERVE_RULES),
                  "tokens": bspec("tokens"), "token": tok_sh, "embeds": emb_sh}
    return [logits.numpy(), step.numpy()], placements


def serve(cfg, params, prompts, slots: int, max_new: int, max_context: int, mesh=None,
          matmul=None):
    """Greedy tokens of each request through the contiguous engine."""
    return engine_run(cfg, params, prompts, slots, max_new, max_context, mesh=mesh,
                      matmul=matmul)["tokens"]


# The paged engine runs of the mesh tests: the default pool (every slot's
# full lane) and one full lane, which preempts.
PAGED_RUNS = {"default": dict(page_size=8), "tight": dict(page_size=8, num_pages=4)}


def engine_run(cfg, params, prompts, slots: int, max_new: int, max_context: int, mesh=None,
               **engine_kw) -> dict:
    """The engine (``engine_kw``: its paging) over ``prompts``: each request's
    greedy tokens and recorded logits rows, the preempted requests, the
    pool leaves' local shapes and the slots each physical page was mapped to,
    in order (paged), and the cache report."""
    from repro_torch.obs import ListSink, Tracer

    sink = ListSink()
    eng = Engine(cfg, params, batch_slots=slots, max_context=max_context, mesh=mesh,
                 record_logits=True, tracer=Tracer(sink), **engine_kw)
    page_slots: dict = {}
    if eng.paged:
        def mapping(fn):
            def call(slot, *args):
                out = fn(slot, *args)
                for page in eng.pm.tables[slot][eng.pm.tables[slot] >= 0]:
                    seen = page_slots.setdefault(int(page), [])
                    if not seen or seen[-1] != slot:
                        seen.append(slot)
                return out
            return call

        eng.pm.reserve_prefill = mapping(eng.pm.reserve_prefill)
        eng.pm.ensure = mapping(eng.pm.ensure)
    for rid, toks in enumerate(prompts):
        eng.submit(Request(rid=rid, tokens=toks, max_new_tokens=max_new))
    tokens = {r.rid: list(r.tokens) for r in eng.run()}
    return {"tokens": tokens, "logits": {rid: np.stack(rows)
                                         for rid, rows in eng.logit_trace.items()},
            "preempted": sorted(r["rid"] for r in sink.records if r["kind"] == "preempt"),
            "paged": eng.paged,
            "pool_shapes": ([tuple(t.shape) for t in model.state_leaves(eng.pools)]
                            if eng.paged else None),
            "page_slots": page_slots,
            "cache": eng.cache_report()}


def lm_rank(rank: int, shape, axes, cfg, params, batch, steps, prompts, serve_kw, wide):
    """OLMo smoke on the mesh: the policy's run, the forced-coo run, a run on
    the many-row batch ``wide`` and the engine, with the policy's decisions
    and the sites' last shard counts."""
    mesh = make_mesh(shape, axes)
    pol = dispatch.PhiExecutionPolicy()
    dispatch.set_policy(pol)
    dispatch.register_usage_from_params(params)
    out = {"coords": mesh.coords}
    out["policy"], out["cache_shapes"] = decode_run(cfg, params, batch, steps, mesh)
    coo = cfg.with_(phi=dataclasses.replace(cfg.phi, impl="coo"))
    out["coo"], _ = decode_run(coo, params, batch, steps, mesh)
    out["builders"], out["builder_placements"] = builders_run(cfg, params, batch, mesh)
    # the banks as stored under SERVE_RULES (split over data) and gathered
    # whole over data (pwp_tiles=None): the same steps, bitwise
    whole = _whole_banks(params, mesh)
    out["replicated_banks"], _ = decode_run(cfg, whole, batch, steps, mesh)
    out["bank_shapes"] = {k: (tuple(params_w["pwp"].shape), tuple(whole_w["pwp"].shape),
                              tuple(params_w["patterns"].shape))
                          for k, params_w, whole_w in _phi_entries(params, whole)}
    del whole
    out["wide"], _ = decode_run(cfg, params, wide, 1, mesh)
    out["wide_paged"] = paged_decode_run(cfg, params, wide, 4, mesh)
    out["decisions"] = pol.decisions()
    out["shards"] = {site: pol.last_decision(site).shards
                     for site in ("lm.w1.spmd", "lm.w2.spmd")}
    out["engine"] = engine_run(cfg, params, prompts, mesh=mesh, **serve_kw)
    out["tokens"] = out["engine"]["tokens"]
    out["paged"] = {name: engine_run(cfg, params, prompts, mesh=mesh, paged=True, **serve_kw,
                                     **kw)
                    for name, kw in PAGED_RUNS.items()}
    out["stats"] = {k: list(v) for k, v in mesh.stats.items()}
    return out


def _phi_entries(a, b, path=""):
    """(path, a's phi_* entry, b's) of two params trees of one structure."""
    for k, v in a.items():
        if k.startswith("phi_"):
            yield f"{path}/{k}", v, b[k]
        elif isinstance(v, dict):
            yield from _phi_entries(v, b[k], f"{path}/{k}")


def _whole_banks(node, mesh):
    """A rank's params with each PWP bank stored split over data (fewer
    K-partitions than its patterns) all-gathered whole over data: the
    placement of ``dict(SERVE_RULES, pwp_tiles=None)``."""
    from repro_torch.distributed import collectives as coll

    out = {}
    for k, v in node.items():
        if k.startswith("phi_") and v["pwp"].shape[-3] != v["patterns"].shape[-3]:
            out[k] = dict(v, pwp=coll.all_gather(v["pwp"], mesh, "data", v["pwp"].dim() - 3))
            if "pwp_scale" in v:
                out[k]["pwp_scale"] = coll.all_gather(v["pwp_scale"], mesh, "data",
                                                      v["pwp_scale"].dim() - 2)
        elif isinstance(v, dict):
            out[k] = _whole_banks(v, mesh)
        else:
            out[k] = v
    return out


def moe_run(shape, axes, cfg, p, x):
    """``moe_ep`` of this rank's rows on a new mesh (rows split over data)."""
    mesh = make_mesh(shape, axes)
    stats: dict = {}
    with torch.no_grad(), use_rules(TRAIN_RULES, mesh):
        y = moe.moe_ep(cfg, p, x, stats)
    return y.numpy(), stats


def moe_dense_run(shape, axes, cfg, p, x, rows: int) -> np.ndarray:
    """``moe_impl="dense"`` through ``moe_apply`` on a new mesh under
    ``SERVE_RULES``: this rank's shards ``p`` and its rows ``x`` of a global
    batch of ``rows`` rows split over data."""
    from repro_torch.distributed.sharding import use_batch_rows

    mesh = make_mesh(shape, axes)
    with torch.no_grad(), use_rules(SERVE_RULES, mesh), \
            use_batch_rows(rows, mesh.coords["data"] * x.shape[0]):
        return moe.moe_apply(cfg, p, x).numpy()


def collective_input(rank: int) -> np.ndarray:
    """Rank ``rank``'s input to the collectives check: 8 values."""
    return (np.arange(8, dtype=np.float32) + 100 * rank) * (1 + rank % 3)


def collectives_run() -> dict:
    """all_reduce, all_gather (dim 0) and all_to_all of collective_input on a
    2 × 2 × 2 mesh, over one axis and over two."""
    from repro_torch.distributed import collectives as coll
    import torch.distributed as dist

    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    x = torch.from_numpy(collective_input(dist.get_rank()))
    out = {}
    for ax in ("model", ("pod", "data"), ("pod", "data", "model")):
        out[ax] = {"all_reduce": coll.all_reduce(x, mesh, ax).numpy(),
                   "all_gather": coll.all_gather(x, mesh, ax, 0).numpy(),
                   "all_to_all": coll.all_to_all(x, mesh, ax).numpy()}
    return out


def sub_mesh(shape, axes, size: int):
    """This rank's mesh of ``shape`` among the blocks of ``size`` consecutive
    ranks the world splits into (a mesh built by hand, as ``collectives.Mesh``
    allows): every rank makes every block's groups, in one order."""
    import itertools
    import math

    import torch.distributed as dist
    from repro_torch.distributed.collectives import Mesh

    me = dist.get_rank()
    groups = {}
    local = torch.arange(size).reshape(shape)
    for first in range(0, dist.get_world_size(), size):
        for r in range(1, len(axes) + 1):
            for sub in itertools.combinations(range(len(axes)), r):
                rest = [i for i in range(len(axes)) if i not in sub]
                block = local.permute(*rest, *sub).reshape(-1, math.prod(shape[i] for i in sub))
                for row in (block + first).tolist():
                    g = dist.new_group(ranks=row)
                    if me in row:
                        groups[tuple(axes[i] for i in sub)] = g
    return Mesh(tuple(axes), tuple(shape), rank=me % size, device=torch.device("cpu"),
                backend="gloo", groups=groups)


def _zeros_like_specs(specs, placements, mesh):
    from repro_torch.distributed.sharding import local_shape

    if isinstance(specs, dict):
        return {k: _zeros_like_specs(specs[k], placements[k], mesh) for k in specs}
    return torch.zeros(local_shape(specs.shape, placements, mesh), dtype=specs.dtype)


def _measured(mesh, fn, *args) -> dict:
    """One real step's collective calls and result bytes by kind (the
    reference's kinds, ``mesh.results``), its ``FlopCounterMode`` FLOPs and
    the bytes of its arguments."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.distributed.cost_analysis import COLLECTIVES
    from repro_torch.utils import tree_bytes

    before = {k: list(v) for k, v in mesh.results.items()}
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    calls, nbytes = {}, {}
    for kind in COLLECTIVES:
        c1, b1 = mesh.results.get(kind, [0, 0])
        c0, b0 = before.get(kind, [0, 0])
        calls[kind], nbytes[kind] = c1 - c0, b1 - b0
    return {"collective_calls": calls, "collectives": nbytes, "flops": fc.get_total_flops(),
            "argument_bytes": tree_bytes(args)}


def dryrun_checks_run(phi_cfg, phi_params, prefill_batch, decode_bs, dense_cfg, ocfg,
                      dense_params, train_batch) -> dict:
    """The dry run's cells, run for real on this rank's (data 2, model 2)
    mesh: a Phi prefill and decode step of OLMo smoke and one dense train
    step, each with :func:`_measured`'s counts (a fresh policy, telemetry
    off, as the dry run resolves)."""
    from repro_torch.train import step as step_lib

    mesh = sub_mesh((2, 2), ("data", "model"), 4)
    dispatch.set_policy(dispatch.PhiExecutionPolicy(telemetry=False))
    out = {"coords": mesh.coords}
    fn = step_lib.make_prefill(phi_cfg, mesh)[0]
    out["prefill"] = _measured(mesh, fn, phi_params, prefill_batch)
    B, S = decode_bs
    fn = step_lib.make_decode_step(phi_cfg, mesh)[0]
    state, _ = step_lib.init_decode_state(phi_cfg, B, S, mesh, device="cpu")
    tok = torch.zeros((B,), dtype=torch.int32)
    out["decode"] = _measured(mesh, fn, phi_params, tok, tok.clone(), state, None)
    bundle, _, o_specs, _ = step_lib.make_train_step(dense_cfg, ocfg, mesh)
    opt_state = _zeros_like_specs(o_specs, bundle.in_shardings[1], mesh)
    out["train"] = _measured(mesh, bundle.fn, dense_params, opt_state, train_batch)
    return out


def world_rank(rank: int, lm_args: tuple, moe_args: tuple, dry_args: tuple) -> dict:
    """The test world's body: the OLMo runs, moe_ep on each mesh, moe_dense
    of each dense run (label, mesh shape, axes, cfg, shards, rows, global
    rows), the collectives, the dry run's cells for real."""
    cfg, runs, dense_runs = moe_args
    return {"lm": lm_rank(rank, *lm_args),
            "moe": [moe_run(shape, axes, cfg, p, x) for shape, axes, p, x in runs],
            "moe_dense": {label: moe_dense_run(shape, axes, c, p, x, rows)
                          for label, shape, axes, c, p, x, rows in dense_runs},
            "collectives": collectives_run(),
            "dryrun": dryrun_checks_run(*dry_args)}


# ------------------------------------------------------------- training ---
def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().numpy()


def _gather(tree, placements, mesh):
    """The global numpy values of a tree of this rank's shards."""
    from repro_torch.distributed import collectives as coll

    if isinstance(tree, dict):
        return {k: _gather(tree[k], placements[k], mesh) for k in tree}
    return coll.gather_global(tree, placements, mesh).numpy()


def train_steps(cfg, ocfg, params, batch, mesh, steps: int, rules=None) -> dict:
    """On ``mesh`` under ``rules`` (default ``TRAIN_RULES``): step 1's loss
    and gathered grads, the gathered trainable params after step 1, every
    step's loss, this rank's trainable shards after ``steps`` steps, and the
    policy's decisions."""
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as step_lib
    from repro_torch.distributed.sharding import place

    pol = dispatch.PhiExecutionPolicy()
    prev = dispatch.set_policy(pol)
    try:
        bundle, _, _, _ = step_lib.make_train_step(cfg, ocfg, mesh, rules)
        p_sh, _, _ = bundle.in_shardings
        t_sh = model.split_phi_state(p_sh)[0]
        local = place(params, p_sh, mesh)
        loss, grads = bundle.grads(local, batch)
        out = {"loss": float(loss), "grads": _gather(grads, t_sh, mesh), "losses": []}
        state = opt.init(model.split_phi_state(local)[0], ocfg)
        for i in range(steps):
            local, state, loss = bundle.fn(local, state, batch)
            out["losses"].append(float(loss))
            if i == 0:
                out["after"] = _gather(model.split_phi_state(local)[0], t_sh, mesh)
        out["local"] = _np(model.split_phi_state(local)[0])
        out["placements"] = t_sh
        out["decisions"] = pol.decisions()
    finally:
        dispatch.set_policy(prev)
    return out


def compressed_run(inputs: dict) -> dict:
    """``pod_compressed_grads`` on (pod 2, data 2, model 2): case c0 the
    reference test's (a replicated leaf), case c1 a leaf split over
    ``model`` with a loss that sums its columns' squares over ``model``."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.sharding import local_shard
    from repro_torch.train.grad_compress import pod_compressed_grads

    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    out = {}
    for case, pl in (("c0", ()), ("c1", (None, "model"))):
        w, x, ef = (torch.from_numpy(inputs[f"{case}_{k}"]) for k in ("w", "x", "ef"))
        n_cols = w.shape[1]

        def loss_fn(p, b):
            y = b["x"] @ p["w"]
            return coll.all_reduce((y ** 2).sum(), mesh, pl[1] if pl else None) / (
                y.shape[0] * n_cols)

        stats: dict = {}
        with use_rules(TRAIN_RULES, mesh):
            loss, grads, new_ef = pod_compressed_grads(
                loss_fn, {"w": local_shard(w, pl, mesh).clone()}, {"x": x},
                {"w": local_shard(ef, pl, mesh).clone()}, mesh, placements={"w": pl},
                stats=stats)
        out[case] = {"loss": float(loss),
                     "grads": coll.gather_global(grads["w"], pl, mesh).numpy(),
                     "new_ef": coll.gather_global(new_ef["w"], pl, mesh).numpy(),
                     "scale": stats["w"]}
    out["stats"] = {k: list(v) for k, v in mesh.stats.items()}
    out["coords"] = mesh.coords
    return out


def pipeline_run(inputs: dict) -> np.ndarray:
    """``pipeline_apply`` over pod = 4 on (pod 4, data 2), the reference
    test's stage."""
    from repro_torch.distributed.pipeline import pipeline_apply

    mesh = make_mesh((4, 2), ("pod", "data"))
    s = mesh.coords["pod"]
    params = {k: torch.from_numpy(inputs[f"pipe_{k}"][s:s + 1]) for k in ("w", "b")}

    def stage_fn(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    return pipeline_apply(stage_fn, params, torch.from_numpy(inputs["pipe_x"]), mesh,
                          axis="pod").numpy()


def checkpoint_run(ckpt: str) -> dict:
    """The reference's elastic test: an (8, 8) leaf placed (data, model)
    saved from (4, 2), restored placed (model, data) on (2, 4)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed.sharding import local_shape, local_shard

    tree = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    mesh1 = make_mesh((4, 2), ("data", "model"))
    mgr = CheckpointManager(ckpt, keep=2, async_save=False, mesh=mesh1)
    mgr.save(10, {"w": local_shard(tree, ("data", "model"), mesh1).clone()},
             {"loader": {"step": 7}}, shardings={"w": ("data", "model")})
    mesh2 = make_mesh((2, 4), ("data", "model"))
    like = {"w": torch.zeros(local_shape((8, 8), ("model", "data"), mesh2))}
    step, got, extra = CheckpointManager(ckpt, mesh=mesh2).restore_latest(
        like, shardings={"w": ("model", "data")})
    return {"step": step, "extra": extra, "w": got["w"].numpy(),
            "want": local_shard(tree, ("model", "data"), mesh2).numpy()}


def crash_resume_run(cfg, ocfg, ckpt: str, steps: int, crash: int,
                     meshes=((4, 2), (2, 4)), global_batch: int = 8) -> dict:
    """``train_loop(mesh=)``: ``steps`` uninterrupted steps on the first of
    ``meshes`` ((data, model) shapes); ``crash`` steps on it checkpointed,
    resumed on the second to ``steps``."""
    from repro_torch.launch.train import train_loop

    kw = dict(global_batch=global_batch, seq=32, log_every=0)
    full = train_loop(cfg, ocfg, steps=steps, mesh=make_mesh(meshes[0], ("data", "model")),
                      **kw)[1]
    first = train_loop(cfg, ocfg, steps=crash, ckpt_dir=ckpt, ckpt_every=100,
                       mesh=make_mesh(meshes[0], ("data", "model")), **kw)[1]
    rest = train_loop(cfg, ocfg, steps=steps, ckpt_dir=ckpt,
                      mesh=make_mesh(meshes[1], ("data", "model")), **kw)[1]
    return {"full": full, "resumed": first + rest}


def moe_grad_run(cfg, p, x, g) -> dict:
    """``moe_ep`` on (data 2, model 4) under autograd: the gradients of
    sum(y * g) over this rank's rows with respect to its rows of ``x`` and
    its shards of the weights (the shared expert's as its body reads them:
    ``fsdp`` whole)."""
    from repro_torch.distributed.sharding import place, specs_to_shardings

    mesh = make_mesh((2, 4), ("data", "model"))
    placed = specs_to_shardings(moe.moe_specs(cfg), mesh, dict(TRAIN_RULES, fsdp=None))
    rows = x.shape[0] // 2
    r0 = mesh.coords["data"] * rows
    local = {k: v.requires_grad_() for k, v in place(p, placed, mesh).items()}
    xl = x[r0:r0 + rows].clone().requires_grad_()
    with use_rules(TRAIN_RULES, mesh):
        y = moe.moe_ep(cfg, local, xl)
    gs = torch.autograd.grad((y * g[r0:r0 + rows]).sum(), [xl, *local.values()])
    return {"x": gs[0].numpy(), **{k: t.numpy() for k, t in zip(local, gs[1:])},
            "placements": placed}


def train_world(rank: int, dense_args: tuple, phi_args: tuple, inputs: dict, tmp: str,
                moe_args: tuple, loop_args: tuple, arctic_args: tuple) -> dict:
    """The training test world's body (8 ranks): dense, Phi and Arctic
    (``moe_impl="dense"``) steps on (data 4, model 2), the compressed
    gradients, the pipeline, the elastic checkpoint, a crash and resume
    through ``train_loop`` and ``moe_ep``'s gradients."""
    mesh = make_mesh((4, 2), ("data", "model"))
    return {"coords": mesh.coords,
            "dense": train_steps(*dense_args, mesh=mesh, steps=3),
            "arctic": train_steps(*arctic_args, mesh=mesh, steps=1),
            # no ZeRO-3: every leaf replicated over data, updated on each replica
            "dense_dp": train_steps(*dense_args, mesh=mesh, steps=3,
                                    rules=dict(TRAIN_RULES, fsdp=None)),
            "phi": train_steps(*phi_args, mesh=mesh, steps=1),
            # cfg.remat "full": each layer group checkpointed, its input kept as
            # the rank's block of the sequence over saved_seq (model)
            "dense_remat": train_steps(dense_args[0].with_(remat="full"), *dense_args[1:],
                                       mesh=mesh, steps=1),
            "compressed": compressed_run(inputs),
            "pipeline": pipeline_run(inputs),
            "checkpoint": checkpoint_run(f"{tmp}/elastic"),
            "crash_resume": crash_resume_run(*loop_args, f"{tmp}/loop", 4, 2),
            "moe": [moe_grad_run(*args) for args in moe_args]}


# ------------------------------------------------- the recurrent families ---
def ssm_serve(shape, runs: list) -> dict:
    """On a new (data, model) ``shape`` mesh, each of ``runs`` = (label, cfg,
    params (global), arm, batch, prompts): the rank's shards placed, then
    ``decode_run`` (prefill and 2 decode steps) and the engine's greedy
    tokens under the arm's GEMM (``phi``: the config's own through the
    policy; ``spiking_dense``; ``dense``: a config without spiking), the
    caches' local shapes and the policy's decisions."""
    from repro_torch.distributed.sharding import place

    mesh = make_mesh(shape, ("data", "model"))
    out = {}
    for label, cfg, params, arm, batch, prompts in runs:
        pol = dispatch.PhiExecutionPolicy()
        prev = dispatch.set_policy(pol)
        try:
            local = place(params, model.param_shardings(cfg, mesh, SERVE_RULES), mesh)
            dispatch.register_usage_from_params(local)
            mm = model.spiking_dense_matmul(cfg) if arm == "spiking_dense" else None
            logits, shapes = decode_run(cfg, local, batch, 2, mesh, matmul=mm)
            tokens = serve(cfg, local, prompts, slots=4, max_new=4, max_context=32, mesh=mesh,
                           matmul=mm)
            out[label] = {"logits": logits, "cache_shapes": shapes, "tokens": tokens,
                          "decisions": pol.decisions(),
                          "shards": {s: pol.last_decision(s).shards
                                     for s in {k[0] for k in pol.decisions()}}}
        finally:
            dispatch.set_policy(prev)
    return out


def ssm_world(rank: int, serve_runs: dict, train_runs: list, loop_args: tuple,
              tmp: str) -> dict:
    """The recurrent families' test world (4 ranks): ``serve_runs`` (mesh
    shape -> its runs) on (data 2, model 2) and (data 1, model 4), each train
    run (label, cfg, ocfg, params, batch) one step on (data 2, model 2), and
    a ``train_loop`` crashed on (data 2, model 2) and resumed on (data 1,
    model 4)."""
    mesh = make_mesh((2, 2), ("data", "model"))
    return {"coords": mesh.coords,
            "serve": {shape: ssm_serve(shape, runs) for shape, runs in serve_runs.items()},
            "train": {label: train_steps(cfg, ocfg, params, batch, mesh, steps=1)
                      for label, cfg, ocfg, params, batch in train_runs},
            "crash_resume": crash_resume_run(*loop_args, f"{tmp}/ssm_loop", 4, 2,
                                             meshes=((2, 2), (1, 4)), global_batch=4)}
