"""Rank bodies of the mesh tests (``tests/test_torch_distributed.py``).

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


def decode_run(cfg, params, batch, steps: int, mesh=None):
    """Prefill ``batch`` and ``steps`` greedy decode steps: every step's
    logits (numpy), and the caches' local shapes."""
    B, S = batch["tokens"].shape
    with torch.no_grad(), use_rules(SERVE_RULES, mesh):
        logits, caches = model.prefill(cfg, params, batch)
        caches = model.extend_caches(cfg, caches, S + steps + 1)
        outs = [logits.numpy()]
        tok = logits.argmax(-1).to(torch.int32)
        for t in range(steps):
            pos = torch.full((B,), S + t, dtype=torch.int32)
            logits, caches = model.decode_step(cfg, params, tok, pos, caches)
            outs.append(logits.numpy())
            tok = logits.argmax(-1).to(torch.int32)
    return outs, [tuple(c.shape) for c in model.state_leaves(caches)]


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


def serve(cfg, params, prompts, slots: int, max_new: int, max_context: int, mesh=None):
    """Greedy tokens of each request through the contiguous engine."""
    eng = Engine(cfg, params, batch_slots=slots, max_context=max_context, mesh=mesh)
    for rid, toks in enumerate(prompts):
        eng.submit(Request(rid=rid, tokens=toks, max_new_tokens=max_new))
    return {r.rid: list(r.tokens) for r in eng.run()}


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
    out["wide"], _ = decode_run(cfg, params, wide, 1, mesh)
    out["decisions"] = pol.decisions()
    out["shards"] = {site: pol.last_decision(site).shards
                     for site in ("lm.w1.spmd", "lm.w2.spmd")}
    out["tokens"] = serve(cfg, params, prompts, mesh=mesh, **serve_kw)
    out["stats"] = {k: list(v) for k, v in mesh.stats.items()}
    return out


def moe_run(shape, axes, cfg, p, x):
    """``moe_ep`` of this rank's rows on a new mesh (rows split over data)."""
    mesh = make_mesh(shape, axes)
    stats: dict = {}
    with torch.no_grad(), use_rules(TRAIN_RULES, mesh):
        y = moe.moe_ep(cfg, p, x, stats)
    return y.numpy(), stats


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


def world_rank(rank: int, lm_args: tuple, moe_args: tuple) -> dict:
    """The test world's body: the OLMo runs, moe_ep on each mesh, the
    collectives."""
    cfg, runs = moe_args
    return {"lm": lm_rank(rank, *lm_args),
            "moe": [moe_run(shape, axes, cfg, p, x) for shape, axes, p, x in runs],
            "collectives": collectives_run()}
