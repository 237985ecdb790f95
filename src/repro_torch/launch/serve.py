"""Serving launcher: build a config (optionally spiking+Phi), load or init
params, and drive the continuous-batching engine over a synthetic request
stream, reporting throughput/latency/slot-utilisation. Port of
``repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo_1b --smoke \
        --requests 16 --slots 4 [--phi] [--ckpt-dir DIR] [--device cpu] \
        [--host-devices 4 --mesh-model 2] \
        [--trace-out trace.jsonl --metrics-out metrics.prom --obs]

Runs on ``cuda`` unless ``--device`` names another. ``--ckpt-dir`` restores
the params of the newest checkpoint there (``launch.train``'s, or the
reference's: one on-disk format).

A mesh: ``--host-devices N`` spawns N local ranks on ``--device`` (the
reference's N virtual CPU devices; on one card the ranks share it and talk
through gloo), and ``--mesh-model M`` serves on a (N/M data, M model) mesh;
M must divide N. Under ``torchrun`` the world comes from ``RANK`` and
``WORLD_SIZE``. Calibration runs once, on the full params, in one process
(the launcher's, or rank 0 under torchrun); each rank receives only its
shards (``models.model.param_shardings``) and serves the same request stream
through a mesh engine; rank 0 reports.

Observability: ``--trace-out`` streams the request lifecycle + dispatch
records as deterministic JSONL, ``--metrics-out`` writes the merged metric
registries (Prometheus text for ``.prom``/``.txt``, JSON otherwise),
``--obs`` adds wall time on top: the gap between each request's
consecutive tokens (``serve_token_latency_ms``, one observation per decoded
token), and on the trace's records ``wall_ms``, span durations, span ids and
parents and ``start_ns``/``end_ns`` on the profiler's clock.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, phi_variant
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import init_params
from repro_torch.kernels import IMPLS, dispatch
from repro_torch.models import model
from repro_torch.serve.engine import Engine, Request
from repro_torch.utils import log, resolve_device


def restore_params(cfg, params: dict, ckpt_dir: str):
    """The params of the newest checkpoint in ``ckpt_dir``, on the devices and
    dtypes of ``params``. Returns (cfg, params, step); step None (and the
    inputs) where the directory holds none.

    ``usage`` leaves an older checkpoint lacks are zero-filled (the policy
    reads all-zero as "no histogram"); a persisted ``--phi-impl`` override
    is re-applied (a live one wins); the usage histograms riding in the
    params tree are registered with the policy, so its usage gate works
    without a fresh calibration pass.
    """
    step, tree, extra = CheckpointManager(ckpt_dir).restore_latest(
        {"params": params}, missing_ok=("usage",))
    if step is None:
        return cfg, params, None
    cfg = dispatch.apply_checkpoint_extra(cfg, extra)
    n_usage = dispatch.register_usage_from_params(tree["params"])
    log.info("restored params from step %d (%d phi usage histograms)", step, n_usage)
    return cfg, tree["params"], step


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1p5_4b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--phi", action="store_true")
    ap.add_argument("--phi-impl", default=None, choices=IMPLS,
                    help="force one Phi kernel lowering; default: the "
                         "execution policy picks per call")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-context", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--paged", action="store_true",
                    help="serve from a paged KV cache (fixed-size pages + "
                         "page-table indirection; bitwise-identical decode)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page (--paged)")
    ap.add_argument("--pages", type=int, default=None,
                    help="physical page-pool size; undersizing it forces "
                         "scheduler preemption (default: worst case, "
                         "slots * max_context / page_size)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the request/dispatch span trace as JSONL "
                         "(deterministic: monotonic seq/tick counters, no "
                         "wall-clock unless --obs)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the merged metric registries at exit — "
                         "Prometheus text exposition for .prom/.txt paths, "
                         "JSON snapshot otherwise")
    ap.add_argument("--obs", action="store_true",
                    help="enable wall-time observation: each decoded token's "
                         "gap since its request's previous token (p50/p99 "
                         "logged) and wall_ms, durations, ids and start_ns/end_ns "
                         "on trace records")
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve the params of the newest checkpoint here")
    ap.add_argument("--device", default="cuda",
                    help="device to serve on (default cuda; cpu runs the "
                         "kernels' plain versions)")
    ap.add_argument("--host-devices", type=int, default=0,
                    help="spawn N local ranks on --device and serve on a mesh "
                         "of them (0 = one process)")
    ap.add_argument("--mesh-model", type=int, default=0,
                    help="model-parallel ways: builds a (data, model) mesh over "
                         "the ranks and serves the Phi GEMMs per rank "
                         "(0 = one device)")
    ap.add_argument("--timeout", type=float, default=1800.0,
                    help="seconds a mesh of ranks may take, and each collective")
    return ap.parse_args(argv)


def build(args: argparse.Namespace, device: torch.device):
    """(cfg, params): the config, its params (seed 0, or the checkpoint's),
    Phi-calibrated with ``--phi`` (the nnz budget set from the calibration's
    L2 density)."""
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.phi:
        cfg = phi_variant(cfg, timesteps=2, q=16)
        if args.phi_impl:
            cfg = cfg.with_(phi=dataclasses.replace(cfg.phi, impl=args.phi_impl))
    params = init_params(model.lm_specs(cfg), torch.Generator().manual_seed(0), device)
    if args.ckpt_dir:
        cfg, params, _ = restore_params(cfg, params, args.ckpt_dir)
    if args.phi:
        batch = model.dummy_batch(cfg, 2, 16, with_labels=False, device=device)
        with torch.no_grad():
            params, stats = model.calibrate_lm_phi(cfg, params, batch)
        maxd = max(s.l2_density for s in stats.values())
        cfg = cfg.with_(phi=dataclasses.replace(
            cfg.phi, nnz_budget=min(0.9, 2 * maxd + 0.05)))
        log.info("phi calibrated (max L2 density %.3f)", maxd)
    return cfg, params


def mesh_shape(args: argparse.Namespace, world: int) -> tuple[int, int]:
    """(data, model) of ``world`` ranks under ``--mesh-model`` (refused where
    it does not divide them)."""
    m = max(args.mesh_model, 1)
    if world % m:
        raise SystemExit(f"--mesh-model {args.mesh_model} does not divide {world} ranks "
                         "(try --host-devices)")
    return world // m, m


def serve(cfg, params, args: argparse.Namespace, mesh=None, report: bool = True) -> dict:
    """Drive the engine over the synthetic request stream (the same on every
    rank); log its throughput, scheduler and cache reports and write the
    trace and metrics where ``report``. Returns {rid: tokens}."""
    tracer = None
    if args.trace_out and report:
        # Installed process-wide so the dispatch policy's per-call records
        # interleave with the engine's lifecycle spans in one stream.
        tracer = obs.Tracer(obs.JsonlSink(args.trace_out), wall_time=args.obs)
        obs.set_tracer(tracer)
    try:
        eng = Engine(cfg, params, batch_slots=args.slots, max_context=args.max_context,
                     paged=args.paged, page_size=args.page_size, num_pages=args.pages,
                     tracer=tracer, wall_time=args.obs, mesh=mesh)
        rng = np.random.default_rng(0)
        t_sub = time.time()
        for rid in range(args.requests):
            plen = int(rng.integers(4, args.max_context // 4))
            eng.submit(Request(rid=rid, tokens=rng.integers(3, cfg.vocab, plen),
                               max_new_tokens=args.max_new,
                               temperature=args.temperature))
        results = eng.run()
        dt = time.time() - t_sub
    finally:
        if tracer is not None:
            obs.set_tracer(None)
            tracer.close()
    if report:
        _report(eng, cfg, args, results, dt, tracer, mesh)
    return {r.rid: list(r.tokens) for r in results}


def _report(eng, cfg, args, results, dt, tracer, mesh) -> None:
    where = eng.device if mesh is None else f"a {mesh.shape} mesh ({mesh.transport})"
    log.info("served %d/%d requests on %s | %d tokens in %.1fs = %.1f tok/s | "
             "%d ticks, slot util %.0f%%",
             len(results), args.requests, where, eng.decoded_tokens, dt,
             eng.decoded_tokens / max(dt, 1e-9), eng.ticks,
             100.0 * eng.decoded_tokens / max(eng.ticks * args.slots, 1))
    rep = eng.serve_report()
    log.info("scheduler decisions: %s", rep["scheduler_decisions"])
    cache = rep["cache"]
    whose = f" ({cache['bytes_of']}'s bytes)" if "bytes_of" in cache else ""
    if rep["paged"]:
        log.info("paged cache%s: %d pages x %d tokens, pools %d bytes, hwm %d pages "
                 "(%d bytes) vs contiguous %d bytes", whose,
                 cache["num_pages"], cache["page_size"], cache["pool_bytes"],
                 cache["hwm_pages"], cache["page_hwm_bytes"],
                 cache["contig_cache_bytes"])
    else:
        log.info("contiguous cache%s: %d bytes", whose, cache["contig_cache_bytes"])
    if mesh is not None:
        log.info("collectives (calls, bytes) on rank 0: %s", mesh.stats)
    if args.obs:
        hist = eng.metrics.get("token_latency_ms")
        log.info("inter-token gap p50 %.3fms p99 %.3fms (%d decoded tokens)",
                 hist.percentile(50), hist.percentile(99), hist.count())
    registries = [eng.metrics]
    if args.phi:
        dispatch.get_policy().metrics_snapshot()    # fold the device counters in
        registries.append(dispatch.get_policy().metrics)
    if args.metrics_out:
        if args.metrics_out.endswith((".prom", ".txt")):
            body = obs.prometheus_many(registries)
        else:
            body = json.dumps(obs.snapshot_many(registries), sort_keys=True, indent=2)
        with open(args.metrics_out, "w") as f:
            f.write(body)
        log.info("metrics written to %s", args.metrics_out)
    if tracer is not None:
        log.info("trace written to %s (%d spans)", args.trace_out,
                 sum(tracer.kind_counts.values()))


def _rank_serve(rank: int, cfg, params: dict, args: argparse.Namespace,
                shape: tuple[int, int]) -> dict:
    """One spawned rank: the mesh over the world, the usage histograms of its
    shards registered with its policy, the engine on its shards."""
    from repro_torch.launch.mesh import make_mesh

    if rank:
        log.setLevel("WARNING")
    mesh = make_mesh(shape, ("data", "model"))
    dispatch.register_usage_from_params(params)
    return serve(cfg, params, args, mesh=mesh, report=rank == 0)


def _shards(cfg, params: dict, shape: tuple[int, int]) -> list[dict]:
    """Every rank's shards of the full ``params``, in rank order; ranks that
    hold the same slices share one copy."""
    import types

    axes = ("data", "model")
    grid = types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)))
    placements = model.param_shardings(cfg, grid, shd.SERVE_RULES)
    used = {a for ax in _entries(placements) for a in shd.axis_names_of(ax)}
    cut: dict = {}
    out = []
    for r in range(shape[0] * shape[1]):
        coords = {"data": r // shape[1], "model": r % shape[1]}
        key = tuple(coords[a] for a in axes if a in used)
        if key not in cut:
            cut[key] = shd.place(params, placements, grid, coords)
        out.append(cut[key])
    return out


def _entries(placements) -> set:
    out: set = set()
    for v in placements.values():
        out |= _entries(v) if isinstance(v, dict) else set(v)
    return out


def _torchrun_serve(args: argparse.Namespace, device: torch.device) -> dict:
    """Serve as one rank of a torchrun world: rank 0 builds and calibrates
    the full params and sends every other rank its shards (card to card
    under NCCL, through host memory under gloo); the config, with the
    calibrated nnz budget, goes first as one object."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_world, make_mesh

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    init_world(rank, world, device=device.type, timeout=args.timeout)
    shape = mesh_shape(args, world)
    try:
        mesh = make_mesh(shape, ("data", "model"))
        box = [None]
        if rank == 0:
            cfg, params = build(args, mesh.device)
            shards = _shards(cfg, params, shape)
            box = [cfg]
        dist.broadcast_object_list(box, src=0)
        cfg = box[0]
        placements = model.param_shardings(cfg, mesh, shd.SERVE_RULES)
        specs = model.lm_specs(cfg)
        wire = mesh.device if mesh.backend == "nccl" else torch.device("cpu")

        def move(spec_node, place_node, path):
            if shd.is_spec(spec_node):
                if rank == 0:
                    mine = None
                    for r in range(world):
                        t = _at(shards[r], path)
                        if r == 0:
                            mine = t.to(mesh.device)
                        else:
                            dist.send(t.to(wire).contiguous(), dst=r)
                    return mine
                buf = torch.empty(shd.local_shape(spec_node.shape, place_node, mesh),
                                  dtype=spec_node.dtype, device=wire)
                dist.recv(buf, src=0)
                return buf.to(mesh.device)
            return {k: move(spec_node[k], place_node[k], path + (k,)) for k in spec_node}

        local = move(specs, placements, ())
        if rank == 0:
            del params, shards
        if rank:
            log.setLevel("WARNING")
        dispatch.register_usage_from_params(local)
        return serve(cfg, local, args, mesh=mesh, report=rank == 0)
    finally:
        dist.destroy_process_group()


def _at(tree: dict, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def main(argv: list[str] | None = None) -> dict:
    """Serve as the flags say; returns {rid: generated tokens}."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and "RANK" in os.environ:
        return _torchrun_serve(args, device)
    if args.host_devices > 1:
        from repro_torch.launch.mesh import spawn_ranks

        shape = mesh_shape(args, args.host_devices)
        cfg, params = build(args, device)
        shards = _shards(cfg, params, shape)
        del params
        log.info("serving on a %s mesh of %d ranks on %s", dict(zip(("data", "model"), shape)),
                 args.host_devices, device)
        out = spawn_ranks(_rank_serve, args.host_devices,
                          [(cfg, shards[r], args, shape) for r in range(args.host_devices)],
                          device=device.type, timeout=args.timeout,
                          threads=max(1, (os.cpu_count() or 1) // args.host_devices))
        return out[0]
    if args.mesh_model > 1:
        raise SystemExit(f"--mesh-model {args.mesh_model} needs a world of ranks: give "
                         "--host-devices, or start under torchrun")
    cfg, params = build(args, device)
    return serve(cfg, params, args)


if __name__ == "__main__":
    main()
