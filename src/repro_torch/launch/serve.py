"""Serving launcher: build a config (optionally spiking+Phi), load or init
params, and drive the continuous-batching engine over a synthetic request
stream, reporting throughput/latency/slot-utilisation. Port of
``repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo_1b --smoke \
        --requests 16 --slots 4 [--phi] [--ckpt-dir DIR] [--device cpu] \
        [--trace-out trace.jsonl --metrics-out metrics.prom --obs]

Runs on ``cuda`` unless ``--device`` names another. ``--ckpt-dir`` restores
the params of the newest checkpoint there (``launch.train``'s, or the
reference's: one on-disk format). The reference's ``--host-devices`` and
``--mesh-model`` (multi-device) have no counterpart yet.

Observability: ``--trace-out`` streams the request lifecycle + dispatch
records as deterministic JSONL, ``--metrics-out`` writes the merged metric
registries (Prometheus text for ``.prom``/``.txt``, JSON otherwise),
``--obs`` adds wall-time sampling (per-token latency histogram, span
durations) on top.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, phi_variant
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


def main(argv: list[str] | None = None) -> None:
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
                    help="enable wall-time observation: per-token latency "
                         "histogram (p50/p99 logged) and wall_ms fields on "
                         "trace spans")
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve the params of the newest checkpoint here")
    ap.add_argument("--device", default="cuda",
                    help="device to serve on (default cuda; cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

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

    tracer = None
    if args.trace_out:
        # Installed process-wide so the dispatch policy's per-call records
        # interleave with the engine's lifecycle spans in one stream.
        tracer = obs.Tracer(obs.JsonlSink(args.trace_out), wall_time=args.obs)
        obs.set_tracer(tracer)
    try:
        eng = Engine(cfg, params, batch_slots=args.slots, max_context=args.max_context,
                     paged=args.paged, page_size=args.page_size, num_pages=args.pages,
                     tracer=tracer, wall_time=args.obs)
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
    log.info("served %d/%d requests on %s | %d tokens in %.1fs = %.1f tok/s | "
             "%d ticks, slot util %.0f%%",
             len(results), args.requests, device, eng.decoded_tokens, dt,
             eng.decoded_tokens / max(dt, 1e-9), eng.ticks,
             100.0 * eng.decoded_tokens / max(eng.ticks * args.slots, 1))
    rep = eng.serve_report()
    log.info("scheduler decisions: %s", rep["scheduler_decisions"])
    cache = rep["cache"]
    if rep["paged"]:
        log.info("paged cache: %d pages x %d tokens, hwm %d pages "
                 "(%d bytes) vs contiguous %d bytes",
                 cache["num_pages"], cache["page_size"],
                 cache["hwm_pages"], cache["page_hwm_bytes"],
                 cache["contig_cache_bytes"])
    if args.obs:
        hist = eng.metrics.get("token_latency_ms")
        log.info("token latency p50 %.3fms p99 %.3fms (%d tokens)",
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


if __name__ == "__main__":
    main()
