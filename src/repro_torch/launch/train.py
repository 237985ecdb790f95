"""Training loop: mesh + data + checkpoint/restore + watchdog in one loop
(port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo_1b --smoke \
        --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt [--phi] [--device cpu]

Runs on ``cuda`` unless ``--device`` names another. On resume the loop
restores params/opt state AND the data cursor, continuing where the saved
run stopped. Checkpoints are in the reference's on-disk format, so either
package resumes the other's. Params are drawn from a generator seeded
``seed`` on the loop's device: the card and the CPU start from different
draws, and a resumed run takes the checkpoint's values.

``train_loop(mesh=)`` trains on a mesh of ranks (every rank of the world
calls it with its own ``Mesh``; the launcher's CLI has no mesh flags, as the
reference's has none): the step is ``make_train_step(cfg, ocfg, mesh,
TRAIN_RULES)``; each rank draws the global params on its device as one
device would (and calibrates them in Phi mode), then keeps its shards, so a
mesh run and a one-device run on the same device start from the same
values; checkpoints are gathered and written by rank 0 and restored onto
the current mesh, whatever mesh saved them. The loss is the same on every
rank; logs, metrics and the tracer's records come from rank 0 only.
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
from repro_torch.data.pipeline import DataConfig, LoaderState, Prefetcher, ShardedLoader
from repro_torch.distributed.collectives import all_reduce
from repro_torch.distributed.sharding import TRAIN_RULES, init_params, place
from repro_torch.distributed.watchdog import StepWatchdog
from repro_torch.kernels import IMPLS, dispatch
from repro_torch.models import model
from repro_torch.train import optimizer as opt
from repro_torch.train import step as step_lib
from repro_torch.utils import StepTimer, log, resolve_device


def train_loop(cfg, ocfg, *, steps: int, global_batch: int, seq: int,
               ckpt_dir: str | None = None, ckpt_every: int = 50,
               mesh=None, seed: int = 0, log_every: int = 10,
               metrics: obs.MetricsRegistry | None = None,
               device: str | torch.device | None = None):
    """Train ``cfg`` for ``steps`` steps (counting those a checkpoint in
    ``ckpt_dir`` already holds). Returns (params, losses of the steps run);
    on a ``mesh``, params are this rank's shards (placements: the step
    bundle's ``in_shardings``), on the mesh's device."""
    rules = TRAIN_RULES
    device = mesh.device if mesh is not None else resolve_device(device)
    lead = mesh is None or mesh.rank == 0
    # Observability: step counters/histograms land in the caller's registry;
    # the process tracer (if installed via --trace-out) gets one "train_step"
    # record per step with the monotonic step counter.
    metrics = metrics if metrics is not None else obs.MetricsRegistry("train")
    m_steps = metrics.counter("steps", "optimizer steps completed")
    m_loss = metrics.gauge("last_loss", "most recent training loss")
    m_step_ms = metrics.histogram("step_ms", "wall time per training step")
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=global_batch, seed=seed)
    loader = ShardedLoader(dcfg)
    mgr = CheckpointManager(ckpt_dir, keep=3, mesh=mesh) if ckpt_dir else None
    if mgr is not None:
        # A persisted Phi impl override must be re-applied before the step
        # function closes over cfg (a live cfg.phi.impl wins over it).
        cfg = dispatch.apply_checkpoint_extra(cfg, mgr.latest_extra())

    if mesh is not None:
        bundle, p_specs, _, _ = step_lib.make_train_step(cfg, ocfg, mesh, rules)
        p_sh, o_sh, _ = bundle.in_shardings
        shardings = {"params": p_sh, "opt": o_sh}
    else:
        bundle, p_specs, _ = step_lib.make_train_step(cfg, ocfg)
        shardings = None
    step_fn = bundle.fn
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(p_specs, gen, device)
    if cfg.spiking and cfg.phi is not None:
        # Spiking-Phi training: fill the zero-initialised Phi state from real
        # spike statistics before the first step (the capture runs the LIF
        # kernel, the usage the matcher kernel). Under autograd every
        # spiking GEMM then resolves the differentiable coo lowering.
        calib = model.dummy_batch(cfg, min(global_batch, 2), seq, with_labels=False,
                                  device=device)
        with torch.no_grad():
            params, _ = model.calibrate_lm_phi(cfg, params, calib)
        if lead:
            log.info("phi calibrated; impl override: %s", cfg.phi.impl or "policy")
    if mesh is not None:
        params = place(params, shardings["params"], mesh)
    opt_state = opt.init(model.split_phi_state(params)[0], ocfg)
    start_step = 0
    if mgr is not None:
        got = mgr.restore_latest({"params": params, "opt": opt_state},
                                 missing_ok=("usage",), shardings=shardings)
        if got[0] is not None:
            start_step, tree, extra = got
            params, opt_state = tree["params"], tree["opt"]
            loader.state = LoaderState.from_dict(extra.get("loader", {"step": 0}))
            if lead:
                log.info("restored checkpoint @ step %d", start_step)

    watchdog = StepWatchdog()
    losses: list[float] = []
    it = iter(Prefetcher(iter(loader)))
    for step in range(start_step, steps):
        batch = next(it)
        with StepTimer() as t:
            params, opt_state, loss = step_fn(
                params, opt_state,
                {k: torch.from_numpy(v).to(device) for k, v in batch.items()})
            loss = float(loss)          # waits for the step
        losses.append(loss)
        step_s = t.history[-1]
        # On a mesh the watchdog's verdict must be the same on every rank
        # (an escalation saves, which every rank joins): rank 0's time.
        step_s = _lead_value(step_s, mesh)
        if lead:
            m_steps.inc()
            m_loss.set(loss)
            m_step_ms.observe(step_s * 1e3)
            tracer = obs.get_tracer()
            if tracer is not None:
                tracer.emit("train_step", step=step + 1, loss=loss)
        verdict = watchdog.record(step_s)
        # Save the CONSUMED cursor (step+1), not loader.state: the
        # prefetcher runs ahead of consumption.
        consumed = {"loader": {"step": step + 1}, **dispatch.checkpoint_extra(cfg)}
        if verdict == "escalate" and mgr is not None:
            mgr.save(step + 1, {"params": params, "opt": opt_state}, consumed, shardings)
        if lead and log_every and (step + 1) % log_every == 0:
            log.info("step %d loss %.4f (median step %.3fs)", step + 1,
                     float(np.mean(losses[-log_every:])), watchdog.median)
        if mgr is not None and (step + 1) % ckpt_every == 0:
            mgr.save(step + 1, {"params": params, "opt": opt_state}, consumed, shardings)
    if mgr is not None:
        mgr.save(steps, {"params": params, "opt": opt_state},
                 {"loader": {"step": steps}, **dispatch.checkpoint_extra(cfg)}, shardings)
        mgr.wait()
    if cfg.spiking and cfg.phi is not None and lead:
        dispatch.get_policy().log_report(prefix="train")
    return params, losses


def _lead_value(x: float, mesh) -> float:
    """``x`` as rank 0 of ``mesh`` has it (``x`` itself off a mesh)."""
    if mesh is None:
        return x
    t = torch.tensor([x if mesh.rank == 0 else 0.0], dtype=torch.float64)
    return float(all_reduce(t.to(mesh.device), mesh, mesh.axis_names)[0])


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo_1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--phi", action="store_true",
                    help="train the spiking+Phi variant of --arch")
    ap.add_argument("--phi-impl", default=None, choices=IMPLS,
                    help="force one Phi kernel lowering; default: the "
                         "execution policy picks per call")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write train_step + dispatch records as JSONL")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the step metrics at exit (Prometheus text "
                         "for .prom/.txt paths, JSON otherwise)")
    ap.add_argument("--device", default="cuda",
                    help="device to train on (default cuda; cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.phi:
        cfg = phi_variant(cfg, timesteps=2, q=16)
        if args.phi_impl:
            cfg = cfg.with_(phi=dataclasses.replace(cfg.phi, impl=args.phi_impl))
    ocfg = opt.OptConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                         decay_steps=args.steps)
    tracer = None
    if args.trace_out:
        tracer = obs.Tracer(obs.JsonlSink(args.trace_out))
        obs.set_tracer(tracer)
    metrics = obs.MetricsRegistry("train")
    t0 = time.time()
    try:
        _, losses = train_loop(cfg, ocfg, steps=args.steps, global_batch=args.batch,
                               seq=args.seq, ckpt_dir=args.ckpt_dir,
                               ckpt_every=args.ckpt_every, metrics=metrics,
                               device=args.device)
    finally:
        if tracer is not None:
            obs.set_tracer(None)
            tracer.close()
    if losses:
        log.info("done: loss %.4f -> %.4f in %.1fs",
                 losses[0], float(np.mean(losses[-10:])), time.time() - t0)
    else:
        log.info("done: nothing to run past the checkpoint (%.1fs)", time.time() - t0)
    if args.metrics_out:
        registries = [metrics]
        if args.phi:
            dispatch.get_policy().metrics_snapshot()    # fold the device counters in
            registries.append(dispatch.get_policy().metrics)
        if args.metrics_out.endswith((".prom", ".txt")):
            body = obs.prometheus_many(registries)
        else:
            body = json.dumps(obs.snapshot_many(registries), sort_keys=True, indent=2)
        with open(args.metrics_out, "w") as f:
            f.write(body)
        log.info("metrics written to %s", args.metrics_out)


if __name__ == "__main__":
    main()
