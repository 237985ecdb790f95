"""One run of one cell: set up the program, measure a window, judge what it
produced against the plain reference, print the result line.

The last line of standard output is the result: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
the ``breakdown``, and last ``checks``: each number compared with its limit.
The same numbers close standard error.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import sys
import time

import torch

from phibench import devtrace, spec
from phibench.work import Work

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Run:
    """What one run measured; the metric readers read it."""

    cell: spec.Cell
    seed: int
    trace: bool
    device: torch.device
    setup_s: float = 0.0
    window_s: float = 0.0
    work: Work = dataclasses.field(default_factory=Work)
    records: dict = dataclasses.field(default_factory=dict)
    summary: devtrace.Summary | None = None
    attempted: int = 0
    failed: int = 0


def forbidden_modules() -> list[str]:
    """Loaded modules of JAX or of the JAX package, by whole top-level name."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def card_info() -> dict:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return {}
    return {"nvidia_smi": out[0]} if out else {}


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t_process: float, control: bool = False) -> dict:
    """Run ``cell`` once; returns the result object (and, with ``control``,
    the control's readings under ``control``)."""
    drv = spec.driver(cell.traffic)
    run = Run(cell=cell, seed=seed, trace=trace, device=device)
    state = drv.setup(run)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    run.setup_s = time.perf_counter() - t_process
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with profile(activities=acts) as prof:
            with record_function(devtrace.WINDOW):
                drv.window(state, run, seconds)
        run.summary = devtrace.summarize(prof)
        del prof
    else:
        drv.window(state, run, seconds)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    drv.account(state, run)
    sample = drv.release(state)
    del state
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks, ok, ctrl = drv.check(run, sample, control)
    entries = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in entries:
        value = spec.metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if run.summary is not None:
        dev.update(busy_s=run.summary.busy_s, window_s=run.summary.window_s)
    result = {"correct": bool(ok and run.failed == 0), "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics, "device": dev}
    if run.summary is not None:
        result["breakdown"] = run.summary.breakdown
    checks["failed"] = {"value": run.failed, "limit": 0}
    result["checks"] = checks
    if control:
        result["control"] = ctrl
    return result


def parse(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def emit(result: dict) -> None:
    """The checks on standard error, then the result line on standard output."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


def main(argv: list[str] | None, t_process: float) -> int:
    args = parse(argv)
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"phibench: {args.workload} needs {cell.chips} CUDA device(s); found {n}",
              file=sys.stderr)
        return 3
    info = card_info()
    if info:
        print(f"phibench: {info['nvidia_smi']}", file=sys.stderr, flush=True)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), t_process)
    found = forbidden_modules()
    if found:
        print(f"phibench: the run loaded JAX or the JAX package: {found}", file=sys.stderr)
        return 4
    result["device"].update(info)
    emit(result)
    return 0
