"""Readings of a cell's program and of its control, seed by seed, in one process.

    python3 phibench/control.py --workload <cell> --seeds 1,2,3 --seconds <s> [--controls n]

The control is the reference put in the program's place and computed in the
precision the configuration names under ``controls`` (the nearest below the
one it states). Each seed prints one JSON line: the run's checks (the
program's readings) and, for the first ``--controls`` seeds (all by
default), the controls' readings on the same answers. The weights come
from the configuration's ``weights_seed`` alone, so the language model's
Phi calibration, which depends on nothing else, is made once and reused by
every seed's run. The benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--controls", type=int, default=None)
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch

    from phibench import harness, spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("phibench: the control runs on the card", file=sys.stderr)
        return 3
    _calibrate_once()
    seeds = [int(s) for s in args.seeds.split(",")]
    n_ctrl = len(seeds) if args.controls is None else args.controls
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        res = harness.run_cell(cell, seed, args.seconds, False, torch.device("cuda", 0),
                               t0, control=i < n_ctrl)
        print(json.dumps({"seed": seed, "correct": res["correct"], "checks": res["checks"],
                          "control": res.get("control"), "metrics": res["metrics"],
                          "run_s": time.perf_counter() - t0}), flush=True)
    return 0


def _calibrate_once() -> None:
    """Make ``calibrate_lm_phi`` return its first answer to every later call."""
    from repro_torch.models import model

    real, memo = model.calibrate_lm_phi, []

    def once(*a, **k):
        if not memo:
            memo.append(real(*a, **k))
        return memo[0]

    model.calibrate_lm_phi = once


if __name__ == "__main__":
    sys.exit(main())
