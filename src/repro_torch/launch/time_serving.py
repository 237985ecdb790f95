"""Time one device's serving steps at a realistic slot count and context.

For each architecture named: Phi spiking mode at full width (depth cut
where it is named ``arch:depth``), params from a seeded generator on the card on the
2^-10 grid, ``calibrate_lm_phi`` on 2 x 128 tokens as ``chip_smoke.py``'s
serving phases do; then CUDA-event times of ``model.prefill`` at
``--prefill`` (B, S) and of ``model.decode_step`` over ``--slots`` slots
whose caches hold ``--context`` positions, every slot attending to all but
the last two. Prints one JSON object a line, the card's name and power limit
in each.

    python src/repro_torch/launch/time_serving.py \\
        --arch olmo_1b:4 --arch zamba2_1p2b --slots 64 --context 4096

It uses only entry points that one device's serving path has had since the
LM stack was ported, so the same file times an older checkout of the port
(``PYTHONPATH=<that checkout>/src``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess

import torch


def cuda_ms(fn, runs: int, warmup: int = 1) -> list[float]:
    """CUDA-event times of ``runs`` calls of ``fn`` after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def time_arch(arch: str, layers: int | None, slots: int, context: int, prefill: tuple,
              runs: int, seed: int) -> dict:
    from repro_torch.configs import get_config, phi_variant
    from repro_torch.distributed.sharding import init_params
    from repro_torch.models import model

    dev = torch.device("cuda")
    cfg = phi_variant(get_config(arch))
    if layers is not None:
        cfg = cfg.with_(n_layers=layers)
    with torch.no_grad():
        params = init_params(model.lm_specs(cfg), torch.Generator(device=dev).manual_seed(seed),
                             dev)
        for leaf in _leaves(model.split_phi_state(params)[0]):
            leaf.copy_((leaf * 1024).round() / 1024)
        calib = model.dummy_batch(cfg, 2, 128, False, torch.Generator().manual_seed(seed), dev)
        params, stats = model.calibrate_lm_phi(cfg, params, calib)
        maxd = max(st.l2_density for st in stats.values())
        cfg = cfg.with_(phi=dataclasses.replace(cfg.phi, nnz_budget=min(0.9, 2 * maxd + 0.05)))
        batch = model.dummy_batch(cfg, *prefill, False, torch.Generator().manual_seed(seed + 1),
                                  dev)
        _reset_peak()
        prefill_ms = cuda_ms(lambda: model.prefill(cfg, params, batch), runs)
        prefill_peak = torch.cuda.max_memory_allocated()
        state = model.init_decode_state(cfg, slots, context, dev)
        tok = torch.full((slots,), 7, dtype=torch.int32, device=dev)
        pos = torch.full((slots,), context - 2, dtype=torch.int32, device=dev)
        _reset_peak()
        decode_ms = cuda_ms(lambda: model.decode_step(cfg, params, tok, pos, state), runs)
        decode_peak = torch.cuda.max_memory_allocated()
    del params, state
    return {"arch": arch, "layers": cfg.n_layers, "prefill": list(prefill),
            "prefill_ms": prefill_ms, "prefill_ms_median": statistics.median(prefill_ms),
            "prefill_peak_bytes": prefill_peak, "slots": slots, "context": context,
            "decode_ms": decode_ms, "decode_ms_median": statistics.median(decode_ms),
            "decode_peak_bytes": decode_peak}


def _reset_peak() -> None:
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", action="append", required=True,
                    help="an architecture, optionally cut to a depth: olmo_1b:4")
    ap.add_argument("--slots", type=int, default=64)
    ap.add_argument("--context", type=int, default=4096)
    ap.add_argument("--prefill", type=int, nargs=2, default=(1, 1024), metavar=("B", "S"))
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--label", default="", help="a tag copied into each line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_serving: no card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    for spec in args.arch:
        name, _, depth = spec.partition(":")
        row = time_arch(name, int(depth) if depth else None, args.slots, args.context,
                        tuple(args.prefill), args.runs, args.seed)
        print(json.dumps({"label": args.label, "card": smi, **row}), flush=True)


if __name__ == "__main__":
    main()
