#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, one JSON object per line, in order: ``env`` (versions, the card),
``build`` (nvcc time), ``main_path`` (calibrate, then Phi inference over four
batches of the VGG configuration at VGG-16 stage widths, logits bitwise
equal to dense inference), ``parity`` (each kernel against its plain PyTorch
version on the main path's tensors), ``timing`` (CUDA events) and the
``kernels`` summary. The card's ``nvidia-smi`` name and power limit sit on
their own line before the summary; the last line is the result object.

Any failure raises and exits non-zero: no phase is caught. Without a CUDA
card, or run where ``src/repro_torch`` is not beside it, it exits 1 and
prints no result. It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Configuration of the slice: one conv per VGG-16 stage at VGG-16's CIFAR
# widths (the kind="vgg" builder pools after every conv, so a 32x32 input
# admits five); depth is the only reduction (5 convs instead of 13).
WIDTHS = (64, 128, 256, 512, 512)
BATCH = 32
BATCHES = 4
GAIN = 3.0     # every weight but conv0's: keeps spikes alive at depth (random init)
SEED = 0

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 CUDA-core FLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def dyadic(x):
    """Round onto the 2^-10 grid: every Phi partial sum is then exact."""
    return (x * 1024).round() / 1024


def cuda_time_ms(fn, runs: int = 15, warmup: int = 3) -> float:
    """Median of ``runs`` timings of ``fn`` with CUDA events, after a warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_profile(fn, wall_ms: float) -> dict:
    """Device time of one call of ``fn`` by kernel, from ``torch.profiler``.

    ``busy_share`` is the summed kernel time over ``wall_ms``, the call's time
    measured with CUDA events outside the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [(ev.key, ev.device_time_total / 1e3, ev.count) for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in kernels)
    return {"device_ms": device_ms, "wall_ms": wall_ms, "busy_share": device_ms / wall_ms,
            "top": [[name[:90], ms, n] for name, ms, n in kernels[:10]]}


def fused_bound_ms(M, K, N, T, q, k, l2_entries) -> tuple[float, float]:
    """Least time for one fused Phi matmul: bytes (inputs once, output once)
    against HBM, float32 operations of this run's data against the CUDA-core
    peak (L1: a multiply and an add per row, partition and column; L2: an add
    per residual entry and column; the final add). The integer match work is
    not counted: the table of peaks has no integer CUDA-core rate."""
    nbytes = 4 * M * K + T * q * k + 4 * T * (q + 1) * N + 4 * T * (q + 1) + 4 * K * N \
        + 4 * M * N + 4 * -(-M // 256)
    flops = 2 * M * T * N + l2_entries * N + M * N
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3


def lif_bound_ms(T, n) -> tuple[float, float]:
    """Least time for the LIF sequence: read the currents and write the spikes
    once; three float32 operations per neuron-step."""
    return 8 * T * n / HBM_BYTES_PER_S * 1e3, 3 * T * n / F32_FLOP_PER_S * 1e3


def bound(rows) -> tuple[float, str]:
    """Sum of per-call bounds, and what bounds the sum (bytes or operations)."""
    total = sum(max(r["bytes_ms"], r["ops_ms"]) for r in rows)
    by = "bytes" if sum(r["bytes_ms"] for r in rows) >= sum(r["ops_ms"] for r in rows) \
        else "operations"
    return total, by


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA card",
              file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a checkout of the repo",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))

    from repro_torch.core.assign import phi_stats
    from repro_torch.core.patterns import PhiConfig, pattern_weight_products, quantize_pwp
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.lif import lif_sequence_cuda, lif_sequence_plain, lif_step_cuda
    from repro_torch.kernels.phi_fused import phi_fused_cuda, phi_fused_plain
    from repro_torch.snn import lif as snn_lif
    from repro_torch.snn import models as M
    from repro_torch.snn.data import synthetic_images

    dev = torch.device("cuda", 0)
    # Float32 GEMMs in full float32: TF32 would round the weights.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---------------------------------------------------------------- env ---
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    emit({"phase": "env", "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                   "cudnn": torch.backends.cudnn.allow_tf32}})

    # -------------------------------------------------------------- build ---
    t0 = time.perf_counter()
    _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.build_info.get("seconds"),
          "ptxas": _build.build_info.get("ptxas", [])})

    # ---------------------------------------------------------- main path ---
    cfg = M.SNNConfig(kind="vgg", widths=WIDTHS, input_size=32, input_channels=3,
                      num_classes=10, timesteps=4, phi=PhiConfig(k=16, q=128, iters=20))
    params = M.init(cfg, torch.Generator().manual_seed(SEED), device=dev)
    raw_w = {}  # gained but not rounded: the kernel-parity check off the grid
    for name, leaf in params.items():
        raw_w[name] = leaf["w"] * (1.0 if name == "conv0" else GAIN)
        leaf["w"] = dyadic(raw_w[name])
    images, _ = synthetic_images(BATCH * (1 + BATCHES), size=32, seed=SEED)
    images = dyadic(torch.from_numpy(images)).to(dev)
    calib_x, batches = images[:BATCH], images[BATCH:].split(BATCH)

    phi_fused_cuda.launches = lif_sequence_cuda.launches = lif_step_cuda.launches = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        state, acts = M.calibrate_model(params, cfg, calib_x)
        torch.cuda.synchronize()
        calib_s = time.perf_counter() - t0
        logits = []
        for x in batches:
            phi_logits = M.phi_apply(params, cfg, state, x)
            dense_logits = M.apply(params, cfg, x)
            logits.append((phi_logits, dense_logits))
        torch.cuda.synchronize()
    launches = {"phi_fused": phi_fused_cuda.launches,
                "lif_sequence": lif_sequence_cuda.launches,
                "lif_step": lif_step_cuda.launches}
    main_s = time.perf_counter() - t0

    for i, (p, d) in enumerate(logits):
        if p.shape != (BATCH, 10) or not torch.isfinite(p).all():
            raise AssertionError(f"batch {i}: logits {tuple(p.shape)} not finite/(B, 10)")
        if not torch.equal(p, d):
            raise AssertionError(f"batch {i}: phi_apply logits differ from dense apply, max "
                                 f"|diff| {float((p - d).abs().max())}")
        if float(p.abs().sum()) == 0:
            raise AssertionError(f"batch {i}: all logits are zero (no spikes reached the head)")
    n_phi = len(state.patterns)
    if launches["phi_fused"] != BATCHES * n_phi or n_phi != 5:
        raise AssertionError(f"fused launches {launches['phi_fused']} != {BATCHES} x 5")
    if launches["lif_sequence"] <= 0:
        raise AssertionError("the LIF sequence kernel never launched on the main path")

    layers = {}
    for name, act in acts.items():
        w = params[name]["w"]
        w2 = w.reshape(-1, w.shape[-1])
        st = phi_stats(act, state.patterns[name])
        T, q, k = state.patterns[name].shape
        layers[name] = {"M": act.shape[0], "K": act.shape[1], "N": w2.shape[1], "T": T,
                        "density": float(act.mean()), "l1_density": st.l1_density,
                        "l2_density": st.l2_density, "idx_density": st.idx_density,
                        "pwp_bytes": state.pwp[name].numel() * state.pwp[name].element_size()}
        if layers[name]["density"] < 0.01:
            raise AssertionError(f"{name}: input spike density {layers[name]['density']} < 1%")
    # The card's logits against the plain versions on the CPU, same input.
    cpu_params = {n: {"w": leaf["w"].cpu()} for n, leaf in params.items()}
    cpu_state = M.PhiState({n: p.cpu() for n, p in state.patterns.items()},
                           {n: p.cpu() for n, p in state.pwp.items()}, state.usage)
    cpu_logits = M.phi_apply(cpu_params, cfg, cpu_state, batches[0].cpu())
    if not torch.equal(cpu_logits, logits[0][0].cpu()):
        raise AssertionError("card logits differ from the CPU plain-version logits")
    emit({"phase": "main_path", "config": {"kind": cfg.kind, "widths": cfg.widths,
                                           "input_size": cfg.input_size,
                                           "timesteps": cfg.timesteps, "k": cfg.phi.k,
                                           "q": cfg.phi.q, "iters": cfg.phi.iters,
                                           "batch": BATCH, "batches": BATCHES},
          "calibrate_s": calib_s, "main_path_s": main_s, "launches": launches,
          "logits_bitwise_equal_dense": True, "logits_equal_cpu_plain": True,
          "layers": layers})

    # ------------------------------------------------------------- parity ---
    def fused_args(name, w2, pwp=None, scale=None):
        pats = state.patterns[name]
        pwp = state.pwp[name] if pwp is None else pwp
        scale = torch.ones(pwp.shape[:2], device=dev) if scale is None else scale
        return [acts[name].contiguous(), pats, pwp, scale, w2]

    fused_err, fused_checks = 0.0, []
    for name in acts:
        w2 = params[name]["w"].reshape(-1, layers[name]["N"])
        L, T = layers[name], layers[name]["T"]
        cases = {"f32": fused_args(name, w2)}
        cases["bf16"] = fused_args(name, w2, state.pwp[name].to(torch.bfloat16))
        q8, sc = quantize_pwp(state.pwp[name])
        cases["int8"] = fused_args(name, w2, q8, sc)
        ragged = fused_args(name, w2)
        ragged[0] = torch.cat([ragged[0], ragged[0][:37]])
        cases["ragged_m"] = ragged
        packed = state.packed[name]
        for case, args in cases.items():
            out, nnz = phi_fused_cuda(*args, block_m=256, packed=packed)
            pout, pnnz = phi_fused_plain(*args, block_m=256)
            torch.cuda.synchronize()
            if not (torch.equal(out, pout) and torch.equal(nnz, pnnz)):
                raise AssertionError(f"{name} {case}: fused kernel != plain version, max |diff| "
                                     f"{float((out - pout).abs().max())}")
            if case == "f32" and int(nnz.sum()) != round(L["l2_density"] * L["M"] * L["K"]):
                raise AssertionError(f"{name}: l2_nnz {int(nnz.sum())} disagrees with phi_stats")
        # Off the 2^-10 grid only the order of each partition's <= k-term L2
        # sum differs (ascending set bits in the kernel, a matmul in the plain
        # version). Bound: T partitions x k terms x k*max|w| x 2^-24.
        wr = raw_w[name].reshape(-1, L["N"])
        pwp_r = pattern_weight_products(state.patterns[name], wr)
        args = fused_args(name, wr, pwp_r)
        out, _ = phi_fused_cuda(*args, block_m=256, packed=packed)
        pout, _ = phi_fused_plain(*args, block_m=256)
        err = float((out - pout).abs().max())
        tol = T * 16 * 16 * float(wr.abs().max()) * 2.0 ** -24
        if err > tol:
            raise AssertionError(f"{name} unrounded weights: max |diff| {err} > {tol}")
        fused_err = max(fused_err, err)
        fused_checks.append({"layer": name, "bitwise": list(cases), "unrounded_err": err,
                             "unrounded_tol": tol})
    refused = []
    for what, call in (
        ("k=128", lambda: phi_fused_cuda(
            torch.zeros((8, 128), device=dev), torch.zeros((1, 4, 128), device=dev),
            torch.zeros((1, 5, 8), device=dev), torch.ones((1, 5), device=dev),
            torch.zeros((128, 8), device=dev), block_m=8)),
        ("q=1024", lambda: phi_fused_cuda(
            torch.zeros((8, 16), device=dev), torch.zeros((1, 1024, 16), device=dev),
            torch.zeros((1, 1025, 8), device=dev), torch.ones((1, 1025), device=dev),
            torch.zeros((16, 8), device=dev), block_m=8)),
        ("lif float64", lambda: lif_sequence_cuda(torch.zeros((4, 8), device=dev,
                                                              dtype=torch.float64))),
    ):
        try:
            call()
        except (ValueError, TypeError) as exc:
            refused.append({"shape": what, "raised": type(exc).__name__})
        else:
            raise AssertionError(f"the kernel took a refused input ({what}) without raising")

    # LIF: the currents each spiking layer's LIF sees on the main path.
    lif_inputs: list = []
    real_seq = snn_lif.lif_sequence_cuda

    def recording(x_seq, **kw):
        lif_inputs.append(x_seq.clone())
        return real_seq(x_seq, **kw)

    snn_lif.lif_sequence_cuda = recording
    try:
        with torch.no_grad():
            M.apply(params, cfg, batches[0])
    finally:
        snn_lif.lif_sequence_cuda = real_seq
    lif_checks, lif_err = [], 0.0
    for x_seq in lif_inputs:
        for reset in ("hard", "soft"):
            lcfg = snn_lif.LIFConfig(reset=reset)
            got = lif_sequence_cuda(x_seq, reset=reset)
            with torch.enable_grad():
                want = snn_lif.lif_sequence(x_seq.clone().requires_grad_(), lcfg).detach()
            plain = lif_sequence_plain(x_seq, reset=reset)
            v = torch.randn(x_seq.shape[1:], generator=torch.Generator().manual_seed(1)).to(dev)
            s, vn = lif_step_cuda(v, x_seq[0], reset=reset)
            rs, rv = ref.lif_ref(v, x_seq[0], 0.5, 1.0, reset)
            errs = [float((x - y).abs().max()) for x, y in
                    ((got, want), (got, plain), (s, rs), (vn, rv))]
            lif_err = max([lif_err] + errs)
            if not (torch.equal(got, want) and torch.equal(got, plain)):
                raise AssertionError(f"lif_sequence kernel != plain, shape {tuple(x_seq.shape)}, "
                                     f"max |diff| {max(errs[:2])}")
            if not (torch.equal(s, rs) and torch.equal(vn, rv)):
                raise AssertionError(f"lif_step kernel != lif_ref, shape {tuple(v.shape)}, "
                                     f"max |diff| {max(errs[2:])}")
        lif_checks.append(list(x_seq.shape))
    torch.cuda.synchronize()
    emit({"phase": "parity", "phi_fused": fused_checks, "phi_fused_max_abs_err": fused_err,
          "lif_shapes": lif_checks, "lif_bitwise": True, "lif_max_abs_err": lif_err,
          "refused": refused})

    # ------------------------------------------------------------- timing ---
    timing = []
    for name in acts:
        L = layers[name]
        w2 = params[name]["w"].reshape(-1, L["N"])
        args, packed = fused_args(name, w2), state.packed[name]
        _, nnz = phi_fused_cuda(*args, block_m=256, packed=packed)
        b_ms, o_ms = fused_bound_ms(L["M"], L["K"], L["N"], L["T"], cfg.phi.q, cfg.phi.k,
                                    int(nnz.sum()))
        timing.append({
            "layer": name, "M": L["M"], "K": L["K"], "N": L["N"], "T": L["T"],
            "ms": cuda_time_ms(lambda: phi_fused_cuda(*args, block_m=256, packed=packed)),
            "plain_ms": cuda_time_ms(lambda: phi_fused_plain(*args, block_m=256), runs=10),
            "library_ms": cuda_time_ms(lambda: torch.matmul(args[0], w2)),
            "bytes_ms": b_ms, "ops_ms": o_ms, "bound_ms": max(b_ms, o_ms),
            "launches_per_batch": 1})
    lif_rows = []
    for x_seq in lif_inputs:
        b_ms, o_ms = lif_bound_ms(x_seq.shape[0], x_seq[0].numel())
        lif_rows.append({
            "shape": list(x_seq.shape),
            "ms": cuda_time_ms(lambda: lif_sequence_cuda(x_seq)),
            "plain_ms": cuda_time_ms(lambda: lif_sequence_plain(x_seq), runs=10),
            "bytes_ms": b_ms, "ops_ms": o_ms, "bound_ms": max(b_ms, o_ms)})
    with torch.no_grad():
        phi_ms = cuda_time_ms(lambda: M.phi_apply(params, cfg, state, batches[0]), runs=10)
        dense_ms = cuda_time_ms(lambda: M.apply(params, cfg, batches[0]), runs=10)
        profiles = {"phi_apply": device_profile(
                        lambda: M.phi_apply(params, cfg, state, batches[0]), phi_ms),
                    "apply": device_profile(lambda: M.apply(params, cfg, batches[0]), dense_ms)}
    emit({"phase": "timing", "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "phi_fused": timing, "lif_sequence": lif_rows,
          "phi_apply_ms_per_batch": phi_ms, "apply_ms_per_batch": dense_ms,
          "profile": profiles})

    # ------------------------------------------------------------ summary ---
    # Times are per batch of the main path: the sum over the calls one batch
    # makes (the five Phi layers; the five spiking layers' LIF sequences).
    print(smi, flush=True)
    fused_bound, fused_by = bound(timing)
    lif_bound, lif_by = bound(lif_rows)
    emit({"kernels": [
        {"name": "phi_fused", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/phi_fused.cu",
         "replaces": "src/repro/kernels/phi_fused.py:135",
         "launches": launches["phi_fused"], "max_abs_err": fused_err,
         "ms": sum(r["ms"] for r in timing), "plain_ms": sum(r["plain_ms"] for r in timing),
         "bound_ms": fused_bound, "bound_by": fused_by,
         "library_ms": sum(r["library_ms"] for r in timing)},
        {"name": "lif_sequence", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/lif.cu",
         "replaces": "src/repro/kernels/lif.py:39",
         "launches": launches["lif_sequence"], "max_abs_err": lif_err,
         "ms": sum(r["ms"] for r in lif_rows), "plain_ms": sum(r["plain_ms"] for r in lif_rows),
         "bound_ms": lif_bound, "bound_by": lif_by, "library_ms": None},
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
