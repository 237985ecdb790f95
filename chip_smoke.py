#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA card and check them.

    python3 chip_smoke.py

Phases, one JSON object per line, in order: ``env`` (versions, the card),
``build`` (nvcc time), then for each path its main path, parity and timing
phases, and the ``kernels`` summary:

* VGG — ``main_path`` (calibrate, then Phi inference over four batches of a
  VGG at VGG-16 stage widths through the execution policy, logits bitwise
  equal to dense inference), ``parity`` (the fused kernels and the LIF
  kernels against their plain PyTorch versions on the main path's tensors),
  ``timing`` (CUDA events);
* VGG under ``PhiConfig(impl="pallas")`` — ``pallas_main_path`` (the same
  configuration and data, every GEMM on the matcher, L1-gather and L2-spmm
  kernels, logits bitwise equal to dense inference, every capacity audit
  zero), ``pallas_parity`` (the three kernels against their plain versions
  at every GEMM's operands and at odd shapes, the matcher also at the odd
  banks its design treats apart), ``pallas_timing``;
* Spikformer-4-384 with softmax attention — ``spikformer_main_path`` (the
  same, every attention site on the Phi flash-attention kernel, every
  spiking GEMM on the fused kernel the policy resolves; the prefetch sites
  take their gather sets from runtime telemetry from the second batch on),
  ``spikformer_parity``, ``spikformer_timing``.

Every ``*main_path`` phase prints the policy's decisions (site, impl,
reason, count). Each main path is driven with every kernel's launch count
set to 0 just before it and read just after. The card's ``nvidia-smi`` name
and power limit sit on their own line before the summary; the last line is
the result object.

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
GAIN = 3.0     # every weight but the encoder's: keeps spikes alive at depth (random init)
ATTN_ULPS = 16  # phi_flash_attention against its plain version, in ulps of max|V|
SEED = 0

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 CUDA-core FLOP/s
# and dense int8 tensor-core operations/s.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
INT8_OPS_PER_S = 1979e12
# The kernel each wrapper launches, as the profiler names it.
FUSED_KERNEL = {"fused": "phi_fused_kernel", "fused_prefetch": "phi_fused_kernel",
                "fused_stream": "phi_fused_stream_kernel"}


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


def _launches(fns, name: str, calls: int) -> list:
    """The launches of kernels whose name holds ``name``, in time order, that
    one ``torch.profiler`` session sees over ``calls`` calls of each of
    ``fns`` in turn, after a warm-up step (the profiler's own, so that no
    launch at the start of the session is lost)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for fn in fns:
            fn()
        torch.cuda.synchronize()
        prof.step()
        for fn in fns:
            for _ in range(calls):
                fn()
        torch.cuda.synchronize()
        prof.step()
    return sorted((ev for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA and name in ev.name),
                  key=lambda ev: ev.time_range.start)


def attach_device_ms(rows, name_of, calls: int = 10) -> None:
    """Set each row's ``device_ms``: the device time of one call of its
    ``_fn`` (removed from the row) in kernels whose name holds
    ``name_of(row)``, from ``torch.profiler``: the kernel alone, without its
    wrapper's host time. Each fn launches one such kernel a call; its time is
    the mean over the launches a session of ``calls`` calls sees. The
    profiler may miss some launches of a session; a session that sees none is
    tried again, twice, and then the row's ``device_ms`` is None (not
    measured)."""
    for row in rows:
        fn, name = row.pop("_fn"), name_of(row)
        events = []
        for _ in range(3):
            events = _launches([fn], name, calls)
            if events:
                break
        row["device_ms"] = (sum(ev.device_time_total for ev in events) / 1e3 / len(events)
                            if events else None)
        row["device_launches_seen"] = len(events)


def device_sum(rows):
    """The rows' summed ``device_ms``; None where a row's was not measured."""
    times = [r["device_ms"] for r in rows]
    return None if None in times else sum(times)


def fused_bound_ms(M, K, N, T, q, k, l2_entries, pwp_rows=None) -> tuple[float, float]:
    """Least time for one fused Phi matmul: bytes (inputs once, output once)
    against HBM, float32 operations of this run's data against the CUDA-core
    peak (L1: a multiply and an add per row, partition and column; L2: an add
    per residual entry and column; the final add). ``pwp_rows`` is the number
    of PWP rows (and scales) the call needs: the whole bank, T·(q+1), unless
    the prefetching kernel's active sets leave fewer. The integer match work
    is not counted: the table of peaks has no integer CUDA-core rate."""
    pwp_rows = T * (q + 1) if pwp_rows is None else pwp_rows
    nbytes = 4 * M * K + T * q * k + 4 * pwp_rows * N + 4 * pwp_rows + 4 * K * N \
        + 4 * M * N + 4 * -(-M // 256)
    flops = 2 * M * T * N + l2_entries * N + M * N
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3


def lif_bound_ms(T, n) -> tuple[float, float]:
    """Least time for the LIF sequence: read the currents and write the spikes
    once; three float32 operations per neuron-step."""
    return 8 * T * n / HBM_BYTES_PER_S * 1e3, 3 * T * n / F32_FLOP_PER_S * 1e3


def attn_bound_ms(B, S, H, D, T, qp, kp, nq, l2_entries) -> tuple[float, float]:
    """Least time for one Phi flash-attention call: bytes (q, k, v and the
    packed bank read once; out and the (B·H, nq) l2_nnz written once) against
    HBM, and the float32 operations the function itself needs on this run's
    data, whatever implements it, against the CUDA-core peak: per score the
    L1 sum (T adds), L1 + L2, the ragged tail (2 per tail feature), the
    scale, the softmax (max, subtract, exp, sum: 4) and p.V (2 D); per
    residual entry of a K row an add for every query row (``l2_entries``
    counts each K row's residual once); per output the division by the
    denominator. The integer match is not counted: the table of peaks has no
    integer rate."""
    BH = B * H
    nbytes = 16 * B * S * H * D + 8 * T * qp + 4 * BH * nq
    scores = BH * S * S
    flops = scores * (T + 1 + 2 * (D - T * kp) + 1 + 4 + 2 * D) + l2_entries * S + BH * S * D
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3


def active_sets(args, p_active):
    """Per-stripe active sets for the prefetching kernel on one GEMM: P from
    the layer's calibration usage where it shows skew (``PhiState.p_active``;
    the gate then routes the GEMM to that kernel), else P = 16, which checks
    and times the kernel at the GEMM's shape all the same."""
    from repro_torch.kernels.phi_fused import stripe_active_sets

    return stripe_active_sets(args[0], args[1], p_active or 16, 256)


def fused_checks(label, args, packed, active) -> int:
    """The three fused kernels against their plain versions on one GEMM's
    operands: ``out`` and ``l2_nnz`` bitwise; with an f32 bank the
    prefetching kernel's ``out`` also equals the full-bank one (exact
    whatever the sets). Returns the full-bank residual entries."""
    import torch

    from repro_torch.kernels.phi_fused import (
        phi_fused_cuda, phi_fused_plain, phi_fused_prefetch_cuda, phi_fused_prefetch_plain,
        phi_fused_stream_cuda)

    pout, pnnz = phi_fused_plain(*args, block_m=256)
    runs = [(kern, kern(*args, block_m=256, packed=packed), (pout, pnnz))
            for kern in (phi_fused_cuda, phi_fused_stream_cuda)]
    runs.append((phi_fused_prefetch_cuda,
                 phi_fused_prefetch_cuda(*args, active, block_m=256, packed=packed),
                 phi_fused_prefetch_plain(*args, active, block_m=256)))
    torch.cuda.synchronize()
    for kern, (out, nnz), (want, want_nnz) in runs:
        if not (torch.equal(out, want) and torch.equal(nnz, want_nnz)):
            raise AssertionError(f"{label}: {kern.__name__} != plain version, max |diff| "
                                 f"{float((out - want).abs().max())}, l2_nnz "
                                 f"{int(nnz.sum())} vs {int(want_nnz.sum())}")
    if args[2].dtype == torch.float32 and not torch.equal(runs[2][1][0], pout):
        raise AssertionError(f"{label}: phi_fused_prefetch != the full-bank output")
    return int(pnnz.sum())


def fused_timing(name, args, packed, route, active, plain_runs) -> dict:
    """CUDA-event times of one GEMM on the three fused kernels, the plain
    version of the kernel the path runs and ``torch.matmul``, and that
    kernel's bound; ``ms`` is the kernel the path runs (``_fn`` calls it, for
    :func:`attach_device_ms`)."""
    import torch

    from repro_torch.kernels.phi_fused import (
        phi_fused_cuda, phi_fused_plain, phi_fused_prefetch_cuda, phi_fused_prefetch_plain,
        phi_fused_stream_cuda)

    a, pats, _, _, w2 = args
    T, q, k = pats.shape
    calls = {"fused": lambda: phi_fused_cuda(*args, block_m=256, packed=packed),
             "fused_stream": lambda: phi_fused_stream_cuda(*args, block_m=256, packed=packed),
             "fused_prefetch": lambda: phi_fused_prefetch_cuda(*args, active, block_m=256,
                                                               packed=packed)}
    _, nnz = calls[route]()
    pwp_rows = None
    if route == "fused_prefetch":                 # the bank rows the active sets name
        pwp_rows = sum(int(active[:, t].unique().numel()) + 1 for t in range(T))
    b_ms, o_ms = fused_bound_ms(a.shape[0], a.shape[1], w2.shape[1], T, q, k, int(nnz.sum()),
                                pwp_rows)
    times = {impl: cuda_time_ms(fn) for impl, fn in calls.items()}
    plain = (lambda: phi_fused_prefetch_plain(*args, active, block_m=256)) \
        if route == "fused_prefetch" else (lambda: phi_fused_plain(*args, block_m=256))
    return {"layer": name, "M": a.shape[0], "K": a.shape[1], "N": w2.shape[1], "T": T,
            "route": route, "p_active": active.shape[-1], "ms": times[route],
            "_fn": calls[route],
            **{f"ms_{impl}": t for impl, t in times.items()},
            "plain_ms": cuda_time_ms(plain, runs=plain_runs, warmup=1),
            "library_ms": cuda_time_ms(lambda: torch.matmul(a, w2)),
            "bytes_ms": b_ms, "ops_ms": o_ms, "bound_ms": max(b_ms, o_ms),
            "launches_per_batch": 1}


def lif_rows(inputs) -> tuple[list, float]:
    """The LIF sequence kernel against the plain version (and the autograd
    ``lif_sequence``) on each recorded input, hard and soft reset, bitwise;
    the step kernel against ``lif_ref``. Returns per-input timing rows (CUDA
    events, and the kernel's profiler device time alone) and the largest
    difference seen."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.lif import lif_sequence_cuda, lif_sequence_plain, lif_step_cuda
    from repro_torch.snn import lif as snn_lif

    rows, err = [], 0.0
    for x_seq in inputs:
        for reset in ("hard", "soft"):
            got = lif_sequence_cuda(x_seq, reset=reset)
            with torch.enable_grad():
                want = snn_lif.lif_sequence(x_seq.clone().requires_grad_(),
                                            snn_lif.LIFConfig(reset=reset)).detach()
            plain = lif_sequence_plain(x_seq, reset=reset)
            v = torch.randn(x_seq.shape[1:], generator=torch.Generator().manual_seed(1))
            v = v.to(x_seq.device)
            s, vn = lif_step_cuda(v, x_seq[0], reset=reset)
            rs, rv = ref.lif_ref(v, x_seq[0], 0.5, 1.0, reset)
            errs = [float((x - y).abs().max()) for x, y in
                    ((got, want), (got, plain), (s, rs), (vn, rv))]
            err = max([err] + errs)
            if not (torch.equal(got, want) and torch.equal(got, plain)):
                raise AssertionError(f"lif_sequence kernel != plain, shape {tuple(x_seq.shape)}, "
                                     f"max |diff| {max(errs[:2])}")
            if not (torch.equal(s, rs) and torch.equal(vn, rv)):
                raise AssertionError(f"lif_step kernel != lif_ref, shape {tuple(v.shape)}, "
                                     f"max |diff| {max(errs[2:])}")
        b_ms, o_ms = lif_bound_ms(x_seq.shape[0], x_seq[0].numel())
        rows.append({
            "shape": list(x_seq.shape),
            "ms": cuda_time_ms(lambda: lif_sequence_cuda(x_seq)),
            "_fn": lambda x_seq=x_seq: lif_sequence_cuda(x_seq),
            "plain_ms": cuda_time_ms(lambda: lif_sequence_plain(x_seq), runs=10),
            "bytes_ms": b_ms, "ops_ms": o_ms, "bound_ms": max(b_ms, o_ms)})
    attach_device_ms(rows, lambda row: "lif_sequence_kernel")
    return rows, err


def record_lif_inputs(fn) -> list:
    """The currents every LIF sequence kernel launch of ``fn()`` receives."""
    from repro_torch.snn import lif as snn_lif

    inputs, real = [], snn_lif.lif_sequence_cuda

    def recording(x_seq, **kw):
        inputs.append(x_seq.clone())
        return real(x_seq, **kw)

    snn_lif.lif_sequence_cuda = recording
    try:
        fn()
    finally:
        snn_lif.lif_sequence_cuda = real
    return inputs


def gate_routes(params, state, acts) -> dict:
    """The fused kernel ``ops.fused_shape_viable`` gives each calibrated GEMM
    of a path, from its shape and calibration usage, as ``phi_apply`` asks."""
    from repro_torch.kernels import ops

    return {name: ops.fused_shape_viable(act.shape[0], act.shape[1],
                                         params[name]["w"].shape[-1],
                                         *state.patterns[name].shape[:2],
                                         p_active=state.p_active[name])
            for name, act in acts.items() if not name.endswith("_attn")}


def check_fused_launches(launches, routes, path) -> None:
    """Each fused kernel launched once per batch for every GEMM routed to it."""
    for impl in ("fused", "fused_stream", "fused_prefetch"):
        want = BATCHES * sum(r == impl for r in routes.values())
        if launches[f"phi_{impl}_cuda"] != want:
            raise AssertionError(f"{path}: phi_{impl} launches {launches[f'phi_{impl}_cuda']} "
                                 f"!= {want}: routes {routes}")


def check_decisions(decisions, routes, path) -> None:
    """Every GEMM site resolved once a batch, each to the kernel it is routed to."""
    for name, route in routes.items():
        got = {(impl, reason): n for (site, impl, reason), n in decisions.items()
               if site == f"snn.{name}"}
        if sum(got.values()) != BATCHES or any(impl != route for impl, _ in got):
            raise AssertionError(f"{path}: snn.{name} resolved {got}, want {route} x {BATCHES}")


def bound(rows) -> tuple[float, str]:
    """Sum of per-call bounds, and what bounds the sum (bytes or operations)."""
    total = sum(max(r["bytes_ms"], r["ops_ms"]) for r in rows)
    by = "bytes" if sum(r["bytes_ms"] for r in rows) >= sum(r["ops_ms"] for r in rows) \
        else "operations"
    return total, by


def spikformer_path(dev, images, smi) -> dict:
    """The spikformer phases: Spikformer-4-384 Phi inference with every
    attention site on the phi_flash_attention kernel and every GEMM on the
    fused kernel the shape gate picks; each kernel against its plain version
    at the path's shapes (the attention also on the masks and a ragged S);
    timings. Returns the attention kernel's entry of the ``kernels`` line,
    the path's fused and LIF timing rows, the largest LIF difference and the
    main path's launch counts."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.patterns import PhiConfig
    from repro_torch.kernels import dispatch, ops
    from repro_torch.kernels.lif import lif_sequence_cuda, lif_step_cuda
    from repro_torch.kernels.phi_attention import (
        flash_attention_cuda, phi_flash_attention_cuda, phi_flash_attention_plain)
    from repro_torch.kernels.phi_fused import (
        phi_fused_cuda, phi_fused_prefetch_cuda, phi_fused_stream_cuda)
    from repro_torch.snn import models as M

    cfg = M.SNNConfig(kind="spikformer", input_size=32, input_channels=3, num_classes=10,
                      timesteps=4, dim=384, heads=12, blocks=4, attn="flash",
                      phi=PhiConfig(k=16, q=128, iters=20))
    params = M.init(cfg, torch.Generator().manual_seed(SEED), device=dev)
    for name, leaf in params.items():
        leaf["w"] = dyadic(leaf["w"] * (1.0 if name == "embed" else GAIN))
    calib_x, batches = images[:BATCH], images[BATCH:].split(BATCH)
    policy = dispatch.PhiExecutionPolicy()
    prev_policy = dispatch.set_policy(policy)
    counted = (phi_fused_cuda, phi_fused_stream_cuda, phi_fused_prefetch_cuda, lif_sequence_cuda,
               lif_step_cuda, phi_flash_attention_cuda, flash_attention_cuda)

    # ------------------------------------------------------ main path ---
    prepass, real_prepass = [], ops.stripe_active_sets
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        state, acts = M.calibrate_model(params, cfg, calib_x)
        torch.cuda.synchronize()
        calib_s = time.perf_counter() - t0
        ops.stripe_active_sets = lambda *a, **k: (prepass.append(1), real_prepass(*a, **k))[1]
        try:
            logits = [(M.phi_apply(params, cfg, state, x), M.apply(params, cfg, x))
                      for x in batches]
        finally:
            ops.stripe_active_sets = real_prepass
        torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counted}
    main_s = time.perf_counter() - t0
    decisions = policy.decisions()

    n_attn = sum(name.endswith("_attn") for name in state.patterns)
    n_mm = len(state.patterns) - n_attn
    if n_attn != cfg.blocks or n_mm != 4 * cfg.blocks + 1:
        raise AssertionError(f"calibrated sites {sorted(state.patterns)}")
    if launches["phi_flash_attention_cuda"] != BATCHES * cfg.blocks:
        raise AssertionError(f"phi_flash_attention launches {launches} != {BATCHES} x 4")
    # The gate's kernel per GEMM: fc2 (K = 1536, T = 96) streamed, a GEMM
    # whose calibration usage is skewed prefetched, the rest on the first one.
    routes = gate_routes(params, state, acts)
    check_fused_launches(launches, routes, "spikformer")
    check_decisions(decisions, routes, "spikformer")
    # A prefetch site runs the pre-pass on its first batch only; from the
    # second on its runtime match histogram supplies the gather sets.
    prefetched = [name for name, route in routes.items() if route == "fused_prefetch"]
    for name in prefetched:
        for reason, n in (("pattern_usage_prefetch_native", 1),
                          ("pattern_usage_prefetch_native_runtime_sets", BATCHES - 1)):
            if decisions.get((f"snn.{name}", "fused_prefetch", reason)) != n:
                raise AssertionError(f"snn.{name}: {reason} resolved "
                                     f"{decisions.get((f'snn.{name}', 'fused_prefetch', reason))}"
                                     f" times, want {n}")
    if len(prepass) != len(prefetched):
        raise AssertionError(f"the prefetch pre-pass ran {len(prepass)} times, want "
                             f"{len(prefetched)} (once per prefetch site)")
    if launches["lif_sequence_cuda"] <= 0:
        raise AssertionError("the LIF sequence kernel never launched on the spikformer path")
    for b in range(cfg.blocks):
        key = (f"snn.b{b}_attn", "phi_flash", "spike_qk_phi_flash_native")
        if decisions.get(key) != BATCHES:
            raise AssertionError(f"{key} resolved {decisions.get(key)} times: {decisions}")
    if any(reason.endswith("_xla") for _, _, reason in decisions):
        raise AssertionError(f"a plain (_xla) row fired on the card: {decisions}")
    for i, (p, d) in enumerate(logits):
        if p.shape != (BATCH, 10) or not torch.isfinite(p).all():
            raise AssertionError(f"spikformer batch {i}: logits not finite/(B, 10)")
        if not torch.equal(p, d):
            raise AssertionError(f"spikformer batch {i}: phi_apply != dense apply, max |diff| "
                                 f"{float((p - d).abs().max())}")
        if float(p.abs().sum()) == 0:
            raise AssertionError(f"spikformer batch {i}: all logits are zero")
    density = {name: float(act.mean()) for name, act in acts.items()}
    if min(density.values()) < 0.01:
        raise AssertionError(f"a Phi site has input spike density < 1%: {density}")
    # The CPU plain versions on the same input: reported, not required equal
    # (the kernel's softmax rounds in another order than the plain one).
    cpu_params = {n: {"w": leaf["w"].cpu()} for n, leaf in params.items()}
    cpu_state = M.PhiState({n: p.cpu() for n, p in state.patterns.items()},
                           {n: p.cpu() for n, p in state.pwp.items()}, state.usage)
    cpu_logits = M.phi_apply(cpu_params, cfg, cpu_state, batches[0].cpu())
    emit({"phase": "spikformer_main_path",
          "config": {"kind": cfg.kind, "dim": cfg.dim, "heads": cfg.heads,
                     "blocks": cfg.blocks, "attn": cfg.attn, "input_size": cfg.input_size,
                     "timesteps": cfg.timesteps, "k": cfg.phi.k, "q": cfg.phi.q,
                     "iters": cfg.phi.iters, "batch": BATCH, "batches": BATCHES},
          "calibrate_s": calib_s, "main_path_s": main_s, "launches": launches,
          "decisions": [[*key, n] for key, n in sorted(decisions.items())],
          "routes": routes, "prepass_launches": len(prepass),
          "runtime_sets_decisions": sum(n for (_, _, reason), n in decisions.items()
                                        if reason.endswith("_runtime_sets")),
          "logits_bitwise_equal_dense": True, "density": density,
          "cpu_plain_logits_max_abs_diff": float((cpu_logits - logits[0][0].cpu()).abs().max())})

    # --------------------------------------------------------- parity ---
    sites = []
    real_attention = policy.attention

    def recording(q, k, v, patterns=None, **kw):
        sites.append((kw["site"], q, k, v, patterns, kw.get("packed")))
        return real_attention(q, k, v, patterns, **kw)

    policy.attention = recording
    try:
        with torch.no_grad():
            lif_inputs = record_lif_inputs(lambda: M.phi_apply(params, cfg, state, batches[0]))
    finally:
        policy.attention = real_attention
        dispatch.set_policy(prev_policy)
    fused_args = {name: (act.contiguous(), state.patterns[name], state.pwp[name],
                         torch.ones(state.pwp[name].shape[:2], device=dev), params[name]["w"])
                  for name, act in acts.items() if not name.endswith("_attn")}
    sets = {name: active_sets(args, state.p_active[name]) for name, args in fused_args.items()}
    gemm_checks = {name: fused_checks(f"spikformer {name}", args, state.packed[name],
                                      sets[name])
                   for name, args in fused_args.items()}
    lif_timing, lif_err = lif_rows(lif_inputs)
    attn_err, checks = 0.0, []

    def check(label, q, k, v, pats, packed, **kw):
        nonlocal attn_err
        out, nnz = phi_flash_attention_cuda(q, k, v, pats, packed=packed, **kw)
        pout, pnnz = phi_flash_attention_plain(q, k, v, pats, **kw)
        dense = flash_attention_cuda(q, k, v, **{"causal": False, **kw})
        torch.cuda.synchronize()
        err = float((out - pout).abs().max())
        # Scores and l2_nnz are exact; the softmax sums p and p.V in another
        # order than the plain version and uses expf: each output is a convex
        # combination of V rows, so the bound is ATTN_ULPS ulps of max|V|.
        tol = ATTN_ULPS * 2.0 ** -24 * float(v.abs().max())
        if not torch.equal(nnz, pnnz):
            raise AssertionError(f"{label}: l2_nnz differs from the plain version")
        if err > tol:
            raise AssertionError(f"{label}: kernel != plain, max |diff| {err} > {tol}")
        if not torch.equal(out, dense):
            raise AssertionError(f"{label}: Phi and dense instantiations differ, max |diff| "
                                 f"{float((out - dense).abs().max())}")
        attn_err = max(attn_err, err)
        checks.append({"case": label, "shape": list(q.shape), "max_abs_err": err, "tol": tol,
                       "l2_nnz": int(nnz.sum())})

    blocks = {}
    for site, q, k, v, pats, packed in sites:
        blocks[site] = policy.last_decision(site).blocks
        check(site, q, k, v, pats, packed, block_q=blocks[site][0], block_kv=blocks[site][1])
    _, q, k, v, pats, packed = sites[0]
    # A query row's softmax arithmetic depends on block_kv only: the Phi
    # kernel at block_q 32 equals the dense one at 64.
    bq0, bkv0 = blocks[sites[0][0]]
    out32, _ = phi_flash_attention_cuda(q, k, v, pats, packed=packed, block_q=bq0 // 2,
                                        block_kv=bkv0)
    if not torch.equal(out32, flash_attention_cuda(q, k, v, causal=False, block_q=bq0,
                                                   block_kv=bkv0)):
        raise AssertionError("Phi at block_q/2 != dense at block_q, equal block_kv")
    # Q off {0, 1} (dyadic, so every score is still exact): the float route.
    qn = q * torch.tensor([0.5, 0.25, 2.0, -1.0], device=dev)[
        torch.randint(0, 4, q.shape, generator=torch.Generator().manual_seed(3)).to(dev)]
    check("non_binary_q", qn, k, v, pats, packed, block_q=bq0, block_kv=bkv0)
    for label, kw in (("causal", dict(causal=True, block_q=32, block_kv=16)),
                      ("window", dict(causal=True, window=9, block_q=16, block_kv=32)),
                      ("chunk", dict(chunk=16, block_q=32, block_kv=32)),
                      ("ragged_s", dict(block_q=16, block_kv=16))):
        if label == "ragged_s":
            q, k, v = (x[:, :37].contiguous() for x in (q, k, v))
        check(label, q, k, v, pats, packed, **kw)
    emit({"phase": "spikformer_parity", "phi_flash_attention": checks,
          "max_abs_err": attn_err, "fused_bitwise_l2_nnz": gemm_checks,
          "lif_shapes": [r["shape"] for r in lif_timing], "lif_bitwise": True,
          "lif_max_abs_err": lif_err})

    # --------------------------------------------------------- timing ---
    rows = []
    for site, q, k, v, pats, packed in sites:
        bq, bkv = blocks[site]
        kw = dict(causal=False, block_q=bq, block_kv=bkv)
        _, nnz = phi_flash_attention_cuda(q, k, v, pats, packed=packed, **kw)
        B, S, H, D = q.shape
        T, qp, kp = pats.shape
        nq = -(-S // min(bq, S))               # every q-block column holds the panel's count
        b_ms, o_ms = attn_bound_ms(B, S, H, D, T, qp, kp, nq, int(nnz.sum()) // nq)
        qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
        rows.append({
            "site": site, "shape": [B, S, H, D], "blocks": [bq, bkv],
            "ms": cuda_time_ms(lambda: phi_flash_attention_cuda(q, k, v, pats, packed=packed,
                                                                **kw)),
            "_fn": lambda q=q, k=k, v=v, pats=pats, packed=packed, kw=kw:
                phi_flash_attention_cuda(q, k, v, pats, packed=packed, **kw),
            "dense_ms": cuda_time_ms(lambda: flash_attention_cuda(q, k, v, **kw)),
            # a smaller q-block: less shared memory per block, more blocks per SM
            "ms_block_q32": cuda_time_ms(lambda: phi_flash_attention_cuda(
                q, k, v, pats, packed=packed, **{**kw, "block_q": 32})),
            "plain_ms": cuda_time_ms(lambda: phi_flash_attention_plain(q, k, v, pats, **kw),
                                     runs=10),
            "library_ms": cuda_time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh)),
            "bytes_ms": b_ms, "ops_ms": o_ms, "bound_ms": max(b_ms, o_ms),
            "launches_per_batch": 1})
    # Both fused kernels at this path's 17 GEMMs of one batch (the
    # calibration batch's activations have a main-path batch's shapes).
    attach_device_ms(rows, lambda row: "attn_kernel")
    fused_rows = [fused_timing(name, args, state.packed[name], routes[name], sets[name],
                               plain_runs=3)
                  for name, args in fused_args.items()]
    attach_device_ms(fused_rows, lambda row: FUSED_KERNEL[row["route"]])
    with torch.no_grad():
        phi_ms = cuda_time_ms(lambda: M.phi_apply(params, cfg, state, batches[0]), runs=10)
        dense_ms = cuda_time_ms(lambda: M.apply(params, cfg, batches[0]), runs=10)
        profiles = {"phi_apply": device_profile(
                        lambda: M.phi_apply(params, cfg, state, batches[0]), phi_ms),
                    "apply": device_profile(lambda: M.apply(params, cfg, batches[0]), dense_ms)}
    emit({"phase": "spikformer_timing", "device": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "phi_fused": fused_rows,
          "phi_fused_per_batch": {
              "ms": sum(r["ms"] for r in fused_rows),
              **{f"ms_all_{impl}": sum(r[f"ms_{impl}"] for r in fused_rows)
                 for impl in ("fused", "fused_stream", "fused_prefetch")}},
          "lif_sequence": lif_timing,
          "phi_flash_attention": rows,
          "phi_apply_ms_per_batch": phi_ms, "apply_ms_per_batch": dense_ms,
          "profile": profiles})
    total, by = bound(rows)
    # Times are per batch of the main path: the sum over its four sites.
    attn_entry = {"name": "phi_flash_attention", "route": "cuda",
                  "source": "src/repro_torch/kernels/csrc/phi_attention.cu",
                  "replaces": "src/repro/kernels/phi_attention.py:158",
                  "launches": launches["phi_flash_attention_cuda"], "max_abs_err": attn_err,
                  "ms": sum(r["ms"] for r in rows), "device_ms": device_sum(rows),
                  "plain_ms": sum(r["plain_ms"] for r in rows),
                  "bound_ms": total, "bound_by": by,
                  "library_ms": sum(r["library_ms"] for r in rows),
                  "dense_instantiation_ms": sum(r["dense_ms"] for r in rows),
                  "dense_instantiation_launches": launches["flash_attention_cuda"]}
    return {"attn_entry": attn_entry, "fused_rows": fused_rows, "lif_rows": lif_timing,
            "lif_err": lif_err, "launches": launches}


def unit_bounds(a, pats, idx, pwp, entries, w_cols, N, G_bm) -> dict:
    """Least times of the three per-unit kernels on one GEMM, (bytes, operations)
    each: inputs read once, outputs written once, over 3.35 TB/s; float32
    operations of this run's data over 67 TFLOP/s. The matcher reads a and
    the packed bank and writes idx and the int8 residual; its operations are
    the scores as int8 tensor-core work, a multiply and an add per row,
    partition, pattern and bit (M·T·q·k·2 over 1,979 TOP/s). The gather reads idx and the bank rows the indices name (each
    distinct (t, index) row once) and writes the output; T - 1 adds per
    output. The spmm reads the real entries (4 + 4 + 1 bytes) and the weight
    rows they name and writes the (G·bm, N) output; an add per entry and
    column."""
    import torch

    M, K = a.shape
    T, q, _ = pats.shape
    rows_named = int(torch.unique(idx.long() + torch.arange(T, device=idx.device)
                                  * (q + 1)).numel())
    return {
        "matcher": ((4 * M * K + 8 * T * q + 4 * M * T + M * K) / HBM_BYTES_PER_S * 1e3,
                    2 * M * T * q * pats.shape[2] / INT8_OPS_PER_S * 1e3),
        "l1_gather": ((4 * M * T + rows_named * N * pwp.element_size() + 4 * M * N)
                      / HBM_BYTES_PER_S * 1e3, M * N * (T - 1) / F32_FLOP_PER_S * 1e3),
        "l2_spmm": ((9 * entries + 4 * w_cols * N + 4 * G_bm * N) / HBM_BYTES_PER_S * 1e3,
                    entries * N / F32_FLOP_PER_S * 1e3)}


def unit_operands(a, pats, pwp, w, nnz_budget):
    """The three kernels' operands for one GEMM, as ``ops.phi_matmul(impl=
    "pallas")`` builds them: idx and residual from the matcher, the COO of the
    residual bucketed per 256-row block with the lowering's capacities."""
    from repro_torch.core.assign import pack_l2_coo_jit
    from repro_torch.kernels import ops

    M, K = a.shape
    idx, res = ops.matcher(a, pats)
    cap = max(128, int(nnz_budget * M * K))
    rows, cols, signs, _ = pack_l2_coo_jit(res, cap)
    bm = ops.effective_block_m(M, 256)
    G = -(-M // bm)
    br, bc, bs, dropped = ops.bucket_coo(rows, cols, signs, G * bm, bm,
                                         ops.l2_per_block_cap(nnz_budget, 256, K, cap))
    if int(dropped):
        raise AssertionError(f"bucket_coo dropped {int(dropped)} entries at M={M}, K={K}")
    return idx, res, (br, bc, bs, bm), (rows, cols, signs)


def unit_checks(label, a, pats, packed, pwp, w, nnz_budget) -> dict:
    """The matcher, gather and spmm kernels against their plain versions on one
    GEMM's operands, bitwise; the gather also on the bank in bf16. (The
    reference's two modes of the gather and the spmm are one kernel here.)"""
    import torch

    from repro_torch.kernels.matcher import matcher_cuda, matcher_plain
    from repro_torch.kernels.phi_gather import l1_gather_cuda, l1_gather_plain, make_range_flag
    from repro_torch.kernels.phi_spmm import l2_spmm_cuda, l2_spmm_plain

    idx, res = matcher_cuda(a, pats, packed=packed)
    pidx, pres = matcher_plain(a, pats)
    _, _, (br, bc, bs, bm), _ = unit_operands(a, pats, pwp, w, nnz_budget)
    runs = {"matcher": [(idx, pidx), (res, pres)]}
    flag = make_range_flag(a.device)
    runs["l1_gather"] = [(gather(pidx, bank), l1_gather_plain(pidx, bank))
                         for bank in (pwp, pwp.to(torch.bfloat16))
                         for gather in (l1_gather_cuda,     # the check, and the flag
                                        lambda i, b: l1_gather_cuda(i, b, range_flag=flag))]
    runs["l2_spmm"] = [(l2_spmm_cuda(br, bc, bs, w, block_m=bm),
                        l2_spmm_plain(br, bc, bs, w, block_m=bm))]
    torch.cuda.synchronize()
    if int(flag[0]):
        raise AssertionError(f"{label}: the gather flagged an index the matcher made")
    errs = {}
    for kern, pairs in runs.items():
        errs[kern] = max(float((x.float() - y.float()).abs().max()) if x.numel() else 0.0
                         for x, y in pairs)
        if not all(torch.equal(x, y) for x, y in pairs):
            raise AssertionError(f"{label}: {kern} kernel != plain version, max |diff| "
                                 f"{errs[kern]}")
    return {"case": label, "M": a.shape[0], "K": a.shape[1], "N": w.shape[1],
            "l2_entries": int((bs != 0).sum()), "max_abs_err": errs}


def matcher_odd_checks(a) -> list:
    """The matcher kernel against its plain version, bitwise, on the VGG's
    conv1 activations (K = 576) at the shapes its design treats apart: k = 9
    and 36 (partitions straddle 32-bit words), 32 and 64 (the other two mma
    depths), q = 1 and 9, q = 3500 (past one shared-memory chunk of the
    bank), M = 1 and one block's 64 rows + 37, and an ``a`` one float past a
    16-byte boundary (the scalar loads). Each bank is the partitions of q
    activation rows, with pattern 1 a duplicate of pattern 0: many rows tie
    between equal or equidistant patterns and between a pattern and their
    own popcount."""
    import torch

    from repro_torch.kernels.matcher import matcher_cuda, matcher_plain, matcher_plan

    g = torch.Generator().manual_seed(SEED + 4)
    K = a.shape[1]
    out = []
    for label, rows, k, q in (("k=9", 4096, 9, 128), ("k=32", 4096, 32, 128),
                              ("k=36", 4096, 36, 128), ("k=64", 4096, 64, 128),
                              ("q=1", 4096, 16, 1), ("q=9", 4096, 16, 9),
                              ("q=3500", 512, 16, 3500), ("M=1", 1, 16, 128),
                              ("M=64+37", 101, 16, 128), ("unaligned a", 4096 + 37, 16, 128)):
        T = K // k
        x = a[:rows]
        if label == "unaligned a":
            flat = torch.zeros(rows * K + 1, device=a.device)
            flat[1:] = x.reshape(-1)
            x = flat[1:].view(rows, K)
            if x.data_ptr() % 16 == 0:
                raise AssertionError("the unaligned case's a is 16-byte aligned")
        pick = torch.randint(0, a.shape[0], (q,), generator=g).to(a.device)
        pats = a[pick].reshape(q, T, k).transpose(0, 1).to(torch.uint8).contiguous()
        if q > 1:
            pats[:, 1] = pats[:, 0]
        idx, res = matcher_cuda(x, pats)
        pidx, pres = matcher_plain(x, pats)
        torch.cuda.synchronize()
        if not (torch.equal(idx, pidx) and torch.equal(res, pres)):
            raise AssertionError(f"matcher {label}: kernel != plain version, idx differs at "
                                 f"{int((idx != pidx).sum())}, residual at "
                                 f"{int((res != pres).sum())}")
        tp, chunk, smem = matcher_plan(T, q, k)
        out.append({"case": label, "M": rows, "K": K, "T": T, "q": q, "k": k,
                    "plan": {"partitions_a_block": tp, "chunk": chunk, "smem_bytes": smem},
                    "matched": int((idx < q).sum()), "unmatched": int((idx == q).sum())})
    return out


def pallas_path(dev, cfg, params, state, batches, dense_logits, smi) -> dict:
    """The pallas phases: the VGG main path's configuration and data under
    ``PhiConfig(impl="pallas")``; the three kernels against their plain
    versions at every GEMM and at odd shapes; timings. Returns the three
    kernels' entries of the ``kernels`` line."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from repro_torch.core.patterns import pattern_weight_products
    from repro_torch.core.patterns import quantize_pwp
    from repro_torch.kernels import dispatch, ops
    from repro_torch.kernels.lif import lif_sequence_cuda
    from repro_torch.kernels.matcher import matcher_cuda, matcher_plain
    from repro_torch.kernels.phi_fused import phi_fused_cuda, phi_fused_stream_cuda
    from repro_torch.kernels.phi_fused import phi_fused_prefetch_cuda
    from repro_torch.kernels.phi_gather import (
        check_range_flag, l1_gather_cuda, l1_gather_plain, make_range_flag, range_flag_to_host)
    from repro_torch.kernels.phi_spmm import l2_spmm_cuda, l2_spmm_plain
    from repro_torch.snn import models as M

    def flagged_gather(idx, pwp):
        """The gather as the lowering runs it: the range checked by the kernel's
        flag, read back once the stream has passed it."""
        flag = make_range_flag(idx.device)
        out = l1_gather_cuda(idx, pwp, range_flag=flag)
        host = range_flag_to_host(flag)
        torch.cuda.synchronize()
        check_range_flag(host, idx, pwp.shape[1])
        return out

    pcfg = dataclasses.replace(cfg, phi=dataclasses.replace(cfg.phi, impl="pallas"))
    budget = pcfg.phi.nnz_budget
    units = (matcher_cuda, l1_gather_cuda, l2_spmm_cuda)
    counted = units + (phi_fused_cuda, phi_fused_stream_cuda, phi_fused_prefetch_cuda,
                       lif_sequence_cuda)
    policy = dispatch.PhiExecutionPolicy()
    prev_policy = dispatch.set_policy(policy)

    # ------------------------------------------------------ main path ---
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = [M.phi_apply(params, pcfg, state, x) for x in batches]
        torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted}
    decisions = policy.decisions()
    dispatch.set_policy(prev_policy)
    for i, (p, d) in enumerate(zip(logits, dense_logits)):
        if not torch.equal(p, d):
            raise AssertionError(f"pallas batch {i}: phi_apply != dense apply, max |diff| "
                                 f"{float((p - d).abs().max())}")
    for fn in units:                      # once per GEMM a batch: 5 at the slice's widths
        if launches[fn.__name__] != len(state.patterns) * BATCHES:
            raise AssertionError(f"pallas: {fn.__name__} launches {launches}, want "
                                 f"{len(state.patterns)} x {BATCHES}")
    if any(launches[fn.__name__] for fn in counted[3:6]):
        raise AssertionError(f"pallas: a fused kernel ran: {launches}")
    check_decisions(decisions, {name: "pallas" for name in state.patterns}, "pallas")
    if any(reason != "config_override" for _, _, reason in decisions):
        raise AssertionError(f"pallas: {decisions}")
    # The budgeted lowering is exact only if no capacity dropped an entry:
    # audit every GEMM of every batch (its activations from dense apply).
    audits = []
    with torch.no_grad():
        for i, x in enumerate(batches):
            cap = {}
            M.apply(params, cfg, x, capture=cap)
            for name, act in cap.items():
                aud = ops.phi_l2_audit(act, state.patterns[name], nnz_budget=budget)
                audits.append({"batch": i, "layer": name, **aud})
                if aud["pack_overflow"] or aud["bucket_dropped"] or aud["chunk_overflow"]:
                    raise AssertionError(f"pallas batch {i} {name}: capacity audit {aud}")
    emit({"phase": "pallas_main_path", "impl": "pallas", "nnz_budget": budget,
          "main_path_s": main_s, "launches": launches,
          "decisions": [[*key, n] for key, n in sorted(decisions.items())],
          "logits_bitwise_equal_dense": True, "audits": audits})

    # --------------------------------------------------------- parity ---
    acts = {}
    with torch.no_grad():
        M.apply(params, cfg, batches[0], capture=acts)
    gemms = {}
    for name, act in acts.items():
        w2 = params[name]["w"].reshape(-1, params[name]["w"].shape[-1])
        gemms[name] = (act.contiguous(), state.patterns[name], state.packed[name],
                       state.pwp[name], w2)
    checks = [unit_checks(name, *args, budget) for name, args in gemms.items()]
    a1, pats1, packed1, _, w1 = gemms["conv1"]
    ragged = torch.cat([a1, a1[:37]])
    checks.append(unit_checks("conv1 M+37", ragged, pats1, packed1, state.pwp["conv1"], w1,
                              budget))
    w384 = dyadic(torch.randn((w1.shape[0], 384), generator=torch.Generator().manual_seed(2))
                  .to(dev) * 0.05)
    if ops._pick_block_n(384, 256) != 192:
        raise AssertionError("block_n for N = 384 is not 192")
    checks.append(unit_checks("conv1 N=384", a1, pats1, packed1,
                              pattern_weight_products(pats1, w384), w384, budget))
    matcher_odd = matcher_odd_checks(a1)
    refused = []
    for what, call, exc in (
        ("matcher k=128", lambda: matcher_cuda(
            torch.zeros((8, 128), device=dev),
            torch.zeros((1, 4, 128), dtype=torch.uint8, device=dev)), ValueError),
        ("l1_gather int8 bank", lambda: l1_gather_cuda(
            torch.zeros((8, 1), dtype=torch.int32, device=dev),
            torch.zeros((1, 5, 8), dtype=torch.int8, device=dev)), TypeError),
        ("l1_gather idx past q", lambda: l1_gather_cuda(
            torch.full((8, 1), 5, dtype=torch.int32, device=dev),
            torch.zeros((1, 5, 8), device=dev)), ValueError),
        ("l1_gather idx past q, flagged", lambda: flagged_gather(
            torch.full((8, 1), 5, dtype=torch.int32, device=dev),
            torch.zeros((1, 5, 8), device=dev)), ValueError),
        ("policy k=128", lambda: dispatch.PhiExecutionPolicy().matmul(
            torch.zeros((8, 512), device=dev), torch.zeros((512, 8), device=dev),
            torch.zeros((4, 8, 128), dtype=torch.uint8, device=dev),
            torch.zeros((4, 9, 8), device=dev), site="wide_k"), ValueError),
        ("pallas int8 bank", lambda: ops.phi_matmul(
            a1, w1, pats1, quantize_pwp(state.pwp["conv1"])[0], impl="pallas"), ValueError),
    ):
        try:
            call()
        except exc as err:
            refused.append({"case": what, "raised": type(err).__name__})
        else:
            raise AssertionError(f"the kernel took a refused input ({what}) without raising")
    unit_errs = {kern: max(c["max_abs_err"][kern] for c in checks)
                 for kern in ("matcher", "l1_gather", "l2_spmm")}
    emit({"phase": "pallas_parity", "checks": checks, "matcher_odd_shapes": matcher_odd,
          "bitwise": True, "max_abs_err": unit_errs, "refused": refused})

    # --------------------------------------------------------- timing ---
    rows = []
    for name, (a, pats, packed, pwp, w2) in gemms.items():
        idx, res, (br, bc, bs, bm), (crows, ccols, csigns) = unit_operands(a, pats, pwp, w2,
                                                                          budget)
        M_, K = a.shape
        T, q, _ = pats.shape
        N = w2.shape[1]
        real = csigns != 0
        entries = int(real.sum())
        w_cols = int(torch.unique(ccols[real]).numel())
        bounds = unit_bounds(a, pats, idx, pwp, entries, w_cols, N, br.shape[0] * bm)
        offsets = (torch.arange(T, device=dev) * (q + 1))[None]
        bags = (idx.long() + offsets).contiguous()
        table = pwp.reshape(T * (q + 1), N)
        sparse = torch.sparse_coo_tensor(torch.stack([crows[real].long(), ccols[real].long()]),
                                         csigns[real].float(), (M_, K)).coalesce()

        def lowered_gather(idx=idx, pwp=pwp):
            """The gather as the lowering calls it: a zeroed flag, the kernel,
            the flag's copy to the host (read at the packer's sync, untimed)."""
            flag = make_range_flag(dev)
            out = l1_gather_cuda(idx, pwp, range_flag=flag)
            range_flag_to_host(flag)
            return out

        calls = {   # the kernels' calls are kept (``_fn``): bound to this GEMM's operands
            "matcher": (lambda a=a, pats=pats, packed=packed: matcher_cuda(a, pats,
                                                                           packed=packed),
                        lambda: matcher_plain(a, pats), None),
            "l1_gather": (lowered_gather, lambda: l1_gather_plain(idx, pwp),
                          lambda: F.embedding_bag(bags, table, mode="sum")),
            "l2_spmm": (lambda br=br, bc=bc, bs=bs, w2=w2, bm=bm: l2_spmm_cuda(br, bc, bs, w2,
                                                                              block_m=bm),
                        lambda: l2_spmm_plain(br, bc, bs, w2, block_m=bm),
                        lambda: torch.sparse.mm(sparse, w2)),
        }
        for kern, (fn, plain, lib) in calls.items():
            b_ms, o_ms = bounds[kern]
            rows.append({"kernel": kern, "layer": name, "M": M_, "K": K, "N": N, "T": T,
                         "l2_entries": entries, "ms": cuda_time_ms(fn),
                         "_fn": fn,
                         # a direct call: the range checked on the host first
                         **({"ms_checked": cuda_time_ms(lambda: l1_gather_cuda(idx, pwp))}
                            if kern == "l1_gather" else {}),
                         "plain_ms": cuda_time_ms(plain, runs=3, warmup=1),
                         "library_ms": None if lib is None else cuda_time_ms(lib),
                         "bytes_ms": b_ms, "ops_ms": o_ms, "bound_ms": max(b_ms, o_ms),
                         "launches_per_batch": 1})
    attach_device_ms(rows, lambda row: row["kernel"])
    with torch.no_grad():
        x = batches[0]
        times = {"pallas": lambda: M.phi_apply(params, pcfg, state, x),
                 "policy": lambda: M.phi_apply(params, cfg, state, x),
                 "dense": lambda: M.apply(params, cfg, x)}
        per_batch = {path: cuda_time_ms(fn, runs=10) for path, fn in times.items()}
        profile = device_profile(times["pallas"], per_batch["pallas"])
    emit({"phase": "pallas_timing", "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "units": rows, "phi_apply_ms_per_batch": per_batch, "profile_pallas": profile})

    entries = []
    for kern, source, replaces in (
            ("matcher", "matcher.cu", "src/repro/kernels/matcher.py:48"),
            ("l1_gather", "phi_gather.cu", "src/repro/kernels/phi_gather.py:52"),
            ("l2_spmm", "phi_spmm.cu", "src/repro/kernels/phi_spmm.py:50")):
        krows = [r for r in rows if r["kernel"] == kern]
        b_ms, by = bound(krows)
        entries.append({
            "name": kern, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces, "launches": launches[f"{kern}_cuda"],
            "max_abs_err": unit_errs[kern], "ms": sum(r["ms"] for r in krows),
            "device_ms": device_sum(krows),
            **({"ms_checked": sum(r["ms_checked"] for r in krows)}
               if kern == "l1_gather" else {}),
            "plain_ms": sum(r["plain_ms"] for r in krows), "bound_ms": b_ms, "bound_by": by,
            "library_ms": None if kern == "matcher" else sum(r["library_ms"] for r in krows)})
    return entries


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
    from repro_torch.kernels import _build, dispatch, ops
    from repro_torch.kernels.lif import lif_sequence_cuda, lif_step_cuda
    from repro_torch.kernels.phi_attention import flash_attention_cuda, phi_flash_attention_cuda
    from repro_torch.kernels.phi_fused import (
        phi_fused_cuda, phi_fused_plain, phi_fused_prefetch_cuda, phi_fused_prefetch_plain,
        phi_fused_stream_cuda)
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
    lib = _build.library()
    gt = ops.stream_group_t(128, 16)
    # Blocks one SM holds, at the main paths' shapes (q = 128, k = 16; the
    # first kernel at the spikformer's T = 24 and conv2's T = 72; the
    # spikformer's attention sites; fc2's N = 384 and conv3/conv4's 512).
    resident = {"phi_fused_t24": lib.phi_fused_occupancy(0, 128, 16, 0, 384, 24),
                "phi_fused_t72": lib.phi_fused_occupancy(0, 128, 16, 0, 256, 72),
                "phi_fused_prefetch_t24": lib.phi_fused_occupancy(1, 128, 16, 0, 384, 24),
                "phi_fused_stream_n384": lib.phi_fused_occupancy(2, 128, 16, gt, 384, 0),
                "phi_fused_stream_n512": lib.phi_fused_occupancy(2, 128, 16, gt, 512, 0),
                "phi_flash_attention_64_64": lib.phi_attention_occupancy(64, 64, 32, 2, 128, 1),
                "flash_attention_dense_64_64": lib.phi_attention_occupancy(64, 64, 32, 0, 0, 0)}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.build_info.get("seconds"),
          "ptxas": _build.build_info.get("ptxas", []), "stream_group_t": gt,
          "resident_blocks_per_sm": resident})

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

    counted = (phi_fused_cuda, phi_fused_stream_cuda, phi_fused_prefetch_cuda, lif_sequence_cuda,
               lif_step_cuda, phi_flash_attention_cuda, flash_attention_cuda)
    policy = dispatch.PhiExecutionPolicy()
    prev_policy = dispatch.set_policy(policy)
    for fn in counted:
        fn.launches = 0
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
    launches = {fn.__name__: fn.launches for fn in counted}
    main_s = time.perf_counter() - t0
    decisions = policy.decisions()
    dispatch.set_policy(prev_policy)

    for i, (p, d) in enumerate(logits):
        if p.shape != (BATCH, 10) or not torch.isfinite(p).all():
            raise AssertionError(f"batch {i}: logits {tuple(p.shape)} not finite/(B, 10)")
        if not torch.equal(p, d):
            raise AssertionError(f"batch {i}: phi_apply logits differ from dense apply, max "
                                 f"|diff| {float((p - d).abs().max())}")
        if float(p.abs().sum()) == 0:
            raise AssertionError(f"batch {i}: all logits are zero (no spikes reached the head)")
    # The gate's kernel per layer: conv3 and conv4 (T >= 96) streamed, a
    # layer whose calibration usage is skewed prefetched, the rest on the
    # first kernel; five Phi GEMMs a batch.
    routes = gate_routes(params, state, acts)
    if len(routes) != 5:
        raise AssertionError(f"calibrated layers {sorted(routes)} != 5")
    check_fused_launches(launches, routes, "vgg")
    check_decisions(decisions, routes, "vgg")
    if launches["lif_sequence_cuda"] <= 0:
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
          "decisions": [[*key, n] for key, n in sorted(decisions.items())], "routes": routes,
          "logits_bitwise_equal_dense": True, "logits_equal_cpu_plain": True,
          "layers": layers})

    # ------------------------------------------------------------- parity ---
    def fused_args(name, w2, pwp=None, scale=None):
        pats = state.patterns[name]
        pwp = state.pwp[name] if pwp is None else pwp
        scale = torch.ones(pwp.shape[:2], device=dev) if scale is None else scale
        return [acts[name].contiguous(), pats, pwp, scale, w2]

    fused_errs, fused_rows_checked = {}, []
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
            nnz = fused_checks(f"{name} {case}", args, packed,
                               active_sets(args, state.p_active[name]))
            if case == "f32" and nnz != round(L["l2_density"] * L["M"] * L["K"]):
                raise AssertionError(f"{name}: l2_nnz {nnz} disagrees with phi_stats")
        # Off the 2^-10 grid only the order of each partition's <= k-term L2
        # sum differs (ascending set bits in the kernels, a matmul in the plain
        # version). Bound: T partitions x k terms x k*max|w| x 2^-24.
        wr = raw_w[name].reshape(-1, L["N"])
        pwp_r = pattern_weight_products(state.patterns[name], wr)
        args = fused_args(name, wr, pwp_r)
        pout, _ = phi_fused_plain(*args, block_m=256)
        active = active_sets(args, state.p_active[name])
        ppout, _ = phi_fused_prefetch_plain(*args, active, block_m=256)
        tol = T * 16 * 16 * float(wr.abs().max()) * 2.0 ** -24
        errs = {}
        for kern, extra, want in ((phi_fused_cuda, (), pout), (phi_fused_stream_cuda, (), pout),
                                  (phi_fused_prefetch_cuda, (active,), ppout)):
            out, _ = kern(*args, *extra, block_m=256, packed=packed)
            errs[kern.__name__] = float((out - want).abs().max())
            if errs[kern.__name__] > tol:
                raise AssertionError(f"{name} unrounded weights, {kern.__name__}: max |diff| "
                                     f"{errs[kern.__name__]} > {tol}")
        fused_errs = {kern: max(err, fused_errs.get(kern, 0.0)) for kern, err in errs.items()}
        fused_rows_checked.append({"layer": name, "bitwise": list(cases), "unrounded_err": errs,
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
        ("stream group_t=9", lambda: phi_fused_stream_cuda(
            torch.zeros((8, 16), device=dev), torch.zeros((1, 4, 16), device=dev),
            torch.zeros((1, 5, 8), device=dev), torch.ones((1, 5), device=dev),
            torch.zeros((16, 8), device=dev), block_m=8, group_t=9)),
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
    with torch.no_grad():
        lif_inputs = record_lif_inputs(lambda: M.apply(params, cfg, batches[0]))
    lif_timing, lif_err = lif_rows(lif_inputs)
    torch.cuda.synchronize()
    emit({"phase": "parity", "phi_fused": fused_rows_checked, "max_abs_err": fused_errs,
          "lif_shapes": [r["shape"] for r in lif_timing], "lif_bitwise": True,
          "lif_max_abs_err": lif_err, "refused": refused})

    # ------------------------------------------------------------- timing ---
    timing = []
    for name in acts:
        args = fused_args(name, params[name]["w"].reshape(-1, layers[name]["N"]))
        timing.append(fused_timing(name, args, state.packed[name], routes[name],
                                   active_sets(args, state.p_active[name]), plain_runs=5))
    attach_device_ms(timing, lambda row: FUSED_KERNEL[row["route"]])
    with torch.no_grad():
        phi_ms = cuda_time_ms(lambda: M.phi_apply(params, cfg, state, batches[0]), runs=10)
        dense_ms = cuda_time_ms(lambda: M.apply(params, cfg, batches[0]), runs=10)
        profiles = {"phi_apply": device_profile(
                        lambda: M.phi_apply(params, cfg, state, batches[0]), phi_ms),
                    "apply": device_profile(lambda: M.apply(params, cfg, batches[0]), dense_ms)}
    emit({"phase": "timing", "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "phi_fused": timing, "lif_sequence": lif_timing,
          "phi_apply_ms_per_batch": phi_ms, "apply_ms_per_batch": dense_ms,
          "profile": profiles})

    # ------------------------------------------------------------- pallas ---
    unit_entries = pallas_path(dev, cfg, params, state, batches, [d for _, d in logits], smi)

    # --------------------------------------------------------- spikformer ---
    spk = spikformer_path(dev, images, smi)

    # ------------------------------------------------------------ summary ---
    # Times are per batch of the main paths: the sum over the calls one
    # batch of each path makes (the VGG's five Phi GEMMs and the
    # spikformer's seventeen, each on the kernel its path runs; both paths'
    # LIF sequences; the spikformer's four attention sites; the pallas path's
    # five GEMMs for the matcher, gather and spmm). Launches are the counts
    # of the main paths' runs, VGG and spikformer added.
    print(smi, flush=True)
    all_fused = timing + spk["fused_rows"]
    all_lif = lif_timing + spk["lif_rows"]
    spk_launches = spk["launches"]

    def fused_entry(impl, replaces):
        rows = [r for r in all_fused if r["route"] == impl]
        n = launches[f"phi_{impl}_cuda"] + spk_launches[f"phi_{impl}_cuda"]
        if not rows or n == 0:
            raise AssertionError(f"phi_{impl} ran on neither main path")
        b_ms, by = bound(rows)
        return {"name": f"phi_{impl}", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/phi_fused.cu", "replaces": replaces,
                "launches": n,
                "max_abs_err": fused_errs[f"phi_{impl}_cuda"], "ms": sum(r["ms"] for r in rows),
                "device_ms": device_sum(rows),
                "plain_ms": sum(r["plain_ms"] for r in rows), "bound_ms": b_ms, "bound_by": by,
                "library_ms": sum(r["library_ms"] for r in rows)}

    lif_bound, lif_by = bound(all_lif)
    emit({"kernels": [
        fused_entry("fused", "src/repro/kernels/phi_fused.py:135"),
        {"name": "lif_sequence", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/lif.cu",
         "replaces": "src/repro/kernels/lif.py:39",
         "launches": launches["lif_sequence_cuda"] + spk_launches["lif_sequence_cuda"],
         "max_abs_err": max(lif_err, spk["lif_err"]),
         "ms": sum(r["ms"] for r in all_lif), "device_ms": device_sum(all_lif),
         "plain_ms": sum(r["plain_ms"] for r in all_lif),
         "bound_ms": lif_bound, "bound_by": lif_by, "library_ms": None},
        spk["attn_entry"],
        fused_entry("fused_stream", "src/repro/kernels/phi_fused.py:326"),
        fused_entry("fused_prefetch", "src/repro/kernels/phi_fused.py:549"),
        *unit_entries,
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
