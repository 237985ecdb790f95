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
  ``spikformer_parity``, ``spikformer_timing``;
* the paper's accelerator evaluation — ``accel_sim`` (one batch of the VGG
  and of Spikformer-4-384: ``capture_phi_traces`` on the card, the matcher
  kernel assigning every calibrated GEMM, each trace held to the integer
  against the plain matcher's and each layer's L2 entries against the fused
  kernels' ``l2_nnz``; the event-driven sims of the Phi accelerator and of
  Eyeriss and ``perfmodel.compare``, modelled numbers of the paper's 28 nm,
  500 MHz design; ``phi_kernel_traffic`` at the Hopper kernels' tiles beside
  each GEMM's bound and device time; the measured kernel-launch constant and
  what ``ops.launch_cost_prefers_coo`` decides at each GEMM);
* training and PAFT (the paper's Sec. 3.3–3.4 workflow) — ``train`` (the
  VGG's weights trained with surrogate gradients on the card; step 1's loss
  and gradients against the same step on the CPU; CUDA-event ms a step and
  the profiler's busy share), ``paft`` (the trained weights calibrated, Phi
  inference over four batches, PAFT with the matcher kernel assigning every
  step, recalibration, Phi inference again: logits bitwise equal to dense
  inference in both rounds, L2 density from ``phi_stats`` and from the fused
  kernels' ``l2_nnz`` before and after), ``spikformer_train`` (Spikformer-4-384
  trained through the attention kernel's dense instantiation with its
  logsumexp and the flash backward; lse and one site's gradients against
  the plain versions);
* LM serving — ``lm_serve`` (OLMo-1B at full width in Phi spiking mode,
  depth cut to ``LM_LAYERS`` = 2 of its 16 layers, T = 4, q = 128, k = 16:
  params from a seeded generator on the card, rounded onto the 2^-10 grid;
  ``calibrate_lm_phi`` on 2 x 128 tokens; the prefill gate,
  ``train_logits`` at B = 1, S = 2048, Phi logits bitwise the spiking-dense
  ones with the attention kernel at every layer; the serving
  engine over 8 requests and 4 slots as Phi, spiking-dense, paged and
  paged-with-preemption runs, token- and logit-identical; the policy's
  decisions at prefill and decode; each kernel the phase launched against
  its plain version at layer 0's operands; prefill, decode and GEMM timings
  beside their bounds; PWP bytes and peak memory; the dry run's trace of a
  decode step and a prefill against the same steps run once: each kernel's
  launches and the argument bytes equal, the roofline's step time beside
  the step's);
* serving on a mesh — ``mesh_serve`` (``lm_serve``'s calibrated OLMo-1B on
  a (data 2, model 2) mesh of four spawned ranks sharing the card, talking
  through gloo, each holding its shards (cut here, passed through host
  shared memory): a 2 x 2048 Phi prefill and 4 decode steps bitwise one device's,
  a short prompt's forced-``coo`` run bitwise the policy's, the engine over
  ``lm_serve``'s requests token-identical, a paged engine from
  ``lm_serve``'s undersized pool (each rank's pools its KV heads and every
  page) preempting, token-identical and logit-identical to ``lm_serve``'s
  paged engine from that pool, the w1 and w2 decisions a fused
  kernel in the per-rank body with ``shards`` 4, each rank's launches
  counted; rank 0's kernels against their plain versions at its layer-0
  local operands; then one Arctic-480B MoE layer at full width, ``moe_dense``
  here and ``moe_ep`` over four ranks of 32 experts, within ``MOE_ULPS``
  bf16 ulps, no token dropped; per-rank times, collectives and peak memory;
  the dry run of the (data 2, model 2) cell in a fake world against every
  rank's first prefill and decode step: collective calls and result bytes
  by kind and argument bytes, exactly);
* the dry run — ``dryrun`` (``olmo_1b`` × ``decode_32k`` × 16 x 16 in Phi
  mode through ``python -m repro_torch.launch.dryrun`` in a subprocess: a
  fake world of 256 ranks, fake card tensors; the roofline on the H100's
  data-sheet rates, per-rank memory, the kernel plan, seconds);
* hybrid serving — ``hybrid_serve`` (Zamba2-1.2B at full width in Phi
  spiking mode, depth cut to ``HYB_LAYERS`` = 14 of its 38 layers: 12
  Mamba-2 layers in 2 sites, each followed by the shared attention + MLP
  block with the site's LoRA on Q, then the 2 tail layers; ``lm_serve``'s
  calibration batch, prefill gate and requests; the engine as Phi and
  spiking-dense runs, token- and logit-identical, a one-slot Phi engine
  over two requests, token-identical, and a ``paged=True`` engine that
  keeps dense slots; each kernel against its plain version at layer 0's
  operands; prefill, decode and GEMM timings at the wz, wB (N = 64) and wo
  sites; calibration seconds and peak memory);
* the hybrid on a mesh — ``hybrid_mesh`` (``hybrid_serve``'s calibrated
  params cut to the first site and the tail, 8 layers at full width, no
  second calibration; on (data 2, model 2), four spawned ranks sharing the
  card through gloo, shards through host shared memory: a 2 x 2048 Phi
  prefill and 4 decode steps bitwise one device's, the engine over
  ``hybrid_serve``'s requests token-identical to one device's engine,
  every ``lm.*.spmd`` decision a fused kernel in the per-rank body with
  ``shards`` 4, each rank's decode state at its placements' local shapes,
  each rank's launches counted; rank 0's kernels against their plain
  versions at its layer-0 local operands (LIF, streaming at wz and the
  Mamba-2 wo, the first fused kernel at the shared wo, attention at 16
  heads); then the same 8 layers dense at float32, 2 ZeRO-3 /
  tensor-parallel steps through ``train_loop(mesh=)`` at S = 2048, global
  batch 2, against one device's: step 1's loss within 2^-12, every
  gathered gradient leaf within 2^-5 of its largest entry, the params
  within 2 sum(lr); step 1 at the config's bf16 too, loss within 2^-12 and
  gradients within 2^-2 of one device's bf16 ones, beside one device's own
  bf16 gap to float32; per-rank ms beside one device's, collectives, peak
  memory);
* LM training and checkpoints — ``lm_train`` (OLMo-1B at full width,
  ``LM_TRAIN_LAYERS`` = 2 deep, through ``launch.train.train_loop`` at B = 1, S =
  2048, every layer's attention on the kernel with lse under autograd:
  step 1 against the same step with the attention's plain forward; dense,
  6 uninterrupted steps against 3 checkpointed steps and a resume to 6,
  the checkpoint restored bitwise, a second resume that runs no step, an
  engine over the checkpoint's params token-identical to one over the
  trained params in memory; the launcher's ``--phi`` config (T = 2, q = 16,
  ``LM_TRAIN_PHI_LAYERS`` = 1 layer) calibrated by the loop (LIF and
  matcher kernels), 3 steps on ``coo``,
  then rounded, recalibrated and Phi ``train_logits`` bitwise its
  spiking-dense arm (the streaming kernel); ms a step and its parts,
  checkpoint bytes, save and restore seconds, peak memory);
* training on a mesh — ``mesh_train`` (OLMo-1B at full width, ``MT_LAYERS`` = 2
  deep, S = 2048, global batch 2, on four spawned ranks sharing the card through gloo, against one
  device's run of the same params and batches: A, ZeRO-3 / tensor-parallel
  steps on (data 2, model 2) through ``train_loop(mesh=)``, step 1's loss
  and every gathered gradient leaf, 4 steps' losses and final params, a
  crash at step 2 whose checkpoint is byte for byte one device's and a
  resume on (data 1, model 4); B, int8 error-feedback gradients across
  (pod 2, data 1, model 2) against the uncompressed mesh step; C, the GPipe
  pipeline of four full-width decoder-layer stages (the two layers in turn)
  over pod = 4, bitwise the stages in sequence; D, the ``--phi`` config calibrated here once, 2 steps,
  every ``lm.*.spmd`` GEMM on ``coo``; per-rank collectives, step ms beside
  one device's, peak memory and attention launches).

Every ``*main_path`` phase, ``lm_serve``, ``mesh_serve``, ``hybrid_serve``,
``hybrid_mesh``, ``lm_train`` and ``mesh_train`` print the policy's
decisions (site, impl, reason, count). Each main path, ``accel_sim``'s
captures and ``phi_apply`` calls, each of the four training phases, the
serving phases' counted runs and ``hybrid_mesh``'s serving and training
runs on every rank are driven with every kernel's launch count set to 0
just before and read just after. The card's
``nvidia-smi`` name and power limit sit on their own line before the
summary; the last line is the result object.

Any failure raises and exits non-zero: no phase is caught. Without a CUDA
card, or run where ``src/repro_torch`` is not beside it, it exits 1 and
prints no result. It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import json
import os
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
# Spikformer-4-384 (Zhou et al., ICLR 2023, CIFAR-10): 4 blocks, 384 wide, 12 heads.
SPIKFORMER = dict(kind="spikformer", input_size=32, input_channels=3, num_classes=10,
                  timesteps=4, dim=384, heads=12, blocks=4, attn="flash")
BATCH = 32
BATCHES = 4
GAIN = 3.0     # every weight but the encoder's: keeps spikes alive at depth (random init)
ATTN_ULPS = 16  # phi_flash_attention against its plain version, in ulps of max|V|
SEED = 0
# Training and PAFT. Images on the 2^-10 grid, so step 1's spikes are the
# same on the card and the CPU; trained weights are rounded onto the grid
# before each calibration, so Phi inference stays bitwise against dense.
TRAIN_IMAGES, TEST_IMAGES = 1024, 256
TRAIN_STEPS = 30
TRAIN_OPT = dict(lr=1e-3, warmup_steps=5, decay_steps=TRAIN_STEPS, weight_decay=1e-4)
PAFT_STEPS, PAFT_LAM, PAFT_LR = 20, 50.0, 1e-3
SPK_TRAIN_STEPS = 5
LOSS_REL = 1e-6  # step 1's loss, card against CPU (one log-softmax, rounded otherwise)
GRAD_REL = 1e-5  # gradients against another order of the backward's sums
LSE_ULPS = 64    # the kernel's lse against _flash_fwd_impl's, in ulps of max(1, max|lse|)

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 CUDA-core FLOP/s
# and dense int8 tensor-core operations/s, from the port's hwconst. Outside a
# checkout there is none: main() then says so and exits 1.
if (SRC / "repro_torch" / "__init__.py").is_file():
    sys.path.insert(0, str(SRC))
    from repro_torch.core.hwconst import F32_FLOP_PER_S, HBM_BYTES_PER_S, INT8_OPS_PER_S
    from repro_torch.kernels import costs
else:
    F32_FLOP_PER_S = HBM_BYTES_PER_S = INT8_OPS_PER_S = costs = None
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
            "kernel_launches": sum(r[2] for r in kernels),
            "top": [[name[:90], ms, n] for name, ms, n in kernels[:10]]}


def step_parts_ms(cfg, params, ocfg, x, y) -> dict:
    """CUDA-event ms of a train step's parts at one batch: the forward under
    autograd (the LIF layers' differentiable loop, the graph kept), forward
    and backward (``loss_and_grads``), and the optimizer update alone."""
    import torch

    from repro_torch.snn import models as M
    from repro_torch.snn import train as snn_train
    from repro_torch.train import optimizer as opt

    leaves = {n: {"w": leaf["w"].detach().requires_grad_()} for n, leaf in params.items()}
    grads, _ = snn_train.loss_and_grads(params, cfg, x, y)
    state = opt.init(params, ocfg)
    with torch.enable_grad():
        fwd = cuda_time_ms(lambda: M.apply(leaves, cfg, x), runs=10)
    return {"forward_autograd_ms": fwd,
            "forward_backward_ms": cuda_time_ms(
                lambda: snn_train.loss_and_grads(params, cfg, x, y), runs=10),
            "optimizer_ms": cuda_time_ms(lambda: opt.apply_updates(params, grads, state, ocfg),
                                         runs=10)}


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


def bound_ms(cost, rate=None) -> tuple[float, float]:
    """(bytes ms, operations ms) of a ``kernels.costs`` count (ops, bytes):
    the bytes against HBM, the operations against ``rate`` (default the
    float32 CUDA-core peak)."""
    ops, nbytes = cost
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / (rate or F32_FLOP_PER_S) * 1e3


def fused_bound_ms(M, K, N, T, q, k, l2_entries, pwp_rows=None, w_rows=None,
                   l1_pairs=None) -> tuple[float, float]:
    """Least time for one fused Phi matmul (``costs.fused``: this run's
    residual entries, the PWP and weight rows and the matched pairs the call
    needs; the integer match work not counted)."""
    return bound_ms(costs.fused(M, K, N, T, q, k, l2_entries, pwp_rows, w_rows, l1_pairs))


def needed_bound_ms(a, patterns, N) -> tuple[float, float]:
    """:func:`fused_bound_ms` counting what these rows need
    (``costs.fused_needed``)."""
    return bound_ms(costs.fused_needed(a, patterns, N))


def lif_bound_ms(T, n) -> tuple[float, float]:
    """Least time for the LIF sequence (``costs.lif_sequence``)."""
    return bound_ms(costs.lif_sequence(T, n))


def attn_bound_ms(B, S, H, D, T, qp, kp, nq, l2_entries) -> tuple[float, float]:
    """Least time for one Phi flash-attention call on this run's data
    (``costs.phi_attention``; the integer match not counted)."""
    return bound_ms(costs.phi_attention(B, S, H, D, T, qp, kp, nq, l2_entries))


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

    cfg = M.SNNConfig(**SPIKFORMER, phi=PhiConfig(k=16, q=128, iters=20))
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
                  "launches": launches["phi_flash_attention_cuda"],
                  "launches_by_path": {"spikformer": launches["phi_flash_attention_cuda"]},
                  "max_abs_err": attn_err,
                  "ms": sum(r["ms"] for r in rows), "device_ms": device_sum(rows),
                  "plain_ms": sum(r["plain_ms"] for r in rows),
                  "bound_ms": total, "bound_by": by,
                  "library_ms": sum(r["library_ms"] for r in rows),
                  "dense_instantiation_ms": sum(r["dense_ms"] for r in rows),
                  "dense_instantiation_launches": launches["flash_attention_cuda"]}
    return {"attn_entry": attn_entry, "fused_rows": fused_rows, "lif_rows": lif_timing,
            "lif_err": lif_err, "launches": launches, "cfg": cfg, "params": params,
            "state": state}


def unit_bounds(a, pats, idx, pwp, entries, w_cols, N, G_bm) -> dict:
    """Least times of the three per-unit kernels on one GEMM, (bytes ms,
    operations ms) each, from ``kernels.costs``: the matcher's scores as
    int8 tensor-core work; the gather reading each distinct (t, index) bank
    row its indices name once; the spmm reading the real entries and the
    weight rows they name."""
    import torch

    M, K = a.shape
    T, q, _ = pats.shape
    rows_named = int(torch.unique(idx.long() + torch.arange(T, device=idx.device)
                                  * (q + 1)).numel())
    return {"matcher": bound_ms(costs.matcher(M, K, T, q, pats.shape[2]), INT8_OPS_PER_S),
            "l1_gather": bound_ms(costs.l1_gather(M, T, N, rows_named, pwp.element_size())),
            "l2_spmm": bound_ms(costs.l2_spmm(entries, w_cols, N, G_bm))}


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
            "launches_by_path": {"pallas": launches[f"{kern}_cuda"]},
            "max_abs_err": unit_errs[kern], "ms": sum(r["ms"] for r in krows),
            "device_ms": device_sum(krows),
            **({"ms_checked": sum(r["ms_checked"] for r in krows)}
               if kern == "l1_gather" else {}),
            "plain_ms": sum(r["plain_ms"] for r in krows), "bound_ms": b_ms, "bound_by": by,
            "library_ms": None if kern == "matcher" else sum(r["library_ms"] for r in krows)})
    return entries


def counted_kernels():
    """Every kernel wrapper's launch counter, in one tuple."""
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.lif import lif_sequence_cuda, lif_step_cuda
    from repro_torch.kernels.matcher import matcher_cuda
    from repro_torch.kernels.phi_attention import flash_attention_cuda, phi_flash_attention_cuda
    from repro_torch.kernels.phi_fused import (
        phi_fused_cuda, phi_fused_prefetch_cuda, phi_fused_stream_cuda)
    from repro_torch.kernels.phi_gather import l1_gather_cuda
    from repro_torch.kernels.phi_spmm import l2_spmm_cuda

    return (phi_fused_cuda, phi_fused_stream_cuda, phi_fused_prefetch_cuda, lif_sequence_cuda,
            lif_step_cuda, phi_flash_attention_cuda, flash_attention_cuda, matcher_cuda,
            l1_gather_cuda, l2_spmm_cuda, decode_attention_cuda)


def zero_launches() -> None:
    from repro_torch.kernels.phi_attention import flash_attention_cuda

    for fn in counted_kernels():
        fn.launches = 0
    flash_attention_cuda.lse_launches = 0


def read_launches() -> dict:
    from repro_torch.kernels.phi_attention import flash_attention_cuda

    return {**{fn.__name__: fn.launches for fn in counted_kernels()},
            "flash_attention_cuda_lse": flash_attention_cuda.lse_launches}


def train_data():
    """Training images (``TRAIN_IMAGES``, seed 1) and held-out test images
    (``TEST_IMAGES``, seed 2), 32x32, on the 2^-10 grid, as numpy."""
    import torch

    from repro_torch.snn.data import synthetic_images

    out = []
    for n, seed in ((TRAIN_IMAGES, SEED + 1), (TEST_IMAGES, SEED + 2)):
        x, y = synthetic_images(n, size=32, seed=seed)
        out.append((dyadic(torch.from_numpy(x)).numpy(), y))
    return out


def grid(params):
    return {name: {"w": dyadic(leaf["w"])} for name, leaf in params.items()}


def rel_err(got, want) -> float:
    """max |got - want| over max |want| (want on the CPU or the card)."""
    return float((got.cpu() - want.cpu()).abs().max()) / max(float(want.abs().max()), 1e-30)


def train_phase(dev, cfg, params, data, smi) -> dict:
    """The ``train`` phase: the VGG of the main path (its x GAIN, 2^-10-grid
    weights) trained ``TRAIN_STEPS`` steps on the card, accuracy before and
    after; step 1 against the CPU; ms a step. Returns the trained weights and
    the phase's launch counts."""
    import numpy as np
    import torch

    from repro_torch.snn import models as M
    from repro_torch.snn import train as snn_train
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.optimizer import init as opt_init

    (x, y), (xt, yt) = data
    ocfg = OptConfig(**TRAIN_OPT)
    # Step 1 as train() draws it, on the card and on the CPU: identical
    # spikes (grid weights and images), another order of the backward's sums.
    sl = np.random.default_rng(SEED).integers(0, len(x), BATCH)
    xb, yb = torch.from_numpy(x[sl]), torch.from_numpy(y[sl])
    grads, (loss, _) = snn_train.loss_and_grads(params, cfg, xb.to(dev), yb.to(dev))
    cpu_params = {name: {"w": leaf["w"].cpu()} for name, leaf in params.items()}
    cgrads, (closs, _) = snn_train.loss_and_grads(cpu_params, cfg, xb, yb)
    loss_err = abs(float(loss) - float(closs)) / abs(float(closs))
    grad_err = {name: rel_err(grads[name]["w"], cgrads[name]["w"]) for name in grads}
    if loss_err > LOSS_REL or max(grad_err.values()) > GRAD_REL:
        raise AssertionError(f"train step 1: card against CPU, loss {loss_err} (tol "
                             f"{LOSS_REL}), gradients {grad_err} (tol {GRAD_REL})")
    if any(float(g["w"].abs().max()) == 0 for g in cgrads.values()):
        raise AssertionError("train step 1: a layer's gradient is zero")

    zero_launches()
    t0 = time.perf_counter()
    trained, hist = snn_train.train(cfg, x, y, steps=TRAIN_STEPS, batch=BATCH, ocfg=ocfg,
                                    seed=SEED, params=params, log_every=0, device=dev)
    train_s = time.perf_counter() - t0
    acc0 = snn_train.evaluate(params, cfg, xt, yt)
    acc1 = snn_train.evaluate(trained, cfg, xt, yt)
    torch.cuda.synchronize()
    launches = read_launches()
    losses = [h[0] for h in hist]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train: a loss is not finite: {losses}")
    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not last5 < first5:
        raise AssertionError(f"train: mean of the last 5 losses {last5} >= first 5 {first5}")
    if abs(losses[0] - float(loss)) > LOSS_REL * abs(float(loss)):
        raise AssertionError(f"train: step 1's loss {losses[0]} != loss_and_grads' {loss}")
    if launches["lif_sequence_cuda"] <= 0:
        raise AssertionError("train: evaluate never launched the LIF kernel")

    step_fn = snn_train.make_train_step(cfg, ocfg)
    state = opt_init(trained, ocfg)
    xd, yd = xb.to(dev), yb.to(dev)
    step_ms = cuda_time_ms(lambda: step_fn(trained, state, xd, yd), runs=10, warmup=3)
    with torch.no_grad():
        dense_ms = cuda_time_ms(lambda: M.apply(trained, cfg, xd), runs=10)
    profile = device_profile(lambda: step_fn(trained, state, xd, yd), step_ms)
    parts = step_parts_ms(cfg, trained, ocfg, xd, yd)
    emit({"phase": "train", "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "config": {"kind": cfg.kind, "widths": cfg.widths, "input_size": cfg.input_size,
                     "timesteps": cfg.timesteps, "batch": BATCH, "steps": TRAIN_STEPS,
                     "images": TRAIN_IMAGES, "opt": TRAIN_OPT},
          "losses": losses, "first5_mean": first5, "last5_mean": last5,
          "accuracy_before": acc0, "accuracy_after": acc1, "test_images": TEST_IMAGES,
          "step1_cpu": {"loss_rel_err": loss_err, "loss_tol": LOSS_REL,
                        "grad_rel_err": grad_err, "grad_tol": GRAD_REL},
          "train_s": train_s, "launches": launches, "ms_per_step": step_ms,
          "dense_forward_ms": dense_ms, "step_parts": parts, "profile_step": profile})
    return {"params": trained, "launches": launches}


def phi_round(cfg, w, calib_x, batches) -> dict:
    """Calibrate ``w``, run phi_apply and dense apply over ``batches`` through
    a fresh policy, and count the L2 entries two ways: the fused kernels'
    per-block ``l2_nnz`` (the policy's counters) and ``phi_stats`` on the
    same batches' activations. Raises unless the logits are bitwise equal
    and, at every GEMM matched against the whole bank (``fused``,
    ``fused_stream``), the counts agree; a prefetched GEMM matches against
    its active sets, so its kernel count is reported beside the bank's."""
    import torch

    from repro_torch.core.assign import phi_stats
    from repro_torch.kernels import dispatch
    from repro_torch.snn import models as M

    policy = dispatch.PhiExecutionPolicy()
    prev = dispatch.set_policy(policy)
    try:
        with torch.no_grad():
            state, _ = M.calibrate_model(w, cfg, calib_x)
            logits = [(M.phi_apply(w, cfg, state, x), M.apply(w, cfg, x)) for x in batches]
        budgets = {b.site: b for b in policy.report()["packer_budgets"]}
        impls = {name: policy.last_decision(f"snn.{name}").impl for name in state.patterns}
    finally:
        dispatch.set_policy(prev)
    for i, (p, d) in enumerate(logits):
        if not torch.isfinite(p).all() or not torch.equal(p, d):
            raise AssertionError(f"batch {i}: phi_apply != dense apply, max |diff| "
                                 f"{float((p - d).abs().max())}")
    stats = dict.fromkeys(state.patterns, 0)
    size = dict.fromkeys(state.patterns, 0)
    with torch.no_grad():
        for x in batches:
            cap = {}
            M.apply(w, cfg, x, capture=cap)
            for name, act in cap.items():
                st = phi_stats(act, state.patterns[name])
                stats[name] += round(st.l2_density * act.numel())
                size[name] += act.numel()
    layers = {}
    for name in state.patterns:
        kern = budgets[f"snn.{name}"].l2_nnz_total
        if impls[name] != "fused_prefetch" and kern != stats[name]:
            raise AssertionError(f"{name}: the kernels' l2_nnz {kern} != phi_stats' {stats[name]}")
        layers[name] = {"impl": impls[name], "l2_entries": stats[name],
                        "l2_density": stats[name] / size[name], "kernel_l2_entries": kern}
    density = sum(v["l2_density"] for v in layers.values()) / len(layers)
    return {"state": state, "layers": layers, "l2_density_mean": density,
            "l2_density_pooled": sum(v["l2_entries"] for v in layers.values())
            / sum(size.values())}


def paft_phase(dev, cfg, trained, images, data, smi) -> dict:
    """The ``paft`` phase: the trained weights (on the 2^-10 grid) calibrated
    and run through Phi inference, PAFT for ``PAFT_STEPS`` steps, then the
    same again; densities, accuracy, the matcher's launches, ms a step."""
    import numpy as np
    import torch

    from repro_torch.core import paft
    from repro_torch.snn import train as snn_train
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.optimizer import init as opt_init

    (x, y), (xt, yt) = data
    calib_x, batches = images[:BATCH], images[BATCH:].split(BATCH)
    w0 = grid(trained)
    zero_launches()
    t0 = time.perf_counter()
    before = phi_round(cfg, w0, calib_x, batches)
    state = before["state"]
    matcher_before = read_launches()["matcher_cuda"]
    w1, hist = paft.paft_finetune(w0, cfg, state, x, y, lam=PAFT_LAM, lr=PAFT_LR,
                                  steps=PAFT_STEPS, batch=BATCH, seed=SEED, device=dev)
    torch.cuda.synchronize()
    matcher_paft = read_launches()["matcher_cuda"] - matcher_before
    w1 = grid(w1)
    after = phi_round(cfg, w1, calib_x, batches)
    acc0 = snn_train.evaluate(w0, cfg, xt, yt)
    acc1 = snn_train.evaluate(w1, cfg, xt, yt)
    torch.cuda.synchronize()
    paft_s = time.perf_counter() - t0
    launches = read_launches()
    if matcher_paft != PAFT_STEPS * len(state.patterns):
        raise AssertionError(f"paft: matcher launched {matcher_paft} times, want "
                             f"{PAFT_STEPS} steps x {len(state.patterns)} layers")
    if not all(np.isfinite([h[0] for h in hist])):
        raise AssertionError(f"paft: a loss is not finite: {hist}")
    if not after["l2_density_mean"] < before["l2_density_mean"]:
        raise AssertionError(f"paft: L2 density {before['l2_density_mean']} -> "
                             f"{after['l2_density_mean']} did not fall")

    ocfg = OptConfig(lr=PAFT_LR, warmup_steps=0, decay_steps=PAFT_STEPS, weight_decay=0.0)
    step_fn = snn_train.make_train_step(cfg, ocfg, paft.paft_regularizer(cfg, state, PAFT_LAM))
    opt_state = opt_init(w0, ocfg)
    xd, yd = (torch.from_numpy(a[:BATCH]).to(dev) for a in (x, y))
    step_ms = cuda_time_ms(lambda: step_fn(w0, opt_state, xd, yd), runs=10, warmup=3)
    profile = device_profile(lambda: step_fn(w0, opt_state, xd, yd), step_ms)
    reg = paft.paft_regularizer(cfg, state, PAFT_LAM)
    parts = {"forward_backward_ms": cuda_time_ms(
        lambda: snn_train.loss_and_grads(w0, cfg, xd, yd, reg), runs=10)}
    emit({"phase": "paft", "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "lam": PAFT_LAM, "lr": PAFT_LR, "steps": PAFT_STEPS, "batch": BATCH,
          "weights_on_2^-10_grid": True, "losses": [h[0] for h in hist],
          "before": {k: v for k, v in before.items() if k != "state"},
          "after": {k: v for k, v in after.items() if k != "state"},
          "logits_bitwise_equal_dense": True, "batches_checked": 2 * BATCHES,
          "accuracy_before": acc0, "accuracy_after": acc1,
          "matcher_launches_paft": matcher_paft, "launches": launches, "paft_s": paft_s,
          "ms_per_step": step_ms, "step_parts": parts, "profile_step": profile})
    return {"launches": launches}


def spikformer_train_phase(dev, data, smi) -> dict:
    """The ``spikformer_train`` phase: Spikformer-4-384 (attn="flash", x GAIN
    2^-10-grid weights) trained ``SPK_TRAIN_STEPS`` steps, every attention
    site on the dense kernel with lse and the flash backward; one site's lse
    and q/k/v gradients against the plain versions. Returns the attention
    kernel's lse error and the phase's launch counts."""
    import numpy as np
    import torch

    from repro_torch.core.patterns import PhiConfig
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.phi_attention import flash_attention_cuda
    from repro_torch.models import flash as flash_mod
    from repro_torch.snn import models as M
    from repro_torch.snn import train as snn_train
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.optimizer import init as opt_init

    (x, y), _ = data
    cfg = M.SNNConfig(**SPIKFORMER, phi=PhiConfig(k=16, q=128, iters=20))
    params = M.init(cfg, torch.Generator().manual_seed(SEED), device=dev)
    for name, leaf in params.items():
        leaf["w"] = dyadic(leaf["w"] * (1.0 if name == "embed" else GAIN))
    policy = dispatch.PhiExecutionPolicy()
    prev = dispatch.set_policy(policy)
    try:
        zero_launches()
        t0 = time.perf_counter()
        trained, hist = snn_train.train(cfg, x, y, steps=SPK_TRAIN_STEPS, batch=BATCH,
                                        seed=SEED, params=params, log_every=0, device=dev)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = read_launches()
        decisions = policy.decisions()
        # One more step's attention operands, recorded at each site.
        sites, real = [], flash_mod.flash_attention

        def recording(q, k, v, causal, window, chunk, bq, bkv):
            sites.append((q.detach(), k.detach(), v.detach(), causal, bq, bkv))
            return real(q, k, v, causal, window, chunk, bq, bkv)

        flash_mod.flash_attention = recording
        try:
            xb, yb = (torch.from_numpy(a[:BATCH]).to(dev) for a in (x, y))
            snn_train.loss_and_grads(trained, cfg, xb, yb)
        finally:
            flash_mod.flash_attention = real
    finally:
        dispatch.set_policy(prev)
    n_sites = cfg.blocks * SPK_TRAIN_STEPS
    if launches["flash_attention_cuda_lse"] != n_sites or \
            launches["flash_attention_cuda"] != n_sites:
        raise AssertionError(f"spikformer_train: dense attention launches {launches}, want "
                             f"{n_sites} with lse")
    for b in range(cfg.blocks):
        key = (f"snn.b{b}_attn", "flash", "autodiff_keeps_flash")
        if decisions.get(key) != SPK_TRAIN_STEPS:
            raise AssertionError(f"spikformer_train: {key} resolved {decisions.get(key)}")
    losses = [h[0] for h in hist]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"spikformer_train: a loss is not finite: {losses}")
    if len(sites) != cfg.blocks:
        raise AssertionError(f"spikformer_train: recorded {len(sites)} sites")

    # lse at every site, and one site's gradients against plain autograd.
    lse_err, lse_tol = 0.0, 0.0
    for q, k, v, causal, bq, bkv in sites:
        _, lse = flash_attention_cuda(q, k, v, causal=causal, block_q=bq, block_kv=bkv,
                                      return_lse=True)
        _, plse = flash_mod._flash_fwd_impl(q, k, v, causal, None, None, bq, bkv)
        tol = LSE_ULPS * 2.0 ** -24 * max(1.0, float(plse.abs().max()))
        err = float((lse - plse).abs().max())
        if err > tol:
            raise AssertionError(f"spikformer_train: lse max |diff| {err} > {tol}")
        lse_err, lse_tol = max(lse_err, err), max(lse_tol, tol)
    q, k, v, causal, bq, bkv = sites[0]
    cot = torch.randn(q.shape, generator=torch.Generator().manual_seed(SEED + 5)).to(dev)
    kern = [z.clone().requires_grad_() for z in (q, k, v)]
    (flash_mod.flash_attention(*kern, causal, None, None, bq, bkv) * cot).sum().backward()
    plain = [z.clone().requires_grad_() for z in (q, k, v)]
    (flash_mod._flash_fwd_impl(*plain, causal, None, None, bq, bkv)[0] * cot).sum().backward()
    grad_err = {name: rel_err(a.grad, b.grad) for name, a, b in zip("qkv", kern, plain)}
    if max(grad_err.values()) > GRAD_REL:
        raise AssertionError(f"spikformer_train: site gradients {grad_err} > {GRAD_REL}")

    # One site, forward and backward: the kernel with lse and the flash
    # backward, against autograd through the plain forward (x4 sites a step).
    def site_step(fn):
        def run():
            z = [t.clone().requires_grad_() for t in (q, k, v)]
            (fn(*z) * cot).sum().backward()
        return run

    site = {"kernel_fwd_ms": cuda_time_ms(lambda: flash_attention_cuda(
                q, k, v, causal=causal, block_q=bq, block_kv=bkv, return_lse=True)),
            "fwd_bwd_ms": cuda_time_ms(site_step(
                lambda *z: flash_mod.flash_attention(*z, causal, None, None, bq, bkv))),
            "plain_autograd_fwd_bwd_ms": cuda_time_ms(site_step(
                lambda *z: flash_mod._flash_fwd_impl(*z, causal, None, None, bq, bkv)[0]))}
    ocfg = OptConfig(lr=1e-3, warmup_steps=20, decay_steps=SPK_TRAIN_STEPS, weight_decay=1e-4)
    step_fn = snn_train.make_train_step(cfg, ocfg)
    state = opt_init(trained, ocfg)
    step_ms = cuda_time_ms(lambda: step_fn(trained, state, xb, yb), runs=5, warmup=2)
    profile = device_profile(lambda: step_fn(trained, state, xb, yb), step_ms)
    parts = step_parts_ms(cfg, trained, ocfg, xb, yb)
    emit({"phase": "spikformer_train", "device": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "steps": SPK_TRAIN_STEPS, "batch": BATCH, "losses": losses,
          "train_s": train_s, "launches": launches,
          "decisions": [[*key, n] for key, n in sorted(decisions.items())],
          "site_shape": list(q.shape), "blocks": [bq, bkv],
          "lse_max_abs_err": lse_err, "lse_tol": lse_tol,
          "site_grad_rel_err": grad_err, "grad_tol": GRAD_REL, "site_ms": site,
          "ms_per_step": step_ms, "step_parts": parts, "profile_step": profile})
    return {"lse_err": lse_err, "launches": launches}


def launch_bytes(dev) -> dict:
    """One kernel launch in HBM byte-equivalents: the CUDA-event time of
    ``lif_sequence_cuda`` on one element (the wrapper's host time included)
    times HBM bytes/s."""
    import torch

    from repro_torch.kernels.lif import lif_sequence_cuda

    one = torch.zeros((1, 1), device=dev)
    ms = cuda_time_ms(lambda: lif_sequence_cuda(one), runs=200, warmup=20)
    return {"lif_sequence_one_element_ms": ms, "bytes": ms * 1e-3 * HBM_BYTES_PER_S}


def accel_sim_phase(dev, models, smi) -> dict:
    """The ``accel_sim`` phase: the paper's accelerator evaluation on traces
    the port captures on the card. ``models`` maps a path's name to (cfg,
    params, state, one batch, its ``fused_timing`` rows). For each model,
    with every kernel's launch count set to 0 just before and read just
    after: ``capture_phi_traces`` (the LIF kernel in ``apply``, the matcher
    kernel assigning every calibrated GEMM) and ``phi_apply`` on the same
    batch through a fresh policy. Then, outside the counted run: every trace
    against the one built by ``matcher_plain`` on the card from the same
    activations (to the integer); each layer's ``l2_nnz`` against the fused
    kernels' (gated where the site matched against the whole bank) and
    ``phi_stats``'; the event-driven sim (Phi ``asic`` dataflow, Eyeriss) and
    ``perfmodel.compare`` (modelled 28 nm / 500 MHz ASIC numbers, not the
    card's); ``phi_kernel_traffic`` at the Hopper kernels' tiles in ms at
    HBM bytes/s beside each GEMM's bound and device time; the measured
    launch constant and what ``ops.launch_cost_prefers_coo`` decides at each
    GEMM."""
    import torch

    from repro_torch.core import hwconst
    from repro_torch.core import perfmodel as pm
    from repro_torch.core.assign import phi_stats
    from repro_torch.kernels import dispatch, ops
    from repro_torch.kernels.matcher import matcher_cuda, matcher_plain
    from repro_torch.kernels.phi_fused import _BM
    from repro_torch.sim import EyerissSim, PhiAcceleratorSim, summarize_run
    from repro_torch.sim.trace import _assign_torch
    from repro_torch.snn import models as M

    t_phase = time.perf_counter()
    runs = {}
    zero_launches()
    t0 = time.perf_counter()
    for path, (cfg, params, state, x, _) in models.items():
        policy = dispatch.PhiExecutionPolicy()
        prev = dispatch.set_policy(policy)
        try:
            with torch.no_grad():
                traces = M.capture_phi_traces(params, cfg, state, x)
                M.phi_apply(params, cfg, state, x)
            torch.cuda.synchronize()
            budgets = {b.site: b for b in policy.report()["packer_budgets"]}
            impls = {t.name: policy.last_decision(t.name).impl for t in traces}
        finally:
            dispatch.set_policy(prev)
        runs[path] = (traces, budgets, impls)
    launches = read_launches()
    counted_s = time.perf_counter() - t0
    n_traces = sum(len(r[0]) for r in runs.values())
    if launches["matcher_cuda"] != n_traces:
        raise AssertionError(f"the matcher launched {launches['matcher_cuda']} times for "
                             f"{n_traces} traces")
    if launches["lif_sequence_cuda"] <= 0:
        raise AssertionError("the LIF kernel never launched in capture_phi_traces")

    out = {"phase": "accel_sim", "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "counted_s": counted_s, "launches": launches,
           "note": "sim_* and model_* are modelled numbers of the paper's 28 nm, 500 MHz "
                   "accelerator (hwconst's ASIC section), not the card's", "models": {}}
    launch = launch_bytes(dev)
    for path, (cfg, params, state, x, timing_rows) in models.items():
        traces, budgets, impls = runs[path]
        timing = {r["layer"]: r for r in timing_rows}
        with torch.no_grad():
            cap = {}
            M.apply(params, cfg, x, capture=cap)
        reps = cfg.timesteps * x.shape[0]
        layers, shapes, stats, matcher_rows = [], [], [], []
        for tr in traces:
            name = tr.name.removeprefix("snn.")
            pats = state.patterns[name]
            T, q, k = pats.shape
            a = cap[name][:, :T * k].to(torch.float32).contiguous()
            plain = _assign_torch(a, pats, matcher_plain)
            got = (tr.idx, tr.tile_pop, tr.tile_res, tr.usage)
            for field, g, want in zip(("idx", "tile_pop", "tile_res", "usage"), got, plain):
                if g.shape != want.shape or not (g == want).all():
                    raise AssertionError(f"{path} {name}: the kernel's trace {field} != the "
                                         f"plain version's")
            matcher_rows.append({"_fn": lambda a=a, p=pats, pk=state.packed[name]:
                                 matcher_cuda(a, p, packed=pk)})
            st = phi_stats(a, pats)
            if round(st.l2_density * a.numel()) != tr.l2_nnz:
                raise AssertionError(f"{path} {name}: phi_stats' L2 entries "
                                     f"{round(st.l2_density * a.numel())} != the trace's "
                                     f"{tr.l2_nnz}")
            kern = budgets[tr.name].l2_nnz_total
            whole_bank = impls[tr.name] != "fused_prefetch"
            if whole_bank and kern != tr.l2_nnz:
                raise AssertionError(f"{path} {name}: the fused kernels' l2_nnz {kern} != the "
                                     f"trace's {tr.l2_nnz}")
            N = tr.n
            shapes.append(pm.GemmShape(tr.m // reps, tr.k_dim, N))
            stats.append(st)
            p_active = state.p_active.get(name)
            usage = None if p_active is None else (p_active + 1) / (q + 1)
            entry = impls[tr.name]
            traffic = pm.phi_kernel_traffic(
                pm.GemmShape(tr.m, tr.k_dim, N), k=k, q=q, block_m=_BM, block_n=128,
                pwp_usage=usage, prefetch_prepass=False)[entry]
            row = timing.get(name, {})
            layers.append({
                "layer": name, "M": tr.m, "K": tr.k_dim, "N": N, "T": T, "impl": entry,
                "l2_nnz": tr.l2_nnz, "kernel_l2_nnz": kern, "gated": whole_bank,
                "idx_density": tr.idx_density, "bit_density": tr.bit_density,
                "model_traffic_bytes": traffic.total,
                "model_traffic_ms": traffic.total / HBM_BYTES_PER_S * 1e3,
                "bound_ms": row.get("bound_ms"), "device_ms": row.get("device_ms"),
                "ms": row.get("ms"),
                "stream_group_t": ops.stream_group_t(q, k) if entry == "fused_stream" else None,
                "launch_cost_prefers_coo": ops.launch_cost_prefers_coo(
                    tr.m, tr.k_dim, N, T, q, pwp_usage=usage)})
        attach_device_ms(matcher_rows, lambda row: "matcher")
        for row, m in zip(layers, matcher_rows):
            row["matcher_device_ms"] = m["device_ms"]
        with torch.no_grad():
            capture_ms = cuda_time_ms(lambda: M.capture_phi_traces(params, cfg, state, x),
                                      runs=3, warmup=1)
        t0 = time.perf_counter()
        phi_res = PhiAcceleratorSim().run(traces)
        eye_res = EyerissSim().run(traces)
        sim_s = time.perf_counter() - t0
        for row, r, e in zip(layers, phi_res, eye_res):
            row.update(sim_cycles=r.cycles, sim_eyeriss_cycles=e.cycles,
                       sim_p_active=r.p_active, sim_l2_processed=r.l2_processed)
        phi_sum, eye_sum = summarize_run(phi_res), summarize_run(eye_res)
        model = pm.compare(shapes, stats)
        out["models"][path] = {
            "traces": len(traces), "sim_s": sim_s, "capture_phi_traces_ms": capture_ms,
            "matcher_device_ms": device_sum(matcher_rows),
            "sim_phi": phi_sum, "sim_eyeriss": eye_sum,
            "sim_speedup_vs_eyeriss": eye_sum["cycles"] / phi_sum["cycles"],
            "sim_energy_eff_vs_eyeriss": phi_sum["gop_per_j"] / eye_sum["gop_per_j"],
            "model_compare": model, "model_rows_per_image_step": [s.m for s in shapes],
            "layers": layers}
    out["launch"] = {**launch, "hwconst_bytes": hwconst.KERNEL_LAUNCH_BYTES}
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return {"launches": launches}


# The LM serving path: OLMo-1B (src/repro_torch/configs/olmo_1b.py) at full
# width in Phi spiking mode (phi_variant: T = 4, q = 128, k = 16). Its depth
# is cut to LM_LAYERS of 16 so that the script stays inside its time limit:
# 4 until PR 27, 2 since the decode, windowed-prefill, split-bank and remat
# checks joined it (PERF.md §4).
LM_ARCH = "olmo_1b"
LM_SMOKE = False           # the smoke cut, for rehearsing the phase on the CPU
LM_LAYERS = 2              # OLMo-1B's depth (None: all 16 layers)
LM_CALIB = (2, 128)        # calibration batch, sequences x tokens
LM_PREFILL_S = 2048        # prefill gate: S > 1024 takes the attention kernel
LM_REQUESTS, LM_SLOTS, LM_MAX_NEW, LM_MAX_CONTEXT = 8, 4, 16, 256
LM_PROMPT = (16, 100)      # prompt lengths, inclusive
LM_PAGE, LM_TIGHT_PAGES = 16, 16   # the undersized pool: one full lane
# Prompt lengths and tokens of the engine runs. A pool only preempts where a
# running request grows into an unmapped page while the pool is full; with
# this seed's lengths that happens under FIFO and under cohort admission
# alike (seed 0's lengths never cross a page boundary then).
LM_PROMPT_SEED = 3


def tree_leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from tree_leaves(v)
        else:
            yield v


def causal_attn_bound_ms(B, S, H, D) -> tuple[float, float]:
    """Least time for one causal dense attention (``costs.dense_attention``:
    the S(S+1)/2 scores a head keeps)."""
    return bound_ms(costs.dense_attention(B, S, H, D))


def lm_gemms(sites, captured, recs, decode_m, timed) -> tuple[dict, list]:
    """Layer 0's Phi GEMMs of an LM path against their plain versions, and
    timings. ``sites`` maps a label to (capture key, params node, weight
    name): each site's first captured call (layer 0's calibration spikes)
    goes through :func:`fused_checks` at 256 rows; the sites in ``timed``
    through :func:`fused_timing` at the calibration's rows and at
    ``decode_m`` rows, on the kernel the policy last chose for that site and
    shape, beside the bound of what those rows need. Returns ({label: L2
    entries at 256 rows}, timing rows)."""
    import torch

    from repro_torch.core.patterns import active_pattern_sets
    from repro_torch.kernels.phi_fused import pack_patterns

    checks, rows = {}, []
    for label, (key, node, name) in sites.items():
        spk = captured[key][0]
        K = spk.shape[-1]
        a = spk.reshape(-1, K).to(torch.float32).contiguous()
        phi_p = node["phi_" + name]
        pats, pwp = phi_p["patterns"], phi_p["pwp"].to(torch.float32)
        if pats.dim() == 4:                      # a stacked site: layer 0's bank
            pats, pwp = pats[0], pwp[0]
        w = node[name].to(torch.float32)
        w = (w[0] if w.dim() == 3 else w).contiguous()
        args = [a[:256].contiguous(), pats, pwp, torch.ones(pwp.shape[:2], device=a.device), w]
        route = [r["impl"] for r in recs
                 if r["site"] == f"lm.{name}" and r["shape"][1:3] == [K, w.shape[1]]][-1]
        usage = phi_p["usage"].cpu().numpy()
        sets, _ = active_pattern_sets(usage[0] if usage.ndim == 3 else usage)
        p_active = None if sets is None else int(sets.shape[-1])
        packed = pack_patterns(pats)
        checks[label] = fused_checks(f"lm {label}", args, packed, active_sets(args, p_active))
        if label not in timed:
            continue
        for rows_label, m in (("calibration", a.shape[0]), ("decode", decode_m)):
            targs = [a[:m].contiguous()] + args[1:]
            row = fused_timing(label, targs, packed, route, active_sets(targs, p_active),
                               plain_runs=1)
            b_ms, o_ms = needed_bound_ms(targs[0], pats, w.shape[1])
            row.update(rows=rows_label, bytes_ms=b_ms, ops_ms=o_ms, bound_ms=max(b_ms, o_ms),
                       whole_bank_bound_ms=row["bound_ms"])
            rows.append(row)
    attach_device_ms(rows, lambda row: FUSED_KERNEL[row["route"]])
    return checks, rows


def lm_matcher_row(label, a, pats) -> dict:
    """The matcher kernel against ``assign_patterns`` on one site's
    calibration rows, bitwise, and its times."""
    import torch

    from repro_torch.kernels.matcher import matcher_cuda, matcher_plain

    idx, res = matcher_cuda(a, pats)
    pidx, pres = matcher_plain(a, pats)
    if not (torch.equal(idx, pidx) and torch.equal(res, pres)):
        raise AssertionError(f"{label}: matcher kernel != assign_patterns")
    row = {"shape": list(a.shape), "T": pats.shape[0],
           "ms": cuda_time_ms(lambda: matcher_cuda(a, pats)),
           "_fn": lambda: matcher_cuda(a, pats),
           "plain_ms": cuda_time_ms(lambda: matcher_plain(a, pats), runs=3)}
    attach_device_ms([row], lambda row: "matcher")
    return row


def lm_attention_row(label, policy, q, k, v) -> dict:
    """The attention kernel's dense instantiation on one prefill site's float32
    q, k, v (causal, the policy's last blocks) against ``_flash_fwd_impl``,
    within ATTN_ULPS ulps of max|V|, and its times beside SDPA's and the
    bound."""
    import torch.nn.functional as F

    from repro_torch.kernels.phi_attention import flash_attention_cuda
    from repro_torch.models.flash import _flash_fwd_impl

    bq, bkv = policy.last_decision("lm.attn_prefill").blocks
    kw = dict(causal=True, block_q=bq, block_kv=bkv)
    out = flash_attention_cuda(q, k, v, **kw)
    pout, _ = _flash_fwd_impl(q, k, v, True, None, None, bq, bkv)
    err = float((out - pout).abs().max())
    tol = ATTN_ULPS * 2.0 ** -24 * float(v.abs().max())
    if err > tol:
        raise AssertionError(f"{label} attention: kernel != plain, max |diff| {err} > {tol}")
    B, S, H, D = q.shape
    b_ms, o_ms = causal_attn_bound_ms(B, S, H, D)
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    row = {"shape": [B, S, H, D], "blocks": [bq, bkv], "max_abs_err": err, "tol": tol,
           "ms": cuda_time_ms(lambda: flash_attention_cuda(q, k, v, **kw)),
           "_fn": lambda: flash_attention_cuda(q, k, v, **kw),
           "plain_ms": cuda_time_ms(lambda: _flash_fwd_impl(q, k, v, True, None, None, bq, bkv),
                                    runs=3),
           "library_ms": cuda_time_ms(lambda: F.scaled_dot_product_attention(
               qh, kh, vh, is_causal=True)),
           "bytes_ms": b_ms, "ops_ms": o_ms, "bound_ms": max(b_ms, o_ms)}
    attach_device_ms([row], lambda row: "attn_kernel")
    return row


DECODE_ULPS = 16               # decode kernel vs plain: float32 ulps of max|V| beside
                               # one ulp of |want| (decode_tol)
WINDOW_ULPS = 128              # the windowed prefill's kernel (online softmax over ~W / bkv
                               # blocks) against the banded plain path (one softmax a
                               # 512-row block): float32 ulps of max|V|
DECODE_LONG = 32768            # the one-row decode check's context
WINDOW_ARCH = "h2o_danube3_4b" # the long windowed prefill's attention
WINDOW_S = 16384               # > 8192: the banded path's length


def decode_bound_ms(B, Hq, Hkv, D, pos, smax, mode, q_bytes, kv_bytes) -> tuple[float, float]:
    """Least time of one decode attention over the cache rows this call's
    masks keep (``costs.decode_attention``)."""
    from repro_torch.kernels.decode_attention import valid_keys

    rows = int(valid_keys(pos, smax, mode).sum())
    return bound_ms(costs.decode_attention(B, Hq, Hkv, D, rows, q_bytes, kv_bytes))


def decode_tol(want, v):
    """The decode kernel's tolerance against its plain version, per output
    element: one ulp of |want| in its dtype (both sides sum in float32 and
    round once, so they may land on neighbouring values) plus DECODE_ULPS
    float32 ulps of max|V| (the float32 sums run in different orders)."""
    import torch

    w = want.float().abs()
    ulp = torch.ldexp(torch.full_like(w, torch.finfo(want.dtype).eps),
                      torch.frexp(w).exponent - 1)
    return torch.where(w > 0, ulp, 0.0) + DECODE_ULPS * 2.0 ** -24 * float(v.float().abs().max())


def decode_row(label, q, k, v, pos, mode) -> dict:
    """The decode kernel on (q, k, v, pos) against its plain version (per
    element within :func:`decode_tol`), a rank's block
    (rows [B/2, B), heads [H/2, H) and their KV heads, run alone) bitwise the
    whole call's, and the kernel's times (CUDA events; the profiler's device
    time of its two launches) beside the plain version's, SDPA's at q length
    1 and the bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import (
        decode_attention_cuda, decode_attention_plain, valid_keys)
    from repro_torch.models.layers import _repeat_kv

    fn = lambda: decode_attention_cuda(q, k, v, pos, mode=mode)          # noqa: E731
    got, want = fn(), decode_attention_plain(q, k, v, pos, mode=mode)
    B, _, Hq, D = q.shape
    Hkv = k.shape[2]
    tol = decode_tol(want, v)
    diff = (got.float() - want.float()).abs()
    err, worst = float(diff.max()), float((diff / tol).max())
    if not torch.isfinite(got).all() or worst > 1:
        raise AssertionError(f"{label} decode {mode}: kernel != plain, max |diff| {err}, "
                             f"{worst} of the tolerance where it is tightest")
    b0, h0 = B // 2, Hq // 2
    kv0 = h0 * Hkv // Hq
    part = decode_attention_cuda(q[b0:, :, h0:].contiguous(), k[b0:, :, kv0:].contiguous(),
                                 v[b0:, :, kv0:].contiguous(), pos[b0:], mode=mode)
    if not torch.equal(part, got[b0:, :, h0:]):
        raise AssertionError(f"{label} decode {mode}: a rank's block differs from the whole "
                             "call's")
    smax = k.shape[1]
    b_ms, o_ms = decode_bound_ms(B, Hq, Hkv, D, pos, smax, mode, q.element_size(),
                                 k.element_size())
    rep = Hq // Hkv
    qh = q.transpose(1, 2)
    kh, vh = (_repeat_kv(x, rep).transpose(1, 2) for x in (k, v))
    mask = valid_keys(pos, smax, mode)[:, None, None, :]
    row = {"mode": mode, "shape": [B, smax, Hq, Hkv, D], "dtype": str(q.dtype),
           "max_abs_err": err, "err_over_tol": worst, "tol_range": [float(tol.min()),
                                                                    float(tol.max())],
           "rank_block_bitwise": True,
           "ms": cuda_time_ms(fn), "plain_ms": cuda_time_ms(
               lambda: decode_attention_plain(q, k, v, pos, mode=mode), runs=5),
           "library_ms": cuda_time_ms(lambda: F.scaled_dot_product_attention(
               qh, kh, vh, attn_mask=mask)),
           "bytes_ms": b_ms, "ops_ms": o_ms, "bound_ms": max(b_ms, o_ms)}
    events = []
    for _ in range(3):
        events = _launches([fn], "decode_", 10)
        if events:
            break
    calls = sum("decode_partial" in ev.name for ev in events)
    row["device_ms"] = (sum(ev.device_time_total for ev in events) / 1e3 / calls
                        if calls else None)
    return row


def lm_decode_rows(cfg, dev) -> list:
    """The decode kernel at OLMo-1B's decode shapes (LM_SLOTS slots, context
    LM_MAX_CONTEXT, its heads and head size, the cache's dtype), in each of
    the three masks, and at one row of a DECODE_LONG context."""
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    H, hd, dt = cfg.q_heads_padded, cfg.hd, cfg.compute_dtype
    rows = []
    for B, smax, mode in ((LM_SLOTS, LM_MAX_CONTEXT, "full"), (LM_SLOTS, LM_MAX_CONTEXT, "ring"),
                          (LM_SLOTS, LM_MAX_CONTEXT, "chunk_ring"), (1, DECODE_LONG, "full")):
        q = torch.randn((B, 1, H, hd), generator=g, device=dev).to(dt)
        k, v = (torch.randn((B, smax, H, hd), generator=g, device=dev).to(dt) for _ in range(2))
        hi = smax if mode == "full" else 2 * smax
        pos = torch.randint(0, hi, (B,), generator=g, device=dev)
        pos[0] = smax - 1 if mode == "full" else smax + 3
        rows.append(decode_row(f"lm {B}x{smax}", q, k, v, pos, mode))
    return rows


def windowed_prefill_check(dev) -> dict:
    """H2O-Danube3's attention at full width, one layer, B = 1, S = WINDOW_S
    (> 8192: on the CPU the banded plain path): the attention kernel, which
    walks only the window's kv-blocks, against the plain banded
    ``layers.flash_attention`` within WINDOW_ULPS ulps of max|V|, through
    ``layers.attention_prefill`` (the policy's blocks, GQA repeated, bf16
    widened), and the second half of the heads run alone bitwise the whole
    call's."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.phi_attention import flash_attention_cuda
    from repro_torch.models import layers as ll

    cfg = get_config(WINDOW_ARCH)
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    H, Hkv, hd = cfg.q_heads_padded, cfg.kv_heads_padded, cfg.hd
    q = torch.randn((1, WINDOW_S, H, hd), generator=g, device=dev)
    k, v = (torch.randn((1, WINDOW_S, Hkv, hd), generator=g, device=dev) for _ in range(2))
    before = flash_attention_cuda.launches
    got = ll.attention_prefill(cfg, 0, q, k, v, layer_global=False)
    torch.cuda.synchronize()
    if flash_attention_cuda.launches != before + 1:
        raise AssertionError("the windowed prefill did not launch the attention kernel")
    half = ll.attention_prefill(cfg, 0, q[:, :, H // 2:].contiguous(),
                                k[:, :, Hkv // 2:].contiguous(), v[:, :, Hkv // 2:].contiguous(),
                                layer_global=False)
    if not torch.equal(half, got[:, :, H // 2:]):
        raise AssertionError("windowed prefill: a head block differs from the whole call's")
    kr, vr = (ll._repeat_kv(x, H // Hkv) for x in (k, v))
    plain = lambda: ll.flash_attention(q, kr, vr, window=cfg.window,          # noqa: E731
                                       block_q=512, block_kv=1024)
    want = plain()
    err = float((got - want).abs().max())
    tol = WINDOW_ULPS * 2.0 ** -24 * float(v.abs().max())
    if err > tol:
        raise AssertionError(f"windowed prefill: kernel != banded plain, {err} > {tol}")
    ms = cuda_time_ms(lambda: ll.attention_prefill(cfg, 0, q, k, v, layer_global=False),
                      runs=3, warmup=1)
    b_ms, o_ms = bound_ms(costs.dense_attention(1, WINDOW_S, H, hd, True, cfg.window))
    return {"arch": WINDOW_ARCH, "shape": [1, WINDOW_S, H, Hkv, hd], "window": cfg.window,
            "max_abs_err": err, "tol": tol, "head_block_bitwise": True, "ms": ms,
            "plain_ms": cuda_time_ms(plain, runs=2, warmup=1), "bytes_ms": b_ms,
            "ops_ms": o_ms, "bound_ms": max(b_ms, o_ms)}


def lm_timings(cfg, params, batch, dev) -> dict:
    """CUDA-event ms of the prefill gate's ``train_logits`` in both arms and
    of one ``decode_step`` at LM_SLOTS slots, with the profiler's device time,
    busy share and launches of the Phi prefill and decode step."""
    import torch

    from repro_torch.models import model

    out = {}
    with torch.no_grad():
        out["prefill_ms"] = cuda_time_ms(lambda: model.train_logits(cfg, params, batch),
                                         runs=3, warmup=1)
        out["prefill_spiking_dense_ms"] = cuda_time_ms(lambda: model.train_logits(
            cfg, params, batch, matmul=model.spiking_dense_matmul(cfg)), runs=3, warmup=1)
        out["prefill_profile"] = device_profile(lambda: model.train_logits(cfg, params, batch),
                                                out["prefill_ms"])
        state = model.init_decode_state(cfg, LM_SLOTS, LM_MAX_CONTEXT, dev)
        tok = torch.full((LM_SLOTS,), 7, dtype=torch.int32, device=dev)
        dpos = torch.full((LM_SLOTS,), 100, dtype=torch.int32, device=dev)
        out["decode_step_ms"] = cuda_time_ms(
            lambda: model.decode_step(cfg, params, tok, dpos, state), runs=5, warmup=2)
        out["decode_profile"] = device_profile(
            lambda: model.decode_step(cfg, params, tok, dpos, state), out["decode_step_ms"])
    return out


def lm_serve_rows(runs, times, requests) -> dict:
    """Per engine run: wall s, ticks, tokens (the first token of each of its
    ``requests[name]`` requests comes from its prefill), tokens/s, the mean
    gap between a request's consecutive tokens, scheduler decisions and
    cache bytes."""
    rows = {}
    for name, (eng, _) in runs.items():
        hist = eng.metrics.get("token_latency_ms")
        wall = times[f"engine_{name}"]
        tokens = eng.decoded_tokens + requests[name]
        rows[name] = {"wall_s": wall, "ticks": eng.ticks, "decoded_tokens": eng.decoded_tokens,
                      "tokens": tokens, "tokens_per_s": tokens / wall,
                      "token_gap_ms_mean": hist.sum() / max(hist.count(), 1),
                      "scheduler": eng.scheduler.report(), "cache": eng.cache_report()}
    return rows


DRYRUN_CELL = ("olmo_1b", "decode_32k")     # traced at 16x16 in Phi mode
TEMP_RATIO = (0.8, 1.25)   # the dry run's temp bytes over a real step's peak above its start
DRYRUN_TIMEOUT = 300.0


ANALYSIS_TIMEOUT = 300.0


def analysis_phase(smi) -> dict:
    """The ``analysis`` phase: ``python -m repro_torch.analysis --layer
    contracts`` in a subprocess on the card, against the built library: every
    kernel's launch plan, counters and shared-memory model, each held against
    the library's exports and ptxas's spills, under the committed baseline.
    Exit 0 or the phase fails."""
    import torch

    t0 = time.perf_counter()
    report = ROOT / "build" / "analysis_contracts.json"
    proc = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "--layer",
                           "contracts", "--json", str(report)], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=str(SRC)), capture_output=True,
                          text=True, timeout=ANALYSIS_TIMEOUT)
    if proc.returncode != 0:
        raise AssertionError(f"repro_torch.analysis --layer contracts exited "
                             f"{proc.returncode}:\n{proc.stdout[-3000:]}{proc.stderr[-2000:]}")
    rep = json.loads(report.read_text())
    if not rep["card"]:
        raise AssertionError("repro_torch.analysis did not check the library on the card")
    row = {"phase": "analysis", "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "exit": proc.returncode, "summary": rep["summary"],
           "allowlisted": [f["key"] for f in rep["allowlisted"]],
           "seconds": time.perf_counter() - t0}
    emit(row)
    return row


def dryrun_phase(smi) -> dict:
    """The ``dryrun`` phase: one production cell, DRYRUN_CELL on the 16 x 16
    mesh in Phi mode, through the dry run's command line in a subprocess
    (a fake world of 256 ranks, fake card tensors); its record read back:
    the roofline's terms on the H100's data-sheet rates, per-rank memory,
    the kernel plan and the seconds it took."""
    import torch

    arch, shape = DRYRUN_CELL
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                           "--shape", shape, "--phi", "--force"], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=str(SRC)), capture_output=True,
                          text=True, timeout=DRYRUN_TIMEOUT)
    if proc.returncode != 0:
        raise AssertionError(f"dry run of {arch} x {shape} failed:\n{proc.stderr[-3000:]}")
    rec = json.loads((ROOT / "results" / "dryrun_torch" /
                      f"{arch}__{shape}__16x16_phi.json").read_text())
    if not {"memory", "cost", "collectives", "roofline", "launches"} <= set(rec) or \
            not rec["launches"]["kernels"]:
        raise AssertionError(f"dry run of {arch} x {shape}: record {sorted(rec)}")
    r = rec["roofline"]
    row = {"phase": "dryrun", "cell": f"{arch} x {shape} x 16x16 phi",
           "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "rates": "H100 SXM data sheet",
           "roofline": {k: r[k] for k in ("compute_s", "memory_s", "collective_s", "bottleneck",
                                          "step_s", "mfu", "useful_ratio")},
           "memory_per_rank": rec["memory"], "collectives": rec["collectives"],
           "launches": rec["launches"]["kernels"], "trace_s": rec["trace_s"],
           "total_s": rec["total_s"], "seconds": time.perf_counter() - t0}
    emit(row)
    return row


def lm_dryrun_check(cfg, params, policy, batch, dev) -> dict:
    """``lm_serve``'s one-device cell traced by the dry run (a decode step of
    LM_SLOTS slots at LM_MAX_CONTEXT, and the prefill of the gate's batch)
    with the phase's calibration usage, against the same steps run once for
    real under the phase's policy: each kernel's launches and the argument
    bytes equal. The roofline's step time (the H100's data-sheet rates) is
    printed beside the step's CUDA-event time (not gated), and the dry run's
    temp bytes (the peak of live fake storages less the arguments) are held
    within TEMP_RATIO of the real step's peak allocation above what was
    allocated before it. Resets the card's peak memory count."""
    import torch

    from repro_torch.utils import tree_bytes
    from repro_torch.kernels import dispatch
    from repro_torch.launch import dryrun
    from repro_torch.models import model
    from repro_torch.train import step as step_lib

    usage = dryrun.policy_usage(policy)
    state = model.init_decode_state(cfg, LM_SLOTS, LM_MAX_CONTEXT, dev)
    tok = torch.zeros((LM_SLOTS,), dtype=torch.int32, device=dev)
    pos = torch.full((LM_SLOTS,), LM_MAX_CONTEXT // 2, dtype=torch.int32, device=dev)
    B, S = batch["tokens"].shape
    runs = {"decode": (LM_SLOTS, LM_MAX_CONTEXT, step_lib.make_decode_step(cfg)[0],
                       (params, tok, pos, state, None)),
            "prefill": (B, S, step_lib.make_prefill(cfg)[0], (params, batch))}
    out = {}
    prev = dispatch.set_policy(policy)
    try:
        for name, (b, ctx, fn, args) in runs.items():
            rec = dryrun.trace_step(cfg, name, b, ctx, None, device=dev, usage=usage)
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            zero_launches()
            fn(*args)
            torch.cuda.synchronize()
            real_temp = torch.cuda.max_memory_allocated() - before
            real = {k: v for k, v in read_launches().items() if k != "flash_attention_cuda_lse"}
            plan = {k: rec["launches"]["kernels"].get(k, 0) for k in real}
            nbytes = tree_bytes(args)
            if plan != real or nbytes != rec["memory"]["argument_bytes"]:
                raise AssertionError(f"lm_serve {name}: dry-run launches {plan} and argument "
                                     f"bytes {rec['memory']['argument_bytes']}; the real step "
                                     f"launched {real} on {nbytes} bytes")
            ratio = rec["memory"]["temp_bytes"] / real_temp
            if not TEMP_RATIO[0] <= ratio <= TEMP_RATIO[1]:
                raise AssertionError(f"lm_serve {name}: dry-run temp bytes "
                                     f"{rec['memory']['temp_bytes']} against the real step's "
                                     f"peak {real_temp}: {ratio} outside {TEMP_RATIO}")
            r = rec["roofline"]
            out[name] = {"batch": b, "context": ctx, "launches": real, "argument_bytes": nbytes,
                         "temp_bytes": rec["memory"]["temp_bytes"],
                         "measured_temp_bytes": real_temp,
                         "temp_bytes_over_measured": rec["memory"]["temp_bytes"] / real_temp,
                         "roofline": {k: r[k] for k in ("compute_s", "memory_s", "collective_s",
                                                        "bottleneck", "step_s")},
                         "roofline_step_ms": r["step_s"] * 1e3,
                         "measured_ms": cuda_time_ms(lambda: fn(*args), runs=5, warmup=1),
                         "trace_s": rec["trace_s"]}
    finally:
        dispatch.set_policy(prev)
    return out


def lm_serve_phase(dev, smi) -> dict:
    """The ``lm_serve`` phase: OLMo-1B in Phi spiking mode, full width and
    LM_LAYERS of its 16 layers, on the card. With every kernel's launch count
    set to 0 just before and read just after: params from a seeded generator
    on the card, rounded onto the 2^-10 grid; ``calibrate_lm_phi`` on a 2 x
    128 batch (the PWP banks written in place); the prefill gate
    (``train_logits`` at B = 1, S = 2048, Phi bitwise the spiking-dense
    oracle, the attention kernel at every layer);
    the engine over 8 requests and 4 slots four times — Phi, spiking-dense,
    paged, and paged from an undersized pool that forces preemption — each
    token- and logit-identical to the first; the drift monitor. Then, outside
    the counted run: every kernel the phase launched against its plain
    version at layer 0's operands; timings of the prefill, a decode step and
    the GEMMs at prefill and decode rows; peak memory."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config, phi_variant
    from repro_torch.distributed.sharding import init_params
    from repro_torch.kernels import dispatch
    from repro_torch.models import layers as ll
    from repro_torch.models import model, transformer
    from repro_torch.obs import DriftMonitor, ListSink, Tracer, set_tracer
    from repro_torch.serve.engine import Engine, Request

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = phi_variant(get_config(LM_ARCH, smoke=LM_SMOKE))
    if LM_LAYERS is not None:
        cfg = cfg.with_(n_layers=LM_LAYERS)
    policy = dispatch.PhiExecutionPolicy()
    prev_policy = dispatch.set_policy(policy)
    sink = ListSink()
    tracer = Tracer(sink)
    prev_tracer = set_tracer(tracer)
    times = {}

    def stage(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out

    rng = np.random.default_rng(LM_PROMPT_SEED)
    prompts = [rng.integers(3, cfg.vocab, int(n))
               for n in rng.integers(LM_PROMPT[0], LM_PROMPT[1] + 1, LM_REQUESTS)]
    engines = {"phi": {}, "spiking_dense": {}, "paged": dict(paged=True, page_size=LM_PAGE),
               "paged_tight": dict(paged=True, page_size=LM_PAGE, num_pages=LM_TIGHT_PAGES)}
    marks = {}

    def serve(name, kw):
        eng = Engine(cfg, params, batch_slots=LM_SLOTS, max_context=LM_MAX_CONTEXT,
                     record_logits=True, wall_time=True, tracer=tracer,
                     matmul=model.spiking_dense_matmul(cfg) if name == "spiking_dense" else None,
                     **kw)
        for rid, toks in enumerate(prompts):
            eng.submit(Request(rid=rid, tokens=toks, max_new_tokens=LM_MAX_NEW))
        first = len(sink.records)
        res = stage(f"engine_{name}", eng.run)
        marks[name] = (first, len(sink.records))
        return eng, {r.rid: r.tokens for r in res}

    zero_launches()
    try:
        with torch.no_grad():
            def build():
                p = init_params(model.lm_specs(cfg), torch.Generator(device=dev).manual_seed(SEED),
                                dev)
                for leaf in tree_leaves(model.split_phi_state(p)[0]):
                    leaf.copy_(dyadic(leaf))
                return p

            params = stage("init_params", build)
            calib = model.dummy_batch(cfg, *LM_CALIB, False, torch.Generator().manual_seed(SEED),
                                      dev)
            params, stats = stage("calibrate", lambda: model.calibrate_lm_phi(cfg, params, calib))
            maxd = max(st.l2_density for st in stats.values())
            cfg = cfg.with_(phi=dataclasses.replace(cfg.phi, nnz_budget=min(0.9, 2 * maxd + 0.05)))
            batch = model.dummy_batch(cfg, 1, LM_PREFILL_S, False,
                                      torch.Generator().manual_seed(SEED + 1), dev)
            first = len(sink.records)
            phi_logits = stage("prefill_phi", lambda: model.train_logits(cfg, params, batch))
            marks["prefill"] = (first, len(sink.records))
            dense_logits = stage("prefill_spiking_dense", lambda: model.train_logits(
                cfg, params, batch, matmul=model.spiking_dense_matmul(cfg)))
            runs = {name: serve(name, kw) for name, kw in engines.items()}
            drift = DriftMonitor(policy, prefix="lm.").check()
        launches = read_launches()
    finally:
        set_tracer(prev_tracer)
        dispatch.set_policy(prev_policy)
    counted_s = time.perf_counter() - t_phase

    # ------------------------------------------------------------ gates ---
    V = cfg.vocab
    if phi_logits.shape != (1, LM_PREFILL_S, V) or not torch.isfinite(phi_logits).all():
        raise AssertionError(f"prefill logits {tuple(phi_logits.shape)} not finite/(1, S, V)")
    if not torch.equal(phi_logits, dense_logits):
        raise AssertionError(f"prefill: Phi logits differ from spiking-dense, max |diff| "
                             f"{float((phi_logits - dense_logits).abs().max())}")
    if float(phi_logits.std()) == 0:
        raise AssertionError("prefill: constant logits")
    want_eng, want = runs["phi"]
    if sorted(want) != list(range(LM_REQUESTS)) or \
            any(len(t) != LM_MAX_NEW for t in want.values()):
        raise AssertionError(f"phi engine: results {[len(t) for t in want.values()]}")
    # A preempted request resumes with a prefill over its prompt and prefix,
    # whose logits row for the next token is the prefill's, not a decode
    # step's: its tokens are gated, the rest of its rows and every other
    # request's rows bitwise.
    preempted = {name: sorted({r["rid"] for r in sink.records[slice(*marks[name])]
                               if r["kind"] == "preempt"}) for name in runs}
    if not preempted["paged_tight"] or any(preempted[n] for n in runs if n != "paged_tight"):
        raise AssertionError(f"preemptions {preempted}: want some in paged_tight only")
    for name, (eng, res) in runs.items():
        if res != want:
            raise AssertionError(f"engine {name}: tokens differ from the Phi engine's")
        for rid, rows in want_eng.logit_trace.items():
            if rid in preempted[name]:
                continue
            if len(rows) != len(eng.logit_trace[rid]) or not all(
                    np.array_equal(a, b) for a, b in zip(rows, eng.logit_trace[rid])):
                raise AssertionError(f"engine {name}: request {rid}'s logits not bitwise")
    recs = [r for r in sink.records if r["kind"] == "dispatch"]
    n_attn = sum(r["site"] == "lm.attn_prefill" for r in recs)
    if launches["flash_attention_cuda"] != n_attn or n_attn != 2 * cfg.n_layers:
        raise AssertionError(f"attention kernel launches {launches['flash_attention_cuda']}, "
                             f"decisions {n_attn}, want 2 x {cfg.n_layers} layers")
    for impl in ("fused", "fused_stream", "fused_prefetch"):
        n = sum(r["impl"] == impl for r in recs)
        if launches[f"phi_{impl}_cuda"] != n:
            raise AssertionError(f"phi_{impl} launched {launches[f'phi_{impl}_cuda']} times for "
                                 f"{n} decisions")
    if launches["lif_sequence_cuda"] <= 0 or launches["matcher_cuda"] <= 0:
        raise AssertionError(f"LIF or matcher kernel never launched: {launches}")
    # every decode step of every engine: one decode attention launch a layer
    n_dec = launches["decode_attention_cuda"]
    if n_dec <= 0 or n_dec % cfg.n_layers:
        raise AssertionError(f"decode attention kernel launched {n_dec} times, not a "
                             f"positive multiple of {cfg.n_layers} layers")

    def tally(lo, hi, keep=lambda r: True):
        out = {}
        for r in sink.records[lo:hi]:
            if r["kind"] == "dispatch" and keep(r):
                key = (r["site"], r["impl"], r["reason"])
                out[key] = out.get(key, 0) + 1
        return [[*key, n] for key, n in sorted(out.items())]

    decode_m = cfg.phi.timesteps * LM_SLOTS
    decisions = {"prefill": tally(*marks["prefill"]),
                 "engine_decode": tally(*marks["phi"], lambda r: r["shape"][0] == decode_m),
                 "engine_prefill": tally(*marks["phi"], lambda r: r["shape"][0] != decode_m)}

    # ------------------------------------ kernels against plain versions ---
    layer0 = transformer.layer_slice(params["decoder"]["stack"], 0)["p0"]
    with torch.no_grad():
        captured = model._capture_phi_spikes(cfg, params, calib)
    sites = {name: (f"{name}#0", layer0, name) for name in ("wq", "wk", "wv", "wo")}
    sites.update({name: (f"{name}#0", layer0["mlp"], name) for name in ("w1", "w3", "w2")})
    checks, gemm_rows = lm_gemms(sites, captured, recs, decode_m, timed=sites)
    # LIF: the rate coding of layer 0's wq operand (the calibration batch).
    x0 = ll.apply_norm(cfg, layer0["ln1"], model._embed_inputs(cfg, params, calib))
    x_seq = x0.to(torch.float32).unsqueeze(0).expand(cfg.phi.timesteps, *x0.shape).contiguous()
    lif_timing, lif_err = lif_rows([x_seq])
    # Matcher: the calibration's assignment at w2 (K = 8192).
    matcher_row = lm_matcher_row(
        "lm w2", captured["w2#0"][0].reshape(-1, cfg.d_ff).to(torch.float32).contiguous(),
        layer0["mlp"]["phi_w2"]["patterns"])
    # Attention: layer 0's q, k, v at the prefill gate's S, widened to float32.
    with torch.no_grad():
        h = ll.apply_norm(cfg, layer0["ln1"], model._embed_inputs(cfg, params, batch))
        pos = torch.arange(LM_PREFILL_S, device=dev)[None]
        q, k, v = (x.to(torch.float32).contiguous() for x in transformer._qkv(
            cfg, layer0, h, pos, model.make_matmul(cfg)))
    attn_row = lm_attention_row("lm", policy, q, k, v)
    del q, k, v, h
    decode_rows = lm_decode_rows(cfg, dev)
    windowed = windowed_prefill_check(dev)
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ timing ---
    timing = lm_timings(cfg, params, batch, dev)
    serve_rows = lm_serve_rows(runs, times, dict.fromkeys(runs, LM_REQUESTS))
    peak = torch.cuda.max_memory_allocated()        # the dry-run check resets the count
    dry = lm_dryrun_check(cfg, params, policy, batch, dev)
    pwp_bytes = sum(leaf.numel() * leaf.element_size()
                    for leaf in tree_leaves(model.split_phi_state(params)[1])
                    if leaf.dim() == 4)
    weight_bytes = sum(leaf.numel() * leaf.element_size()
                       for leaf in tree_leaves(model.split_phi_state(params)[0]))
    emit({"phase": "lm_serve", "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "config": {"arch": LM_ARCH, "smoke": LM_SMOKE, "n_layers": cfg.n_layers,
                     "d_model": cfg.d_model, "d_ff": cfg.d_ff, "vocab": V,
                     "timesteps": cfg.phi.timesteps, "q": cfg.phi.q, "k": cfg.phi.k,
                     "calib": LM_CALIB, "prefill_s": LM_PREFILL_S, "requests": LM_REQUESTS,
                     "slots": LM_SLOTS, "max_new": LM_MAX_NEW, "max_context": LM_MAX_CONTEXT,
                     "page": LM_PAGE, "tight_pages": LM_TIGHT_PAGES},
          "counted_s": counted_s, "stages_s": times, "launches": launches,
          "decisions": decisions,
          "gates": {"prefill_phi_bitwise_spiking_dense": True,
                    "engines_token_and_logit_identical": sorted(runs),
                    "preempted_rids": preempted["paged_tight"],
                    "attention_launches": n_attn},
          "drift": drift, "dryrun": dry, "l2_density_max": maxd,
          "l2_density": {key: st.l2_density for key, st in sorted(stats.items())},
          "gemm_l2_entries_256_rows": checks, "gemms": gemm_rows,
          "lif_sequence": lif_timing, "lif_max_abs_err": lif_err,
          "matcher": matcher_row, "attention": attn_row, "decode_attention": decode_rows,
          "windowed_prefill": windowed, **timing, "serve": serve_rows,
          "pwp_bytes": pwp_bytes, "weight_bytes": weight_bytes,
          "max_memory_allocated": max(peak, torch.cuda.max_memory_allocated()),
          "seconds": time.perf_counter() - t_phase})
    paged_tight = runs["paged_tight"][0]
    del runs
    torch.cuda.empty_cache()
    return {"launches": launches, "lif_err": lif_err, "attn_err": attn_row["max_abs_err"],
            "decode_rows": decode_rows, "windowed_err": windowed["max_abs_err"],
            "cfg": cfg, "params": params, "prompts": prompts, "tokens": want,
            "paged_logits": {rid: torch.from_numpy(np.stack(rows)) for rid, rows in
                             paged_tight.logit_trace.items()}}


# Serving on a mesh of ranks. OLMo-1B in Phi spiking mode, lm_serve's
# configuration and calibrated params, on a (data, model) mesh of MESH_SHAPE
# ranks; one Arctic-480B MoE layer (src/repro_torch/configs/arctic_480b.py)
# at full width, expert-parallel on MOE_MESH. The script needs one card, so
# the ranks are processes sharing it: NCCL refuses two ranks on one device,
# and the collectives go through gloo.
MESH_SHAPE = (2, 2)            # (data, model)
# The mesh phases' engine runs keep each PWP bank whole over data: split, the
# banks are all-gathered at every Phi GEMM, and four ranks on one card pass
# them through gloo's host buffers (gigabytes a forward), which the script's
# time limit cannot pay over an engine run. One prefill and one decode step
# of mesh_serve run under SERVE_RULES' split (``pwp_tiles`` over data) and are
# held bitwise against these.
MESH_RULES = {"pwp_tiles": None}
MESH_PREFILL = (2, 2048)       # B, S: S > 1024 takes the attention kernel
MESH_DECODE_STEPS = 4
MESH_SHORT = (2, 16)           # the forced-coo gate's prompt
MESH_COO_STEPS = 2
MESH_TIMEOUT = 600.0           # seconds a world of ranks may take, and each collective
MOE_ARCH = "arctic_480b"
MOE_MESH = (1, 4)
MOE_TOKENS = (4, 256)          # B, S of the MoE layer's input
MOE_CF = 8.0                   # capacity factor: no token drops (the reference's test's)
# EP against dense, per element: within MOE_ULPS bf16 ulps of max|dense|.
# Both paths compute each expert's three GEMMs in bf16 with float32
# accumulation, on buffers of different rows (every token against 128
# experts; 4 x capacity routed rows against 32), so cuBLAS may sum a dot
# product in another order and round h1, h3, their product, the second
# GEMM's output and the combine's cast each one bf16 ulp apart (2^-8 of the
# value); the second GEMM sums 4864 such differences of random sign. Eight
# ulps of the largest output bound that with room, and the mean is held to
# one ulp of the mean magnitude.
MOE_ULPS = 8


def _host_shared(tree):
    """A copy of a tree of tensors in host shared memory: spawned ranks map
    it without a copy, and it is gone when the last of them lets it go."""
    import torch

    if isinstance(tree, dict):
        return {k: _host_shared(v) for k, v in tree.items()}
    out = torch.empty(tree.shape, dtype=tree.dtype).share_memory_()
    return out.copy_(tree)


def _card_memory(reset: bool = False) -> dict:
    """This process's peak bytes allocated and reserved since the last reset,
    its bytes reserved now, and the card's free and total bytes (every
    process's use counted). With ``reset`` the cache is emptied and the
    peaks reset after reading."""
    import gc

    import torch

    torch.cuda.synchronize()
    free, total = torch.cuda.mem_get_info()
    out = {"peak_allocated": torch.cuda.max_memory_allocated(),
           "peak_reserved": torch.cuda.max_memory_reserved(),
           "reserved": torch.cuda.memory_reserved(), "card_free": free, "card_total": total}
    if reset:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return out


def _release_before_ranks() -> dict:
    """Frees what this process no longer references and returns its cache to
    the card before ranks are spawned onto it; what it still holds, and the
    card's free bytes, are returned."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    return {"allocated": torch.cuda.memory_allocated(), "reserved": torch.cuda.memory_reserved(),
            "card_free": free, "card_total": total}


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def timed_into(times: dict):
    """``timed(name, fn)``: ``fn()`` between two card syncs, its ms appended
    to ``times[name]``."""
    import torch

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        times.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return res

    return timed


def greedy_run(cfg, params, batch, steps: int, timed, probe=None) -> tuple[list, list]:
    """The prefill of ``batch`` and ``steps`` greedy decode steps, each call
    through ``timed`` ("prefill_ms", "decode_ms"): every step's logits
    (numpy) and the decode state's shapes. On a mesh, in the caller's
    ``use_rules``. ``probe(name, args, call)``, where given, makes each call
    (``name`` "prefill" or "decode", ``args`` the step's arguments)."""
    import torch

    from repro_torch.models import model

    probe = probe or (lambda name, args, call: call())
    B, S = batch["tokens"].shape
    logits, caches = timed("prefill_ms", lambda: probe(
        "prefill", (params, batch), lambda: model.prefill(cfg, params, batch)))
    caches = model.extend_caches(cfg, caches, S + steps + 1)
    outs = [logits.cpu().numpy()]
    tok = logits.argmax(-1).to(torch.int32)
    for i in range(steps):
        pos = torch.full((B,), S + i, dtype=torch.int32, device=tok.device)
        logits, caches = timed("decode_ms", lambda: probe(
            "decode", (params, tok, pos, caches),
            lambda: model.decode_step(cfg, params, tok, pos, caches)))
        outs.append(logits.cpu().numpy())
        tok = logits.argmax(-1).to(torch.int32)
    return outs, [tuple(x.shape) for x in model.state_leaves(caches)]


def _bf16_ulp(v: float) -> float:
    """One bf16 ulp at magnitude ``v`` (8 significant bits)."""
    import math

    return 2.0 ** (math.floor(math.log2(v)) - 7) if v > 0 else 0.0


def _first_lif_input(fn):
    """The current of the first LIF sequence kernel launch of ``fn()``."""
    from repro_torch.snn import lif as snn_lif

    seen, real = [], snn_lif.lif_sequence_cuda

    def recording(x_seq, **kw):
        if not seen:
            seen.append(x_seq.clone())
        return real(x_seq, **kw)

    snn_lif.lif_sequence_cuda = recording
    try:
        fn()
    finally:
        snn_lif.lif_sequence_cuda = real
    return seen[0]


def _first_attention_operands(fn):
    """q, k, v of the first dense attention kernel call of ``fn()``."""
    from repro_torch.models import flash as flash_mod

    seen, real = [], flash_mod.flash_attention

    def recording(q, k, v, *a, **kw):
        if not seen:
            seen.append((q.clone(), k.clone(), v.clone()))
        return real(q, k, v, *a, **kw)

    flash_mod.flash_attention = recording
    try:
        fn()
    finally:
        flash_mod.flash_attention = real
    return seen[0]


def _record_layer0(params, cfg, batch, mesh) -> dict:
    """Every rank: a prefill of ``batch`` on the mesh (its collectives need
    every rank) that records this rank's layer-0 local operands: the first
    GEMM of each Phi site and local K (spikes, weight, patterns, bank, usage,
    the kernel the policy chose), the first LIF current and the first
    attention call's q, k, v."""
    import torch

    from repro_torch.distributed.sharding import SERVE_RULES, use_rules
    from repro_torch.kernels import dispatch
    from repro_torch.models import model

    class Recording(dispatch.PhiExecutionPolicy):
        def __init__(self):
            super().__init__()
            self.first = {}

        def matmul(self, a, w, patterns, pwp, **kw):
            out = super().matmul(a, w, patterns, pwp, **kw)
            self.first.setdefault((kw["site"], w.shape[0]), (
                a, w, patterns, pwp, kw.get("usage"), self.last_decision(kw["site"]).impl))
            return out

    rec = Recording()
    prev = dispatch.set_policy(rec)
    held = {}
    try:
        with torch.no_grad(), use_rules(SERVE_RULES, mesh):
            def run():
                held["qkv"] = _first_attention_operands(
                    lambda: model.prefill(cfg, params, batch))
            held["lif"] = _first_lif_input(run)
    finally:
        dispatch.set_policy(prev)
    return {"policy": rec, "gemms": rec.first, "lif": held["lif"], "qkv": held["qkv"]}


# OLMo's sites on the mesh: w1 column-parallel, w2 and wo row-parallel (wo's
# local T = 64 takes the first fused kernel at model = 2).
OLMO_MESH_SITES = {"lm.w1.spmd": ("lm.w1.spmd", None), "lm.w2.spmd": ("lm.w2.spmd", None),
                   "lm.wo.spmd": ("lm.wo.spmd", None)}


def _mesh_rank_checks(policy, rec, sites=OLMO_MESH_SITES) -> dict:
    """Rank 0, after the counted run, while the other ranks wait: each kernel
    the ranks launched against its plain version at this rank's layer-0
    local operands (``rec``), and their times. ``sites`` maps a label to
    (site, local K), K None for the site's first GEMM. The card is this
    rank's alone then."""
    import torch

    from repro_torch.core.patterns import active_pattern_sets
    from repro_torch.kernels.phi_fused import pack_patterns

    out = {"gemms": [], "l2_entries_256_rows": {}}
    for label, (site, k_local) in sites.items():
        a, w, pats, pwp, usage, route = next(
            v for (s, K), v in rec["gemms"].items() if s == site and k_local in (None, K))
        args = [a[:256].contiguous(), pats, pwp, torch.ones(pwp.shape[:2], device=a.device), w]
        sets, _ = active_pattern_sets(usage) if usage is not None else (None, 1.0)
        p_active = None if sets is None else int(sets.shape[-1])
        packed = pack_patterns(pats)
        out["l2_entries_256_rows"][label] = fused_checks(f"mesh {label}", args, packed,
                                                         active_sets(args, p_active))
        targs = [a[:1024].contiguous()] + args[1:]
        row = fused_timing(label, targs, packed, route, active_sets(targs, p_active),
                           plain_runs=1)
        b_ms, o_ms = needed_bound_ms(targs[0], pats, w.shape[1])
        row.update(bytes_ms=b_ms, ops_ms=o_ms, bound_ms=max(b_ms, o_ms),
                   whole_bank_bound_ms=row["bound_ms"])
        out["gemms"].append(row)
    attach_device_ms(out["gemms"], lambda row: FUSED_KERNEL[row["route"]])
    lif_timing, out["lif_max_abs_err"] = lif_rows([rec["lif"].contiguous()])
    out["lif_sequence"] = lif_timing
    out["attention"] = lm_attention_row("mesh", rec["policy"],
                                        *(t.contiguous() for t in rec["qkv"]))
    for row in out["gemms"] + out["lif_sequence"] + [out["attention"]]:
        row.pop("_fn", None)
    return out


def mesh_lm_rank(rank, cfg, params, banks, batch, short, prompts, paged_logits,
                 check: bool) -> dict:
    """One rank of the OLMo mesh: every kernel's launch count set to 0, then
    the prefill of ``batch`` and MESH_DECODE_STEPS greedy decode steps, the
    short prompt's run under the policy and with ``impl="coo"`` forced, and
    the engine over ``prompts``; the counts read. Then, counted on their
    own, the same requests through a paged engine from lm_serve's undersized
    pool (LM_PAGE, LM_TIGHT_PAGES), which preempts, its logits rows held
    against ``paged_logits``, lm_serve's from the same pool. Then one prefill
    and decode step with ``banks``, the rank's PWP banks as SERVE_RULES place
    them (split over data), in place of its banks whole over data. Rank 0
    (``check``) then holds the kernels against their plain versions."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.utils import tree_bytes
    from repro_torch.distributed.sharding import SERVE_RULES, use_rules
    from repro_torch.kernels import dispatch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model
    from repro_torch.obs import ListSink, Tracer
    from repro_torch.serve.engine import Engine, Request
    from repro_torch.utils import log

    torch.backends.cuda.matmul.allow_tf32 = False
    log.setLevel("WARNING")
    mesh = make_mesh(MESH_SHAPE, ("data", "model"))
    params, banks, batch, short = (_to_device(t, mesh.device)
                                   for t in (params, banks, batch, short))
    policy = dispatch.PhiExecutionPolicy()
    dispatch.set_policy(policy)
    dispatch.register_usage_from_params(params)
    times: dict = {}
    timed = timed_into(times)

    def greedy(c, b, steps, label, probe=None):
        return greedy_run(c, params, b, steps, lambda name, fn: timed(f"{label}_{name}", fn),
                          probe)

    rules = dict(SERVE_RULES, **MESH_RULES)

    def counter(steps: dict):
        def counted(name, args, call):
            """The first prefill's and decode step's collectives (calls and
            result bytes by the reference's kinds) and argument bytes: what
            the parent's dry run of this cell must give."""
            if name in steps:
                return call()
            before = {k: list(v) for k, v in mesh.results.items()}
            out = call()
            steps[name] = {"argument_bytes": tree_bytes(args), "collectives": {
                kind: [c - before.get(kind, [0, 0])[0], b - before.get(kind, [0, 0])[1]]
                for kind, (c, b) in mesh.results.items()}}
            return out
        return counted

    steps: dict = {}
    counted = counter(steps)
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    with torch.no_grad(), use_rules(rules, mesh):
        logits, cache_shapes = greedy(cfg, batch, MESH_DECODE_STEPS, "main", counted)
        short_policy, _ = greedy(cfg, short, MESH_COO_STEPS, "short")
        coo = cfg.with_(phi=dataclasses.replace(cfg.phi, impl="coo"))
        short_coo, _ = greedy(coo, short, MESH_COO_STEPS, "short_coo")
    eng = Engine(cfg, params, batch_slots=LM_SLOTS, max_context=LM_MAX_CONTEXT, mesh=mesh,
                 wall_time=True)
    for rid, toks in enumerate(prompts):
        eng.submit(Request(rid=rid, tokens=toks, max_new_tokens=LM_MAX_NEW))
    tokens = {r.rid: list(r.tokens) for r in timed("engine_ms", eng.run)}
    launches = read_launches()
    sink = ListSink()
    paged = Engine(cfg, params, batch_slots=LM_SLOTS, max_context=LM_MAX_CONTEXT, mesh=mesh,
                   paged=True, page_size=LM_PAGE, num_pages=LM_TIGHT_PAGES, wall_time=True,
                   tracer=Tracer(sink), record_logits=True)
    for rid, toks in enumerate(prompts):
        paged.submit(Request(rid=rid, tokens=toks, max_new_tokens=LM_MAX_NEW))
    zero_launches()
    paged_tokens = {r.rid: list(r.tokens) for r in timed("paged_engine_ms", paged.run)}
    paged_launches = read_launches()
    rows = {rid: np.stack(r) for rid, r in paged.logit_trace.items()}
    logit_diff = [float(np.abs(rows[rid] - w.numpy()).max()) if rows[rid].shape == w.shape
                  else float("inf") for rid, w in paged_logits.items()]
    paged.logit_trace.clear()
    out = {"rank": rank, "coords": mesh.coords, "backend": mesh.backend,
           "transport": mesh.transport,
           "collectives": {op: {"calls": c, "bytes": b} for op, (c, b) in mesh.stats.items()},
           "logits": logits, "cache_shapes": cache_shapes, "short_policy": short_policy,
           "short_coo": short_coo, "tokens": tokens, "launches": launches, "times_ms": times,
           "engine_ticks": eng.ticks, "decoded_tokens": eng.decoded_tokens,
           "paged": {"tokens": paged_tokens, "launches": paged_launches,
                     "engine_ms": times["paged_engine_ms"][0], "ticks": paged.ticks,
                     "decoded_tokens": paged.decoded_tokens,
                     "logits_bitwise": sorted(rows) == sorted(paged_logits) and max(logit_diff) == 0,
                     "logits_max_abs_diff": max(logit_diff),
                     "preempted": sorted(r["rid"] for r in sink.records
                                         if r["kind"] == "preempt"),
                     "pool_shapes": [tuple(t.shape) for t in model.state_leaves(paged.pools)],
                     "cache": paged.cache_report(), "contig_cache": eng.cache_report()},
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "steps": steps,
           "decisions": [[*key, n] for key, n in sorted(policy.decisions().items())],
           "last": {site: dataclasses.asdict(policy.last_decision(site))
                    for site in ("lm.w1.spmd", "lm.w2.spmd")}}
    for d in out["last"].values():
        d["runtime_sets"] = None if d["runtime_sets"] is None else np.asarray(d["runtime_sets"])
    # SERVE_RULES' placement: each bank's K-partitions split over data too,
    # all-gathered at each call; the prefill and a decode step bitwise the
    # replicated banks' run above.
    split = _with_leaves(params, banks)
    split_steps: dict = {}
    with torch.no_grad(), use_rules(SERVE_RULES, mesh):
        split_logits, _ = greedy_run(cfg, split, batch, 1,
                                     lambda name, fn: timed(f"split_{name}", fn),
                                     counter(split_steps))
    out["split"] = {"logits_bitwise": all(np.array_equal(a, b)
                                          for a, b in zip(split_logits, logits[:2])),
                    "steps": split_steps, "bank_bytes": _bank_bytes(split),
                    "replicated_bank_bytes": _bank_bytes(params)}
    del split, banks
    rec = _record_layer0(params, cfg, batch, mesh)
    if check:
        out["checks"] = _mesh_rank_checks(policy, rec)
    return out


def _bank_tree(node) -> dict:
    """The PWP banks (and ``pwp_scale``) of a params tree, under their key
    paths."""
    out = {}
    for k, v in node.items():
        if isinstance(v, dict):
            if sub := _bank_tree(v):
                out[k] = sub
        elif k in ("pwp", "pwp_scale"):
            out[k] = v
    return out


def _bank_bytes(tree) -> int:
    return sum(v.numel() * v.element_size() for v in tree_leaves(_bank_tree(tree)))


def _with_leaves(tree, sub):
    """``tree`` with the leaves of ``sub`` (a subtree under the same key
    paths) in place of its own."""
    return {k: ((_with_leaves(v, sub[k]) if isinstance(v, dict) else sub[k]) if k in sub else v)
            for k, v in tree.items()}


def mesh_moe_rank(rank, cfg, router, x) -> dict:
    """One rank of the expert-parallel MoE layer: its 32 experts drawn on
    its card (:func:`_moe_experts`), ``moe_ep`` of every token (``data`` = 1)
    against them."""
    import torch

    from repro_torch.distributed.sharding import SERVE_RULES, use_rules
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe

    mesh = make_mesh(MOE_MESH, ("data", "model"))
    torch.cuda.reset_peak_memory_stats()
    e_loc = cfg.n_experts // MOE_MESH[1]
    p = _moe_experts(cfg, mesh.device, rank * e_loc, (rank + 1) * e_loc)
    p["router"] = router.to(mesh.device)
    x = x.to(mesh.device)
    stats: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad(), use_rules(SERVE_RULES, mesh):
        y = moe.moe_ep(cfg, p, x, stats)
    torch.cuda.synchronize()
    return {"rank": rank, "y": y.to(torch.float32).cpu().numpy(), "stats": stats,
            "ms": (time.perf_counter() - t0) * 1e3,
            "collectives": {op: {"calls": c, "bytes": b} for op, (c, b) in mesh.stats.items()},
            "transport": mesh.transport, "backend": mesh.backend,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}


def _moe_experts(cfg, dev, lo: int, hi: int) -> dict:
    """Experts ``lo`` to ``hi`` of one MoE layer (``moe_specs``' law, scale
    1/sqrt(fan_in), drawn in float32 on ``dev`` and cast to the param dtype):
    each expert's weights from a generator seeded by its leaf and index, so
    a rank draws its own experts as the full layer holds them."""
    import math

    import torch

    from repro_torch.models import moe

    p = {}
    for j, (name, spec) in enumerate(sorted(moe.moe_specs(cfg).items())):
        if name == "router":
            continue
        t = torch.empty((hi - lo,) + spec.shape[1:], dtype=spec.dtype, device=dev)
        for i, e in enumerate(range(lo, hi)):
            gen = torch.Generator(device=dev).manual_seed(1_000_003 * (j + 1) + e + SEED)
            t[i].copy_(torch.randn(spec.shape[1:], generator=gen, device=dev)
                       / math.sqrt(spec.shape[-2]))
        p[name] = t
    return p


def _moe_inputs(cfg, dev):
    """The layer's router (scale 0.02, as ``moe_specs``) and its input batch."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED)
    router = torch.randn((cfg.d_model, cfg.n_experts), generator=gen, device=dev) * 0.02
    x = torch.randn((*MOE_TOKENS, cfg.d_model), generator=gen, device=dev)
    return router.to(cfg.param_dtype), x.to(cfg.param_dtype)


def mesh_dryrun_check(cfg, dev, usage, ranks) -> dict:
    """The dry run of ``mesh_serve``'s OLMo cell: the MESH_SHAPE mesh in a
    fake world of as many ranks, the MESH_PREFILL prefill and a decode step
    at its extended context, traced on fake card tensors with the phase's
    calibration usage, against what every rank counted at its first prefill
    and decode step: collective calls and result bytes by the reference's
    kinds and argument bytes, exactly."""
    from repro_torch.distributed.cost_analysis import COLLECTIVES
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    from repro_torch.distributed.sharding import SERVE_RULES

    B, S = MESH_PREFILL
    out = {}
    runs = (("prefill", "prefill", S, MESH_RULES, "steps"),
            ("decode", "decode", S + MESH_DECODE_STEPS + 1, MESH_RULES, "steps"),
            ("split_prefill", "prefill", S, {}, "split"),
            ("split_decode", "decode", S + 2, {}, "split"))
    with dryrun.fake_world(MESH_SHAPE[0] * MESH_SHAPE[1]):
        mesh = make_mesh(MESH_SHAPE, ("data", "model"), dev)
        def step_of(r, where, name):
            return (r["steps"] if where == "steps" else r["split"]["steps"])[name]

        for label, name, ctx, over, where in runs:
            rec = dryrun.trace_step(cfg, name, B, ctx, mesh, dict(SERVE_RULES, **over),
                                    device=dev, usage=usage)
            want = {k: [rec["collective_calls"][k], rec["collectives"][k]] for k in COLLECTIVES}
            for r in ranks:
                step = step_of(r, where, name)
                got = {k: step["collectives"].get(k, [0, 0]) for k in COLLECTIVES}
                if got != want or step["argument_bytes"] != rec["memory"]["argument_bytes"]:
                    raise AssertionError(
                        f"rank {r['rank']} {label}: collectives {got}, argument bytes "
                        f"{step['argument_bytes']}; the dry run gives {want}, "
                        f"{rec['memory']['argument_bytes']}")
            step0 = step_of(ranks[0], where, name)
            out[label] = {"collectives": want,
                          "argument_bytes": rec["memory"]["argument_bytes"],
                          "all_gather_bytes": rec["collectives"]["all-gather"],
                          "rank0": {"argument_bytes": step0["argument_bytes"],
                                    "all_gather_bytes": step0["collectives"].get(
                                        "all-gather", [0, 0])[1]},
                          "temp_bytes": rec["memory"]["temp_bytes"],
                          "launches": rec["launches"]["kernels"], "roofline": rec["roofline"],
                          "trace_s": rec["trace_s"]}
    return out


def mesh_serve_phase(dev, smi, lm) -> dict:
    """The ``mesh_serve`` phase. OLMo-1B: ``lm_serve``'s calibrated params
    and config; on one device (this process), a Phi prefill at MESH_PREFILL
    and MESH_DECODE_STEPS greedy decode steps; every rank's shards
    (``model.param_shardings``), passed through host shared memory to
    MESH_SHAPE spawned ranks on this card; on the ranks the same prefill and steps, a
    short prompt's run under the policy and with ``coo`` forced, and
    ``lm_serve``'s requests through the mesh engine, then through a paged
    mesh engine from the undersized pool. Gates, all bitwise: the mesh
    logits against one device's, the coo run against the policy's, both
    engines' tokens against ``lm_serve``'s Phi engine's, the paged engine's
    every logits row against ``lm_serve``'s paged engine's from the same
    pool; the paged engine preempting, its pool leaves holding ``H / model``
    KV heads, its own launches counting the streaming and LIF kernels; the
    decisions
    at w1 and w2 a fused kernel in the per-rank body with every rank
    counted. Arctic-480B: one MoE layer at full width, ``moe_dense`` here,
    then ``moe_ep`` on MOE_MESH ranks of 32 experts each (each draws its
    own, as the full layer holds them), within MOE_ULPS, no token dropped."""
    import types

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import SERVE_RULES, place
    from repro_torch.kernels import dispatch
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.models import model, moe

    t_phase = time.perf_counter()
    cfg, params = lm["cfg"], lm["params"]
    policy = dispatch.PhiExecutionPolicy()
    prev_policy = dispatch.set_policy(policy)
    dispatch.register_usage_from_params(params)
    times = {}
    try:
        batch = model.dummy_batch(cfg, *MESH_PREFILL, False,
                                  torch.Generator().manual_seed(SEED + 2), dev)
        short = model.dummy_batch(cfg, *MESH_SHORT, False,
                                  torch.Generator().manual_seed(SEED + 3), dev)
        ms: dict = {}
        with torch.no_grad():
            single, single_shapes = greedy_run(cfg, params, batch, MESH_DECODE_STEPS,
                                               timed_into(ms))
        single_ms = {"prefill": ms["prefill_ms"], "decode": ms["decode_ms"]}
        torch.cuda.empty_cache()
    finally:
        dispatch.set_policy(prev_policy)

    axes = ("data", "model")
    grid = types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, MESH_SHAPE)))
    placements = model.param_shardings(cfg, grid, dict(SERVE_RULES, **MESH_RULES))
    world = MESH_SHAPE[0] * MESH_SHAPE[1]
    t0 = time.perf_counter()
    # each model index's shards, which its data ranks share, in host shared
    # memory: each rank copies its own onto the card
    by_model = {m: _host_shared(place(params, placements, grid, {"data": 0, "model": m},
                                      copy=False))
                for m in range(MESH_SHAPE[1])}
    # and each rank's banks as SERVE_RULES place them (split over data too)
    split_placements = model.param_shardings(cfg, grid, SERVE_RULES)
    banks = [_host_shared(place(_bank_tree(params), split_placements, grid,
                                {"data": r // MESH_SHAPE[1], "model": r % MESH_SHAPE[1]},
                                copy=False))
             for r in range(world)]
    torch.cuda.synchronize()
    times["cut_shards_s"] = time.perf_counter() - t0
    shard_bytes = {m: sum(t.numel() * t.element_size() for t in tree_leaves(sh))
                   for m, sh in by_model.items()}
    paged_logits = _host_shared(lm["paged_logits"])
    full_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    t0 = time.perf_counter()
    ranks = spawn_ranks(mesh_lm_rank, world,
                        [(cfg, by_model[r % MESH_SHAPE[1]], banks[r], _host_shared(batch),
                          _host_shared(short), lm["prompts"], paged_logits, r == 0)
                         for r in range(world)],
                        device="cuda", timeout=MESH_TIMEOUT, threads=2)
    times["olmo_ranks_s"] = time.perf_counter() - t0
    del by_model, banks

    # ------------------------------------------------------------ gates ---
    V = cfg.vocab
    for r in ranks:
        got = r["logits"]
        if len(got) != len(single) or any(g.shape != (MESH_PREFILL[0], V) for g in got):
            raise AssertionError(f"rank {r['rank']}: logits {[g.shape for g in got]}")
        for i, (g, w) in enumerate(zip(got, single)):
            if not np.array_equal(g, w):
                raise AssertionError(f"rank {r['rank']} step {i}: mesh logits differ from one "
                                     f"device's, max |diff| {float(np.abs(g - w).max())}")
        for i, (g, w) in enumerate(zip(r["short_coo"], r["short_policy"])):
            if not np.array_equal(g, w):
                raise AssertionError(f"rank {r['rank']} short step {i}: forced coo differs "
                                     f"from the policy's, max |diff| {float(np.abs(g - w).max())}")
        if r["tokens"] != lm["tokens"]:
            raise AssertionError(f"rank {r['rank']}: mesh engine tokens differ from lm_serve's")
        for site, d in r["last"].items():
            if d["impl"] not in ("fused", "fused_stream", "fused_prefetch") or \
                    not d["reason"].startswith("spmd_local_") or d["shards"] != world:
                raise AssertionError(f"rank {r['rank']} {site}: decision {d['impl']} "
                                     f"{d['reason']} shards {d['shards']}")
        if not any(s == "lm.w2.spmd" and i == "coo" and reason == "config_override"
                   for s, i, reason, _ in r["decisions"]):
            raise AssertionError(f"rank {r['rank']}: no config_override coo at lm.w2.spmd")
        want_shapes = [(L, B // MESH_SHAPE[0], S_, H // MESH_SHAPE[1], hd)
                       for (L, B, S_, H, hd) in single_shapes]
        if r["cache_shapes"] != want_shapes:
            raise AssertionError(f"rank {r['rank']}: caches {r['cache_shapes']} != {want_shapes}")
        lc = r["launches"]
        if lc["phi_fused_stream_cuda"] <= 0 or lc["lif_sequence_cuda"] <= 0 or \
                lc["flash_attention_cuda"] != cfg.n_layers:
            raise AssertionError(f"rank {r['rank']}: launches {lc}")
        pg = r["paged"]
        if pg["tokens"] != lm["tokens"]:
            raise AssertionError(f"rank {r['rank']}: paged mesh engine tokens differ from "
                                 "lm_serve's")
        if not pg["preempted"]:
            raise AssertionError(f"rank {r['rank']}: the paged engine never preempted")
        if not pg["logits_bitwise"]:
            raise AssertionError(f"rank {r['rank']}: paged mesh logits differ from lm_serve's "
                                 f"paged engine's, max |diff| {pg['logits_max_abs_diff']}")
        H, hd = cfg.kv_heads_padded, cfg.hd
        want_pools = [(cfg.n_layers, LM_TIGHT_PAGES + 1, LM_PAGE, H // MESH_SHAPE[1], hd)] * 2
        if pg["pool_shapes"] != want_pools:
            raise AssertionError(f"rank {r['rank']}: pools {pg['pool_shapes']} != {want_pools}")
        if pg["launches"]["phi_fused_stream_cuda"] <= 0 or \
                pg["launches"]["lif_sequence_cuda"] <= 0:
            raise AssertionError(f"rank {r['rank']}: paged engine launches {pg['launches']}")
        sp = r["split"]
        if not sp["logits_bitwise"]:
            raise AssertionError(f"rank {r['rank']}: the prefill and decode step from banks "
                                 "split over data differ from the replicated banks' run")
        if sp["bank_bytes"] * MESH_SHAPE[0] != sp["replicated_bank_bytes"]:
            raise AssertionError(f"rank {r['rank']}: split banks hold {sp['bank_bytes']} bytes "
                                 f"of the replicated {sp['replicated_bank_bytes']}")
        if lc["decode_attention_cuda"] <= 0:
            raise AssertionError(f"rank {r['rank']}: no decode attention launch: {lc}")
    if float(np.std(single[0])) == 0 or not np.isfinite(single[0]).all():
        raise AssertionError("mesh_serve: constant or non-finite prefill logits")
    checks = ranks[0]["checks"]
    launches = {k: sum(r["launches"][k] + r["paged"]["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    from repro_torch.launch.dryrun import policy_usage

    dry = mesh_dryrun_check(cfg, dev, policy_usage(policy), ranks)

    # ----------------------------------------------- Arctic MoE, EP over 4 ---
    mcfg = get_config(MOE_ARCH).with_(capacity_factor=MOE_CF)
    del lm["params"], params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    p = _moe_experts(mcfg, dev, 0, mcfg.n_experts)
    p["router"], x = _moe_inputs(mcfg, dev)
    torch.cuda.synchronize()
    times["moe_init_s"] = time.perf_counter() - t0
    expert_bytes = sum(t.numel() * t.element_size() for k, t in p.items() if k != "router")
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dense = moe.moe_dense(mcfg, p, x)
        torch.cuda.synchronize()
        dense_ms = (time.perf_counter() - t0) * 1e3
        dense = dense.to(torch.float32).cpu().numpy()
    dense_peak = torch.cuda.max_memory_allocated()
    router, x = p["router"].cpu(), x.cpu()
    del p
    torch.cuda.empty_cache()
    tp = MOE_MESH[1]
    t0 = time.perf_counter()
    moe_ranks = spawn_ranks(mesh_moe_rank, tp, [(mcfg, router, x)] * tp, device="cuda",
                            timeout=MESH_TIMEOUT, threads=2)
    times["moe_ranks_s"] = time.perf_counter() - t0
    ulp = _bf16_ulp(float(np.abs(dense).max()))
    mean_ulp = _bf16_ulp(float(np.abs(dense).mean()))
    moe_err = {}
    for r in moe_ranks:
        y = r["y"]
        if y.shape != dense.shape or not np.isfinite(y).all():
            raise AssertionError(f"moe rank {r['rank']}: output {y.shape} not finite/{dense.shape}")
        if r["stats"]["dropped"] != 0:
            raise AssertionError(f"moe rank {r['rank']}: {r['stats']['dropped']} choices dropped")
        diff = np.abs(y - dense)
        moe_err[r["rank"]] = {"max_abs_err": float(diff.max()), "mean_abs_err": float(diff.mean()),
                              "differing_share": float((diff > 0).mean())}
        if diff.max() > MOE_ULPS * ulp or diff.mean() > mean_ulp:
            raise AssertionError(f"moe rank {r['rank']}: EP vs dense max |diff| {diff.max()} "
                                 f"(> {MOE_ULPS * ulp}?) mean {diff.mean()} (> {mean_ulp}?)")
        if not np.array_equal(y, moe_ranks[0]["y"]):
            raise AssertionError(f"moe rank {r['rank']}: output differs from rank 0's")

    def rank_row(r):
        return {"rank": r["rank"], "coords": r["coords"], "backend": r["backend"],
                "transport": r["transport"], "collectives": r["collectives"],
                "times_ms": r["times_ms"], "engine_ticks": r["engine_ticks"],
                "decoded_tokens": r["decoded_tokens"],
                "max_memory_allocated": r["max_memory_allocated"], "launches": r["launches"],
                "paged": {k: v for k, v in r["paged"].items() if k != "tokens"}}

    emit({"phase": "mesh_serve", "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "note": "ranks are processes sharing one card: their times include each other's work",
          "olmo": {"arch": LM_ARCH, "n_layers": cfg.n_layers, "mesh": dict(zip(axes, MESH_SHAPE)),
                   "prefill": MESH_PREFILL, "decode_steps": MESH_DECODE_STEPS,
                   "short": MESH_SHORT, "coo_steps": MESH_COO_STEPS,
                   "full_param_bytes": full_bytes, "shard_bytes_by_model_index": shard_bytes,
                   "single_device_ms": single_ms, "ranks": [rank_row(r) for r in ranks],
                   "decisions_rank0": ranks[0]["decisions"],
                   "last_decisions_rank0": {s: {k: v for k, v in d.items()
                                                if k != "runtime_sets"}
                                            for s, d in ranks[0]["last"].items()},
                   "checks_rank0": checks, "dryrun": dry,
                   "gates": {"prefill_and_decode_bitwise_one_device": True,
                             "forced_coo_bitwise_policy": True,
                             "engine_tokens_equal_lm_serve": True,
                             "paged_engine_tokens_equal_lm_serve": True,
                             "paged_engine_logits_bitwise_lm_serve_paged": True,
                             "paged_engine_preempted": True,
                             "paged_pool_kv_heads_a_rank": cfg.kv_heads_padded // MESH_SHAPE[1],
                             "w1_w2_spmd_local_fused_shards": world,
                             "dryrun_collectives_and_argument_bytes_equal_every_rank": True,
                             "split_banks_prefill_and_decode_bitwise_replicated": True},
                   "split_banks": {"rules": "SERVE_RULES (pwp_tiles over data); the other "
                                   "runs keep the banks whole over data (MESH_RULES)",
                                   "bank_bytes_rank0": ranks[0]["split"]["bank_bytes"],
                                   "replicated_bank_bytes_rank0":
                                       ranks[0]["split"]["replicated_bank_bytes"]},
                   "paged": {"page": LM_PAGE, "pages": LM_TIGHT_PAGES,
                             "layout": "KV heads over model, every page on every rank"}},
          "moe": {"arch": MOE_ARCH, "mesh": dict(zip(axes, MOE_MESH)),
                  "d_model": mcfg.d_model, "d_ff": mcfg.d_ff, "experts": mcfg.n_experts,
                  "top_k": mcfg.top_k, "tokens": MOE_TOKENS, "capacity_factor": MOE_CF,
                  "capacity": moe_ranks[0]["stats"]["capacity"],
                  "dropped": [r["stats"]["dropped"] for r in moe_ranks],
                  "expert_bytes": expert_bytes, "dense_ms": dense_ms,
                  "dense_peak_memory": dense_peak, "tolerance_ulps": MOE_ULPS,
                  "bf16_ulp_at_max": ulp, "errors": moe_err,
                  "ranks": [{k: r[k] for k in ("rank", "ms", "collectives", "transport",
                                               "backend", "max_memory_allocated")}
                            for r in moe_ranks]},
          "stages_s": times, "seconds": time.perf_counter() - t_phase})
    return {"launches": launches, "lif_err": checks["lif_max_abs_err"],
            "attn_err": checks["attention"]["max_abs_err"]}


# The hybrid serving path: Zamba2-1.2B (src/repro_torch/configs/zamba2_1p2b.py)
# at full width in Phi spiking mode, with lm_serve's calibration, prefill
# gate, requests and engine sizes. Its depth is cut to HYB_LAYERS = 14 of 38:
# the first 2 of its 6 sites (6 Mamba-2 layers and the shared block each) and
# the 2 tail layers. It ran all 38 until hybrid_mesh joined the script; the
# cut pays for that phase (the calibration alone took 139-157 s at 38).
HYB_ARCH = "zamba2_1p2b"
HYB_SMOKE = False          # the smoke cut, for rehearsing the phase on the CPU
HYB_LAYERS = 14            # of Zamba2-1.2B's 38 layers
HYB_SOLO = 2               # requests the one-slot engine serves again
MAMBA_GEMMS = ("wz", "wx", "wB", "wC", "wdt", "wo")
SHARED_GEMMS = {"attn": ("wq", "wk", "wv", "wo"), "mlp": ("w1", "w3", "w2")}


def hybrid_sites(decoder) -> dict:
    """{capture key: (label, params node, weight name)} of every Phi GEMM site
    of a Zamba2 decoder, keyed as the forward first reaches them: the main
    Mamba-2 layers' (#0), the shared block's (``wo`` #1) and the tail's (#1,
    ``wo`` #2)."""
    sites = {f"{n}#0": (n, decoder["mamba"], n) for n in MAMBA_GEMMS}
    for part, names in SHARED_GEMMS.items():
        for n in names:
            sites[f"{n}#{int(n == 'wo')}"] = (f"shared.{n}", decoder["shared"][part], n)
    if "mamba_tail" in decoder:
        sites.update({f"{n}#{1 + int(n == 'wo')}": (f"tail.{n}", decoder["mamba_tail"], n)
                      for n in MAMBA_GEMMS})
    return sites


def hybrid_serve_phase(dev, smi) -> dict:
    """The ``hybrid_serve`` phase: Zamba2-1.2B in Phi spiking mode, full width,
    HYB_LAYERS deep (12 Mamba-2 layers in 2 sites, each followed by the
    shared attention + MLP block with the site's LoRA on Q, then 2 tail
    layers), on the card. With every kernel's launch count set to 0 just before and read
    just after: params from a seeded generator on the card, rounded onto the
    2^-10 grid; ``calibrate_lm_phi`` on 2 x 128 tokens; the prefill gate
    (``train_logits`` at B = 1, S = 2048, Phi bitwise the spiking-dense arm,
    the attention kernel at every site); the engine over 8 requests and 4
    slots as Phi and spiking-dense, token- and logit-identical; a one-slot
    Phi engine over two of them, token-identical (each admission writes its
    slot's states at their own batch axis); a ``paged=True`` engine keeping
    dense slots. Then, outside the counted run: every kernel the phase
    launched against its plain version at layer 0's operands; prefill,
    decode-step and GEMM timings beside their bounds; peak memory. Returns
    the launches and errors, and the calibrated config, params and requests
    (``hybrid_mesh`` takes them)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config, phi_variant
    from repro_torch.distributed.sharding import init_params
    from repro_torch.kernels import dispatch
    from repro_torch.models import layers as ll
    from repro_torch.models import model, transformer
    from repro_torch.obs import ListSink, Tracer, set_tracer
    from repro_torch.serve.engine import Engine, Request

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = phi_variant(get_config(HYB_ARCH, smoke=HYB_SMOKE)).with_(n_layers=HYB_LAYERS)
    n_sites = cfg.n_layers // cfg.hybrid_attn_every
    policy = dispatch.PhiExecutionPolicy()
    prev_policy = dispatch.set_policy(policy)
    sink = ListSink()
    tracer = Tracer(sink)
    prev_tracer = set_tracer(tracer)
    times, marks = {}, {}

    def stage(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out

    rng = np.random.default_rng(LM_PROMPT_SEED)
    prompts = [rng.integers(3, cfg.vocab, int(n))
               for n in rng.integers(LM_PROMPT[0], LM_PROMPT[1] + 1, LM_REQUESTS)]
    engines = {"phi": dict(batch_slots=LM_SLOTS), "spiking_dense": dict(batch_slots=LM_SLOTS),
               "one_slot": dict(batch_slots=1)}

    def serve(name, kw):
        eng = Engine(cfg, params, max_context=LM_MAX_CONTEXT, record_logits=True,
                     wall_time=True, tracer=tracer,
                     matmul=model.spiking_dense_matmul(cfg) if name == "spiking_dense" else None,
                     **kw)
        for rid, toks in enumerate(prompts[:HYB_SOLO] if name == "one_slot" else prompts):
            eng.submit(Request(rid=rid, tokens=toks, max_new_tokens=LM_MAX_NEW))
        first = len(sink.records)
        res = stage(f"engine_{name}", eng.run)
        marks[name] = (first, len(sink.records))
        return eng, {r.rid: r.tokens for r in res}

    zero_launches()
    try:
        with torch.no_grad():
            def build():
                p = init_params(model.lm_specs(cfg), torch.Generator(device=dev).manual_seed(SEED),
                                dev)
                for leaf in tree_leaves(model.split_phi_state(p)[0]):
                    leaf.copy_(dyadic(leaf))
                return p

            params = stage("init_params", build)
            calib = model.dummy_batch(cfg, *LM_CALIB, False, torch.Generator().manual_seed(SEED),
                                      dev)
            params, stats = stage("calibrate", lambda: model.calibrate_lm_phi(cfg, params, calib))
            calib_peak = torch.cuda.max_memory_allocated()
            maxd = max(st.l2_density for st in stats.values())
            cfg = cfg.with_(phi=dataclasses.replace(cfg.phi, nnz_budget=min(0.9, 2 * maxd + 0.05)))
            batch = model.dummy_batch(cfg, 1, LM_PREFILL_S, False,
                                      torch.Generator().manual_seed(SEED + 1), dev)
            first = len(sink.records)
            phi_logits = stage("prefill_phi", lambda: model.train_logits(cfg, params, batch))
            marks["prefill"] = (first, len(sink.records))
            dense_logits = stage("prefill_spiking_dense", lambda: model.train_logits(
                cfg, params, batch, matmul=model.spiking_dense_matmul(cfg)))
            runs = {name: serve(name, kw) for name, kw in engines.items()}
            paged = Engine(cfg, params, batch_slots=LM_SLOTS, max_context=LM_MAX_CONTEXT,
                           paged=True)
        launches = read_launches()
    finally:
        set_tracer(prev_tracer)
        dispatch.set_policy(prev_policy)
    counted_s = time.perf_counter() - t_phase

    # ------------------------------------------------------------ gates ---
    V = cfg.vocab
    if phi_logits.shape != (1, LM_PREFILL_S, V) or not torch.isfinite(phi_logits).all():
        raise AssertionError(f"hybrid prefill logits {tuple(phi_logits.shape)} not "
                             "finite/(1, S, V)")
    if not torch.equal(phi_logits, dense_logits):
        raise AssertionError(f"hybrid prefill: Phi logits differ from spiking-dense, max |diff| "
                             f"{float((phi_logits - dense_logits).abs().max())}")
    if float(phi_logits.std()) == 0:
        raise AssertionError("hybrid prefill: constant logits")
    want_eng, want = runs["phi"]
    if sorted(want) != list(range(LM_REQUESTS)) or \
            any(len(t) != LM_MAX_NEW for t in want.values()):
        raise AssertionError(f"hybrid phi engine: results {[len(t) for t in want.values()]}")
    dense_eng, dense_res = runs["spiking_dense"]
    if dense_res != want:
        raise AssertionError("hybrid engine spiking_dense: tokens differ from the Phi engine's")
    for rid, rows in want_eng.logit_trace.items():
        if len(rows) != len(dense_eng.logit_trace[rid]) or not all(
                np.array_equal(a, b) for a, b in zip(rows, dense_eng.logit_trace[rid])):
            raise AssertionError(f"hybrid engine spiking_dense: request {rid}'s logits not bitwise")
    solo = runs["one_slot"][1]
    if solo != {rid: want[rid] for rid in range(HYB_SOLO)}:
        raise AssertionError(f"hybrid one-slot engine: tokens {solo} differ from the four-slot "
                             f"run's {[want[r] for r in range(HYB_SOLO)]}")
    if paged.paged or paged.scheduler.report().get("paged_gate_dense") != 1:
        raise AssertionError(f"hybrid paged engine did not keep dense slots: "
                             f"{paged.scheduler.report()}")
    recs = [r for r in sink.records if r["kind"] == "dispatch"]
    n_attn = sum(r["site"] == "lm.attn_prefill" for r in recs)
    if launches["flash_attention_cuda"] != n_attn or n_attn != 2 * n_sites:
        raise AssertionError(f"hybrid attention kernel launches {launches['flash_attention_cuda']},"
                             f" decisions {n_attn}, want 2 x {n_sites} sites")
    for impl in ("fused", "fused_stream", "fused_prefetch"):
        n = sum(r["impl"] == impl for r in recs)
        if launches[f"phi_{impl}_cuda"] != n:
            raise AssertionError(f"hybrid phi_{impl} launched {launches[f'phi_{impl}_cuda']} "
                                 f"times for {n} decisions")
    if launches["lif_sequence_cuda"] <= 0 or launches["matcher_cuda"] <= 0:
        raise AssertionError(f"hybrid: LIF or matcher kernel never launched: {launches}")

    def tally(lo, hi, keep=lambda r: True):
        out = {}
        for r in sink.records[lo:hi]:
            if r["kind"] == "dispatch" and keep(r):
                key = (r["site"], r["impl"], r["reason"], *r["shape"][1:3])
                out[key] = out.get(key, 0) + 1
        return [[*key, n] for key, n in sorted(out.items())]

    decode_m = cfg.phi.timesteps * LM_SLOTS
    decisions = {"prefill": tally(*marks["prefill"]),
                 "engine_decode": tally(*marks["phi"], lambda r: r["shape"][0] == decode_m),
                 "engine_prefill": tally(*marks["phi"], lambda r: r["shape"][0] != decode_m)}

    # ------------------------------------ kernels against plain versions ---
    dec = params["decoder"]
    with torch.no_grad():
        captured = model._capture_phi_spikes(cfg, params, calib)
    sites = hybrid_sites(dec)
    if sorted(sites) != sorted(stats) or sorted(captured) != sorted(stats):
        raise AssertionError(f"hybrid sites {sorted(sites)} != calibrated {sorted(stats)}")
    site_table = []
    for key, (label, node, name) in sites.items():
        w, pwp = node[name], node["phi_" + name]["pwp"]
        layers = w.shape[0] if w.dim() == 3 else 1
        site_table.append({"site": label, "key": key, "K": w.shape[-2], "N": w.shape[-1],
                           "T": w.shape[-2] // cfg.phi.k, "layers": layers,
                           "calls": len(captured[key]),
                           "bank_bytes_per_layer": pwp.numel() * pwp.element_size() // layers,
                           "l2_density": stats[key].l2_density})
    layer0 = {key: site for key, site in sites.items() if not site[0].startswith("tail.")}
    checks, gemm_rows = lm_gemms({label: (key, node, name)
                                  for key, (label, node, name) in layer0.items()},
                                 captured, recs, decode_m, timed=("wz", "wB", "wo"))
    # LIF: the rate coding of layer 0's wz operand (the calibration batch).
    x0 = ll.apply_norm(cfg, transformer.layer_slice(dec["ln"], 0),
                       model._embed_inputs(cfg, params, calib))
    x_seq = x0.to(torch.float32).unsqueeze(0).expand(cfg.phi.timesteps, *x0.shape).contiguous()
    lif_timing, lif_err = lif_rows([x_seq])
    # Matcher: the calibration's assignment at layer 0's wo (K = d_inner).
    matcher_row = lm_matcher_row(
        "hybrid wo", captured["wo#0"][0].reshape(-1, cfg.d_inner).to(torch.float32).contiguous(),
        dec["mamba"]["phi_wo"]["patterns"][0])
    # Attention: the shared block's q, k, v at site 0 of the prefill gate
    # (the residual stream after the first six Mamba-2 layers), widened to
    # float32.
    with torch.no_grad():
        mm = model.make_matmul(cfg)
        x = model._embed_inputs(cfg, params, batch)
        for li in range(cfg.hybrid_attn_every):
            x, _ = transformer._mamba_layer_prefill(cfg, transformer.layer_slice(dec["mamba"], li),
                                                    transformer.layer_slice(dec["ln"], li), x, mm)
        _, merged, lora = transformer._shared_block(dec, 0)
        h = ll.apply_norm(cfg, merged["ln1"], x)
        pos = torch.arange(LM_PREFILL_S, device=dev)[None]
        q, k, v = (t.to(torch.float32).contiguous() for t in transformer._qkv(
            cfg, merged, h, pos, mm, lora))
    attn_row = lm_attention_row("hybrid", policy, q, k, v)

    # ------------------------------------------------------------ timing ---
    timing = lm_timings(cfg, params, batch, dev)
    serve_rows = lm_serve_rows(runs, times, {"phi": LM_REQUESTS, "spiking_dense": LM_REQUESTS,
                                             "one_slot": HYB_SOLO})
    split = model.split_phi_state(params)
    pwp_bytes = sum(leaf.numel() * leaf.element_size() for leaf in tree_leaves(split[1])
                    if leaf.dim() >= 3 and leaf.dtype == cfg.param_dtype)
    weight_bytes = sum(leaf.numel() * leaf.element_size() for leaf in tree_leaves(split[0]))
    emit({"phase": "hybrid_serve", "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "config": {"arch": HYB_ARCH, "smoke": HYB_SMOKE, "n_layers": cfg.n_layers,
                     "sites": n_sites, "layers_a_site": cfg.hybrid_attn_every,
                     "d_model": cfg.d_model, "d_inner": cfg.d_inner, "d_ff": cfg.d_ff,
                     "ssm_state": cfg.ssm_state, "ssm_heads": cfg.ssm_heads, "vocab": V,
                     "timesteps": cfg.phi.timesteps, "q": cfg.phi.q, "k": cfg.phi.k,
                     "calib": LM_CALIB, "prefill_s": LM_PREFILL_S, "requests": LM_REQUESTS,
                     "slots": LM_SLOTS, "max_new": LM_MAX_NEW, "max_context": LM_MAX_CONTEXT,
                     "one_slot_requests": HYB_SOLO},
          "counted_s": counted_s, "stages_s": times, "launches": launches,
          "decisions": decisions,
          "gates": {"prefill_phi_bitwise_spiking_dense": True,
                    "engines_token_and_logit_identical": ["phi", "spiking_dense"],
                    "one_slot_tokens_equal": True, "paged_gate_dense": True,
                    "attention_launches": n_attn},
          "l2_density_max": maxd, "sites": site_table,
          "gemm_l2_entries_256_rows": checks, "gemms": gemm_rows,
          "lif_sequence": lif_timing, "lif_max_abs_err": lif_err,
          "matcher": matcher_row, "attention": attn_row,
          "calibrate_s": times["calibrate"], "calibrate_peak_memory": calib_peak,
          **timing, "serve": serve_rows, "pwp_bytes": pwp_bytes, "weight_bytes": weight_bytes,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "seconds": time.perf_counter() - t_phase})
    del runs, paged, captured, split
    torch.cuda.empty_cache()
    return {"launches": launches, "lif_err": lif_err, "attn_err": attn_row["max_abs_err"],
            "cfg": cfg, "params": params, "prompts": prompts}


# The hybrid on a mesh: hybrid_serve's calibrated Zamba2-1.2B cut to its
# first site (6 Mamba-2 layers and the shared block) and its 2 tail layers, 8
# of 38 layers at full width, on four ranks sharing the card through gloo;
# then the same 8 layers dense, trained on that mesh. No second calibration:
# the cut keeps the first site's layers of hybrid_serve's banks.
HM_MESH = (2, 2)                   # (data, model)
HM_PREFILL = (2, 2048)             # B, S: S > 1024 takes the attention kernel
HM_DECODE_STEPS = 4
HM_TRAIN_STEPS = 2
HM_TRAIN_BATCH = 2                 # global rows: one a data rank
# Training runs twice; mesh_train's gates hold the float32 arm. The config's own
# bf16 arm takes step 1 only: at bf16 one device's gradients lie up to 29.6%
# of a leaf's largest entry from its own float32 ones (mamba_tail/wB), and
# the mesh's up to 20.5% from one device's (mamba/D; ln/w 8.9%) and within
# 1.44x one device's bf16 gap from float32 (H100, seed 0). Its gradients are
# held to one device's within HM_BF16_GRAD_REL, between those two readings.
HM_BF16_GRAD_REL = 2.0 ** -2


def hybrid_first_site(cfg, params):
    """(config, params) of ``cfg``'s first site and tail: the main stack's
    first ``hybrid_attn_every`` layers (their Phi state with them), the shared
    block, the first site's LoRA and the whole tail, copied so that the rest
    can be let go."""
    g = cfg.hybrid_attn_every
    tail = cfg.n_layers - (cfg.n_layers // g) * g

    def lead(tree, n):
        if isinstance(tree, dict):
            return {k: lead(v, n) for k, v in tree.items()}
        return tree[:n].clone()

    dec = dict(params["decoder"])
    dec["mamba"], dec["ln"] = lead(dec["mamba"], g), lead(dec["ln"], g)
    dec["lora_a"], dec["lora_b"] = lead(dec["lora_a"], 1), lead(dec["lora_b"], 1)
    return cfg.with_(n_layers=g + tail), dict(params, decoder=dec)


def hybrid_mesh_rank(rank, cfg, params, batch, prompts, dcfg, bcfg, ocfg, params0, single,
                     check: bool) -> dict:
    """One rank of the hybrid mesh. Serving: every kernel's launch count set
    to 0, the prefill of ``batch`` and HM_DECODE_STEPS greedy decode steps
    and the engine over ``prompts``, the counts read; rank 0 (``check``)
    then holds the kernels against their plain versions at its layer-0 local
    operands. Training: the counts set to 0, step 1's loss and gradients of
    ``dcfg`` (float32) and of ``bcfg`` (bf16) from ``params0``, gathered and
    held against ``single``'s, then HM_TRAIN_STEPS steps of ``dcfg`` through
    ``train_loop(mesh=)`` from the same seed, the counts read."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.data.pipeline import DataConfig, ShardedLoader
    from repro_torch.distributed.sharding import SERVE_RULES, place, use_rules
    from repro_torch.kernels import dispatch
    from repro_torch.launch import train as train_launch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model
    from repro_torch.serve.engine import Engine, Request
    from repro_torch.train import step as step_lib
    from repro_torch.utils import log

    torch.backends.cuda.matmul.allow_tf32 = False
    log.setLevel("WARNING")
    mesh = make_mesh(HM_MESH, ("data", "model"))
    dev = mesh.device
    params, batch = _to_device(params, dev), _to_device(batch, dev)
    policy = dispatch.PhiExecutionPolicy()
    dispatch.set_policy(policy)
    dispatch.register_usage_from_params(params)
    times: dict = {}
    timed = timed_into(times)
    B, S = batch["tokens"].shape
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    with torch.no_grad(), use_rules(SERVE_RULES, mesh):
        outs, cache_shapes = greedy_run(cfg, params, batch, HM_DECODE_STEPS, timed)
    want_state, _ = step_lib.init_decode_state(cfg, B, S + HM_DECODE_STEPS + 1, mesh)
    want_shapes = [tuple(x.shape) for x in model.state_leaves(want_state)]
    del want_state
    eng = Engine(cfg, params, batch_slots=LM_SLOTS, max_context=LM_MAX_CONTEXT, mesh=mesh,
                 wall_time=True)
    for rid, toks in enumerate(prompts):
        eng.submit(Request(rid=rid, tokens=toks, max_new_tokens=LM_MAX_NEW))
    tokens = {r.rid: list(r.tokens) for r in timed("engine_ms", eng.run)}
    launches = read_launches()
    spmd = sorted({site for site, _, _ in policy.decisions() if site.endswith(".spmd")})
    out = {"rank": rank, "coords": mesh.coords, "backend": mesh.backend,
           "transport": mesh.transport, "logits": outs, "cache_shapes": cache_shapes,
           "want_cache_shapes": want_shapes, "tokens": tokens, "launches": launches,
           "engine_ticks": eng.ticks, "decoded_tokens": eng.decoded_tokens,
           "serve_collectives": {op: {"calls": c, "bytes": b}
                                 for op, (c, b) in mesh.stats.items()},
           "serve_peak_memory": torch.cuda.max_memory_allocated(),
           "decisions": [[*key, n] for key, n in sorted(policy.decisions().items())],
           "last": {site: {k: v for k, v in dataclasses.asdict(policy.last_decision(site)).items()
                           if k != "runtime_sets"} for site in spmd}}
    del eng
    rec = _record_layer0(params, cfg, batch, mesh)
    if check:
        out["checks"] = _mesh_rank_checks(policy, rec, {
            "lm.wz.spmd": ("lm.wz.spmd", None),
            "lm.wo.spmd mamba": ("lm.wo.spmd", cfg.d_inner // HM_MESH[1]),
            "lm.wo.spmd shared": ("lm.wo.spmd", cfg.q_heads_padded * cfg.hd // HM_MESH[1])})
    del rec, params
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ training ---
    loader = iter(ShardedLoader(DataConfig(vocab=dcfg.vocab, seq_len=S,
                                           global_batch=HM_TRAIN_BATCH, seed=SEED)))
    batch0 = {k: torch.from_numpy(v).to(dev) for k, v in next(loader).items()}
    dist.barrier()                 # rank 0's checks done: the steps' times are the steps'
    mesh.stats.clear()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    bundle, _, _, _ = step_lib.make_train_step(dcfg, ocfg, mesh)
    p_sh = bundle.in_shardings[0]
    t_sh = model.split_phi_state(p_sh)[0]
    local = _to_device(place(params0, p_sh, mesh), dev)
    loss1, grads = timed("grads_ms", lambda: bundle.grads(local, batch0))
    out["loss1"] = float(loss1)
    out["grad_errs"] = _gathered_errs(grads, t_sh, mesh, single["grads"])[0]
    del grads
    bundle, _, _, _ = step_lib.make_train_step(bcfg, ocfg, mesh)
    loss1, grads = timed("grads_bf16_ms", lambda: bundle.grads(local, batch0))
    out["loss1_bf16"] = float(loss1)
    out["grad_errs_bf16"], out["grad_errs_bf16_f32"] = _gathered_errs(
        grads, t_sh, mesh, single["grads_bf16"], single["grads"])
    del grads, local, bundle
    p_full, losses = timed("train_loop_ms", lambda: train_launch.train_loop(
        dcfg, ocfg, steps=HM_TRAIN_STEPS, global_batch=HM_TRAIN_BATCH, seq=S, seed=SEED,
        log_every=0, mesh=mesh))
    out["losses"] = losses
    out["param_errs"] = _gathered_errs(model.split_phi_state(p_full)[0], t_sh, mesh,
                                       single["params"])[0]
    del p_full
    out["train_launches"] = read_launches()
    out["train_collectives"] = {op: {"calls": c, "bytes": b} for op, (c, b) in mesh.stats.items()}
    out["train_peak_memory"] = torch.cuda.max_memory_allocated()
    out["times_ms"] = times
    return out


def hybrid_mesh_phase(dev, smi, hyb) -> dict:
    """The ``hybrid_mesh`` phase. Serving: ``hybrid_serve``'s calibrated
    Zamba2-1.2B cut to its first site and tail (:func:`hybrid_first_site`);
    on one device (this process) a Phi prefill at HM_PREFILL, HM_DECODE_STEPS
    greedy decode steps and the engine over ``hybrid_serve``'s requests;
    every rank's shards (``model.param_shardings``) through host shared
    memory to four spawned ranks on this card, which run the same. Gates, all
    bitwise: the mesh's logits against one device's, its engine's tokens
    against one device's engine's; every ``lm.*.spmd`` decision a fused
    kernel in the per-rank body with ``shards`` 4, every rank's decode state
    its placements' local shapes, the attention kernel at the prefill's one
    site. Training: the same 8 layers dense at float32 (``train_loop``'s
    seeded params and batches), one device's step 1 and HM_TRAIN_STEPS
    steps here, the ranks' on (data 2, model 2): step 1's loss within
    BF16_LOSS_REL, every gathered gradient leaf within BF16_GRAD_REL of its
    largest entry, the params after the steps within 2 Σlr (mean within
    Σlr / 20); the config's
    bf16 step 1: loss within BF16_LOSS_REL and gradients within
    HM_BF16_GRAD_REL of one device's bf16 ones, whose own gap to its float32
    ones is printed beside them."""
    import types

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, ShardedLoader
    from repro_torch.distributed.sharding import SERVE_RULES, init_params, place
    from repro_torch.kernels import dispatch
    from repro_torch.launch import train as train_launch
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.models import model
    from repro_torch.serve.engine import Engine, Request
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as step_lib

    t_phase = time.perf_counter()
    cfg, params = hybrid_first_site(hyb["cfg"], hyb.pop("params"))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    prompts = hyb["prompts"]
    times: dict = {}
    stage = timed_into(times)

    # ------------------------------------------ one device's references ---
    policy = dispatch.PhiExecutionPolicy()
    prev_policy = dispatch.set_policy(policy)
    try:
        dispatch.register_usage_from_params(params)
        batch = model.dummy_batch(cfg, *HM_PREFILL, False,
                                  torch.Generator().manual_seed(SEED + 2), dev)
        B, S = HM_PREFILL
        with torch.no_grad():
            single, _ = greedy_run(cfg, params, batch, HM_DECODE_STEPS, stage)
            eng = Engine(cfg, params, batch_slots=LM_SLOTS, max_context=LM_MAX_CONTEXT)
            for rid, toks in enumerate(prompts):
                eng.submit(Request(rid=rid, tokens=toks, max_new_tokens=LM_MAX_NEW))
            single_tokens = {r.rid: list(r.tokens) for r in stage("engine_ms", eng.run)}
            del eng
    finally:
        dispatch.set_policy(prev_policy)
    axes = ("data", "model")
    grid = types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, HM_MESH)))
    placements = model.param_shardings(cfg, grid, dict(SERVE_RULES, **MESH_RULES))
    # each model index's shards, which its data ranks share, in host shared memory
    by_model = {m: _host_shared(place(params, placements, grid, {"data": 0, "model": m},
                                      copy=False))
                for m in range(HM_MESH[1])}
    shard_bytes = {m: sum(t.numel() * t.element_size() for t in tree_leaves(sh))
                   for m, sh in by_model.items()}
    full_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    serve_peak = torch.cuda.max_memory_allocated()
    del params
    torch.cuda.empty_cache()

    # dense training: train_loop's seeded params, one device's step 1 at
    # float32 and at the config's bf16, and its steps at float32
    bcfg = get_config(HYB_ARCH, smoke=HYB_SMOKE).with_(n_layers=cfg.n_layers)
    dcfg = bcfg.with_(compute_dtype=torch.float32)
    ocfg = opt.OptConfig(**LM_TRAIN_OPT)
    loader = iter(ShardedLoader(DataConfig(vocab=dcfg.vocab, seq_len=S,
                                           global_batch=HM_TRAIN_BATCH, seed=SEED)))
    batch0 = {k: torch.from_numpy(v).to(dev) for k, v in next(loader).items()}
    torch.cuda.reset_peak_memory_stats()
    params0 = init_params(model.lm_specs(dcfg), torch.Generator(device=dev).manual_seed(SEED),
                          dev)
    bundle, _, _ = step_lib.make_train_step(dcfg, ocfg)
    loss1, grads = stage("grads_ms", lambda: bundle.grads(params0, batch0))
    bundle, _, _ = step_lib.make_train_step(bcfg, ocfg)
    loss1_bf16, grads_bf16 = stage("grads_bf16_ms", lambda: bundle.grads(params0, batch0))
    # one device's own bf16 gap: its bf16 gradients against its float32 ones
    bf16_noise = {k: float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
                  for (k, g), (_, w) in zip(_flat_leaves(grads_bf16), _flat_leaves(grads))}
    ref = {"grads": _host_shared(grads), "grads_bf16": _host_shared(grads_bf16)}
    del grads, grads_bf16, bundle
    host_params0 = _host_shared(params0)
    del params0
    p_end, single_losses = stage("train_loop_ms", lambda: train_launch.train_loop(
        dcfg, ocfg, steps=HM_TRAIN_STEPS, global_batch=HM_TRAIN_BATCH, seq=S, seed=SEED,
        log_every=0, device=dev))
    ref["params"] = _host_shared(p_end)
    del p_end
    train_peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()

    # ----------------------------------------------------------- the ranks ---
    world = HM_MESH[0] * HM_MESH[1]
    parent_memory = _release_before_ranks()
    t0 = time.perf_counter()
    ranks = spawn_ranks(hybrid_mesh_rank, world,
                        [(cfg, by_model[r % HM_MESH[1]], _host_shared(batch), prompts, dcfg,
                          bcfg, ocfg, host_params0, ref, r == 0) for r in range(world)],
                        device="cuda", timeout=MESH_TIMEOUT, threads=2)
    times["ranks_s"] = time.perf_counter() - t0
    del by_model, host_params0, ref

    # ------------------------------------------------------------ report ---
    lr_sum = _lr_sum(ocfg, HM_TRAIN_STEPS)
    checks = ranks[0].get("checks", {})
    launches = {k: sum(r["launches"][k] + r["train_launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}

    def rank_row(r):
        return {k: r[k] for k in ("rank", "coords", "backend", "transport", "times_ms",
                                  "engine_ticks", "decoded_tokens", "serve_collectives",
                                  "train_collectives", "serve_peak_memory",
                                  "train_peak_memory", "launches", "train_launches",
                                  "loss1", "loss1_bf16", "losses")}

    def worst(key):
        return {k: max(r[key][k][0] / max(r[key][k][2], 1e-30) for r in ranks)
                for k in ranks[0][key]}

    emit({"phase": "hybrid_mesh", "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "note": "ranks are processes sharing one card: their times include each other's work",
          "config": {"arch": HYB_ARCH, "n_layers": cfg.n_layers,
                     "sites": cfg.n_layers // cfg.hybrid_attn_every,
                     "mesh": dict(zip(axes, HM_MESH)), "prefill": HM_PREFILL,
                     "decode_steps": HM_DECODE_STEPS, "requests": len(prompts),
                     "train_steps": HM_TRAIN_STEPS, "train_batch": HM_TRAIN_BATCH,
                     "train_seq": S, "train_dtype": str(dcfg.compute_dtype),
                     "bf16_dtype": str(bcfg.compute_dtype), "opt": LM_TRAIN_OPT,
                     "nnz_budget": cfg.phi.nnz_budget},
          "full_param_bytes": full_bytes, "shard_bytes_by_model_index": shard_bytes,
          "parent_memory_before_ranks": parent_memory,
          "single_device": {"times_ms": times, "serve_peak_memory": serve_peak,
                            "train_peak_memory": train_peak, "loss1": float(loss1),
                            "loss1_bf16": float(loss1_bf16), "losses": single_losses},
          "ranks": [rank_row(r) for r in ranks],
          "decisions_rank0": ranks[0]["decisions"],
          "last_decisions_rank0": {s: [d["impl"], d["reason"], d["shards"], d["shape"]]
                                   for s, d in ranks[0]["last"].items()},
          "grad_rel_err_max": worst("grad_errs"),
          "bf16_grad_rel_err_max": {"mesh_vs_one_device": worst("grad_errs_bf16"),
                                    "one_device_vs_float32": bf16_noise,
                                    "mesh_vs_float32": worst("grad_errs_bf16_f32")},
          "param_err_max": {k: max(r["param_errs"][k][0] for r in ranks)
                            for k in ranks[0]["param_errs"]},
          "tolerances": {"loss_rel": BF16_LOSS_REL, "grad_rel": BF16_GRAD_REL,
                         "bf16_grad_rel": HM_BF16_GRAD_REL,
                         "param_abs": 2 * lr_sum, "param_mean_abs": lr_sum / 20},
          "checks_rank0": checks,
          "gates": ["prefill_and_decode_bitwise_one_device", "engine_tokens_equal_one_device",
                    "spmd_local_fused_shards", "train_within_tolerances"],
          "seconds": time.perf_counter() - t_phase})

    # ------------------------------------------------------------ gates ---
    names = {f"lm.{n}.spmd" for n in MAMBA_GEMMS + SHARED_GEMMS["attn"] + SHARED_GEMMS["mlp"]}
    for r in ranks:
        rk = r["rank"]
        got = r["logits"]
        if len(got) != len(single) or any(g.shape != (B, cfg.vocab) for g in got):
            raise AssertionError(f"hybrid_mesh rank {rk}: logits {[g.shape for g in got]}")
        for i, (g, w) in enumerate(zip(got, single)):
            if not np.array_equal(g, w):
                raise AssertionError(f"hybrid_mesh rank {rk} step {i}: mesh logits differ from "
                                     f"one device's, max |diff| {float(np.abs(g - w).max())}")
        if r["tokens"] != single_tokens:
            raise AssertionError(f"hybrid_mesh rank {rk}: engine tokens differ from one "
                                 "device's engine's")
        if r["cache_shapes"] != r["want_cache_shapes"]:
            raise AssertionError(f"hybrid_mesh rank {rk}: decode state {r['cache_shapes']} != "
                                 f"{r['want_cache_shapes']}")
        if set(r["last"]) != names:
            raise AssertionError(f"hybrid_mesh rank {rk}: spmd sites {sorted(r['last'])}")
        for site, impl, reason, _ in r["decisions"]:
            if site.endswith(".spmd") and (
                    impl not in ("fused", "fused_stream", "fused_prefetch")
                    or not reason.startswith("spmd_local_")):
                raise AssertionError(f"hybrid_mesh rank {rk} {site}: {impl} {reason}")
        if any(d["shards"] != world for d in r["last"].values()):
            raise AssertionError(f"hybrid_mesh rank {rk}: shards "
                                 f"{ {s: d['shards'] for s, d in r['last'].items()} }")
        lc = r["launches"]
        for impl in ("fused", "fused_stream", "fused_prefetch"):
            n = sum(c for site, i, _, c in r["decisions"] if i == impl and site in names)
            if lc[f"phi_{impl}_cuda"] != n:
                raise AssertionError(f"hybrid_mesh rank {rk}: phi_{impl} launched "
                                     f"{lc[f'phi_{impl}_cuda']} times for {n} decisions")
        if lc["phi_fused_stream_cuda"] <= 0 or lc["phi_fused_cuda"] <= 0 or \
                lc["lif_sequence_cuda"] <= 0 or lc["flash_attention_cuda"] != 1:
            raise AssertionError(f"hybrid_mesh rank {rk}: launches {lc}")
        if r["train_launches"]["flash_attention_cuda_lse"] <= 0:
            raise AssertionError(f"hybrid_mesh rank {rk}: train launches {r['train_launches']}")
        if abs(r["loss1"] - float(loss1)) > BF16_LOSS_REL * abs(float(loss1)):
            raise AssertionError(f"hybrid_mesh rank {rk}: step 1 loss {r['loss1']} vs {loss1}")
        for k, (d, _, w) in r["grad_errs"].items():
            if d > BF16_GRAD_REL * w:
                raise AssertionError(f"hybrid_mesh rank {rk}: grad {k} off by {d} of {w}")
        if abs(r["loss1_bf16"] - float(loss1_bf16)) > BF16_LOSS_REL * abs(float(loss1_bf16)):
            raise AssertionError(f"hybrid_mesh rank {rk}: bf16 step 1 loss {r['loss1_bf16']} "
                                 f"vs {loss1_bf16}")
        for k, (d, _, w) in r["grad_errs_bf16"].items():
            if d > HM_BF16_GRAD_REL * w:
                raise AssertionError(f"hybrid_mesh rank {rk}: bf16 grad {k} off by {d} of {w}")
        if len(r["losses"]) != HM_TRAIN_STEPS or not np.allclose(
                r["losses"], single_losses, rtol=HM_TRAIN_STEPS * BF16_LOSS_REL, atol=0):
            raise AssertionError(f"hybrid_mesh rank {rk}: losses {r['losses']} vs "
                                 f"{single_losses}")
        for k, (d, mean, _) in r["param_errs"].items():
            if d > 2 * lr_sum or mean > lr_sum / 20:
                raise AssertionError(f"hybrid_mesh rank {rk}: params {k} max {d} mean {mean}")
    if float(np.std(single[0])) == 0 or not np.isfinite(single[0]).all():
        raise AssertionError("hybrid_mesh: constant or non-finite prefill logits")

    return {"launches": launches, "lif_err": checks["lif_max_abs_err"],
            "attn_err": checks["attention"]["max_abs_err"]}


# LM training and checkpoints: OLMo-1B (lm_serve's config, LM_TRAIN_LAYERS
# deep) trained at full width through the port's train_loop, dense (the launcher's
# default) and in Phi spiking mode (the launcher's --phi config), at B = 1,
# S = 2048 so that every layer's attention takes the kernel under autograd.
LM_TRAIN_S = 2048
# lm_train's depth: 2 of OLMo-1B's 16 layers (it ran 4 before mesh_train
# joined the script), cut to keep the script near 800 s of its 1200 s limit.
LM_TRAIN_LAYERS = 2
LM_TRAIN_OPT = dict(lr=3e-4, warmup_steps=2, decay_steps=6)
LM_TRAIN_STEPS, LM_TRAIN_CRASH = 6, 3  # uninterrupted steps; the crashed run's
LM_TRAIN_PHI_STEPS = 3
# The Phi arm's depth. Its calibration pools every layer's 2 x 2048 spike
# rows a site: at 4 layers one pass took 45-47 s, and the arm calibrates
# twice (the loop's pass, the recalibration after training).
LM_TRAIN_PHI_LAYERS = 1
LM_TRAIN_SERVE = 4                    # lm_serve's first requests, served from the checkpoint
RESUME_RTOL, RESUME_ATOL = 1e-4, 1e-5  # resumed losses (the reference's crash-resume test)
# Step 1 on the path's bf16 activations, kernel against plain attention:
# each layer's attention output is rounded to bf16 (2^-8 relative), and the
# other order of the f32 softmax flips some of those roundings by one ulp.
# Averaged over 2048 tokens the loss moves little; a gradient by a few bf16
# ulps of its largest entry. The same step at float32 activations is held to
# LOSS_REL / GRAD_REL.
BF16_LOSS_REL = 2.0 ** -12
BF16_GRAD_REL = 2.0 ** -5


def fwd_passes(cfg) -> int:
    """Forward passes a training step makes of each layer: 2 under
    ``cfg.remat`` (the step's, and the recompute in its backward), else 1."""
    return 1 if cfg.remat == "none" else 2


@contextlib.contextmanager
def plain_attention():
    """A context in which ``models.flash.flash_attention`` runs the plain
    forward ``_flash_fwd_impl`` on the card instead of the kernel (its
    ``autograd.Function`` looks the kernel's wrapper up at each call)."""
    from repro_torch.kernels import phi_attention
    from repro_torch.models.flash import _flash_fwd_impl

    real = phi_attention.flash_attention_cuda

    def plain(q, k, v, *, causal, window, chunk, block_q, block_kv, return_lse=False):
        out, lse = _flash_fwd_impl(q, k, v, causal, window, chunk, block_q, block_kv)
        return (out, lse) if return_lse else out

    phi_attention.flash_attention_cuda = plain
    try:
        yield
    finally:
        phi_attention.flash_attention_cuda = real


def tree_pairs(a, b, path=""):
    """(path, leaf of a, leaf of b) over two trees of one structure."""
    if isinstance(a, dict):
        if sorted(a) != sorted(b):
            raise AssertionError(f"{path}: keys {sorted(a)} != {sorted(b)}")
        for key in a:
            yield from tree_pairs(a[key], b[key], f"{path}/{key}")
    else:
        yield path, a, b


def lm_train_parts_ms(cfg, bundle, params, opt_state, ocfg, batch) -> dict:
    """CUDA-event ms of a train step's parts: the forward under autograd
    (the graph kept), forward and backward (``bundle.grads``), and the
    optimizer update alone."""
    import torch

    from repro_torch.models import model
    from repro_torch.train import optimizer as opt

    trainable, phi_state = model.split_phi_state(params)
    leaves = model.map_state(lambda w: w.detach().requires_grad_(), trainable)
    merged = model.merge_phi_state(leaves, phi_state)
    _, grads = bundle.grads(params, batch)
    with torch.enable_grad():
        fwd = cuda_time_ms(lambda: model.train_loss(cfg, merged, batch), runs=5, warmup=1)
    return {"forward_autograd_ms": fwd,
            "forward_backward_ms": cuda_time_ms(lambda: bundle.grads(params, batch), runs=5,
                                                warmup=1),
            "optimizer_ms": cuda_time_ms(
                lambda: opt.apply_updates(trainable, grads, opt_state, ocfg), runs=5, warmup=1)}


def lm_train_phase(dev, smi) -> dict:
    """The ``lm_train`` phase: OLMo-1B at full width, LM_TRAIN_LAYERS of its
    16 layers, trained through ``launch.train.train_loop`` at B = 1, S = 2048.

    Step 1's loss and gradients with the attention kernel against the same
    step with the attention's plain forward (outside the counted run). Then,
    with every kernel's launch count set to 0 just before and read just
    after: dense, 6 uninterrupted steps; 3 steps checkpointed at step 3 (the
    restored params, optimizer state and cursor bitwise what was saved);
    a resume to 6 (losses within RESUME_RTOL/ATOL of the uninterrupted
    run's); a second resume that runs no step; an engine over params
    restored from the checkpoint against one over the trained params in
    memory, token-identical on lm_serve's first 4 requests. Phi (the
    launcher's ``--phi`` config, T = 2, q = 16, LM_TRAIN_PHI_LAYERS deep):
    the loop's calibration (the
    LIF and matcher kernels), 3 steps with every GEMM on ``coo``
    (``autodiff_or_vmap``) and every attention ``autodiff_keeps_flash``;
    the trained weights rounded onto the 2^-10 grid and recalibrated, Phi
    ``train_logits`` bitwise the spiking-dense arm's (the streaming kernel).
    Then the kernels at this path's operands against their plain versions,
    ms a step and its parts, the profiler's view of one dense step,
    checkpoint bytes, save and restore seconds, peak memory."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config, phi_variant
    from repro_torch.data.pipeline import DataConfig, ShardedLoader
    from repro_torch.distributed.sharding import init_params
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.phi_attention import flash_attention_cuda
    from repro_torch.launch import serve as serve_launch
    from repro_torch.launch import train as train_launch
    from repro_torch.models import flash as flash_mod
    from repro_torch.models import layers as ll
    from repro_torch.models import model, transformer
    from repro_torch.obs import ListSink, Tracer, set_tracer
    from repro_torch.serve.engine import Engine, Request
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as step_lib
    from repro_torch.utils import tree_bytes

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # trained at the config's own remat ("full"); one step at each remat is
    # held against the others
    cfg = get_config(LM_ARCH, smoke=LM_SMOKE)
    if LM_TRAIN_LAYERS is not None:
        cfg = cfg.with_(n_layers=LM_TRAIN_LAYERS)
    phi_cfg = phi_variant(cfg, timesteps=2, q=16).with_(   # the launcher's --phi
        n_layers=min(cfg.n_layers, LM_TRAIN_PHI_LAYERS))
    ocfg = opt.OptConfig(**LM_TRAIN_OPT)
    kw = dict(global_batch=1, seq=LM_TRAIN_S, seed=SEED, log_every=0, device=dev)
    policy = dispatch.PhiExecutionPolicy()
    prev_policy = dispatch.set_policy(policy)
    sink = ListSink()
    tracer = Tracer(sink)
    prev_tracer = set_tracer(tracer)
    tmp = tempfile.mkdtemp(prefix="lm_train_")
    ckpt = f"{tmp}/ckpt"
    times, marks = {}, {}

    def stage(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out

    class Recording(CheckpointManager):
        """The manager train_loop builds, keeping each save's tree (the
        step is functional: the tensors it saved are never written)."""
        saved: dict = {}

        def save(self, step, tree, extra=None, shardings=None):
            Recording.saved[step] = (tree, extra)
            super().save(step, tree, extra, shardings)

    try:
        # ------------------------------ step 1: kernel against plain twin ---
        params = init_params(model.lm_specs(cfg), torch.Generator(device=dev).manual_seed(SEED),
                             dev)
        first = next(iter(ShardedLoader(DataConfig(vocab=cfg.vocab, seq_len=LM_TRAIN_S,
                                                   global_batch=1, seed=SEED))))
        batch = {k: torch.from_numpy(v).to(dev) for k, v in first.items()}

        def step1_against_plain(c, loss_tol, grad_tol):
            bundle = step_lib.make_train_step(c, ocfg)[0]
            lse0 = flash_attention_cuda.lse_launches
            loss, grads = bundle.grads(params, batch)
            lse1 = flash_attention_cuda.lse_launches
            with plain_attention():
                ploss, pgrads = bundle.grads(params, batch)
            torch.cuda.synchronize()
            if lse1 - lse0 != c.n_layers * fwd_passes(c) or \
                    flash_attention_cuda.lse_launches != lse1:
                raise AssertionError(f"step 1: {lse1 - lse0} lse launches with the kernel, "
                                     f"{flash_attention_cuda.lse_launches - lse1} with the "
                                     f"plain forward; want {c.n_layers * fwd_passes(c)} and 0")
            out = {"loss": float(loss), "plain_loss": float(ploss),
                   "loss_rel_err": abs(float(loss) - float(ploss)) / abs(float(ploss)),
                   "grad_rel_err": {p: rel_err(g, w) for p, g, w in tree_pairs(grads, pgrads)},
                   "loss_tol": loss_tol, "grad_tol": grad_tol}
            if out["loss_rel_err"] > loss_tol or max(out["grad_rel_err"].values()) > grad_tol:
                raise AssertionError(f"lm_train step 1 ({c.compute_dtype}): kernel against "
                                     f"plain attention {out}")
            if any(float(w.abs().max()) == 0 for _, _, w in tree_pairs(grads, pgrads)):
                raise AssertionError("lm_train step 1: a gradient is zero")
            return out

        step1 = {"float32": step1_against_plain(cfg.with_(compute_dtype=torch.float32),
                                                LOSS_REL, GRAD_REL),
                 "path": step1_against_plain(cfg, BF16_LOSS_REL, BF16_GRAD_REL)}

        def remat_steps():
            """Step 1's loss and gradients under each ``cfg.remat``, held to
            the "none" step's within LOSS_REL and GRAD_REL (the recomputed
            forward repeats the same kernels and library calls: bitwise is
            expected and printed), with the step's peak allocation above
            what was allocated before it."""
            out, base = {}, None
            for r in ("none", "full", "dots"):
                bundle = step_lib.make_train_step(cfg.with_(remat=r), ocfg)[0]
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                loss, grads = bundle.grads(params, batch)
                torch.cuda.synchronize()
                row = {"loss": float(loss),
                       "peak_bytes_above_start": torch.cuda.max_memory_allocated() - before}
                if base is None:
                    base = (loss, grads)
                else:
                    pairs = list(tree_pairs(grads, base[1]))
                    row["bitwise_none"] = bool(torch.equal(loss, base[0]) and all(
                        torch.equal(g, w) for _, g, w in pairs))
                    row["loss_rel_err"] = abs(float(loss) - float(base[0])) / abs(float(base[0]))
                    row["grad_rel_err_max"] = max(rel_err(g, w) for _, g, w in pairs)
                    if row["loss_rel_err"] > LOSS_REL or row["grad_rel_err_max"] > GRAD_REL:
                        raise AssertionError(f"lm_train remat {r}: step 1 against remat none "
                                             f"{row}")
                out[r] = row
            return out

        remat = remat_steps()
        del params

        # ------------------------------------------------ the counted run ---
        train_launch.CheckpointManager = Recording
        zero_launches()
        first_rec = len(sink.records)
        p_full, full = stage("train_6", lambda: train_launch.train_loop(
            cfg, ocfg, steps=LM_TRAIN_STEPS, **kw))
        p3, l1 = stage("train_3_ckpt", lambda: train_launch.train_loop(
            cfg, ocfg, steps=LM_TRAIN_CRASH, ckpt_dir=ckpt, ckpt_every=LM_TRAIN_CRASH, **kw))
        saved, saved_extra = Recording.saved[LM_TRAIN_CRASH]
        like = {"params": p3, "opt": opt.init(model.split_phi_state(p3)[0], ocfg)}
        got = stage("restore", lambda: CheckpointManager(ckpt).restore_latest(like))
        restored_step, restored, extra = got
        roundtrip = {"step": restored_step, "extra": extra, "leaves": 0}
        for path, a, b in tree_pairs(restored, saved):
            if a.device != b.device or a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f"checkpoint {path}: restored != saved ({a.dtype} "
                                     f"{a.device} vs {b.dtype} {b.device})")
            roundtrip["leaves"] += 1
        if restored_step != LM_TRAIN_CRASH or extra != saved_extra or \
                extra["loader"] != {"step": LM_TRAIN_CRASH}:
            raise AssertionError(f"checkpoint step {restored_step}, extra {extra}")
        for path, a, b in tree_pairs(restored["params"], p3):
            if not torch.equal(a, b):
                raise AssertionError(f"checkpoint {path}: restored != the trained params")
        ckpt_bytes = tree_bytes(restored)
        del restored, saved, like, p3
        Recording.saved.clear()
        p6, l2 = stage("resume_6", lambda: train_launch.train_loop(
            cfg, ocfg, steps=LM_TRAIN_STEPS, ckpt_dir=ckpt, ckpt_every=100, **kw))
        _, l3 = stage("resume_noop", lambda: train_launch.train_loop(
            cfg, ocfg, steps=LM_TRAIN_STEPS, ckpt_dir=ckpt, ckpt_every=100, **kw))
        marks["dense"] = (first_rec, len(sink.records))

        # engine over the checkpoint's params against the in-memory ones
        rng = np.random.default_rng(LM_PROMPT_SEED)
        prompts = [rng.integers(3, cfg.vocab, int(n))
                   for n in rng.integers(LM_PROMPT[0], LM_PROMPT[1] + 1, LM_REQUESTS)]

        def serve(p):
            eng = Engine(cfg, p, batch_slots=LM_SLOTS, max_context=LM_MAX_CONTEXT)
            for rid, toks in enumerate(prompts[:LM_TRAIN_SERVE]):
                eng.submit(Request(rid=rid, tokens=toks, max_new_tokens=LM_MAX_NEW))
            return {r.rid: r.tokens for r in eng.run()}

        base = init_params(model.lm_specs(cfg), torch.Generator(device=dev).manual_seed(SEED + 9),
                           dev)
        _, from_ckpt, served_step = serve_launch.restore_params(cfg, base, ckpt)
        del base
        tokens_ckpt = stage("serve_from_checkpoint", lambda: serve(from_ckpt))
        tokens_mem = stage("serve_in_memory", lambda: serve(p6))
        del from_ckpt

        # ----------------------------------------------------- Phi arm ---
        first_rec = len(sink.records)
        p_phi, phi_losses = stage("phi_train", lambda: train_launch.train_loop(
            phi_cfg, ocfg, steps=LM_TRAIN_PHI_STEPS, **kw))
        marks["phi_train"] = (first_rec, len(sink.records))
        calib = model.dummy_batch(phi_cfg, 1, LM_TRAIN_S, with_labels=False, device=dev)
        with torch.no_grad():
            for leaf in tree_leaves(model.split_phi_state(p_phi)[0]):
                leaf.copy_(dyadic(leaf))
            p_phi, stats = stage("recalibrate", lambda: model.calibrate_lm_phi(
                phi_cfg, p_phi, calib))
            eval_batch = model.dummy_batch(phi_cfg, 1, LM_TRAIN_S, False,
                                           torch.Generator().manual_seed(SEED + 1), dev)
            first_rec = len(sink.records)
            phi_logits = stage("phi_logits", lambda: model.train_logits(phi_cfg, p_phi,
                                                                        eval_batch))
            marks["phi_gate"] = (first_rec, len(sink.records))
            dense_logits = stage("spiking_dense_logits", lambda: model.train_logits(
                phi_cfg, p_phi, eval_batch, matmul=model.spiking_dense_matmul(phi_cfg)))
        launches = read_launches()
    finally:
        train_launch.CheckpointManager = CheckpointManager
        set_tracer(prev_tracer)
        dispatch.set_policy(prev_policy)
        shutil.rmtree(tmp, ignore_errors=True)
    counted_s = time.perf_counter() - t_phase

    # ------------------------------------------------------------ gates ---
    n_layers, phi_layers = cfg.n_layers, phi_cfg.n_layers
    resume_diff = float(np.abs(np.asarray(l1 + l2) - np.asarray(full)).max())
    if not all(np.isfinite(full)) or len(full) != LM_TRAIN_STEPS or \
            len(l1) != LM_TRAIN_CRASH or len(l2) != LM_TRAIN_STEPS - LM_TRAIN_CRASH:
        raise AssertionError(f"lm_train: losses {full}, {l1}, {l2}")
    if not np.allclose(l1 + l2, full, rtol=RESUME_RTOL, atol=RESUME_ATOL):
        raise AssertionError(f"lm_train: resumed losses {l1 + l2} != uninterrupted {full} "
                             f"(max |diff| {resume_diff})")
    if l3:
        raise AssertionError(f"lm_train: the second resume ran steps {l3}")
    if full[0] != step1["path"]["loss"]:
        raise AssertionError(f"lm_train: train_loop's step 1 loss {full[0]} != "
                             f"{step1['path']['loss']}")
    if served_step != LM_TRAIN_STEPS or tokens_ckpt != tokens_mem or \
            sorted(tokens_mem) != list(range(LM_TRAIN_SERVE)) or \
            any(len(t) != LM_MAX_NEW for t in tokens_mem.values()):
        raise AssertionError(f"lm_train: engine from the step-{served_step} checkpoint "
                             f"{tokens_ckpt} != in memory {tokens_mem}")
    if not all(np.isfinite(phi_losses)) or len(phi_losses) != LM_TRAIN_PHI_STEPS:
        raise AssertionError(f"lm_train: Phi losses {phi_losses}")
    if phi_logits.shape != (1, LM_TRAIN_S, cfg.vocab) or not torch.isfinite(phi_logits).all():
        raise AssertionError(f"lm_train: Phi logits {tuple(phi_logits.shape)} not finite")
    if not torch.equal(phi_logits, dense_logits):
        raise AssertionError(f"lm_train: Phi logits after training differ from spiking-dense, "
                             f"max |diff| {float((phi_logits - dense_logits).abs().max())}")

    def tally(lo, hi):
        out = {}
        for r in sink.records[lo:hi]:
            if r["kind"] == "dispatch":
                key = (r["site"], r["impl"], r["reason"])
                out[key] = out.get(key, 0) + 1
        return out

    dense_dec = tally(*marks["dense"])
    dense_steps = LM_TRAIN_STEPS + LM_TRAIN_CRASH + LM_TRAIN_STEPS - LM_TRAIN_CRASH
    # under cfg.remat each step's layers run forward twice: in the step, and
    # recomputed in its backward
    passes, phi_passes = fwd_passes(cfg), fwd_passes(phi_cfg)
    if dense_dec != {("lm.attn_prefill", "flash", "autodiff_keeps_flash"):
                     dense_steps * n_layers * passes}:
        raise AssertionError(f"lm_train dense decisions {dense_dec}")
    phi_dec = tally(*marks["phi_train"])
    want = {(f"lm.{w}", "coo", "autodiff_or_vmap"): LM_TRAIN_PHI_STEPS * phi_layers * phi_passes
            for w in ("wq", "wk", "wv", "wo", "w1", "w2", "w3")}
    # the calibration captures with dense math: one no-grad attention a layer
    want[("lm.attn_prefill", "flash", "dense_qk_keeps_flash")] = phi_layers
    want[("lm.attn_prefill", "flash", "autodiff_keeps_flash")] = \
        LM_TRAIN_PHI_STEPS * phi_layers * phi_passes
    if phi_dec != want:
        raise AssertionError(f"lm_train Phi decisions {phi_dec}, want {want}")
    gate_dec = tally(*marks["phi_gate"])
    gate_impls = {impl for (site, impl, _) in gate_dec if site.startswith("lm.w")}
    if not gate_impls or not gate_impls <= {"fused", "fused_stream", "fused_prefetch"}:
        raise AssertionError(f"lm_train: the gate after training ran {gate_dec}")
    # Launches: the attention kernel with lse once a layer a forward pass (the step-1
    # twin ran outside the counted run), without lse at both calibrations'
    # captures and both arms of the gate; LIF and matcher at calibration.
    n_lse = dense_steps * n_layers * passes + LM_TRAIN_PHI_STEPS * phi_layers * phi_passes
    if launches["flash_attention_cuda_lse"] != n_lse or \
            launches["flash_attention_cuda"] != n_lse + 4 * phi_layers:
        raise AssertionError(f"lm_train attention launches {launches}, want {n_lse} with lse "
                             f"and {4 * phi_layers} without")
    if launches["lif_sequence_cuda"] <= 0 or launches["matcher_cuda"] <= 0:
        raise AssertionError(f"lm_train: calibration never launched LIF or matcher: {launches}")
    for impl in ("fused", "fused_stream", "fused_prefetch"):
        n = sum(c for (site, i, _), c in gate_dec.items() if i == impl)
        if launches[f"phi_{impl}_cuda"] != n:
            raise AssertionError(f"lm_train: phi_{impl} launched {launches[f'phi_{impl}_cuda']} "
                                 f"times for {n} decisions")

    # ------------------------------------ kernels against plain versions ---
    layer0 = transformer.layer_slice(p_phi["decoder"]["stack"], 0)["p0"]
    with torch.no_grad():
        captured = model._capture_phi_spikes(phi_cfg, p_phi, calib)
    sites = {name: (f"{name}#0", layer0, name) for name in ("wq", "wk", "wv", "wo")}
    sites.update({name: (f"{name}#0", layer0["mlp"], name) for name in ("w1", "w3", "w2")})
    gate_recs = [r for r in sink.records[slice(*marks["phi_gate"])] if r["kind"] == "dispatch"]
    checks, gemm_rows = lm_gemms(sites, captured, gate_recs, 16, timed=("wq", "w2"))
    x0 = ll.apply_norm(phi_cfg, layer0["ln1"], model._embed_inputs(phi_cfg, p_phi, calib))
    x_seq = x0.to(torch.float32).unsqueeze(0).expand(phi_cfg.phi.timesteps,
                                                     *x0.shape).contiguous()
    lif_timing, lif_err = lif_rows([x_seq])
    matcher_row = lm_matcher_row(
        "lm_train w2", captured["w2#0"][0].reshape(-1, cfg.d_ff).to(torch.float32).contiguous(),
        layer0["mlp"]["phi_w2"]["patterns"])
    del captured
    # Attention with lse: layer 0's q, k, v of the trained dense model.
    d0 = transformer.layer_slice(p6["decoder"]["stack"], 0)["p0"]
    with torch.no_grad():
        h = ll.apply_norm(cfg, d0["ln1"], model._embed_inputs(cfg, p6, batch))
        pos = torch.arange(LM_TRAIN_S, device=dev)[None]
        q, k, v = (x.to(torch.float32).contiguous()
                   for x in transformer._qkv(cfg, d0, h, pos, model.make_matmul(cfg)))
    attn_row = lm_attention_row("lm_train", policy, q, k, v)
    bq, bkv = attn_row["blocks"]
    _, lse = flash_attention_cuda(q, k, v, causal=True, block_q=bq, block_kv=bkv,
                                  return_lse=True)
    _, plse = flash_mod._flash_fwd_impl(q, k, v, True, None, None, bq, bkv)
    lse_err = float((lse - plse).abs().max())
    lse_tol = LSE_ULPS * 2.0 ** -24 * max(1.0, float(plse.abs().max()))
    if lse_err > lse_tol:
        raise AssertionError(f"lm_train: lse max |diff| {lse_err} > {lse_tol}")
    attn_row.update(lse_max_abs_err=lse_err, lse_tol=lse_tol)
    del q, k, v, lse, plse, p_phi, x_seq

    # ------------------------------------------------------------ timing ---
    bundle, _, _ = step_lib.make_train_step(cfg, ocfg)
    state = opt.init(p6, ocfg)
    step_ms = cuda_time_ms(lambda: bundle.fn(p6, state, batch), runs=5, warmup=2)
    profile = device_profile(lambda: bundle.fn(p6, state, batch), step_ms)
    parts = lm_train_parts_ms(cfg, bundle, p6, state, ocfg, batch)
    tree = {"params": p6, "opt": state}
    with tempfile.TemporaryDirectory(prefix="lm_train_") as tmp:
        mgr = CheckpointManager(tmp, async_save=False)
        t0 = time.perf_counter()
        mgr.save(1, tree)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        mgr.restore_latest(tree)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    emit({"phase": "lm_train", "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "config": {"arch": LM_ARCH, "smoke": LM_SMOKE, "n_layers": n_layers,
                     "phi_layers": phi_layers,
                     "d_model": cfg.d_model, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
                     "heads": cfg.n_heads, "batch": 1, "seq": LM_TRAIN_S, "opt": LM_TRAIN_OPT,
                     "steps": LM_TRAIN_STEPS, "crash_at": LM_TRAIN_CRASH,
                     "phi": {"timesteps": phi_cfg.phi.timesteps, "q": phi_cfg.phi.q,
                             "k": phi_cfg.phi.k, "nnz_budget": phi_cfg.phi.nnz_budget,
                             "steps": LM_TRAIN_PHI_STEPS}},
          "counted_s": counted_s, "stages_s": times, "launches": launches,
          "step1_plain_attention": step1, "remat": remat,
          "losses": full, "resumed_losses": l1 + l2, "resume_max_abs_diff": resume_diff,
          "resume_tol": [RESUME_RTOL, RESUME_ATOL], "checkpoint_roundtrip": roundtrip,
          "served_tokens_identical": LM_TRAIN_SERVE, "phi_losses": phi_losses,
          "phi_logits_bitwise_spiking_dense": True,
          "phi_l2_density": {key: st.l2_density for key, st in sorted(stats.items())},
          "decisions": {"dense": [[*key, n] for key, n in sorted(dense_dec.items())],
                        "phi_train": [[*key, n] for key, n in sorted(phi_dec.items())],
                        "phi_gate": [[*key, n] for key, n in sorted(gate_dec.items())]},
          "gemm_l2_entries_256_rows": checks, "gemms": gemm_rows,
          "lif_sequence": lif_timing, "lif_max_abs_err": lif_err, "matcher": matcher_row,
          "attention": attn_row, "ms_per_step": step_ms, "step_parts": parts,
          "profile_step": profile, "checkpoint_bytes": ckpt_bytes,
          "checkpoint_save_s": save_s, "checkpoint_restore_s": restore_s,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "seconds": time.perf_counter() - t_phase})
    del p6, state, tree, p_full
    torch.cuda.empty_cache()
    return {"launches": launches, "lif_err": lif_err, "attn_err": attn_row["max_abs_err"],
            "lse_err": lse_err}



# Training on a mesh: OLMo-1B (lm_serve's config, full width, MT_LAYERS deep;
# lm_train's optimizer and sequence) on four ranks sharing the card through
# gloo (NCCL refuses two ranks on one device), against one device's run of
# the same params and batches. The depth was LM_LAYERS = 4 until the config's
# remat="full" put a second forward in every step; 2 layers pay for it. The
# pipeline's four stages run the layers in turn (stage s, layer s mod 2).
MT_LAYERS = 2
MT_PIPE_STAGES = 4
MT_BATCH = 2                       # global rows: one a data rank on (data 2, model 2)
MT_STEPS, MT_CRASH = 4, 2          # uninterrupted steps; the crashed run's
MT_MESH = (2, 2)                   # (data, model)
MT_RESUME_MESH = (1, 4)            # the elastic resume's
MT_POD_MESH = (2, 1, 2)            # (pod, data, model): the compressed gradients
MT_COMPRESS_STEPS = 2
MT_PHI_STEPS = 2
MT_PIPE = (6, 1, 512)              # microbatches, rows, tokens of each (x d_model)
MT_TIMED_STEPS = 2
# The mesh against one device: the data ranks' and the row-parallel partial
# sums in another order, rounded to bf16 activations where one device rounds
# its own sums (lm_train's kernel-against-plain gap, BF16_LOSS_REL and
# BF16_GRAD_REL). After MT_STEPS AdamW steps a parameter moves by at most
# about lr_t a step (|m/sqrt(v)| <= 1), so where a rounding moves a near-zero
# gradient the runs may differ by 2 * sum(lr_t); the mean difference is held
# to a hundredth of it. Compressed gradients: the reference test's 5% of the
# uncompressed gradient's largest entry.
MT_COMPRESS_REL = 0.05
# A compressed step's update differs where the int8 step zeroes a gradient
# entry (Adam then moves it by 0 instead of lr): the next loss, against the
# uncompressed mesh step's, measured 7.2e-4 relative on an H100.
MT_COMPRESS_LOSS_REL = 2.0 ** -9
# The crash and the elastic resume run at float32 activations: on another
# mesh a step's sums round in another order, and at bf16 activations that
# moved step 4's loss 1.26e-4 relative on an H100, past the reference's
# crash-resume tolerance; at float32 it holds RESUME_RTOL / RESUME_ATOL.
MT_RESUME_DTYPE = "float32"


def _flat_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat_leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _lr_sum(ocfg, steps: int) -> float:
    import torch

    from repro_torch.train import optimizer as opt

    sched = opt.lr_schedule(ocfg)
    return float(sum(sched(torch.tensor(s)) for s in range(1, steps + 1)))


def _checkpoint_bytes_equal(path, tree, extra) -> int:
    """Rank 0: the files of the checkpoint at ``path`` against the bytes one
    device's ``save_tree`` writes for ``tree`` (global values): every leaf's
    ``.npy`` and the manifest. Returns the bytes compared."""
    import io
    import json

    from repro_torch.checkpoint import checkpoint as ckpt

    manifest = {"leaves": [], "extra": extra or {}}
    compared = 0
    for i, (key, leaf) in enumerate(ckpt._flatten(tree)):
        arr, name = ckpt._to_numpy(leaf)
        buf = io.BytesIO()
        ckpt._save_npy(buf, arr, name)
        fname = f"leaf_{i:05d}.npy"
        with open(os.path.join(path, fname), "rb") as f:
            if f.read() != buf.getvalue():
                raise AssertionError(f"checkpoint {key}: {fname} differs from one device's")
        compared += len(buf.getvalue())
        manifest["leaves"].append({"key": key, "file": fname, "shape": list(arr.shape),
                                   "dtype": name})
    with open(os.path.join(path, "manifest.json")) as f:
        if f.read() != json.dumps(manifest):
            raise AssertionError("checkpoint manifest differs from one device's")
    return compared


def _gathered_errs(tree, placements, mesh, *wants) -> list:
    """For each tree of global values in ``wants``, {leaf: (max |diff|,
    mean |diff|, max |want|)} of a tree of this rank's shards, gathered leaf
    by leaf once, against it."""
    from repro_torch.distributed import collectives as coll

    pls = dict(_flat_leaves(placements))
    ws = [dict(_flat_leaves(want)) for want in wants]
    out = [{} for _ in wants]
    for key, leaf in _flat_leaves(tree):
        full = coll.gather_global(leaf.detach(), pls[key], mesh).float()
        for errs, w in zip(out, ws):
            w = w[key].to(full.device).float()
            d = (full - w).abs()
            errs[key] = (float(d.max()), float(d.mean()), float(w.abs().max()))
            del w, d
        del full
    return out


def mesh_train_rank(rank, cfg, phi_cfg, ocfg, seq, params0, phi_params, single, tmp,
                    pipe) -> dict:
    """One rank of the mesh_train world: every kernel's launch count set to
    0, then arm A (dense, (data 2, model 2): step 1's grads, MT_STEPS steps
    through ``train_loop(mesh=)``, MT_CRASH steps checkpointed, the resume on
    (data 1, model 4)), arm D (Phi, (data 2, model 2)) and arm B
    (compressed gradients, (pod 2, data 1, model 2)); the counts read. Then
    timed steps, arm C (the pipeline over pod = 4) and, on rank 0, the
    attention kernel at this mesh's local operands against its plain
    version."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch import obs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.checkpoint import _unflatten
    from repro_torch.data.pipeline import DataConfig, ShardedLoader
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.pipeline import bubble_fraction, pipeline_apply
    from repro_torch.distributed.sharding import place
    from repro_torch.kernels import dispatch
    from repro_torch.launch import train as train_launch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model, transformer
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as step_lib
    from repro_torch.utils import log

    t_rank = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    log.setLevel("WARNING")
    out = {"rank": rank}
    policy = dispatch.PhiExecutionPolicy()
    dispatch.set_policy(policy)
    sink = obs.ListSink()
    obs.set_tracer(obs.Tracer(sink))
    loader = iter(ShardedLoader(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                           global_batch=MT_BATCH, seed=SEED)))
    batches = [next(loader) for _ in range(max(MT_COMPRESS_STEPS, MT_PHI_STEPS))]
    mesh = make_mesh(MT_MESH, ("data", "model"))
    dev = mesh.device
    gpu = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()} for b in batches]
    kw = dict(global_batch=MT_BATCH, seq=seq, seed=SEED, log_every=0)
    times: dict = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return res

    class Recording(CheckpointManager):
        saved: dict = {}

        def save(self, step, tree, extra=None, shardings=None):
            Recording.saved[step] = (tree, extra, shardings)
            super().save(step, tree, extra, shardings)

    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    steps_run = {}
    # ------------------------------------------------- arm A: dense mesh ---
    bundle, _, _, _ = step_lib.make_train_step(cfg, ocfg, mesh)
    p_sh, o_sh, _ = bundle.in_shardings
    t_sh = model.split_phi_state(p_sh)[0]
    local = _to_device(place(params0, p_sh, mesh), dev)
    mesh.stats.clear()
    held: dict = {}

    def grads_step():
        held["out"] = bundle.grads(local, gpu[0])

    # rank 0 keeps the first attention call's local q, k, v (no extra launch)
    rec = timed("grads_s", lambda: _first_attention_operands(grads_step) if rank == 0
                else grads_step())
    loss1, grads = held.pop("out")
    out["grad_stats"] = {op: list(v) for op, v in mesh.stats.items()}
    out["loss1"] = float(loss1)
    out["grad_errs"] = _gathered_errs(grads, t_sh, mesh, single["grads"])[0]
    del grads, local            # placed again from params0 for the timed steps
    ckpt = f"{tmp}/ckpt"
    p_full, full = timed("train_loop_s", lambda: train_launch.train_loop(
        cfg, ocfg, steps=MT_STEPS, mesh=mesh, **kw))
    out["losses"] = full
    out["param_errs"] = _gathered_errs(model.split_phi_state(p_full)[0], t_sh, mesh,
                                       single["params"])[0]
    del p_full
    # the crash and the elastic resume at float32 activations (see MT_RESUME_DTYPE)
    cfg32 = cfg.with_(compute_dtype=getattr(torch, MT_RESUME_DTYPE))
    _, out["losses_f32"] = timed("train_loop_f32_s", lambda: train_launch.train_loop(
        cfg32, ocfg, steps=MT_STEPS, mesh=mesh, **kw))
    train_launch.CheckpointManager = Recording
    try:
        _, first = timed("crash_run_s", lambda: train_launch.train_loop(
            cfg32, ocfg, steps=MT_CRASH, ckpt_dir=ckpt, ckpt_every=100, mesh=mesh, **kw))
        saved, extra, shardings = Recording.saved.pop(MT_CRASH)
        host, pls = {}, dict(_flat_leaves(shardings))
        for key, leaf in _flat_leaves(saved):
            full_leaf = coll.gather_global(leaf, pls[key], mesh)
            if rank == 0:
                host[key] = full_leaf.cpu()
            del full_leaf
        if rank == 0:
            out["ckpt_bytes_compared"] = timed("ckpt_bytes_s", lambda: _checkpoint_bytes_equal(
                f"{ckpt}/step_{MT_CRASH:010d}", _unflatten(saved, host), extra))
        del saved, host
        mesh2 = make_mesh(MT_RESUME_MESH, ("data", "model"))
        _, rest = timed("resume_run_s", lambda: train_launch.train_loop(
            cfg32, ocfg, steps=MT_STEPS, ckpt_dir=ckpt, mesh=mesh2, **kw))
    finally:
        train_launch.CheckpointManager = CheckpointManager
    out["resumed"] = first + rest
    steps_run["dense_mesh"] = 1 + 2 * MT_STEPS + MT_CRASH + (MT_STEPS - MT_CRASH)
    dist.barrier()
    if rank == 0:
        import shutil
        shutil.rmtree(ckpt, ignore_errors=True)

    # --------------------------------------------------- arm D: Phi mesh ---
    times["arm_a_s"] = time.perf_counter() - t_rank
    memory = {"arm_a": _card_memory(reset=True)}
    phi_policy = dispatch.PhiExecutionPolicy()
    dispatch.set_policy(phi_policy)
    dispatch.register_usage_from_params(phi_params)
    pbundle, _, _, _ = step_lib.make_train_step(phi_cfg, ocfg, mesh)
    pp_sh = pbundle.in_shardings[0]
    plocal = _to_device(place(phi_params, pp_sh, mesh), dev)
    ploss1, pgrads = timed("phi_grads_s", lambda: pbundle.grads(plocal, gpu[0]))
    out["phi_loss1"] = float(ploss1)
    out["phi_grad_errs"] = _gathered_errs(pgrads, model.split_phi_state(pp_sh)[0], mesh,
                                          single["phi_grads"])[0]
    del pgrads
    pstate = opt.init(model.split_phi_state(plocal)[0], ocfg)
    out["phi_losses"] = []
    for i in range(MT_PHI_STEPS):
        plocal, pstate, l = pbundle.fn(plocal, pstate, gpu[i])
        out["phi_losses"].append(float(l))
    out["phi_decisions"] = [[*key, n] for key, n in sorted(phi_policy.decisions().items())]
    del plocal, pstate
    steps_run["phi_mesh"] = 1 + MT_PHI_STEPS
    dispatch.set_policy(policy)
    times["arm_d_s"] = time.perf_counter() - t_rank - times["arm_a_s"]
    memory["arm_d"] = _card_memory(reset=True)

    # ------------------------------------- arm B: compressed gradients ---
    pmesh = make_mesh(MT_POD_MESH, ("pod", "data", "model"))
    ocfg_c = dataclasses.replace(ocfg, grad_compress=True)
    ubundle, _, _, _ = step_lib.make_train_step(cfg, ocfg, pmesh)
    cbundle, _, _, _ = step_lib.make_train_step(cfg, ocfg_c, pmesh)
    c_sh = ubundle.in_shardings[0]
    ct_sh = model.split_phi_state(c_sh)[0]
    clocal = _to_device(place(params0, c_sh, pmesh), dev)
    uloss, ugrads = ubundle.grads(clocal, gpu[0])
    cstate = opt.init(clocal, ocfg_c)
    scales: dict = {}
    pmesh.stats.clear()
    closs, cgrads, new_ef = cbundle.compressed(clocal, gpu[0], cstate["ef"], scales)
    out["compress_stats"] = {op: list(v) for op, v in pmesh.stats.items()}
    errs = {}
    ug, cg = dict(_flat_leaves(ugrads)), dict(_flat_leaves(cgrads))
    for key in ug:
        errs[key] = (float((cg[key] - ug[key]).abs().max()), float(ug[key].abs().max()))
    out["compress"] = {"loss_uncompressed": float(uloss), "loss": float(closs),
                       "grad_errs": errs, "scales": scales, "coords": pmesh.coords,
                       "ef_abs_max": max(float(e.abs().max()) for _, e in
                                         _flat_leaves(new_ef))}
    del ugrads, cgrads, new_ef
    # the compressed steps, then the uncompressed ones from the same params:
    # one run's params and AdamW state on the card at a time
    ulocal = clocal
    out["compress"]["losses"], out["compress"]["uncompressed_losses"] = [], []
    for i in range(MT_COMPRESS_STEPS):
        clocal, cstate, l = cbundle.fn(clocal, cstate, gpu[i])
        out["compress"]["losses"].append(float(l))
    out["compress"]["ef_after_abs_max"] = max(float(e.abs().max()) for _, e in
                                              _flat_leaves(cstate["ef"]))
    del clocal, cstate
    ustate = opt.init(ulocal, ocfg)
    for i in range(MT_COMPRESS_STEPS):
        ulocal, ustate, l = ubundle.fn(ulocal, ustate, gpu[i])
        out["compress"]["uncompressed_losses"].append(float(l))
    del ulocal, ustate
    steps_run["compressed_mesh"] = 2 + 2 * MT_COMPRESS_STEPS
    torch.cuda.synchronize()
    times["arm_b_s"] = time.perf_counter() - t_rank - times["arm_a_s"] - times["arm_d_s"]
    out["launches"] = read_launches()
    out["steps_run"] = steps_run
    memory["arm_b"] = _card_memory(reset=True)
    out["memory"] = memory
    out["max_memory_allocated"] = max(m["peak_allocated"] for m in memory.values())
    out["train_step_records"] = sum(r["kind"] == "train_step" for r in sink.records)
    obs.set_tracer(None)

    # -------------------------------------------- timed steps, (2, 2) ---
    local = _to_device(place(params0, p_sh, mesh), dev)
    state = opt.init(model.split_phi_state(local)[0], ocfg)
    mesh.stats.clear()
    step_ms = []
    for _ in range(MT_TIMED_STEPS):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        local, state, _ = bundle.fn(local, state, gpu[0])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    out["step_ms"] = step_ms
    out["step_collectives"] = {op: {"calls": c // MT_TIMED_STEPS, "bytes": b // MT_TIMED_STEPS}
                               for op, (c, b) in mesh.stats.items()}
    out["backend"], out["transport"] = mesh.backend, mesh.transport
    out["p2p_transport"] = mesh.p2p_transport
    del local, state
    torch.cuda.empty_cache()

    # ------------------------------------------------- arm C: pipeline ---
    qmesh = make_mesh((MT_PIPE_STAGES,), ("pod",))
    li = qmesh.coords["pod"] % cfg.n_layers
    stage_p = _to_device(transformer.layer_slice(params0["decoder"]["stack"],
                                                 slice(li, li + 1)), dev)
    x_micro = pipe.to(dev)
    pos = torch.arange(pipe.shape[2], device=dev)[None]

    def stage(p, x):
        x, _ = transformer.attn_block_prefill(cfg, p["p0"], x, pos, cfg.is_global_layer(0))
        return transformer._ffn(cfg, p["p0"], x)

    qmesh.stats.clear()
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = pipeline_apply(stage, stage_p, x_micro, qmesh, axis="pod")
        torch.cuda.synchronize()
    out["pipeline"] = {"out": y.cpu(), "ms": (time.perf_counter() - t0) * 1e3,
                       "bubble_fraction": bubble_fraction(MT_PIPE[0], MT_PIPE_STAGES),
                       "stats": {op: list(v) for op, v in qmesh.stats.items()},
                       "p2p_transport": qmesh.p2p_transport}
    del stage_p, x_micro, y
    torch.cuda.empty_cache()
    times["rank_s"] = time.perf_counter() - t_rank
    out["times_s"] = times
    if rank == 0:
        from repro_torch.kernels.phi_attention import flash_attention_cuda
        from repro_torch.models.flash import _flash_fwd_impl

        q, k, v = (t.detach().to(torch.float32).contiguous() for t in rec)
        row = lm_attention_row("mesh_train", policy, q, k, v)
        row.pop("_fn", None)
        bq, bkv = row["blocks"]
        _, lse = flash_attention_cuda(q, k, v, causal=True, block_q=bq, block_kv=bkv,
                                      return_lse=True)
        _, plse = _flash_fwd_impl(q, k, v, True, None, None, bq, bkv)
        row["lse_max_abs_err"] = float((lse - plse).abs().max())
        row["lse_tol"] = LSE_ULPS * 2.0 ** -24 * max(1.0, float(plse.abs().max()))
        if row["lse_max_abs_err"] > row["lse_tol"]:
            raise AssertionError(f"mesh_train: lse max |diff| {row['lse_max_abs_err']}")
        out["attention"] = row
    return out


def mesh_train_phase(dev, smi) -> dict:
    """The ``mesh_train`` phase. OLMo-1B at full width, MT_LAYERS deep, S =
    LM_TRAIN_S, global batch MT_BATCH, AdamW (LM_TRAIN_OPT). One device (this
    process) runs the references: step 1's grads and MT_STEPS steps of
    ``train_loop`` from the seed's params, the Phi config (LM_TRAIN_PHI_LAYERS
    deep, calibrated here once: the LIF and matcher kernels) step 1's grads
    and MT_PHI_STEPS steps, and the pipeline's four layers in sequence. Four
    spawned ranks on this card (gloo; params through host shared memory)
    then run arms A, D, B and C (:func:`mesh_train_rank`). Gates: step 1's
    loss and every gradient leaf, gathered, within BF16_LOSS_REL /
    BF16_GRAD_REL of one device's; MT_STEPS losses and the final params
    within the stated tolerance; the crashed run's checkpoint byte for byte
    one device's files, its resume on (data 1, model 4) within
    RESUME_RTOL / RESUME_ATOL of the uninterrupted losses; the compressed
    gradients within MT_COMPRESS_REL, ``ef`` non-zero, one scale a pod; the
    pipeline bitwise the sequential layers; the Phi steps within the bf16
    tolerances, every ``lm.*.spmd`` decision ``coo``; the attention kernel
    launched by every rank."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs import get_config, phi_variant
    from repro_torch.data.pipeline import DataConfig, ShardedLoader
    from repro_torch.distributed.sharding import init_params
    from repro_torch.kernels import dispatch
    from repro_torch.launch import train as train_launch
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.models import model, transformer
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as step_lib

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(LM_ARCH, smoke=LM_SMOKE)
    if MT_LAYERS is not None:
        cfg = cfg.with_(n_layers=MT_LAYERS)
    phi_cfg = phi_variant(cfg, timesteps=2, q=16).with_(
        n_layers=min(cfg.n_layers, LM_TRAIN_PHI_LAYERS))
    ocfg = opt.OptConfig(**LM_TRAIN_OPT)
    loader = iter(ShardedLoader(DataConfig(vocab=cfg.vocab, seq_len=LM_TRAIN_S,
                                           global_batch=MT_BATCH, seed=SEED)))
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in next(loader).items()}
               for _ in range(MT_PHI_STEPS)]
    policy = dispatch.PhiExecutionPolicy()
    prev_policy = dispatch.set_policy(policy)
    times = {}

    def stage(name, fn):
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return res

    try:
        # ------------------------------------------ one device's references ---
        params0 = init_params(model.lm_specs(cfg), torch.Generator(device=dev).manual_seed(SEED),
                              dev)
        bundle, _, _ = step_lib.make_train_step(cfg, ocfg)
        loss1, grads = stage("single_grads", lambda: bundle.grads(params0, batches[0]))
        single = {"grads": _host_shared(grads)}
        del grads
        p4, single_losses = stage("single_train_loop", lambda: train_launch.train_loop(
            cfg, ocfg, steps=MT_STEPS, global_batch=MT_BATCH, seq=LM_TRAIN_S, seed=SEED,
            log_every=0, device=dev))
        single["params"] = _host_shared(p4)
        del p4
        single_step_ms = cuda_time_ms(lambda: bundle.fn(params0, opt.init(params0, ocfg),
                                                        batches[0]), runs=3, warmup=1)
        # pipeline: the four stages' layers in sequence, microbatch by microbatch
        pipe = torch.randn((*MT_PIPE, cfg.d_model),
                           generator=torch.Generator(device=dev).manual_seed(SEED + 5),
                           device=dev).to(cfg.compute_dtype)
        pos = torch.arange(MT_PIPE[2], device=dev)[None]
        seq_out = torch.empty_like(pipe)
        with torch.no_grad():
            for m in range(MT_PIPE[0]):
                y = pipe[m]
                for st in range(MT_PIPE_STAGES):
                    p = transformer.layer_slice(params0["decoder"]["stack"],
                                                st % cfg.n_layers)["p0"]
                    y, _ = transformer.attn_block_prefill(cfg, p, y, pos,
                                                          cfg.is_global_layer(0))
                    y = transformer._ffn(cfg, p, y)
                seq_out[m] = y
        seq_out = seq_out.cpu()
        host_params0 = _host_shared(params0)
        del params0
        # Phi: calibrated here once on 1 x LM_TRAIN_S tokens (lm_train's
        # loop calibrates on as many)
        phi_params = init_params(model.lm_specs(phi_cfg),
                                 torch.Generator(device=dev).manual_seed(SEED), dev)
        calib = model.dummy_batch(phi_cfg, 1, LM_TRAIN_S, with_labels=False, device=dev)
        zero_launches()            # the path's own launches: the calibration's, then the ranks'
        with torch.no_grad():
            phi_params, phi_stats = stage("phi_calibrate", lambda: model.calibrate_lm_phi(
                phi_cfg, phi_params, calib))
        parent_launches = read_launches()
        # An L2 capacity no GEMM overflows: the coo lowering drops the
        # entries past it, and a rank's shard has its own capacity, so only
        # without drops is the mesh's Phi step one device's
        budget = min(0.9, 2 * max(st.l2_density for st in phi_stats.values()) + 0.05)
        phi_cfg = phi_cfg.with_(phi=dataclasses.replace(phi_cfg.phi, nnz_budget=budget))
        pbundle, _, _ = step_lib.make_train_step(phi_cfg, ocfg)
        ploss1, pgrads = pbundle.grads(phi_params, batches[0])
        single["phi_grads"] = _host_shared(pgrads)
        del pgrads
        pstate, pp, phi_losses = opt.init(model.split_phi_state(phi_params)[0], ocfg), \
            phi_params, []
        for i in range(MT_PHI_STEPS):
            pp, pstate, l = pbundle.fn(pp, pstate, batches[i])
            phi_losses.append(float(l))
        del pp, pstate
        host_phi = _host_shared(phi_params)
        del phi_params, batches
        single_peak = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
    finally:
        dispatch.set_policy(prev_policy)

    # ----------------------------------------------------------- the ranks ---
    tmp = tempfile.mkdtemp(prefix="mesh_train_")
    world = MT_MESH[0] * MT_MESH[1]
    parent_memory = _release_before_ranks()
    try:
        t0 = time.perf_counter()
        ranks = spawn_ranks(mesh_train_rank, world,
                            [(cfg, phi_cfg, ocfg, LM_TRAIN_S, host_params0, host_phi, single,
                              tmp, _host_shared(pipe.cpu()))] * world,
                            device="cuda", timeout=MESH_TIMEOUT, threads=2)
        times["ranks_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del host_params0, host_phi, single

    # ------------------------------------------------------------- report ---
    lr_sum = _lr_sum(ocfg, MT_STEPS)
    param_tol = 2 * lr_sum
    # each leaf's largest difference over its largest entry, both over every
    # rank's shard (the reference test's measure of the whole leaf)
    compress_rel = {k: max(r["compress"]["grad_errs"][k][0] for r in ranks)
                    / max(max(r["compress"]["grad_errs"][k][1] for r in ranks), 1e-30)
                    for k in ranks[0]["compress"]["grad_errs"]}
    r0 = ranks[0]
    report = {
        "phase": "mesh_train", "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "note": "ranks are processes sharing one card: their times include each other's work",
        "config": {"arch": LM_ARCH, "n_layers": cfg.n_layers, "phi_layers": phi_cfg.n_layers,
                   "remat": cfg.remat, "saved_seq": "model (TRAIN_RULES)",
                   "phi_nnz_budget": phi_cfg.phi.nnz_budget,
                   "d_model": cfg.d_model, "vocab": cfg.vocab, "seq": LM_TRAIN_S,
                   "global_batch": MT_BATCH, "opt": LM_TRAIN_OPT, "mesh": MT_MESH,
                   "resume_mesh": MT_RESUME_MESH, "pod_mesh": MT_POD_MESH,
                   "pipe": MT_PIPE},
        "tolerances": {"loss_rel": BF16_LOSS_REL, "grad_rel": BF16_GRAD_REL,
                       "param_abs": param_tol, "param_mean_abs": lr_sum / 20,
                       "compress_loss_rel": MT_COMPRESS_LOSS_REL,
                       "resume": [RESUME_RTOL, RESUME_ATOL], "compress_rel": MT_COMPRESS_REL},
        "single": {"loss1": float(loss1), "losses": single_losses, "step_ms": single_step_ms,
                   "phi_loss1": float(ploss1), "phi_losses": phi_losses,
                   "peak_memory": single_peak, "launches_calibration": parent_launches},
        "parent_memory_before_ranks": parent_memory,
        "ranks": [{k: r[k] for k in ("rank", "loss1", "losses", "losses_f32", "resumed",
                                     "phi_loss1",
                                     "phi_losses", "step_ms", "step_collectives", "backend",
                                     "transport", "p2p_transport", "max_memory_allocated",
                                     "memory", "launches", "steps_run", "times_s", "grad_stats",
                                     "train_step_records")} for r in ranks],
        "grad_rel_err_max": {k: max(r["grad_errs"][k][0] / max(r["grad_errs"][k][2], 1e-30)
                                    for r in ranks) for k in r0["grad_errs"]},
        "param_err": {k: [max(r["param_errs"][k][0] for r in ranks),
                          max(r["param_errs"][k][1] for r in ranks)] for k in r0["param_errs"]},
        "phi_grad_rel_err_max": {k: max(r["phi_grad_errs"][k][0]
                                        / max(r["phi_grad_errs"][k][2], 1e-30) for r in ranks)
                                 for k in r0["phi_grad_errs"]},
        "phi_decisions_rank0": r0["phi_decisions"],
        "reference_reason": "spmd_region",
        "compress": [{k: v for k, v in r["compress"].items() if k != "grad_errs"}
                     for r in ranks],
        "compress_grad_rel_err": compress_rel,
        "compress_scale_max_diff_in_a_pod": max(
            abs(r["compress"]["scales"][k] - q["compress"]["scales"][k])
            for r in ranks for q in ranks for k in r["compress"]["scales"]
            if r["compress"]["coords"]["pod"] == q["compress"]["coords"]["pod"]),
        "compress_stats_rank0": r0["compress_stats"],
        "pipeline": {"ms": [r["pipeline"]["ms"] for r in ranks],
                     "bubble_fraction": r0["pipeline"]["bubble_fraction"],
                     "stats_rank0": r0["pipeline"]["stats"],
                     "p2p_transport": r0["pipeline"]["p2p_transport"]},
        "ckpt_bytes_compared": r0.get("ckpt_bytes_compared"),
        "attention_rank0": r0["attention"],
        "stages_s": times, "seconds": time.perf_counter() - t_phase}
    emit(report)

    # ------------------------------------------------------------ gates ---
    for r in ranks:
        rk = r["rank"]
        if abs(r["loss1"] - float(loss1)) > BF16_LOSS_REL * abs(float(loss1)):
            raise AssertionError(f"mesh_train rank {rk}: step 1 loss {r['loss1']} vs {loss1}")
        for k, (d, _, w) in r["grad_errs"].items():
            if d > BF16_GRAD_REL * w or w == 0:
                raise AssertionError(f"mesh_train rank {rk}: grad {k} off by {d} of {w}")
        if len(r["losses"]) != MT_STEPS or not np.allclose(r["losses"], single_losses, rtol=
                                                           MT_STEPS * BF16_LOSS_REL, atol=0):
            raise AssertionError(f"mesh_train rank {rk}: losses {r['losses']} vs "
                                 f"{single_losses}")
        for k, (d, mean, _) in r["param_errs"].items():
            if d > param_tol or mean > lr_sum / 20:
                raise AssertionError(f"mesh_train rank {rk}: params {k} max {d} mean {mean}")
        if not np.allclose(r["resumed"], r["losses_f32"], rtol=RESUME_RTOL, atol=RESUME_ATOL):
            raise AssertionError(f"mesh_train rank {rk}: resumed {r['resumed']} vs "
                                 f"{r['losses_f32']}")
        if abs(r["phi_loss1"] - float(ploss1)) > BF16_LOSS_REL * abs(float(ploss1)) or \
                not np.allclose(r["phi_losses"], phi_losses, rtol=MT_PHI_STEPS * BF16_LOSS_REL,
                                atol=0):
            raise AssertionError(f"mesh_train rank {rk}: Phi losses {r['phi_losses']} vs "
                                 f"{phi_losses}")
        for k, (d, _, w) in r["phi_grad_errs"].items():
            if d > BF16_GRAD_REL * w:
                raise AssertionError(f"mesh_train rank {rk}: Phi grad {k} off by {d} of {w}")
        spmd = [d for d in r["phi_decisions"] if d[0].endswith(".spmd")]
        if len({d[0] for d in spmd}) != 7 or any(d[1] != "coo" for d in spmd):
            raise AssertionError(f"mesh_train rank {rk}: Phi decisions {r['phi_decisions']}")
        c = r["compress"]
        if abs(c["loss"] - c["loss_uncompressed"]) > BF16_LOSS_REL * abs(c["loss_uncompressed"]):
            raise AssertionError(f"mesh_train rank {rk}: compressed loss {c['loss']} vs "
                                 f"{c['loss_uncompressed']}")
        if not np.allclose(c["losses"], c["uncompressed_losses"], rtol=MT_COMPRESS_LOSS_REL,
                           atol=0):
            raise AssertionError(f"mesh_train rank {rk}: compressed losses {c['losses']} vs "
                                 f"{c['uncompressed_losses']}")
        if c["ef_abs_max"] == 0 or c["ef_after_abs_max"] == 0:
            raise AssertionError(f"mesh_train rank {rk}: ef is zero")
        if not np.array_equal(r["pipeline"]["out"].float().numpy(), seq_out.float().numpy()):
            raise AssertionError(f"mesh_train rank {rk}: pipeline differs from the sequential "
                                 "layers")
        lc = r["launches"]
        want_lse = sum(n * (phi_cfg.n_layers * fwd_passes(phi_cfg) if arm == "phi_mesh"
                            else cfg.n_layers * fwd_passes(cfg))
                       for arm, n in r["steps_run"].items())
        if lc["flash_attention_cuda_lse"] != want_lse:
            raise AssertionError(f"mesh_train rank {rk}: {lc['flash_attention_cuda_lse']} lse "
                                 f"launches, want {want_lse}")
    if max(compress_rel.values()) > MT_COMPRESS_REL:
        raise AssertionError(f"mesh_train: compressed grads {compress_rel}")
    for pod in range(MT_POD_MESH[0]):
        same = [r["compress"]["scales"] for r in ranks if r["compress"]["coords"]["pod"] == pod]
        if any(s != same[0] for s in same):
            raise AssertionError(f"mesh_train: pod {pod}'s ranks quantise on other scales")
    if r0.get("ckpt_bytes_compared", 0) <= 0 or r0["train_step_records"] != \
            2 * MT_STEPS + MT_CRASH + MT_STEPS - MT_CRASH:
        raise AssertionError(f"mesh_train: checkpoint bytes {r0.get('ckpt_bytes_compared')}, "
                             f"train_step records {r0['train_step_records']}")
    if any(r["train_step_records"] for r in ranks[1:]):
        raise AssertionError("mesh_train: a rank other than 0 emitted train_step records")
    launches = {k: sum(r["launches"][k] for r in ranks) + parent_launches[k]
                for k in parent_launches}
    return {"launches": launches, "attn_err": r0["attention"]["max_abs_err"],
            "lse_err": r0["attention"]["lse_max_abs_err"]}


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

    # -------------------------------------------------- accelerator model ---
    accel = accel_sim_phase(dev, {
        "vgg": (cfg, params, state, batches[0], timing),
        "spikformer": (spk["cfg"], spk["params"], spk["state"], batches[0], spk["fused_rows"])},
        smi)

    # -------------------------------------------------- training and PAFT ---
    data = train_data()
    trained = train_phase(dev, cfg, params, data, smi)
    paft_run = paft_phase(dev, cfg, trained["params"], images, data, smi)
    spk_train = spikformer_train_phase(dev, data, smi)

    # ------------------------------------------------------ LM serving ---
    lm = lm_serve_phase(dev, smi)
    mesh = mesh_serve_phase(dev, smi, lm)
    dryrun_phase(smi)
    hyb = hybrid_serve_phase(dev, smi)
    hmesh = hybrid_mesh_phase(dev, smi, hyb)

    # ------------------------------------------------------ LM training ---
    lm_tr = lm_train_phase(dev, smi)
    mesh_tr = mesh_train_phase(dev, smi)
    analysis_phase(smi)
    later = {"accel_sim": accel["launches"], "train": trained["launches"],
             "paft": paft_run["launches"], "spikformer_train": spk_train["launches"],
             "lm": lm["launches"], "mesh_serve": mesh["launches"], "hybrid": hyb["launches"],
             "hybrid_mesh": hmesh["launches"], "lm_train": lm_tr["launches"],
             "mesh_train": mesh_tr["launches"]}

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
                "launches_by_path": {"vgg": launches[f"phi_{impl}_cuda"],
                                     "spikformer": spk_launches[f"phi_{impl}_cuda"]},
                "max_abs_err": fused_errs[f"phi_{impl}_cuda"], "ms": sum(r["ms"] for r in rows),
                "device_ms": device_sum(rows),
                "plain_ms": sum(r["plain_ms"] for r in rows), "bound_ms": b_ms, "bound_by": by,
                "library_ms": sum(r["library_ms"] for r in rows)}

    lif_bound, lif_by = bound(all_lif)
    entries = [
        fused_entry("fused", "src/repro/kernels/phi_fused.py:135"),
        {"name": "lif_sequence", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/lif.cu",
         "replaces": "src/repro/kernels/lif.py:39",
         "launches": launches["lif_sequence_cuda"] + spk_launches["lif_sequence_cuda"],
         "launches_by_path": {"vgg": launches["lif_sequence_cuda"],
                              "spikformer": spk_launches["lif_sequence_cuda"]},
         "max_abs_err": max(lif_err, spk["lif_err"], lm["lif_err"], mesh["lif_err"],
                            hyb["lif_err"], hmesh["lif_err"], lm_tr["lif_err"]),
         "ms": sum(r["ms"] for r in all_lif), "device_ms": device_sum(all_lif),
         "plain_ms": sum(r["plain_ms"] for r in all_lif),
         "bound_ms": lif_bound, "bound_by": lif_by, "library_ms": None},
        spk["attn_entry"],
        fused_entry("fused_stream", "src/repro/kernels/phi_fused.py:326"),
        fused_entry("fused_prefetch", "src/repro/kernels/phi_fused.py:549"),
        *unit_entries,
    ]
    # The training phases' launches join each kernel's count (the attention
    # entry's: its Phi instantiation; the dense one's lse launches apart).
    wrapper = {"phi_fused": "phi_fused_cuda", "phi_fused_stream": "phi_fused_stream_cuda",
               "phi_fused_prefetch": "phi_fused_prefetch_cuda",
               "lif_sequence": "lif_sequence_cuda",
               "phi_flash_attention": "phi_flash_attention_cuda", "matcher": "matcher_cuda",
               "l1_gather": "l1_gather_cuda", "l2_spmm": "l2_spmm_cuda"}
    for entry in entries:
        by = {path: counts[wrapper[entry["name"]]] for path, counts in later.items()}
        entry["launches_by_path"].update(by)
        entry["launches"] += sum(by.values())
    attn = entries[2]
    attn["lse_max_abs_err"] = max(spk_train["lse_err"], lm_tr["lse_err"], mesh_tr["lse_err"])
    attn["dense_lse_launches"] = sum(later[path]["flash_attention_cuda_lse"]
                                     for path in ("spikformer_train", "hybrid_mesh", "lm_train",
                                                  "mesh_train"))
    attn["dense_instantiation_launches"] += sum(c["flash_attention_cuda"] for c in later.values())
    attn["lm_dense_max_abs_err"] = lm["attn_err"]
    attn["windowed_prefill_max_abs_err"] = lm["windowed_err"]
    attn["note"] = ("the dense instantiation walks only the kv-blocks its masks leave open "
                    "(causal, window, chunk)")
    attn["mesh_dense_max_abs_err"] = mesh["attn_err"]
    attn["hybrid_dense_max_abs_err"] = hyb["attn_err"]
    attn["hybrid_mesh_dense_max_abs_err"] = hmesh["attn_err"]
    attn["lm_train_dense_max_abs_err"] = lm_tr["attn_err"]
    attn["mesh_train_dense_max_abs_err"] = mesh_tr["attn_err"]
    # The decode attention kernel has no TPU counterpart (the reference's
    # decode attention is plain JAX): its row is lm_serve's decode shapes.
    dec_rows = lm["decode_rows"][:3]
    dec_by = {path: counts["decode_attention_cuda"] for path, counts in later.items()}
    dec_bound, dec_bound_by = bound(dec_rows)
    entries.append({
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "none: src/repro/models/layers.py attention_decode is plain JAX",
        "launches": sum(dec_by.values()), "launches_by_path": dec_by,
        "max_abs_err": max(r["max_abs_err"] for r in lm["decode_rows"]),
        "ms": sum(r["ms"] for r in dec_rows), "device_ms": device_sum(dec_rows),
        "plain_ms": sum(r["plain_ms"] for r in dec_rows), "bound_ms": dec_bound,
        "bound_by": dec_bound_by, "library_ms": sum(r["library_ms"] for r in dec_rows),
        "long_context": lm["decode_rows"][3]})
    emit({"kernels": entries})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
