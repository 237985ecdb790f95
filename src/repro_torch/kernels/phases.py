"""Time the phases of the Phi flash-attention, fused Phi matmul and matcher kernels.

    PYTHONPATH=src python3 -m repro_torch.kernels.phases [--only attn|stream|first|matcher]

Takes four kernels apart on one NVIDIA card: the attention kernel, the
K-streaming fused kernel, the first fused kernel (with its prefetching
instantiation) and the pattern matcher. It builds copies of
``csrc/phi_attention.cu``, ``csrc/phi_fused.cu`` and ``csrc/matcher.cu``
with phases switched off by text patches applied at run time, with
``_build``'s nvcc and flags, into ``build/kernel_phases/``. Each copy
computes a wrong result by design (the matcher's ``popc`` copy excepted):
only its time is read. A patch whose anchor the source no longer holds once
stops the run: a redesign of a kernel edits the tables below
(``tests/test_torch_phases.py`` applies them all on the CPU).

It times every copy at the main paths' shapes, on data from seed 0: the
streaming kernel at Spikformer-4-384's fc2 and the VGG's conv3/conv4, the
first kernel at the Spikformer's qkv and fc1 and the VGG's conv1/conv2, the
prefetching one at the Spikformer's b0_proj with its calibrated active sets
(their calibrated banks and activations; the streaming kernel at the group
depth ``ops.stream_group_t`` gives), the matcher at the VGG's five GEMMs
(CUDA events and profiler device time of the kernel alone), and the
attention kernel at the first Spikformer attention site, blocks (64, 64),
both instantiations, with ``scaled_dot_product_attention`` and
``torch.matmul`` beside them. Copies with clock64 counters give the cycles
a block's warps 0 and 7 spend in each part of an iteration. A time is the
median over 5 runs of 20 back-to-back launches between two CUDA events,
over 20. Each copy runs in a process of its own; one JSON line each, after
the card's ``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys

from repro_torch.kernels import _build

WORK = _build.BUILD_DIR.parent / "kernel_phases"

# {variant: [(old, new), ...]} per kernel: each variant switches one phase off.
_ATTN = {
    "no_match": [("for (int i = sub; i < qp; i += tpp)",
                  "for (int i = sub; i < min(qp, tpp); i += tpp)")],
    "no_scores": [("for (int r0 = 0; r0 < bq; r0 += 64) {",
                   "for (int r0 = 0; r0 < 0; r0 += 64) {")],
    "no_softmax_stats": [("      if (r < bq) {\n        float* sr = s_s",
                          "      if (r < 0) {\n        float* sr = s_s")],
    "no_pv": [("        if (r < bq) {\n          const float* pr = s_s + r * lds;",
               "        if (false) {\n          const float* pr = s_s + r * lds;")],
}
_STREAM = {
    "no_l2": [("      if (rest) {\n        float4 part",
               "      if (rest && false) {\n        float4 part")],
    "no_l1": [("    v[i] = load4(pwp + row * N + n, vec, valid);\n    s[i] = scale[row];",
               "    v[i] = make_float4(0.f, 0.f, 0.f, 0.f);\n    s[i] = 0.f;")],
    "no_match": [("for (int i = sub; i < q; i += tpp)",
                  "for (int i = sub; i < min(q, tpp); i += tpp)")],
}
# The current streaming kernel with cycle counters (clock64) around the four
# parts of a group's iteration, read by warp 0 (which matches) and warp 7
# (which does not): copies and barriers, the match, the sums, the cluster
# barrier.
_STREAM_CYCLES = [
    ("namespace cg = cooperative_groups;\n",
     "namespace cg = cooperative_groups;\n__device__ unsigned long long g_cycles[16];\n"),
    ("    __syncthreads();  // iteration gi-1 is done",
     "    const long long c0 = clock64();\n    __syncthreads();  // iteration gi-1 is done"),
    ("    const unsigned char* tile = tiles + (gi & 1) * tile_bytes;",
     "    const long long c1 = clock64();\n"
     "    const unsigned char* tile = tiles + (gi & 1) * tile_bytes;"),
    ("    if (gi + 1 < n_groups) match(gi + 1);\n",
     "    if (gi + 1 < n_groups) match(gi + 1);\n    const long long c2 = clock64();\n"),
    ("    cluster.sync();  // group gi+1",
     "    const long long c3 = clock64();\n    cluster.sync();  // group gi+1"),
    ("gi's are no longer read\n",
     "gi's are no longer read\n    const long long c4 = clock64();\n"
     "    if (tid == 0 || tid == 224) {\n      unsigned long long* c = g_cycles + (tid ? 8 : 0);\n"
     "      atomicAdd(c, c1 - c0); atomicAdd(c + 1, c2 - c1);\n"
     "      atomicAdd(c + 2, c3 - c2); atomicAdd(c + 3, c4 - c3);\n    }\n"),
]
_CYCLES_READ = """
extern "C" int cycles_read(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_cycles, sizeof(g_cycles));
  unsigned long long z[16] = {0};
  if (e == cudaSuccess && reset) e = cudaMemcpyToSymbol(g_cycles, z, sizeof(z));
  return static_cast<int>(e);
}
"""
# The first kernel (phi_fused_kernel<P, PREFETCH>; both instantiations).
_FIRST = {
    "no_l2": [("  for (int w0 = 0; w0 < tcn;) {", "  for (int w0 = tcn; w0 < tcn;) {")],
    "no_l1": [("    // L1: partitions in ascending t, L1_DEPTH partitions' loads in flight.\n",
               "    if (false) {\n"),
              ("    // L2: each row's residual entries in order, through the warp's list.\n",
               "    }\n")],
    "match_one": [("    if (i >= n_pat) break;", "    if (i >= min(n_pat, 1)) break;")],
}
# The first kernel with cycle counters around the parts of a chunk, read by
# warp 0 and warp 7: the bits of the block's rows, the match (ending where
# the block's own share is written), the cluster barrier that publishes it,
# the L1 sums, the L2 sums.
_FIRST_CYCLES = [
    ("namespace cg = cooperative_groups;\n",
     "namespace cg = cooperative_groups;\n__device__ unsigned long long g_cycles[16];\n"),
    ("    if (c0 > 0) cluster.sync();",
     "    const long long cy0 = clock64();\n    if (c0 > 0) cluster.sync();"),
    ("    // The match: units of",
     "    const long long cy1 = clock64();\n    // The match: units of"),
    ("    cluster.sync();" + " " * 35 + "// the chunk's match tile is complete\n",
     "    const long long cy2 = clock64();\n    cluster.sync();\n"
     "    const long long cy3 = clock64();\n"),
    ("    // L2: each row's residual entries in order, through the warp's list.\n",
     "    const long long cy4 = clock64();\n"),
    ("             vl, valid, lane);\n    }\n",
     "             vl, valid, lane);\n    }\n    const long long cy5 = clock64();\n"
     "    if (tid == 0 || tid == 224) {\n      unsigned long long* c = g_cycles + (tid ? 8 : 0);\n"
     "      atomicAdd(c, cy1 - cy0); atomicAdd(c + 1, cy2 - cy1); atomicAdd(c + 2, cy3 - cy2);\n"
     "      atomicAdd(c + 3, cy4 - cy3); atomicAdd(c + 4, cy5 - cy4);\n    }\n"),
]
FIRST_PARTS = ("bits_copies", "match", "cluster_barrier", "l1_sums", "l2_sums")
STREAM_PARTS = ("copies_barriers", "match", "sums", "cluster_barrier")
# The matcher: the tile loop stopped after one 8-pattern tile, no residual
# bytes written, only the loads (the row bits built and the bank staged; one
# word per row and partition written to idx), and the tensor-core score
# replaced by popcounts of the row's and the bank's words (read through L1)
# in the kernel's own layout, the scoring of the design the kernel
# replaced; that copy is exact.
_MATCHER = {
    "no_compare": [("for (int n8 = 0; n8 < nq8; n8 += 8) {",
                    "for (int n8 = 0; n8 < 8; n8 += 8) {")],
    "no_residual": [("          if (c >= k) break;", "          if (true) break;")],
    "read_only": [("  // ---- 3-4. match a chunk of the bank at a time, then write",
                   "  __syncthreads();\n"
                   "  for (int i = tid; i < ROWS * tn; i += THREADS) {\n"
                   "    const int r = i / tn, t = i - r * tn;\n"
                   "    if (m0 + r < M) idx[(m0 + r) * T + t0 + t] =\n"
                   "        static_cast<int>(bits_at(xbits + r * bs, t * k));\n"
                   "  }\n"
                   "  return;\n"
                   "  // ---- 3-4. match a chunk of the bank at a time, then write")],
    "popc": [("        dot_tile<KP>(d, af, bf);\n",
              "        {\n"
              "          const int j0 = base + n8 + 2 * tig;\n"
              "          const unsigned long long* pw = packed + static_cast<long long>(t0 + t) * q;\n"
              "          const unsigned long long p0 = j0 < q ? __ldg(pw + j0) : 0ull;\n"
              "          const unsigned long long p1 = j0 + 1 < q ? __ldg(pw + j0 + 1) : 0ull;\n"
              "          if (KP <= 32) {\n"
              "            const uint32_t a0 = x0, a8 = x8, b0 = p0, b1 = p1;\n"
              "            d[0] = __popc(a0 & b0); d[1] = __popc(a0 & b1);\n"
              "            d[2] = __popc(a8 & b0); d[3] = __popc(a8 & b1);\n"
              "          } else {\n"
              "            d[0] = __popcll(x0 & p0); d[1] = __popcll(x0 & p1);\n"
              "            d[2] = __popcll(x8 & p0); d[3] = __popcll(x8 & p1);\n"
              "          }\n"
              "        }\n")],
}
# (source, kind, phase table, cycle-counter patches or None)
PATCHES = [("phi_attention.cu", "attn", _ATTN, None),
           ("phi_fused.cu", "stream", _STREAM, _STREAM_CYCLES),
           ("phi_fused.cu", "first", _FIRST, _FIRST_CYCLES),
           ("matcher.cu", "matcher", _MATCHER, None)]


def _patch(fname: str, src: str, patches) -> str:
    for old, new in patches:
        if src.count(old) != 1:
            raise RuntimeError(f"{fname}: patch anchor not found once: {old!r}")
        src = src.replace(old, new)
    return src


def _variants(only: str = "") -> dict[str, str]:
    """{name: patched source}: the full copy, one phase off each, and all of
    them off (attention: what is left is the loads, barriers and stores;
    streaming and first fused kernels: L1, L2 and the match off; matcher:
    the row bits), plus the two fused kernels with their cycle counters.
    ``only``: the kernels whose kind starts with it."""
    out = {}
    for fname, kind, table, cycles in PATCHES:
        if not kind.startswith(only):
            continue
        src = (_build.CSRC / fname).read_text()
        out[f"{kind}_full"] = src
        for name, patches in {**table, "all_off": [p for ps in table.values() for p in ps]}.items():
            out[f"{kind}_{name}"] = _patch(fname, src, patches)
        if cycles:
            out[f"{kind}_cycles"] = _patch(fname, src, cycles) + _CYCLES_READ
    return out


def _time(fn, reps: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / reps)
    return statistics.median(runs)


def _data(cache):
    """The main paths' operands from seed 0, made once and cached."""
    import torch

    if cache.exists():
        return torch.load(cache)
    from repro_torch.core.patterns import PhiConfig
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.phi_fused import stripe_active_sets
    from repro_torch.snn import models as M
    from repro_torch.snn.data import synthetic_images

    dev = torch.device("cuda", 0)
    dyadic = lambda x: (x * 1024).round() / 1024                       # noqa: E731
    images, _ = synthetic_images(64, size=32, seed=0)
    images = dyadic(torch.from_numpy(images)).to(dev)
    gemms, active = {}, {}
    for cfg, names, first in (
            (M.SNNConfig(kind="vgg", widths=(64, 128, 256, 512, 512), input_size=32,
                         phi=PhiConfig(k=16, q=128, iters=20)),
             ("conv1", "conv2", "conv3", "conv4", "head"), "conv0"),
            (M.SNNConfig(kind="spikformer", input_size=32, dim=384, heads=12, blocks=4,
                         attn="flash", phi=PhiConfig(k=16, q=128, iters=20)),
             ("b0_qkv", "b0_fc1", "b0_proj", "b0_fc2"), "embed")):
        params = M.init(cfg, torch.Generator().manual_seed(0), device=dev)
        for name, leaf in params.items():
            leaf["w"] = dyadic(leaf["w"] * (1.0 if name == first else 3.0))
        policy = dispatch.PhiExecutionPolicy()
        dispatch.set_policy(policy)
        with torch.no_grad():
            state, acts = M.calibrate_model(params, cfg, images[:32])
        for name in names:
            w = params[name]["w"]
            gemms[name] = (acts[name].contiguous(), state.patterns[name], state.pwp[name],
                           torch.ones(state.pwp[name].shape[:2], device=dev),
                           w.reshape(-1, w.shape[-1]), state.packed[name])
            if state.p_active[name] is not None:
                active[name] = stripe_active_sets(acts[name].contiguous(), state.patterns[name],
                                                  state.p_active[name], 256)
    sites, real = [], policy.attention

    def recording(q, k, v, patterns=None, **kw):
        sites.append((q, k, v, patterns, kw.get("packed")))
        return real(q, k, v, patterns, **kw)

    policy.attention = recording
    with torch.no_grad():
        M.phi_apply(params, cfg, state, images[32:])
    data = (gemms, active, sites[0])
    torch.save(data, cache)
    return data


# The GEMMs each fused kernel is timed at: the streaming kernel's and the
# first kernel's main-path shapes (the prefetching kernel at b0_proj, with
# its calibrated active sets).
STREAM_GEMMS = ("b0_fc2", "conv3", "conv4")
FIRST_GEMMS = ("b0_qkv", "b0_fc1", "conv1", "conv2")
# The matcher at the VGG's five GEMMs (the pallas path's).
MATCHER_GEMMS = ("conv1", "conv2", "conv3", "conv4", "head")


def _device_ms(fn, name: str, calls: int = 20) -> float:
    """Device time of one call of ``fn`` in kernels whose name holds ``name``,
    from ``torch.profiler`` over ``calls`` calls after a warm-up: the kernel
    alone, without its wrapper's host time; the mean over the launches the
    profiler saw (it may miss some)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    seen = [ev for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA and name in ev.key]
    launches = sum(ev.count for ev in seen)
    if not launches:
        raise RuntimeError(f"the profiler saw no launch of a kernel named {name!r}")
    return sum(ev.device_time_total for ev in seen) / 1e3 / launches


def _read_cycles(lib, fn, iters: int, parts) -> dict:
    """Mean cycles that warps 0 and 7 spend in each part of an iteration
    (the streaming kernel's group, the first kernel's chunk) per block,
    over one launch of ``fn`` (after one unread launch)."""
    import torch

    buf = (ctypes.c_ulonglong * 16)()
    fn()
    torch.cuda.synchronize()
    lib.cycles_read(buf, 1)
    fn()
    torch.cuda.synchronize()
    lib.cycles_read(buf, 1)
    return {f"warp{warp}": dict(zip(parts, (c / iters for c in list(buf)[off:off + len(parts)])))
            for warp, off in ((0, 0), (7, 8))}


def _child(name: str) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.matcher import matcher_cuda
    from repro_torch.kernels.phi_attention import flash_attention_cuda, phi_flash_attention_cuda
    from repro_torch.kernels.phi_fused import (
        fused_tc, phi_fused_cuda, phi_fused_prefetch_cuda, phi_fused_stream_cuda)

    gemms, active, (q, k, v, pats, packed) = _data(WORK / "data.pt")
    lib = _build.load(WORK / f"{name}.so", partial=True)
    _build._lib = lib
    if name.endswith("_cycles"):
        lib.cycles_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    res = {"variant": name}

    def stream(layer):
        a, p, pwp, sc, w, pk = gemms[layer]
        gt = ops.stream_group_t(p.shape[1], p.shape[2])
        return (lambda: phi_fused_stream_cuda(a, p, pwp, sc, w, block_m=256, group_t=gt,
                                              packed=pk)), gt

    def first(layer, prefetch=False):
        a, p, pwp, sc, w, pk = gemms[layer]
        if prefetch:
            return lambda: phi_fused_prefetch_cuda(a, p, pwp, sc, w, active[layer], block_m=256,
                                                   packed=pk)
        return lambda: phi_fused_cuda(a, p, pwp, sc, w, block_m=256, packed=pk)

    def matmul(layer):
        a, w = gemms[layer][0], gemms[layer][4]
        return lambda: torch.matmul(a, w)

    if name.startswith("matcher"):
        for layer in MATCHER_GEMMS:
            a, p, pk = gemms[layer][0], gemms[layer][1], gemms[layer][5]
            fn = lambda: matcher_cuda(a, p, packed=pk)                  # noqa: E731
            res[f"{layer}_ms"] = _time(fn)
            res[f"{layer}_device_ms"] = _device_ms(fn, "matcher")
        res["device_ms"] = sum(res[f"{layer}_device_ms"] for layer in MATCHER_GEMMS)
    elif name.startswith("attn"):
        kw = dict(block_q=64, block_kv=64)
        res["phi_ms"] = _time(lambda: phi_flash_attention_cuda(q, k, v, pats, packed=packed, **kw))
        res["dense_ms"] = _time(lambda: flash_attention_cuda(q, k, v, causal=False, **kw))
        if name == "attn_full":
            qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
            res["sdpa_ms"] = _time(lambda: F.scaled_dot_product_attention(qh, kh, vh))
    elif name == "stream_cycles":
        for layer in STREAM_GEMMS:
            fn, gt = stream(layer)
            a, p, w = gemms[layer][0], gemms[layer][1], gemms[layer][4]
            iters = -(-a.shape[0] // 32) * -(-w.shape[1] // 128) * -(-p.shape[0] // gt)
            res[layer] = _read_cycles(lib, fn, iters, STREAM_PARTS)
    elif name == "first_cycles":
        for layer in FIRST_GEMMS:
            a, p, w = gemms[layer][0], gemms[layer][1], gemms[layer][4]
            chunks = -(-p.shape[0] // fused_tc(p.shape[0]))
            iters = -(-a.shape[0] // 32) * -(-w.shape[1] // 128) * chunks
            res[layer] = _read_cycles(lib, first(layer), iters, FIRST_PARTS)
    elif name.startswith("stream"):
        for layer in STREAM_GEMMS:
            res[f"{layer}_ms"] = _time(stream(layer)[0])
            if name == "stream_full":
                res[f"{layer}_matmul_ms"] = _time(matmul(layer))
    else:
        for layer in FIRST_GEMMS:
            res[f"{layer}_ms"] = _time(first(layer))
            if name == "first_full":
                res[f"{layer}_matmul_ms"] = _time(matmul(layer))
        res["b0_proj_prefetch_ms"] = _time(first("b0_proj", prefetch=True))
        if name == "first_full":
            res["b0_proj_matmul_ms"] = _time(matmul("b0_proj"))
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--only", default="",
                    help="run only the copies of the kernels whose kind starts with this "
                         "(attn, stream, first, matcher)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("phases: needs an NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.child:
        print(json.dumps(_child(args.child)), flush=True)
        return 0
    WORK.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for name, text in _variants(args.only).items():
        (WORK / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", str(WORK / f"{name}.cu"), "-o",
             str(WORK / f"{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(f"phases: nvcc failed on {name}:\n{log}", file=sys.stderr)
            return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    failed = 0
    for name in procs:
        run = subprocess.run([sys.executable, "-m", "repro_torch.kernels.phases", "--child", name],
                             capture_output=True, text=True)
        print(run.stdout.strip() or json.dumps({"variant": name, "error": run.stderr[-2000:]}),
              flush=True)
        failed += run.returncode != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
