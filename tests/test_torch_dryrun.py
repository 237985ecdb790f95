"""repro_torch's dry run held against the reference's on the CPU.

``launch.dryrun`` traces one rank's step on fake tensors in a fake world of
the production mesh's size; ``distributed.cost_analysis`` counts it. Here:
``_model_flops`` and the skip records equal the reference's for every cell
(the reference's side in a subprocess: ``repro.launch.dryrun`` sets
``XLA_FLAGS`` to 512 devices on import), the cost counter's FLOPs equal
``HloCost``'s on the reference's crafted programs, the roofline's
arithmetic on the H100's rates, one production cell end to end on fake
``cuda``, the kernel counts behind ``chip_smoke.py``'s bounds, and the kernel
wrappers on real tensors. The dry run against real ranks is in
``tests/test_torch_distributed.py``.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.distributed.hlo_analysis import HloCost
from repro_torch.configs import ARCH_IDS, get_config, phi_variant
from repro_torch.core import hwconst as H
from repro_torch.distributed import cost_analysis as ca
from repro_torch.kernels import costs
from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parents[1]
PRODUCTION_CELL_LIMIT_S = 60.0   # the production cell's trace, end to end


# ------------------------------------------------ the reference's records ---
_REFERENCE = textwrap.dedent("""
    import json
    from repro.launch import dryrun           # sets XLA_FLAGS first
    from repro.configs import ARCH_IDS, get_config, phi_variant
    flops, skips = {}, {}
    for arch in ARCH_IDS:
        for phi in (False, True):
            cfg = phi_variant(get_config(arch)) if phi else get_config(arch)
            for shape in dryrun.SHAPES:
                flops[f"{arch}|{shape}|{phi}"] = dryrun._model_flops(cfg, shape)
    for arch, shape, phi in (("olmo_1b", "long_500k", False), ("yi_34b", "long_500k", True),
                             ("olmo_1b", "train_4k", True), ("mamba2_2p7b", "train_4k", True)):
        rec = dryrun.run_cell(arch, shape, False, phi)
        skips[f"{arch}|{shape}|{phi}"] = rec
    print(json.dumps({"flops": flops, "skips": skips}))
""")


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REFERENCE], capture_output=True, text=True,
                         env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_model_flops_equal_the_references_for_every_cell(reference):
    got = {}
    for arch in ARCH_IDS:
        for phi in (False, True):
            cfg = phi_variant(get_config(arch)) if phi else get_config(arch)
            for shape in dryrun.SHAPES:
                got[f"{arch}|{shape}|{phi}"] = dryrun._model_flops(cfg, shape)
    assert len(got) == 10 * 4 * 2
    assert got == reference["flops"]


def test_skip_records_equal_the_references(reference):
    assert dryrun.SHAPES == {"train_4k": dict(seq=4096, batch=256, kind="train"),
                             "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
                             "decode_32k": dict(seq=32768, batch=128, kind="decode"),
                             "long_500k": dict(seq=524288, batch=1, kind="decode")}
    for key, want in reference["skips"].items():
        arch, shape, phi = key.split("|")
        got = dryrun.run_cell(arch, shape, False, phi == "True")
        assert got == want, key
        assert "skipped" in got


# ----------------------------------------- the counter on crafted programs ---
def _scan_tanh(x, w):
    def body(c, wl):
        return jnp.tanh(c @ wl), None
    return jax.lax.scan(body, x, w)[0]


def _nested_scan(x, w):
    def outer(c, wl):
        def inner(c2, _):
            return c2 @ wl, None
        return jax.lax.scan(inner, c, None, length=3)[0], None
    return jax.lax.scan(outer, x, w)[0]


def _torch_scan_tanh(x, w):
    for layer in range(w.shape[0]):
        x = torch.tanh(x @ w[layer])
    return x


def _torch_nested_scan(x, w):
    for layer in range(w.shape[0]):
        for _ in range(3):
            x = x @ w[layer]
    return x


@pytest.mark.parametrize("ref_fn,fn,xs,ws", [
    (_scan_tanh, _torch_scan_tanh, (8, 32), (5, 32, 32)),
    (_nested_scan, _torch_nested_scan, (4, 16), (2, 16, 16)),
])
@pytest.mark.parametrize("fake", [False, True])
def test_cost_counter_flops_equal_hlocost_on_crafted_programs(ref_fn, fn, xs, ws, fake):
    """FLOPs exactly (the loops' trip counts honoured), no collective. The
    byte counts are not compared: XLA's program holds loop-carried copies
    and dynamic slices that eager ops do not (a slice is a view here)."""
    comp = jax.jit(ref_fn).lower(jax.ShapeDtypeStruct(xs, jnp.float32),
                                 jax.ShapeDtypeStruct(ws, jnp.float32)).compile()
    want = HloCost(comp.as_text()).total
    with FakeTensorMode() if fake else contextlib.nullcontext():
        x, w = torch.ones(xs), torch.ones(ws)
        with ca.StepCost(None, (x, w)) as got:
            fn(x, w)
    assert got.flops == want.flops
    assert not any(want.coll.values()) and not any(got.collectives.values())
    assert got.argument_bytes == 4 * (np.prod(xs) + np.prod(ws))
    # every matmul's operands and result count in the roofline's bytes
    calls = ws[0] * (1 if fn is _torch_scan_tanh else 3)
    assert got.bytes == 4 * calls * (xs[0] * xs[1] + xs[1] * xs[1] + xs[0] * xs[1])


def test_roofline_terms_on_the_h100_rates():
    r = ca.Roofline(flops_per_dev=H.BF16_FLOP_PER_S, bytes_per_dev=H.HBM_BYTES_PER_S * 2,
                    coll_bytes_per_dev=450e9 * 3, chips=4,
                    model_flops=H.BF16_FLOP_PER_S * 4, peak_flops=ca.peak_flops(torch.bfloat16))
    assert (H.BF16_FLOP_PER_S, H.NVLINK_BYTES_PER_S, H.NVLINK_DIR_BYTES_PER_S) == (
        989e12, 900e9, 450e9)
    assert abs(r.compute_s - 1.0) < 1e-9
    assert abs(r.memory_s - 2.0) < 1e-9
    assert abs(r.collective_s - 3.0) < 1e-9
    assert r.bottleneck == "collective"
    assert abs(r.step_s - 3.0) < 1e-9
    assert abs(r.useful_ratio - 1.0) < 1e-9
    assert abs(r.mfu - 1.0 / 3.0) < 1e-9
    assert ca.peak_flops(torch.float32) == H.F32_FLOP_PER_S
    # the kernels' operations take their own time beside the aten FLOPs'
    k = ca.Roofline(flops_per_dev=2 * H.F32_FLOP_PER_S, bytes_per_dev=0.0, coll_bytes_per_dev=0.0,
                    chips=1, flops_kernels_per_dev=H.F32_FLOP_PER_S, kernel_compute_s=0.5)
    assert abs(k.compute_s - 1.5) < 1e-12 and k.bottleneck == "compute"
    assert set(r.as_dict()) >= {"flops_per_dev", "bytes_per_dev", "bytes_raw_per_dev",
                                "coll_bytes_per_dev", "chips", "model_flops", "compute_s",
                                "memory_s", "collective_s", "bottleneck", "step_s",
                                "useful_ratio", "mfu"}


# --------------------------------------------------- one production cell ---
def test_production_cell_end_to_end_on_fake_cuda():
    """olmo_1b × decode_32k × 16x16 in Phi mode, traced on fake cuda tensors
    in a fake world of 256 ranks: every record key, and a plan in which every
    Phi site runs the kernel the Hopper gate gives its local shape, each
    decision one launch of that kernel."""
    t0 = time.time()
    rec = dryrun.run_cell("olmo_1b", "decode_32k", False, phi=True)
    assert time.time() - t0 < PRODUCTION_CELL_LIMIT_S
    assert {"memory", "cost", "collectives", "roofline", "launches", "trace_s",
            "total_s"} <= set(rec)
    assert rec["mesh"] == "16x16"
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes",
                                  "generated_code_bytes"}
    assert rec["memory"]["argument_bytes"] > 0 and rec["memory"]["temp_bytes"] > 0
    assert rec["memory"]["generated_code_bytes"] is None
    assert set(rec["collectives"]) == set(ca.COLLECTIVES)
    assert rec["collectives"]["all-reduce"] > 0
    assert rec["roofline"]["chips"] == 256
    assert rec["roofline"]["model_flops"] == dryrun._model_flops(
        phi_variant(get_config("olmo_1b")), "decode_32k")
    plan = rec["launches"]
    sites = {s: row for s, row in plan["sites"].items() if s.startswith("lm.w")}
    assert set(sites) == {f"lm.{w}.spmd" for w in ("wq", "wk", "wv", "wo", "w1", "w3", "w2")}
    per_kernel: dict = {}
    for site, row in sites.items():
        assert row["shards"] == 256
        for d in row["decisions"]:
            assert d["impl"] == row["gate"], site
            per_kernel[f"phi_{d['impl']}_cuda"] = per_kernel.get(
                f"phi_{d['impl']}_cuda", 0) + d["calls"]
    assert per_kernel == {k: v for k, v in plan["kernels"].items() if k.startswith("phi_")}
    layers = get_config("olmo_1b").n_layers
    assert plan["kernels"]["lif_sequence_cuda"] == 7 * layers
    assert sum(per_kernel.values()) == 7 * layers


def test_cli_writes_the_cell_and_the_example_prints_its_roofline(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "RESULTS", str(tmp_path))
    path = dryrun.cell_path("olmo_1b", "decode_32k", False, True)
    monkeypatch.setattr(sys, "argv", ["dryrun", "--arch", "olmo_1b", "--shape", "decode_32k",
                                      "--phi"])
    assert dryrun.main() == 0
    rec = json.loads(Path(path).read_text())
    assert os.path.basename(path) == "olmo_1b__decode_32k__16x16_phi.json"
    assert {"memory", "cost", "collectives", "roofline", "launches"} <= set(rec)
    spec = importlib.util.spec_from_file_location(
        "multipod_dryrun_torch", ROOT / "examples" / "multipod_dryrun_torch.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    assert "roofline" in ex.summary(rec) and rec["roofline"]["bottleneck"] in ex.summary(rec)
    row = next(line for line in ex.table(str(tmp_path)).splitlines() if "| olmo_1b |" in line)
    decode = row.split(" | ")[3].split(" / ")
    gib = 2 ** 30
    assert decode[:2] == ["-", "-"] and decode[3] == "-"
    letter = {"compute": "C", "memory": "M", "collective": "N"}[rec["roofline"]["bottleneck"]]
    assert decode[2] == (f"{letter} {rec['memory']['argument_bytes'] / gib:.1f}"
                         f"+{rec['memory']['temp_bytes'] / gib:.0f}")


# ------------------------------------------- counts behind chip_smoke's bounds ---
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_dryrun", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _old_bounds(M, K, N, T, q, k, e, B, S, Hh, D, qp, kp, nq):
    """The bound formulas as ``chip_smoke.py`` held them before they moved."""
    hb, f32, i8 = H.HBM_BYTES_PER_S, H.F32_FLOP_PER_S, H.INT8_OPS_PER_S
    pr = T * (q + 1)
    fused = ((4 * M * K + T * q * k + 4 * pr * N + 4 * pr + 4 * K * N + 4 * M * N
              + 4 * -(-M // 256)) / hb * 1e3, (2 * M * T * N + e * N + M * N) / f32 * 1e3)
    lif = (8 * T * M / hb * 1e3, 3 * T * M / f32 * 1e3)
    BH = B * Hh
    attn = ((16 * B * S * Hh * D + 8 * T * qp + 4 * BH * nq) / hb * 1e3,
            (BH * S * S * (T + 1 + 2 * (D - T * kp) + 1 + 4 + 2 * D) + e * S + BH * S * D)
            / f32 * 1e3)
    causal = (16 * B * S * Hh * D / hb * 1e3,
              (B * Hh * S * (S + 1) // 2 * (4 * D + 4) + B * Hh * S * D) / f32 * 1e3)
    units = {"matcher": ((4 * M * K + 8 * T * q + 4 * M * T + M * K) / hb * 1e3,
                         2 * M * T * q * k / i8 * 1e3),
             "l1_gather": ((4 * M * T + 7 * N * 4 + 4 * M * N) / hb * 1e3,
                           M * N * (T - 1) / f32 * 1e3),
             "l2_spmm": ((9 * e + 4 * 5 * N + 4 * 64 * N) / hb * 1e3, e * N / f32 * 1e3)}
    return fused, lif, attn, causal, units


@pytest.mark.parametrize("M,K,N,T,q,k,e,B,S,Hh,D,qp,kp,nq", [
    (256, 2048, 8192, 128, 128, 16, 9000, 1, 2048, 16, 128, 64, 16, 16),
    (37, 384, 1536, 24, 64, 16, 311, 2, 130, 6, 64, 16, 8, 3),
])
def test_chip_smoke_bounds_read_the_moved_counts(M, K, N, T, q, k, e, B, S, Hh, D, qp, kp, nq):
    cs = _chip_smoke()
    fused, lif, attn, causal, units = _old_bounds(M, K, N, T, q, k, e, B, S, Hh, D, qp, kp, nq)
    assert cs.fused_bound_ms(M, K, N, T, q, k, e) == fused
    assert cs.lif_bound_ms(T, M) == lif
    assert cs.attn_bound_ms(B, S, Hh, D, T, qp, kp, nq, e) == attn
    assert cs.causal_attn_bound_ms(B, S, Hh, D) == causal
    a = torch.zeros(M, K)
    pats = torch.zeros(T, q, k)
    idx = torch.zeros(M, T, dtype=torch.int32)
    idx[:7, 0] = torch.arange(7, dtype=torch.int32)       # 7 distinct (t, index) rows
    idx[7:, 0] = 3
    got = cs.unit_bounds(a, pats, idx, torch.zeros(1, dtype=torch.float32), e, 5, N, 64)
    if T > 1:       # every other partition names row 0: one more distinct row each
        want_rows = 7 + (T - 1)
        units["l1_gather"] = ((4 * M * T + want_rows * N * 4 + 4 * M * N) / H.HBM_BYTES_PER_S
                              * 1e3, units["l1_gather"][1])
    assert got == units


def test_needed_counts_what_the_rows_need():
    """``costs.fused_needed`` against a count by hand on a tiny bank."""
    gen = torch.Generator().manual_seed(0)
    pats = (torch.rand(2, 3, 4, generator=gen) < 0.5).float()
    a = (torch.rand(5, 8, generator=gen) < 0.4).float()
    from repro_torch.core.assign import assign_patterns

    idx, res = assign_patterns(a, pats)
    used = idx < 3
    pairs = {(t, int(idx[m, t])) for m in range(5) for t in range(2) if used[m, t]}
    want = costs.fused(5, 8, 6, 2, 3, 4, int((res != 0).sum()), pwp_rows=len(pairs),
                       w_rows=int((res != 0).any(0).sum()), l1_pairs=int(used.sum()))
    assert costs.fused_needed(a, pats, 6) == want


def test_kept_scores_count_the_masks():
    for S, causal, window, chunk in ((9, False, None, None), (9, True, None, None),
                                     (9, True, 4, None), (10, True, None, 4), (3, True, 8, None)):
        i = np.arange(S)[:, None]
        j = np.arange(S)[None, :]
        keep = np.ones((S, S), bool) if not causal else j <= i
        if window is not None:
            keep &= i - j < window
        if chunk is not None:
            keep &= i // chunk == j // chunk
        assert costs.kept_scores(S, causal, window, chunk) == int(keep.sum())


# ------------------------------------------------------- real tensors ---
def test_wrappers_on_real_tensors_never_take_the_shape_only_path():
    """On real CPU tensors each wrapper runs its plain version, counts no
    launch and logs nothing; the launch functions refuse a CPU tensor as
    before; a real tensor elsewhere (meta) raises rather than fakes."""
    from repro_torch.kernels import lif, matcher, phi_attention, phi_fused

    before = (phi_fused.phi_fused_cuda.launches, lif.lif_sequence_cuda.launches,
              matcher.matcher_cuda.launches)
    a = torch.ones(4, 8)
    pats = torch.zeros(2, 3, 4)
    pwp = torch.zeros(2, 4, 5)
    w = torch.ones(8, 5)
    with costs.recording() as log:
        out, nnz = phi_fused.phi_fused_cuda(a, pats, pwp, torch.ones(2, 4), w, block_m=4)
        lif.lif_sequence_cuda(torch.ones(2, 3))
        matcher.matcher_cuda(a, pats)
    assert torch.equal(out, a @ w) and int(nnz.sum()) == 32
    assert not log
    assert (phi_fused.phi_fused_cuda.launches, lif.lif_sequence_cuda.launches,
            matcher.matcher_cuda.launches) == before
    with pytest.raises(ValueError, match="unsupported device"):
        phi_fused._launch("phi_fused_launch", a, pats, pwp, torch.ones(2, 4), w, 4, None)
    q = torch.zeros(1, 4, 1, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        phi_attention._launch(q, q, q, None, None, causal=True, window=None, chunk=None,
                              block_q=4, block_kv=4)
    m = torch.ones(2, 3, device="meta")
    assert not costs.traced(m)
    with pytest.raises(ValueError):
        lif.lif_sequence_cuda(m)


def test_traced_launches_are_logged_and_not_counted():
    """On fake card tensors each wrapper logs its launch's cost and leaves
    its ``.launches`` as it was: nothing launched."""
    from repro_torch.kernels import lif, phi_attention, phi_fused

    fns = (phi_fused.phi_fused_cuda, lif.lif_sequence_cuda,
           phi_attention.flash_attention_cuda)
    before = [fn.launches for fn in fns] + [phi_attention.flash_attention_cuda.lse_launches]
    with costs.recording() as log, dryrun.tracing("cuda"):
        a = torch.zeros(4, 8, device="cuda")
        out, _ = phi_fused.phi_fused_cuda(a, torch.zeros(2, 3, 4, device="cuda"),
                                          torch.zeros(2, 4, 5, device="cuda"),
                                          torch.ones(2, 4, device="cuda"),
                                          torch.ones(8, 5, device="cuda"), block_m=4)
        lif.lif_sequence_cuda(torch.zeros(2, 3, device="cuda"))
        q = torch.zeros(1, 4, 1, 8, device="cuda")
        phi_attention.flash_attention_cuda(q, q, q, block_q=4, block_kv=4, return_lse=True)
    assert out.shape == (4, 5)
    assert [x.name for x in log] == ["phi_fused_cuda", "lif_sequence_cuda",
                                     "flash_attention_cuda"]
    assert [fn.launches for fn in fns] + [
        phi_attention.flash_attention_cuda.lse_launches] == before


def test_train_cells_need_a_cuda_build(monkeypatch):
    """A train cell traces the card's path on fake cuda tensors; a PyTorch
    without CUDA refuses it rather than trace another device's plan."""
    monkeypatch.setattr(torch.version, "cuda", None)
    with pytest.raises(RuntimeError, match="built with CUDA"):
        dryrun.run_cell("olmo_1b", "train_4k", False)
