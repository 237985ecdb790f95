"""repro_torch.sim and ``snn.models.capture_phi_traces`` held against the
reference package's on the same inputs, and the simulator's conservation
invariants on the port.

Activations and banks are made from a seed with numpy. The traces are
integer arrays and are compared exactly; the simulator's results are
integers (cycles, bytes, counters) and float energies, compared exactly and
at a relative tolerance of 1e-12 respectively. The capture tests carry the
reference's weights (×3 gain past the encoder, on the 2^-10 grid) and its
calibrated PhiState across with ``interop``, and call the reference's
``capture_phi_traces`` directly; for the Spikformer its ``apply`` gets a
folded ``flash_attention`` injected, as the reference's policy-dispatched
attention does not run on this jax.
"""
from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_util import dyadic, np_tree, t

from repro.core.patterns import PhiConfig as RPhiConfig
from repro.models import flash as RF
from repro.sim import accel as RA
from repro.sim import trace as RT
from repro.snn import models as RM
from repro_torch.core.patterns import PhiConfig, active_pattern_sets
from repro_torch.core.perfmodel import packer_budget_report
from repro_torch.interop import params_from_numpy, phi_state_from_numpy
from repro_torch.sim import accel as A
from repro_torch.sim import trace as TR
from repro_torch.sim.engine import Engine, merge_reports
from repro_torch.snn import models as M
from repro_torch.snn.data import synthetic_images

REL = 1e-12
TRACE_FIELDS = ("name", "m", "k_dim", "n", "k", "q", "idx", "tile_pop", "tile_res", "usage",
                "reps")


def same(got, want, path="") -> None:
    """Equal: arrays and ints exactly, floats at REL, containers and
    dataclasses field by field."""
    if dataclasses.is_dataclass(want):
        for f in dataclasses.fields(want):
            same(getattr(got, f.name), getattr(want, f.name), f"{path}.{f.name}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for key in want:
            same(got[key], want[key], f"{path}[{key!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=REL, abs=0.0), path
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def _acts(seed, M_, K, k, q, p=0.15, zero_bank=False):
    rng = np.random.default_rng(seed)
    protos = (rng.random((16, K)) < p).astype(np.float32)
    a = np.abs(protos[rng.integers(0, 16, M_)] - (rng.random((M_, K)) < 0.03)).astype(np.float32)
    pats = a[rng.integers(0, M_, q)].reshape(q, K // k, k).transpose(1, 0, 2)
    pats = np.zeros_like(pats) if zero_bank else pats
    return a, np.ascontiguousarray(pats.astype(np.uint8))


ASSIGN_CASES = [(300, 144, 16, 32), (257, 63, 9, 7), (1000, 576, 9, 128), (64, 128, 64, 5),
                (129, 96, 16, 1)]


# ------------------------------------------------------------------ traces ---
@pytest.mark.parametrize("M_,K,k,q", ASSIGN_CASES)
def test_assign_np_and_the_torch_assignment_match_the_reference(M_, K, k, q):
    a, pats = _acts(M_ + q, M_, K, k, q)
    want = RT._assign_np(a, pats)
    same(TR._assign_np(a, pats), want)
    got = TR._assign_torch(torch.from_numpy(a), torch.from_numpy(pats))
    same(got[:3], want)
    same(got[3], RT._usage_hist(want[0], q))
    assert (got[0] < q).any()                          # patterns matched


@pytest.mark.parametrize("M_,K,k,q", ASSIGN_CASES)
@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_trace_from_acts_matches_the_reference(M_, K, k, q, kind):
    a, pats = _acts(M_ + K, M_, K, k, q)
    acts = np.concatenate([a, a[:, :3]], axis=1).reshape(1, M_, K + 3)  # ragged dense tail
    want = RT.trace_from_acts("t", acts, pats, n=40, reps=3)
    if kind == "tensor":
        acts, pats = torch.from_numpy(acts), torch.from_numpy(pats)
    got = TR.trace_from_acts("t", acts, pats, n=40, reps=3)
    for f in TRACE_FIELDS:
        same(getattr(got, f), getattr(want, f), f)
    for prop in ("t", "bit_nnz", "l2_nnz", "bit_density", "l2_density", "idx_density"):
        same(getattr(got, prop), getattr(want, prop), prop)


@pytest.fixture(scope="module")
def vgg_traces():
    return TR.vgg16_table4_traces(), RT.vgg16_table4_traces()


@pytest.fixture(scope="module")
def zipf_traces():
    kw = dict(m=512, k_dim=128, n=128, reps=3, seed=1)
    return TR.synthetic_zipf_trace(**kw), RT.synthetic_zipf_trace(**kw)


def _same_trace(got, want):
    for f in TRACE_FIELDS:
        same(getattr(got, f), getattr(want, f), f"{want.name}.{f}")


def test_vgg16_table4_traces_match_the_reference(vgg_traces):
    got, want = vgg_traces
    assert len(got) == len(want) == 14
    for g, w in zip(got, want):
        _same_trace(g, w)


@pytest.mark.parametrize("kw", [dict(), dict(m=300, k_dim=96, n=40, k=16, q=32, zipf_a=1.2,
                                             density=0.4, flip=0.05, reps=2, seed=7)])
def test_synthetic_zipf_trace_matches_the_reference(kw):
    _same_trace(TR.synthetic_zipf_trace(**kw), RT.synthetic_zipf_trace(**kw))


@pytest.mark.parametrize("kw", [dict(), dict(densities=(0.01, 0.3), m=200, k_dim=144, n=32,
                                             k=9, q=16, reps=4, seed=3)])
def test_density_sweep_traces_match_the_reference(kw):
    got, want = TR.density_sweep_traces(**kw), RT.density_sweep_traces(**kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same_trace(g, w)


def test_vgg16_table4_traces_fold_truncated_rows_into_reps():
    got, want = TR.vgg16_table4_traces(max_rows=256, timesteps=2, batch=2, q=64, seed=5), \
        RT.vgg16_table4_traces(max_rows=256, timesteps=2, batch=2, q=64, seed=5)
    for g, w in zip(got, want):
        _same_trace(g, w)
    assert got[0].reps == 4 * 1024 // 256


# --------------------------------------------------------------- simulator ---
SIM_CONFIGS = {
    "asic": {}, "asic_no_prefetch": dict(prefetch=False),
    "asic_packer_cap": dict(packer_cap=512, packer_rate=8),
    "asic_small_buffer": dict(pwp_buffer_kb=16, block_m=64),
    "tpu_fused": dict(dataflow="tpu_fused"),
    "tpu_fused_no_prefetch": dict(dataflow="tpu_fused", prefetch=False),
    "tpu_fused_runtime_sets": dict(dataflow="tpu_fused", prefetch_prepass=False),
}


def _sim_traces(vgg_traces, zipf_traces):
    (vg, vr), (zg, zr) = vgg_traces, zipf_traces
    dg = TR.density_sweep_traces(densities=(0.05, 0.4), m=256, reps=2)
    dr = RT.density_sweep_traces(densities=(0.05, 0.4), m=256, reps=2)
    return [zg, *vg[:3], vg[-1], *dg], [zr, *vr[:3], vr[-1], *dr]


@pytest.mark.parametrize("cfg", SIM_CONFIGS.values(), ids=list(SIM_CONFIGS))
def test_phi_accelerator_sim_matches_the_reference(vgg_traces, zipf_traces, cfg):
    got_t, want_t = _sim_traces(vgg_traces, zipf_traces)
    got = A.PhiAcceleratorSim(A.PhiSimConfig(**cfg)).run(got_t)
    want = RA.PhiAcceleratorSim(RA.PhiSimConfig(**cfg)).run(want_t)
    for g, w in zip(got, want):
        same(g, w, w.name)
        same(g.seconds, w.seconds)
        same(g.energy_j, w.energy_j)
    same(A.summarize_run(got), RA.summarize_run(want))
    assert any(r.p_active for r in got) or not A.PhiSimConfig(**cfg).prefetch


def test_eyeriss_sim_and_summaries_match_the_reference(vgg_traces, zipf_traces):
    got_t, want_t = _sim_traces(vgg_traces, zipf_traces)
    for block_m in (128, 100):
        got = A.EyerissSim(block_m=block_m).run(got_t)
        want = RA.EyerissSim(block_m=block_m).run(want_t)
        for g, w in zip(got, want):
            same(g, w, w.name)
        same(A.summarize_run(got), RA.summarize_run(want))


def test_event_log_matches_the_reference(zipf_traces):
    zg, zr = zipf_traces
    eng_cfg = dict(keep_log=True, block_m=256)
    sim, rsim = A.PhiAcceleratorSim(A.PhiSimConfig(**eng_cfg)), \
        RA.PhiAcceleratorSim(RA.PhiSimConfig(**eng_cfg))
    got = sim._run_pass(zg, warm=False, l1_mask=zg.idx < zg.q,
                        l2_per_tile=zg.tile_res.astype(np.int64), want_rows=zg.t * 9,
                        p_active=8)[0]
    want = rsim._run_pass(zr, warm=False, l1_mask=zr.idx < zr.q,
                          l2_per_tile=zr.tile_res.astype(np.int64), want_rows=zr.t * 9,
                          p_active=8)[0]
    same(got, want)


@pytest.mark.parametrize("cfg", [{}, dict(prefetch=False), dict(prefetch_prepass=False),
                                 dict(block_m=64)])
def test_traffic_crosscheck_matches_the_reference(vgg_traces, cfg):
    vg, vr = vgg_traces
    for g, w in zip(vg[::3], vr[::3]):
        got = A.tpu_traffic_crosscheck(g, A.PhiSimConfig(**cfg))
        same(got, RA.tpu_traffic_crosscheck(w, RA.PhiSimConfig(**cfg)))
        assert got["rel_err"] <= 0.10


def test_restricted_split_matches_the_reference(zipf_traces):
    zg, zr = zipf_traces
    active, _ = active_pattern_sets(zg.usage)
    assert active is not None
    for act in (None, active):
        same(A._restricted_split(zg, act), RA._restricted_split(zr, act))


# -------------------------------------------------------------- invariants ---
def test_every_l2_nonzero_processed_exactly_once(vgg_traces, zipf_traces):
    """Sparse-PE entries == packer entries == restricted-assignment residual
    count × reps: nothing dropped, nothing double-counted."""
    for tr in [zipf_traces[0]] + list(vgg_traces[0][:3]):
        for cfg in (A.PhiSimConfig(), A.PhiSimConfig(prefetch=False)):
            r = A.PhiAcceleratorSim(cfg).run_layer(tr)
            active, _ = active_pattern_sets(tr.usage) if cfg.prefetch else (None, 1.0)
            _, l2_per_tile = A._restricted_split(tr, active)
            assert r.l2_processed == int(l2_per_tile.sum()) * max(1, tr.reps)
            assert r.l2_processed == r.units["packer"]["counters"].get("entry", 0)


def test_energy_total_is_sum_of_unit_energies(vgg_traces, zipf_traces):
    for tr in [zipf_traces[0], vgg_traces[0][4]]:
        for sim in (A.PhiAcceleratorSim(), A.EyerissSim()):
            r = sim.run_layer(tr)
            assert r.energy_total_pj == pytest.approx(sum(r.energy_pj.values()), rel=1e-12)
            assert any(k.startswith("static_") for k in r.energy_pj)


def test_same_seed_runs_bit_identical():
    def one():
        tr = TR.synthetic_zipf_trace(m=256, k_dim=128, n=64, reps=2, seed=9)
        r = A.PhiAcceleratorSim().run_layer(tr)
        return json.dumps({"cycles": r.cycles, "energy": r.energy_pj, "dram": r.dram_bytes,
                           "units": r.units}, sort_keys=True)

    assert one() == one()


def test_packer_capacity_crosschecks_budget_report(zipf_traces):
    """The sim packer's cap_required equals what perfmodel's packer-budget
    aggregation derives from equivalent per-stripe counters; a finite packer
    serialises rounds and drops nothing."""
    tr = zipf_traces[0]
    cfg = A.PhiSimConfig(prefetch=False)
    r = A.PhiAcceleratorSim(cfg).run_layer(tr)
    (budget,) = packer_budget_report({"sim.layer": {
        "executions": r.reps, "rows": tr.m * r.reps, "l2_nnz_total": r.l2_processed,
        "l2_nnz_max_block": r.l2_nnz_max_stripe, "block_m": min(cfg.block_m, tr.m),
        "k_dim": tr.k_dim}})
    assert budget.cap_required == r.packer_cap_required
    assert budget.l2_nnz_total == r.l2_processed
    dense = TR.density_sweep_traces(densities=(0.4,), m=512, k_dim=256)[0]
    small = A.PhiAcceleratorSim(A.PhiSimConfig(packer_cap=1024)).run_layer(dense)
    big = A.PhiAcceleratorSim(A.PhiSimConfig(packer_cap=1 << 20)).run_layer(dense)
    assert small.l2_processed == big.l2_processed and small.packer_rounds_max > 1
    assert small.cycles >= big.cycles


def test_engine_fifo_and_merge():
    eng = Engine()
    d1 = eng.submit("u", 0, 10, kind="a", count=1, energy_pj=2.0)
    d2 = eng.submit("u", 5, 10, kind="a", count=1, energy_pj=2.0)
    assert (d1, d2) == (10, 20)
    rep = eng.report(static_w={"core": 1.0}, freq=500e6)
    assert rep["cycles"] == 20
    assert rep["energy_total_pj"] == pytest.approx(sum(rep["energy_pj"].values()))
    merged = merge_reports(rep, rep, reps=3)
    assert merged["cycles"] == 60 and merged["units"]["u"]["counters"]["a"] == 6
    assert merged["energy_total_pj"] == pytest.approx(3 * rep["energy_total_pj"])


# ----------------------------------------------------------------- capture ---
GAIN = 3.0
CAPTURE = {
    "vgg": dict(kind="vgg", widths=(16, 32), input_size=8),
    "mlp": dict(kind="mlp", widths=(64, 32), input_size=8),
    "spikformer": dict(kind="spikformer", dim=32, heads=2, blocks=1, input_size=8,
                       attn="flash"),
}
FIRST = {"vgg": "conv0", "mlp": "fc0", "spikformer": "embed"}


def _ref_attention(qh, kh, vh, name):
    """The spikformer fold around the reference's ``flash_attention``."""
    T_, B, H, S, Dh = qh.shape

    def fold(z):
        return jnp.moveaxis(z.reshape(T_ * B, H, S, Dh), 1, 2)

    out = RF.flash_attention(fold(qh), fold(kh), fold(vh), False, None, None, 128, 128)
    return jnp.moveaxis(out, 2, 1).reshape(T_, B, H, S, Dh)


@pytest.mark.parametrize("kind", list(CAPTURE))
def test_capture_phi_traces_matches_the_reference(kind, monkeypatch):
    from repro.core.patterns import calibrate as rcalibrate
    from repro.core.patterns import pattern_usage as rusage
    from repro.core.patterns import pattern_weight_products as rpwp

    rcfg = RM.SNNConfig(**CAPTURE[kind], phi=RPhiConfig(k=16, q=16, iters=3))
    cfg = M.SNNConfig(**CAPTURE[kind], phi=PhiConfig(k=16, q=16, iters=3))
    raw = np_tree(RM.init(rcfg, jax.random.PRNGKey(0)))
    w = {name: {"w": dyadic(leaf["w"] * (1.0 if name == FIRST[kind] else GAIN))}
         for name, leaf in raw.items()}
    x, _ = synthetic_images(3, size=8, seed=1)
    x = dyadic(x)
    jw = jax.tree.map(jnp.asarray, w)
    if kind == "spikformer":
        real = RM.apply
        monkeypatch.setattr(RM, "apply", lambda *a, **k: real(*a, attention=_ref_attention, **k))
    cap: dict = {}
    RM.apply(jw, rcfg, jnp.asarray(x), capture=cap)
    patterns, pwps, usage = {}, {}, {}
    for name, act in cap.items():
        act = np.asarray(act)
        patterns[name] = rcalibrate(act, rcfg.phi)
        usage[name] = rusage(act, patterns[name])
        if not name.endswith("_attn"):
            wt = jw[name]["w"].reshape(-1, jw[name]["w"].shape[-1])
            pwps[name] = np.asarray(rpwp(jnp.asarray(patterns[name]), wt))
    want = RM.capture_phi_traces(jw, rcfg, RM.PhiState(patterns, pwps, usage), jnp.asarray(x))
    state = phi_state_from_numpy(patterns, pwps, usage, "cpu")
    got = M.capture_phi_traces(params_from_numpy(w, "cpu"), cfg, state, t(x))
    assert len(got) == len(want) > 0
    assert not any(tr.name.endswith("_attn") for tr in got)
    assert (kind == "spikformer") == any(name.endswith("_attn") for name in patterns)
    for g, wt_ in zip(got, want):
        _same_trace(g, wt_)
    assert sum(tr.l2_nnz for tr in got) > 0 and max(tr.idx_density for tr in got) > 0
    for tr in got:
        assert A.PhiAcceleratorSim().run_layer(tr).cycles > 0
