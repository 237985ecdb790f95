"""The port's serving engine, page manager, scheduler, sampling and launcher.

Against the reference: the dense-mode engine (which runs on this jax) on
the same params and prompts gives the same greedy tokens, and its logit
traces agree to LOGIT_ATOL (1e-4: float32 forwards that differ by a few
roundings in norms and softmax, as ``test_torch_lm.py`` states). Within the
port, bitwise: paged decode equals contiguous decode (tokens and every
logits row) on a Phi model with dyadic weights, a preempted run equals an
unconstrained one, and two seeded runs give the same results and decision
counts (cases ported from ``tests/test_serve_paged.py``). Sampled lanes are
held to the reference's contract: a sampled lane batched beside a greedy
one does not change the greedy stream.
"""
from __future__ import annotations

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.distributed.sharding import init_params as ref_init_params
from repro.models import model as ref_model
from repro.serve.engine import Engine as RefEngine, Request as RefRequest
from repro_torch import interop
from repro_torch.configs import get_config, phi_variant
from repro_torch.distributed.sharding import init_params
from repro_torch.kernels import dispatch
from repro_torch.models import model
from repro_torch.serve.engine import Engine, Request, bucket_len
from repro_torch.serve.page_manager import PageManager
from repro_torch.serve.sampling import sample
from repro_torch.serve.scheduler import SchedulerConfig, TelemetryScheduler
from torch_parity_util import np_tree

LOGIT_ATOL = 1e-4


@pytest.fixture
def fresh_policy():
    prev = dispatch.set_policy(dispatch.PhiExecutionPolicy())
    try:
        yield dispatch.get_policy()
    finally:
        dispatch.set_policy(prev)


def _dense_setup(arch="olmo_1b", seed=0):
    cfg = get_config(arch, smoke=True)
    return cfg, init_params(model.lm_specs(cfg), torch.Generator().manual_seed(seed), "cpu")


def _requests(cfg, lens, max_new, seed=11, req=Request, temps=None):
    rng = np.random.default_rng(seed)
    return [req(rid=i, tokens=[int(t) for t in rng.integers(3, cfg.vocab, plen)],
                max_new_tokens=max_new,
                temperature=0.0 if temps is None else temps[i])
            for i, plen in enumerate(lens)]


def _run(eng, reqs):
    for r in reqs:
        eng.submit(r)
    return {r.rid: r.tokens for r in eng.run()}


def _phi_dyadic(fresh=True):
    cfg = phi_variant(get_config("olmo_1b", smoke=True), timesteps=2, q=16)
    params = init_params(model.lm_specs(cfg), torch.Generator().manual_seed(0), "cpu")
    train, frozen = model.split_phi_state(params)

    def rnd(node):
        for v in node.values():
            if isinstance(v, dict):
                rnd(v)
            else:
                v.copy_(torch.round(v * 1024) / 1024)

    rnd(train)
    params = model.merge_phi_state(train, frozen)
    batch = model.dummy_batch(cfg, 2, 16, False, torch.Generator().manual_seed(2), "cpu")
    with torch.no_grad():
        params, stats = model.calibrate_lm_phi(cfg, params, batch)
    maxd = max(s.l2_density for s in stats.values())
    cfg = cfg.with_(phi=dataclasses.replace(cfg.phi, nnz_budget=min(0.9, 2 * maxd + 0.05)))
    return cfg, params


# ------------------------------------------------------------- reference ---
@pytest.mark.parametrize("paged", [False, True])
def test_dense_engine_matches_the_reference_engine(paged):
    rcfg = ref_get_config("olmo_1b", smoke=True)
    rp = ref_init_params(ref_model.lm_specs(rcfg), jax.random.PRNGKey(0))
    cfg = get_config("olmo_1b", smoke=True)
    params = interop.params_from_numpy(np_tree(rp), "cpu")
    lens, max_new = (5, 11, 7), 4
    kw = dict(batch_slots=2, max_context=32, record_logits=True, paged=paged, page_size=8)
    ref = RefEngine(rcfg, rp, **kw)
    want = _run(ref, _requests(rcfg, lens, max_new, req=RefRequest))
    eng = Engine(cfg, params, **kw)
    got = _run(eng, _requests(cfg, lens, max_new))
    assert got == want
    assert set(eng.logit_trace) == set(ref.logit_trace)
    for rid, rows in ref.logit_trace.items():
        assert len(eng.logit_trace[rid]) == len(rows)
        for g, w in zip(eng.logit_trace[rid], rows):
            np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=LOGIT_ATOL)
    assert eng.scheduler.report() == ref.scheduler.report()
    assert eng.cache_report() == ref.cache_report()
    snap, ref_snap = eng.metrics.snapshot(), ref.metrics.snapshot()
    # token_latency_ms observes each request's gap between tokens here and a
    # tick's per-token mean in the reference: only its help text differs
    latency = "serve_token_latency_ms"
    assert snap[latency].pop("help") != ref_snap[latency].pop("help")
    assert snap == ref_snap


# ----------------------------------------------------------------- paged ---
def test_paged_bitwise_identical_to_contiguous_phi_dyadic(fresh_policy):
    """Mixed-length greedy workload, Phi with dyadic weights: the paged
    engine's tokens and per-request logit traces equal the contiguous
    engine's bitwise, and both equal the spiking-dense engine's."""
    cfg, params = _phi_dyadic()
    lens, max_new = (5, 11, 7), 3
    dense = Engine(cfg, params, batch_slots=2, max_context=64, record_logits=True)
    dense_res = _run(dense, _requests(cfg, lens, max_new))
    paged = Engine(cfg, params, batch_slots=2, max_context=64, paged=True, page_size=8,
                   record_logits=True)
    paged_res = _run(paged, _requests(cfg, lens, max_new))
    oracle = Engine(cfg, params, batch_slots=2, max_context=64, record_logits=True,
                    matmul=model.spiking_dense_matmul(cfg))
    oracle_res = _run(oracle, _requests(cfg, lens, max_new))
    assert dense_res == paged_res == oracle_res
    for other in (paged, oracle):
        assert set(dense.logit_trace) == set(other.logit_trace)
        for rid in dense.logit_trace:
            for a, b in zip(dense.logit_trace[rid], other.logit_trace[rid]):
                assert np.array_equal(a, b), f"rid {rid}: logits not bitwise"
    cache = paged.cache_report()
    assert cache["hwm_pages"] >= 1
    assert cache["page_hwm_bytes"] < cache["contig_cache_bytes"]
    assert any(s.startswith("lm.") for s, _, _ in fresh_policy.decisions())


def test_preemption_roundtrip_token_identical():
    cfg, params = _dense_setup()
    lens, max_new = (9, 9, 9, 9), 10
    free = Engine(cfg, params, batch_slots=2, max_context=32, paged=True, page_size=8)
    free_res = _run(free, _requests(cfg, lens, max_new))
    assert free.scheduler.report().get("preempt_pool_dry", 0) == 0
    tight = Engine(cfg, params, batch_slots=2, max_context=32, paged=True, page_size=8,
                   num_pages=4)
    tight_res = _run(tight, _requests(cfg, lens, max_new))
    sched = tight.scheduler.report()
    assert sched.get("preempt_pool_dry", 0) > 0, sched
    assert sched.get("requeue_preempted", 0) > 0, sched
    assert tight_res == free_res


def test_pool_exhaustion_blocks_admission_then_drains():
    cfg, params = _dense_setup()
    eng = Engine(cfg, params, batch_slots=2, max_context=32, paged=True, page_size=8,
                 num_pages=4)
    reqs = _requests(cfg, (9, 9, 9, 9), 10)
    res = _run(eng, reqs)
    assert eng.scheduler.report().get("admit_blocked_pool", 0) > 0
    assert {rid: len(t) for rid, t in res.items()} == {r.rid: r.max_new_tokens for r in reqs}


def test_paged_gate_and_unported_families():
    """A sliding-window arch keeps dense slots (ring caches are already
    O(window)), and so does Mamba-2 (recurrent state has no sequence axis to
    page): paged=True is gated off, counted, and the engine serves with
    raw-length prefill (``tests/test_serve_paged.py``'s ssm case)."""
    cfg, params = _dense_setup("h2o_danube3_4b")
    eng = Engine(cfg, params, batch_slots=2, max_context=32, paged=True, page_size=8)
    assert not eng.paged and not eng.bucketed
    assert eng.scheduler.report().get("paged_gate_dense") == 1
    res = _run(eng, _requests(cfg, (5, 20), 3))
    assert {rid: len(t) for rid, t in res.items()} == {0: 3, 1: 3}
    with pytest.raises(ValueError):
        model.paged_state_specs(get_config("mamba2_2p7b", smoke=True), 4, 8)
    cfg, params = _dense_setup("mamba2_2p7b")
    eng = Engine(cfg, params, batch_slots=2, max_context=32, paged=True, page_size=8)
    assert not eng.paged and not eng.bucketed
    assert eng.scheduler.report().get("paged_gate_dense") == 1
    res = _run(eng, _requests(cfg, (5, 8), 3))
    assert {rid: len(t) for rid, t in res.items()} == {0: 3, 1: 3}
    assert eng.cache_report()["contig_cache_bytes"] == sum(
        t.numel() * t.element_size() for t in model.state_leaves(eng.state))


# ---------------------------------------------------------------- hybrid ---
def test_hybrid_engine_matches_the_references_solo_runs():
    """Zamba2 smoke, greedy, two slots: the port's engine gives each request
    the tokens of the reference engine serving it alone, and logits within
    LOGIT_ATOL of those runs. The reference's own two-slot run does not: its
    slot insert writes every state leaf at axis 1, and the hybrid's main
    Mamba-2 states carry the batch on axis 2, so each admission overwrites
    slot 0's (``dynamic_update_slice`` clamps the start)."""
    rcfg = ref_get_config("zamba2_1p2b", smoke=True)
    rp = ref_init_params(ref_model.lm_specs(rcfg), jax.random.PRNGKey(0))
    cfg = get_config("zamba2_1p2b", smoke=True)
    params = interop.params_from_numpy(np_tree(rp), "cpu")
    lens, max_new = (5, 9), 4
    solo, solo_logits = {}, {}
    for req in _requests(rcfg, lens, max_new, req=RefRequest):
        ref = RefEngine(rcfg, rp, batch_slots=1, max_context=32, record_logits=True)
        solo.update(_run(ref, [req]))
        solo_logits.update(ref.logit_trace)
    ref_pair = _run(RefEngine(rcfg, rp, batch_slots=2, max_context=32),
                    _requests(rcfg, lens, max_new, req=RefRequest))
    assert ref_pair != solo
    eng = Engine(cfg, params, batch_slots=2, max_context=32, record_logits=True)
    assert _run(eng, _requests(cfg, lens, max_new)) == solo
    assert not eng.bucketed
    for rid, rows in solo_logits.items():
        assert len(eng.logit_trace[rid]) == len(rows) == max_new
        for g, w in zip(eng.logit_trace[rid], rows):
            np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=LOGIT_ATOL)


def _phi_dyadic_hybrid():
    cfg = phi_variant(get_config("zamba2_1p2b", smoke=True), timesteps=2, q=16)
    params = init_params(model.lm_specs(cfg), torch.Generator().manual_seed(0), "cpu")
    train, frozen = model.split_phi_state(params)
    for leaf in model.state_leaves(train):
        leaf.copy_(torch.round(leaf * 1024) / 1024)
    params = model.merge_phi_state(train, frozen)
    batch = model.dummy_batch(cfg, 2, 16, False, torch.Generator().manual_seed(2), "cpu")
    with torch.no_grad():
        params, _ = model.calibrate_lm_phi(cfg, params, batch)
    return cfg, params


def test_hybrid_phi_engine_bitwise_spiking_dense_and_one_slot(fresh_policy):
    """Zamba2 smoke in Phi mode on dyadic weights: the engine's tokens and
    every logits row equal the spiking-dense engine's bitwise; a one-slot
    engine over the same requests gives the same tokens; paged=True keeps
    dense slots and counts the gate."""
    cfg, params = _phi_dyadic_hybrid()
    lens, max_new = (5, 11, 7), 3

    def go(**kw):
        eng = Engine(cfg, params, max_context=32, record_logits=True, **kw)
        return eng, _run(eng, _requests(cfg, lens, max_new))

    phi, phi_res = go(batch_slots=2)
    oracle, oracle_res = go(batch_slots=2, matmul=model.spiking_dense_matmul(cfg))
    paged, paged_res = go(batch_slots=2, paged=True)
    _, one_res = go(batch_slots=1)
    assert phi_res == oracle_res == paged_res == one_res
    assert all(len(t) == max_new for t in phi_res.values())
    for other in (oracle, paged):
        for rid, rows in phi.logit_trace.items():
            assert all(np.array_equal(a, b) for a, b in zip(rows, other.logit_trace[rid]))
    assert not paged.paged and paged.scheduler.report().get("paged_gate_dense") == 1
    assert any(s.startswith("lm.wz") for s, _, _ in fresh_policy.decisions())


def test_bucket_len_and_overlong_prompt():
    assert bucket_len(5, 64) == 8 and bucket_len(64, 64) == 64
    with pytest.raises(ValueError):
        bucket_len(65, 64)
    cfg, params = _dense_setup()
    eng = Engine(cfg, params, batch_slots=2, max_context=32)
    with pytest.raises(ValueError):
        eng.submit(Request(rid=0, tokens=list(range(3, 35)), max_new_tokens=2))
    eng.submit(Request(rid=1, tokens=list(range(3, 34)), max_new_tokens=2))


def test_page_manager_allocates_lowest_first_and_releases():
    pm = PageManager(num_pages=4, page_size=8, slots=2, max_context=32)
    assert pm.reserve_prefill(0, 9) and list(pm.tables[0]) == [0, 1, -1, -1]
    assert pm.ensure(1, 0) and pm.tables[1, 0] == 2
    assert pm.ensure(0, 16) and not pm.ensure(0, 24)
    assert pm.release(0) == 3 and pm.in_use == 1 and pm.hwm_pages == 4
    with pytest.raises(ValueError):
        PageManager(num_pages=3, page_size=8, slots=1, max_context=32)


# ------------------------------------------------------------- scheduler ---
def test_scheduler_deterministic_across_runs():
    cfg, params = _dense_setup()

    def go():
        eng = Engine(cfg, params, batch_slots=2, max_context=32, paged=True, page_size=8,
                     num_pages=4, seed=0)
        return _run(eng, _requests(cfg, (9, 5, 9, 12), 6)), eng.scheduler.report()

    assert go() == go()


def _req(rid, plen):
    return Request(rid=rid, tokens=list(range(3, 3 + plen)), max_new_tokens=4)


def test_scheduler_unit_decisions():
    s = TelemetryScheduler()
    q = [_req(0, 5), _req(1, 5)]
    picks = s.select(q, free_slots=2, cap=64,
                     snapshot={"sites": 3, "warm": False, "mean_usage_ratio": 0.5})
    assert [p.rid for p in picks] == [0] and len(q) == 1
    assert s.report() == {"admit_warmup_single": 1}
    s = TelemetryScheduler()
    q = [_req(0, 7), _req(1, 9), _req(2, 6), _req(3, 12), _req(4, 16)]
    picks = s.select(q, free_slots=2, cap=64,
                     snapshot={"sites": 3, "warm": True, "mean_usage_ratio": 0.3})
    assert [p.rid for p in picks] == [1, 3] and [r.rid for r in q] == [0, 2, 4]
    picks = s.select(q, free_slots=2, cap=64,
                     snapshot={"sites": 3, "warm": True, "mean_usage_ratio": 1.0})
    assert [p.rid for p in picks] == [0, 2]
    s = TelemetryScheduler(SchedulerConfig())
    assert s.pick_victim([(0, 3, 10), (1, 7, 4), (2, 7, 9)]) == 2
    assert s.report() == {"preempt_pool_dry": 1}
    with pytest.raises(ValueError):
        s.pick_victim([])


# -------------------------------------------------------------- sampling ---
def test_sampling_greedy_per_slot_and_top_k():
    g = torch.Generator().manual_seed(0)
    logits = torch.tensor([[0.0, 3.0, 1.0, 3.0], [5.0, 0.0, 0.0, 0.0]])
    assert sample(logits, g).tolist() == [1, 0]              # first index on ties
    temps = np.array([0.0, 1.0], np.float32)
    for _ in range(5):
        assert int(sample(logits, g, temperature=temps)[0]) == 1
    draws = sample(logits[:1].expand(512, 4).contiguous(), g, temperature=1.0, top_k=2)
    assert set(draws.tolist()) <= {1, 3} and len(set(draws.tolist())) == 2


def test_sampled_lane_leaves_the_greedy_stream_alone():
    cfg, params = _dense_setup()
    greedy = _run(Engine(cfg, params, batch_slots=2, max_context=32),
                  _requests(cfg, (6, 8), 5))
    mixed = _run(Engine(cfg, params, batch_slots=2, max_context=32, seed=3),
                 _requests(cfg, (6, 8), 5, temps=[0.0, 1.5]))
    assert mixed[0] == greedy[0]


def test_instrumented_run_is_bitwise_and_traced():
    from repro_torch.obs import ListSink, Tracer

    cfg, params = _dense_setup()
    plain = Engine(cfg, params, batch_slots=2, max_context=32, record_logits=True)
    plain_res = _run(plain, _requests(cfg, (5, 9, 7), 3))
    sink = ListSink()
    traced = Engine(cfg, params, batch_slots=2, max_context=32, record_logits=True,
                    tracer=Tracer(sink), wall_time=True)
    assert _run(traced, _requests(cfg, (5, 9, 7), 3)) == plain_res
    for rid, rows in plain.logit_trace.items():
        assert all(np.array_equal(a, b) for a, b in zip(rows, traced.logit_trace[rid]))
    kinds = [r["kind"] for r in sink.records]
    assert kinds.count("submit") == 3 and kinds.count("retire") == 3
    assert traced.metrics.get("token_latency_ms").count() == traced.decoded_tokens


def _profiled(fn):
    """(fn's result, the program's spans, the profiler's host event names)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import trace

    trace.event("test.unprofiled")      # found no profiler: the window starts a record
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, trace.profiled_spans(), {e.name() for e in prof.profiler.kineto_results.events()}


def test_profiled_run_is_bitwise_and_its_spans_nest():
    cfg, params = _dense_setup()
    plain = Engine(cfg, params, batch_slots=2, max_context=32, record_logits=True)
    plain_res = _run(plain, _requests(cfg, (5, 9, 7), 3))
    prof = Engine(cfg, params, batch_slots=2, max_context=32, record_logits=True)
    res, spans, events = _profiled(lambda: _run(prof, _requests(cfg, (5, 9, 7), 3)))
    assert res == plain_res and set(prof.logit_trace) == set(plain.logit_trace)
    for rid, rows in plain.logit_trace.items():
        assert all(np.array_equal(a, b) for a, b in zip(rows, prof.logit_trace[rid]))
    # nothing of the program in the profiler's own trace
    assert not [n for n in events if n.startswith(("serve.", "snn."))]
    ticks = {s["id"]: s for s in spans if s["name"] == "serve.tick"}
    assert len(ticks) == prof.ticks
    work = [s for s in spans if s["name"] in ("serve.prefill", "serve.decode_step")]
    samples = [s for s in spans if s["name"] == "serve.sample"]
    assert sum(s["name"] == "serve.prefill" for s in work) == 3
    assert len(samples) == 3 + sum(s["name"] == "serve.decode_step" for s in work)
    for s in work + samples:
        t = ticks[s["parent"]]
        assert t["start_ns"] <= s["start_ns"] <= s["end_ns"] <= t["end_ns"]
        if s["name"] == "serve.decode_step":
            assert s["rows"] == t["rows"] > 0
    for a in samples:
        assert all(a["end_ns"] <= w["start_ns"] or w["end_ns"] <= a["start_ns"] for w in work)
    assert sum(t["admitted"] for t in ticks.values()) == 3


@pytest.fixture
def fake_clock(monkeypatch):
    """The program's clock advances only in the model's calls and sampling:
    7 ms a prefill, 10 a decode step, 1 a sampling."""
    from repro_torch.obs import trace
    from repro_torch.serve import engine as engine_mod

    now = [0]

    def advancing(fn, ms):
        def call(*a, **k):
            now[0] += int(ms * 1e6)
            return fn(*a, **k)
        return call

    monkeypatch.setattr(trace, "now_ns", lambda: now[0])
    monkeypatch.setattr(model, "prefill_padded", advancing(model.prefill_padded, 7))
    monkeypatch.setattr(model, "decode_step", advancing(model.decode_step, 10))
    monkeypatch.setattr(engine_mod, "sample", advancing(engine_mod.sample, 1))
    return now


def test_request_spans_add_up_to_the_first_token(fake_clock):
    """Per request: admit - submit + prefill + the admission's sampling =
    first_token - submit, on the clock the spans share."""
    cfg, params = _dense_setup()
    eng = Engine(cfg, params, batch_slots=2, max_context=32)
    _, spans, _ = _profiled(lambda: _run(eng, _requests(cfg, (5, 9, 7), 3)))
    at = {}
    for s in spans:
        if "rid" in s:
            at.setdefault((s["name"], s["rid"]), s)

    def dur(s):
        return s["end_ns"] - s["start_ns"]

    firsts = []
    for rid in range(3):
        submit = at["serve.submit", rid]["start_ns"]
        first = at["serve.first_token", rid]["start_ns"]
        assert (at["serve.admit", rid]["start_ns"] - submit + dur(at["serve.prefill", rid])
                + dur(at["serve.sample", rid])) == first - submit
        firsts.append(first / 1e6)
    assert firsts == [8.0, 16.0, 46.0]


def test_token_latency_is_each_requests_gap_between_tokens(fake_clock, monkeypatch):
    """One observation a decoded token: the time since its own request's
    previous token. Request 0's second token waits for request 1's prefill
    (7 ms) and sampling (1) in the same tick: 19 ms; every other gap is a
    decode step and its sampling, 11 ms."""
    cfg, params = _dense_setup()
    eng = Engine(cfg, params, batch_slots=2, max_context=32, wall_time=True)
    seen = []
    hist = eng.metrics.get("token_latency_ms")
    real = hist.observe
    monkeypatch.setattr(hist, "observe", lambda v, **kw: (seen.append(v), real(v, **kw)))
    _run(eng, _requests(cfg, (5, 6, 7), 3))
    assert seen == [19.0, 11.0, 11.0, 11.0, 11.0, 11.0]
    assert hist.count() == eng.decoded_tokens == len(seen)


# -------------------------------------------------------------- launcher ---
def test_launcher_serves_on_the_cpu(tmp_path, fresh_policy):
    from repro_torch.launch import serve

    prom, trace = tmp_path / "m.prom", tmp_path / "t.jsonl"
    serve.main(["--arch", "olmo_1b", "--smoke", "--phi", "--device", "cpu", "--requests",
                "3", "--max-new", "3", "--max-context", "32", "--paged", "--metrics-out",
                str(prom), "--trace-out", str(trace)])
    body = prom.read_text()
    assert "serve_decoded_tokens 6" in body and "phi_dispatch_decisions" in body
    kinds = {json.loads(line)["kind"] for line in trace.read_text().splitlines()}
    assert {"submit", "admit", "prefill", "decode", "retire", "dispatch"} <= kinds


def test_launcher_serves_the_hybrid_on_the_cpu(tmp_path, fresh_policy):
    from repro_torch.launch import serve

    prom = tmp_path / "m.prom"
    serve.main(["--arch", "zamba2_1p2b", "--smoke", "--phi", "--device", "cpu", "--requests",
                "3", "--max-new", "3", "--max-context", "32", "--paged", "--metrics-out",
                str(prom)])
    body = prom.read_text()
    assert "serve_decoded_tokens 6" in body and "phi_dispatch_decisions" in body
    assert 'lm.wz' in body


def test_launcher_and_entry_points_default_to_the_card():
    """Without ``--device``/``device=`` the launcher and the model's entry
    points ask for CUDA, and raise where there is none."""
    from repro_torch.launch import serve

    if torch.cuda.is_available():
        assert model.init_decode_state(get_config("olmo_1b", smoke=True), 1, 8)[0][0].is_cuda
        return
    with pytest.raises(RuntimeError, match="CUDA requested"):
        serve.main(["--arch", "olmo_1b", "--smoke", "--requests", "1"])
    with pytest.raises(RuntimeError, match="CUDA requested"):
        model.init_decode_state(get_config("olmo_1b", smoke=True), 1, 8)
