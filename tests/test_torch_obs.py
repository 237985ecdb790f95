"""The port's observability layer against the reference's ``repro.obs``.

The cases of ``tests/test_obs.py`` run against the port's tracer, metrics
registry, drift monitor and the execution policy's ``site_telemetry``; and
the same operations applied to a reference registry and a port registry
give the same Prometheus text, JSON snapshot and JSONL bytes, exactly
(pure host-side code: no tolerance). Drift scores are float64 numpy in both
and compared exactly.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import repro.obs as ref_obs
import repro_torch.obs as port_obs
from repro_torch.kernels import dispatch
from repro_torch.obs import trace
from repro_torch.obs import (DRIFT_THRESHOLD, DriftMonitor, ListSink,
                             MetricsRegistry, Tracer, get_tracer, prometheus_many, psi,
                             set_tracer, site_drift, snapshot_many)


# ----------------------------------------------------------------- tracer --
def test_tracer_seq_monotonic_and_none_attrs_dropped():
    sink = ListSink()
    tr = Tracer(sink)
    tr.emit("a", x=1, skip=None)
    tr.emit("b", y="z")
    assert [r["seq"] for r in sink.records] == [0, 1]
    assert "skip" not in sink.records[0]
    assert sink.records[0]["kind"] == "a" and sink.records[1]["y"] == "z"
    assert tr.kind_counts == {"a": 1, "b": 1}


def test_tracer_wall_clock_only_when_enabled_and_span_order():
    cold, warm = ListSink(), ListSink()
    Tracer(cold).emit("e")
    tw = Tracer(warm, wall_time=True, clock=iter([1.0, 2.0, 2.5, 3.0]).__next__)
    tw.emit("e")
    with tw.span("s", rid=3):
        pass
    assert "wall_ms" not in cold.records[0]
    assert warm.records[0]["wall_ms"] == 1000.0
    assert warm.records[1]["dur_ms"] == 500.0 and warm.records[1]["rid"] == 3
    sink = ListSink()
    tr = Tracer(sink)
    with tr.span("prefill", rid=3, slot=0):
        tr.emit("inner")
    assert [r["kind"] for r in sink.records] == ["inner", "prefill"]


def _emit_both(path, mod):
    tr = mod.Tracer(mod.JsonlSink(str(path)))
    tr.emit("dispatch", site="lm.wq", impl="fused", blocks=[128, 64])
    with tr.span("prefill", rid=1, tick=0):
        tr.emit("decode", tokens=2, skip=None)
    tr.close()


def test_jsonl_bytes_equal_the_references(tmp_path):
    a, b, r = tmp_path / "a.jsonl", tmp_path / "b.jsonl", tmp_path / "r.jsonl"
    _emit_both(a, port_obs)
    _emit_both(b, port_obs)
    _emit_both(r, ref_obs)
    assert a.read_bytes() == b.read_bytes() == r.read_bytes()
    assert json.loads(a.read_bytes().splitlines()[0])["seq"] == 0


def test_set_tracer_returns_previous():
    tr = Tracer(ListSink())
    prev = set_tracer(tr)
    try:
        assert get_tracer() is tr
    finally:
        set_tracer(prev)
    assert get_tracer() is prev


# ------------------------------------------------- the program's spans --
def test_span_lies_on_the_profilers_clock():
    """A span's start and end lie within 1 ms of a ``record_function`` range
    opened around the same block: the record shares the profiler's clock."""
    import time

    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):
            pass
        with record_function("block"), trace.span("test.block", rows=3):
            time.sleep(0.02)
    (rec,) = [s for s in trace.profiled_spans() if s["name"] == "test.block"]
    (ev,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "block"]
    start, end = ev.start_ns(), ev.start_ns() + ev.duration_ns()
    assert abs(rec["start_ns"] - start) < 1e6 and abs(rec["end_ns"] - end) < 1e6
    assert rec["end_ns"] - rec["start_ns"] >= 20e6 and rec["rows"] == 3


def test_span_off_is_one_null_object_and_records_nothing(monkeypatch):
    def no_clock():
        raise AssertionError("an untraced span read the clock")

    monkeypatch.setattr(trace, "_RECORD", [])
    monkeypatch.setattr(trace, "now_ns", no_clock)
    spans = [trace.span("test.a"), trace.span("test.b", rows=1)]
    assert spans[0] is spans[1] is trace.NULL_SPAN
    with spans[0] as s:
        s.set(rows=2)
    trace.event("test.c", rid=1)
    assert trace.profiled_spans() == []


def test_profiled_spans_nest_and_hold_the_latest_window():
    from torch.profiler import ProfilerActivity, profile

    trace.event("test.unprofiled")
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("test.old"):
            pass
    with trace.span("test.between"):            # no profiler: ends that record
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("test.outer", rows=2) as outer:
            trace.event("test.event", rid=7)
            with trace.span("test.inner"):
                pass
            outer.set(admitted=1)
    got = {s["name"]: s for s in trace.profiled_spans()}
    assert list(got) == ["test.event", "test.inner", "test.outer"]
    o = got["test.outer"]
    assert o["parent"] is None and o["rows"] == 2 and o["admitted"] == 1
    assert got["test.event"]["parent"] == got["test.inner"]["parent"] == o["id"]
    assert got["test.event"]["rid"] == 7
    assert got["test.event"]["start_ns"] == got["test.event"]["end_ns"]
    assert o["start_ns"] <= got["test.inner"]["start_ns"] <= got["test.inner"]["end_ns"] \
        <= o["end_ns"]


def test_timed_tracer_records_carry_ids_and_the_profilers_clock():
    sink = ListSink()
    tr = Tracer(sink, wall_time=True)
    with trace.span("serve.tick", tr, tick=0):
        trace.event("serve.submit", tr, rid=1)
    sub, tick = sink.records
    assert (sub["kind"], tick["kind"]) == ("submit", "tick")
    assert sub["parent"] == tick["id"] and "parent" not in tick
    assert tick["start_ns"] <= sub["start_ns"] == sub["end_ns"] <= tick["end_ns"]
    assert abs(tick["end_ns"] - trace.now_ns()) < 1e9 and tick["dur_ms"] >= 0
    cold = ListSink()
    tr = Tracer(cold)
    with trace.span("serve.tick", tr, tick=0):
        trace.event("serve.submit", tr, rid=1)
    assert [sorted(r) for r in cold.records] == [["kind", "rid", "seq"],
                                                 ["kind", "seq", "tick"]]


def test_the_program_opens_no_record_function():
    """Under CUDA a ``record_function`` range is mirrored onto the device
    timeline, where the benchmark would count it as device work."""
    import re
    from pathlib import Path

    root = Path(port_obs.__file__).resolve().parents[1]
    call = re.compile(r"record_function\s*\(|RecordFunction|_record_function_enter")
    assert not [str(p) for p in root.rglob("*.py") if call.search(p.read_text())]


# ---------------------------------------------------------------- metrics --
def _fill(reg):
    c = reg.counter("hits", "h", labelnames=("kind",))
    c.inc(kind="a")
    c.inc(2, kind="b")
    reg.counter("ticks", "engine iterations").inc(3)
    reg.gauge("temp", "a gauge", labelnames=("site",)).set(0.25, site='x"y')
    h = reg.histogram("lat_ms", "latency", buckets=(1.0, 2.0, 4.0, 8.0))
    for v in (0.5, 1.5, 1.5, 3.0, 7.0, 100.0):
        h.observe(v)
    t = reg.histogram("ticks_lat", "tick latency", buckets=ref_obs.TICK_BUCKETS)
    t.observe(3)
    return reg


def test_prometheus_and_snapshots_equal_the_references():
    ours = [_fill(MetricsRegistry("serve")), _fill(MetricsRegistry("phi"))]
    ref = [_fill(ref_obs.MetricsRegistry("serve")), _fill(ref_obs.MetricsRegistry("phi"))]
    assert prometheus_many(ours) == ref_obs.prometheus_many(ref)
    assert snapshot_many(ours) == ref_obs.snapshot_many(ref)
    assert prometheus_many(ours[:1]) == ref_obs.prometheus_many(ref[:1])
    assert snapshot_many(ours[:1]) == ref_obs.snapshot_many(ref[:1])
    h, rh = ours[0].get("lat_ms"), ref[0].get("lat_ms")
    for p in (0, 10, 50, 90, 99, 100):
        assert h.percentile(p) == rh.percentile(p)
    body = prometheus_many(ours[:1])
    assert "# TYPE serve_ticks counter" in body and "serve_ticks 3" in body
    assert 'serve_lat_ms_bucket{le="1.0"} 1' in body
    assert 'serve_lat_ms_bucket{le="+Inf"} 6' in body and "serve_lat_ms_count 6" in body


def test_registry_counter_labels_total_and_conflicts():
    reg = MetricsRegistry("t")
    c = reg.counter("hits", "h", labelnames=("kind",))
    c.inc(kind="a")
    c.inc(2, kind="b")
    assert c.get(kind="a") == 1 and c.get(kind="b") == 2 and c.total() == 3
    assert reg.counter("hits", "h", labelnames=("kind",)) is c
    reg.counter("x", "d")
    with pytest.raises(ValueError):
        reg.gauge("x", "d")
    reg.counter("y", "d", labelnames=("a",))
    with pytest.raises(ValueError):
        reg.counter("y", "d", labelnames=("b",))
    with pytest.raises(ValueError):
        reg.histogram("bad", "b", buckets=(2.0, 1.0))
    with pytest.raises(ValueError):
        c.inc(kind="a", extra=1)


def test_registry_reset_zeroes_but_keeps_registrations():
    reg = MetricsRegistry("t")
    c, g = reg.counter("n", "d"), reg.gauge("v", "d")
    h = reg.histogram("lat", "d", buckets=(1.0, 2.0))
    c.inc(5)
    g.set(3.0)
    h.observe(1.5)
    assert h.count() == 1 and h.sum() == 1.5
    reg.reset()
    assert c.total() == 0 and g.get() == 0 and h.count() == 0
    assert reg.get("n") is c
    c.inc()
    assert c.total() == 1


def test_snapshot_many_rejects_namespace_collision():
    a, b = MetricsRegistry("dup"), MetricsRegistry("dup")
    a.counter("x", "d")
    b.counter("x", "d")
    with pytest.raises(ValueError):
        snapshot_many([a, b])


# ------------------------------------------------------------------ drift --
def _zipf_hist(t, q, total, shift, a=1.5):
    ranks = (np.arange(q) + 1).astype(np.float64)
    p = 1.0 / ranks ** a
    p = np.roll(p / p.sum(), shift)
    hist = np.zeros((t, q + 1), np.int64)
    hist[:, :q] = np.round(p * total).astype(np.int64)
    hist[:, q] = max(1, total // 20)
    return hist


def test_psi_and_site_drift_equal_the_references():
    h = _zipf_hist(1, 16, 4000, 0)[0]
    assert psi(h, h) == pytest.approx(0.0, abs=1e-9)
    assert psi(h, h * 7) == pytest.approx(0.0, abs=1e-9)
    assert psi(np.zeros(4), h[:4]) == 0.0
    calib, shifted = _zipf_hist(2, 16, 4000, 0), _zipf_hist(2, 16, 4000, 8)
    assert site_drift(calib, shifted) > DRIFT_THRESHOLD == ref_obs.DRIFT_THRESHOLD
    assert site_drift(calib, calib * 7) < DRIFT_THRESHOLD
    assert site_drift(calib, shifted) == ref_obs.site_drift(calib, shifted)
    assert site_drift(calib, shifted[:1]) == ref_obs.site_drift(calib, shifted[:1])
    with pytest.raises(ValueError):
        site_drift(calib, np.zeros((2, 9), np.int64))


def test_drift_monitor_alert_and_silence_deterministic():
    calib = _zipf_hist(2, 16, 4000, 0)
    pol = dispatch.PhiExecutionPolicy()
    pol.register_usage("m.shifted", calib)
    pol.register_usage("m.stationary", calib)
    with pol._lock:
        pol._sites["m.shifted"] = {"executions": 1, "usage_runtime": _zipf_hist(2, 16, 4000, 8)}
        pol._sites["m.stationary"] = {"executions": 1, "usage_runtime": calib * 7}
    mon = DriftMonitor(pol, prefix="m.")
    v1, v2 = mon.check(), mon.check()
    assert v1["alerts"] == ["m.shifted"] and v1["scores"] == v2["scores"]
    alert = pol.metrics.counter("drift_alert", "psi over threshold", labelnames=("site",))
    assert alert.get(site="m.shifted") == 2 and alert.get(site="m.stationary") == 0
    prev = dispatch.set_policy(pol)
    try:
        assert DriftMonitor(prefix="m.").policy is pol
    finally:
        dispatch.set_policy(prev)


# --------------------------------------------------------- site_telemetry --
def test_site_telemetry_edge_cases():
    pol = dispatch.PhiExecutionPolicy()
    assert pol.site_telemetry() == []
    pol.register_usage("lm.wq", _zipf_hist(2, 16, 400, 0))
    assert pol.site_telemetry(prefix="nomatch.") == []
    assert [r["site"] for r in pol.site_telemetry(prefix="lm.")] == ["lm.wq"]
    pol._record_decision(dispatch.Decision(impl="coo", reason="unit", site="lm.ghost",
                                           shape=(8, 64, 64, 2, 16), backend="cpu"))
    row = {r["site"]: r for r in pol.site_telemetry()}["lm.ghost"]
    assert row["impl"] == "coo" and row["executions"] == 0 and row["drift_score"] is None
    for _ in range(4):
        pol._record_nnz("lm.sharded", 64, 128, 8, np.array([3, 5]), shards=4)
    (row,) = pol.site_telemetry(prefix="lm.sharded")
    assert row["shards"] == 4 and row["executions"] == 4 and row["warm"]
    pol.reset(keep_usage=True)
    assert pol.usage_for("lm.wq") is not None
    pol.reset()
    assert pol.usage_for("lm.wq") is None


# ------------------------------------------------ engine reset regression --
def test_engine_back_to_back_runs_report_identical_counts():
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import init_params
    from repro_torch.models import model
    from repro_torch.serve.engine import Engine, Request

    cfg = get_config("olmo_1b", smoke=True)
    params = init_params(model.lm_specs(cfg), torch.Generator().manual_seed(0), "cpu")

    def go():
        eng = Engine(cfg, params, batch_slots=2, max_context=32, paged=True, page_size=8)
        rng = np.random.default_rng(5)
        for i in range(3):
            eng.submit(Request(rid=i, tokens=[int(t) for t in rng.integers(3, cfg.vocab, 7)],
                               max_new_tokens=3))
        eng.run()
        return eng

    a, b = go(), go()
    assert a.metrics.snapshot() == b.metrics.snapshot()
    assert a.scheduler.report() == b.scheduler.report()
    assert a.decoded_tokens == b.decoded_tokens > 0
    b.reset_telemetry(include_policy=False)
    assert b.decoded_tokens == 0 and b.ticks == 0
    assert b.scheduler.report() == {} and b.logit_trace == {}
    assert b.metrics.get("decoded_tokens").total() == 0
