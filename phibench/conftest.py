"""A span record of the program, planted by hand, for the tests of the
per-layer metrics that read the program's own spans
(``phibench/metrics/_spans.py``), with what each of them reads from it."""
import pytest


def _span(name, ms0, ms1=None, id=None, parent=None, **attrs):
    ms1 = ms0 if ms1 is None else ms1
    return {"name": name, "id": id, "parent": parent, "start_ns": int(ms0 * 1e6),
            "end_ns": int(ms1 * 1e6), **attrs}


# The spans (ms): tick 1 admits request 1 (its prefill 30, its sampling 5, a
# decode step 20 and its sampling 20); ticks 6 and 9 admit nothing; request 2
# is still queued; three SNN batches.
PLANTED_SPANS = [
    _span("serve.submit", 0, rid=1), _span("serve.submit", 0, rid=2),
    _span("serve.admit", 10, parent=1, rid=1, slot=0),
    _span("serve.prefill", 10, 40, 2, 1, rid=1, slot=0, bucket=64, prompt_len=40),
    _span("serve.sample", 40, 45, 3, 1, rid=1, rows=1),
    _span("serve.first_token", 45, parent=1, rid=1, slot=0),
    _span("serve.decode_step", 50, 70, 4, 1, rows=1), _span("serve.sample", 70, 90, 5, 1, rows=1),
    _span("serve.tick", 0, 100, 1, admitted=1, rows=1),
    _span("serve.decode_step", 100, 160, 7, 6, rows=1), _span("serve.sample", 160, 190, 8, 6, rows=1),
    _span("serve.tick", 100, 200, 6, admitted=0, rows=1),
    _span("serve.decode_step", 200, 230, 10, 9, rows=1), _span("serve.sample", 230, 250, 11, 9, rows=1),
    _span("serve.tick", 200, 260, 9, admitted=0, rows=1),
    _span("snn.phi_apply", 300, 304, 12, rows=4), _span("snn.phi_apply", 310, 316, 13, rows=4),
    _span("snn.phi_apply", 320, 328, 14, rows=4)]

# What each reader of the spans reads from PLANTED_SPANS, worked by hand; the
# host share is over the 2 s window of the hand-worked run of
# ``test_phibench_harness.py``: (100 - 30 - 20) + (100 - 60) + (60 - 30) ms.
SPAN_BY_HAND = {"tick_span_ms_p50": 80.0, "decode_step_ms_p50": 45.0, "sample_ms_p50": 25.0,
                "host_share": 6.0, "prefill_span_ms_p50": 30.0, "ttft_span_ms_p50": 45.0,
                "queue_wait_ms_p50": 10.0, "phi_apply_host_ms_p50": 6.0}


@pytest.fixture
def planted_spans(monkeypatch):
    """The program's record of the traced window holds PLANTED_SPANS for the
    test, and what it held before afterwards."""
    from repro_torch.obs import trace

    monkeypatch.setattr(trace, "_RECORD", list(PLANTED_SPANS))
    return PLANTED_SPANS


@pytest.fixture(autouse=True)
def _span_metrics_read_by_hand(request, monkeypatch):
    """``test_phibench_harness.py`` reads each metric of the benchmark from a
    run worked by hand; for a metric that reads the program's spans, that run
    has PLANTED_SPANS as its window's record and SPAN_BY_HAND as its value."""
    node = request.node
    if getattr(node, "originalname", None) != "test_each_metric_is_read_by_its_own_or_its_base_reader":
        return
    base = node.callspec.params["name"].split(".")[0]
    if base in SPAN_BY_HAND:
        request.getfixturevalue("planted_spans")
        monkeypatch.setitem(request.module.BY_HAND, base, SPAN_BY_HAND[base])
