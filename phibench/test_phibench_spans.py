"""The per-layer metrics that read the program's own spans, on the CPU: each
reads its hand-worked value from a planted record, nothing from a program
that keeps no record, and a number from a traced run of the program."""
import pytest
import torch

from phibench import harness, spec
from phibench.conftest import SPAN_BY_HAND
from phibench.devtrace import Summary
from phibench.test_phibench_harness import lm_cell, run, snn_cell

SPAN_METRICS = [m["name"] for m in spec.load_benchmark()["per_layer"]
                if m["name"].split(".")[0] in SPAN_BY_HAND]


def traced_run(summary=True):
    return harness.Run(cell=spec.cell("olmo-1b-phi.decode-32"), seed=0, trace=True,
                       device=torch.device("cpu"), setup_s=1.5, window_s=2.0,
                       summary=Summary(window_s=2.0, busy_s=1.5, device_s_by_name={},
                                       breakdown={}) if summary else None)


def test_every_reader_of_the_spans_is_in_the_benchmark():
    assert {n.split(".")[0] for n in SPAN_METRICS} == set(SPAN_BY_HAND)
    assert len(SPAN_METRICS) == 9


@pytest.mark.usefixtures("planted_spans")
@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_reader_reads_the_planted_record(name):
    read = spec.metric_reader(name)
    assert read(traced_run()) == pytest.approx(SPAN_BY_HAND[name.split(".")[0]])
    # no traced window, no reading, whatever the record holds
    assert read(traced_run(summary=False)) is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_reader_finds_nothing_in_a_program_without_spans(name, monkeypatch):
    """A program that keeps no span record, as the one before the spans, and
    one whose record holds none of the reader's spans, give no reading."""
    from repro_torch.obs import trace

    read = spec.metric_reader(name)
    monkeypatch.setattr(trace, "_RECORD", [])
    assert read(traced_run()) is None
    monkeypatch.delattr(trace, "profiled_spans")
    assert read(traced_run()) is None


@pytest.mark.parametrize("make", [lm_cell, snn_cell], ids=["lm", "snn"])
def test_traced_result_line_reads_the_spans(make):
    cell = make()
    res = run(cell, trace=True)
    assert res["correct"]
    want = {m["name"] for m in cell.per_layer} & set(SPAN_METRICS)
    # a tick that admits nothing, which the tick metrics and its parts read,
    # may not come in a short run
    if "tick_ms_p50.decode" not in res["metrics"]:
        want -= {"tick_span_ms_p50.decode", "decode_step_ms_p50.decode",
                 "sample_ms_p50.decode"}
    assert want and want <= set(res["metrics"])
    assert all(res["metrics"][n]["value"] >= 0 for n in want)
