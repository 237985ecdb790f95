"""The harness on the CPU at smoke sizes: files, result line, faults, control."""
import copy
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from phibench import harness, spec, stats

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SEED = 2**33 + 7
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def lm_cell(limit=0.005, logit_limit=0.005):
    c = spec.cell("olmo-1b-phi.decode-32")
    c.config = copy.deepcopy(c.config)
    c.config["program"] = {"arch": "olmo_1b", "smoke": True,
                           "overrides": {"compute_dtype": "bfloat16"},
                           "phi_variant": {"timesteps": 4, "q": 16, "k": 16}}
    c.config["sizes"].update(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
                             vocab=128)
    c.config["calibration_batch"] = [2, 16]
    c.config["weights_seed"] = 1
    c.traffic = dict(c.traffic, concurrency=4, block=4, prompt_len=[8, 40],
                     new_tokens=[2, 4], max_context=64,
                     check={"served_tokens": 4, "served_logit_gap_mean": limit,
                            "logit_err_mean": logit_limit})
    return c


def snn_cell(limit=1e-4):
    c = spec.cell("spikformer-4-384.b128")
    c.config = copy.deepcopy(c.config)
    c.config["sizes"].update(dim=32, heads=2, blocks=1)
    c.config["program"]["phi"] = {"k": 16, "q": 16, "iters": 5}
    c.config["calibration_batch"] = 8
    c.traffic = dict(c.traffic, batch=4, distinct_batches=2, warmup_batches=2,
                     check={"logit_mean_err": limit})
    return c


def run(cell, trace=False, control=False):
    # long enough for a few requests to finish on a CPU that other test
    # workers load
    seconds = 8.0 if cell.traffic["kind"] == "lm_closed_loop" else 2.0
    return harness.run_cell(cell, SEED, seconds, trace, torch.device("cpu"), 0.0, control)


def test_benchmark_names_and_files():
    bench = spec.load_benchmark()
    assert bench["paths"] == ["phibench"]
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w["name"] for w in bench["workloads"]] + [c["name"] for c in bench["configs"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert all(0.01 <= m["bound"] <= 0.25 for m in bench["end_to_end"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))
    # a class of cell without a reader of its own is read by the base's
    assert spec.metric_reader("idle_share.any-class").__module__ == "phibench.metrics.idle_share"
    for w in bench["workloads"]:
        cell = spec.cell(w["name"], bench)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        assert all(m["moves"] in e2e for m in cell.per_layer)
        assert spec.driver(cell.traffic) and spec.reference(cell.config)
        assert cell.config["name"] == w["config"]
        assert set(cell.config["reduced"]) <= set(cell.config)


def test_readers_find_nothing_in_an_empty_run():
    bench = spec.load_benchmark()
    empty = harness.Run(cell=spec.cell("olmo-1b-phi.decode-32", bench), seed=0, trace=True,
                        device=torch.device("cpu"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] != "setup_s":
            assert spec.metric_reader(m["name"])(empty) is None, m["name"]
    assert stats.percentile([3.0, 1.0, 2.0, 4.0], 95) == 4.0
    assert stats.percentile([float(i) for i in range(1, 101)], 95) == 95.0


ALL_METRICS = [m["name"] for m in spec.load_benchmark()["end_to_end"]
               + spec.load_benchmark()["per_layer"]]
# What each reader reads from the run below, worked by hand.
BY_HAND = {"setup_s": 1.5, "images_per_s": 50.0, "batch_ms_p95": 30.0,
           "prompt_tokens_per_s": 40.0, "output_tokens_per_s": 25.0, "tick_ms_p50": 100.0,
           "ttft_ms_p50": 7.0, "prefill_ms_p50": 5.0, "mfu": 1.0, "idle_share": 25.0,
           "phi_gemm_roofline": 10.0}


@pytest.mark.parametrize("name", ALL_METRICS)
def test_each_metric_is_read_by_its_own_or_its_base_reader(name):
    """Each metric of the benchmark is read by ``metrics/<name>.py`` or, for a
    class of cell without one, by ``metrics/<base>.py``, from a run whose
    records and trace were worked by hand."""
    from phibench.devtrace import Summary
    from phibench.work import BF16_FLOP_PER_S, Work

    base = name.split(".")[0]
    read = spec.metric_reader(name)
    own = (HERE / "metrics" / f"{name}.py").exists()
    assert read.__module__ == f"phibench.metrics.{name if own else base}"
    assert own or (HERE / "metrics" / f"{base}.py").exists()
    run = harness.Run(cell=spec.cell("olmo-1b-phi.decode-32"), seed=0, trace=True,
                      device=torch.device("cpu"), setup_s=1.5, window_s=2.0,
                      work=Work(flops=0.02 * BF16_FLOP_PER_S, gemm_least_s=0.1),
                      records={"images": 100, "batch_ms": [10.0, 20.0, 30.0],
                               "prompt_tokens": 80, "output_tokens": 50,
                               "ticks": [(0.0, 0.1, 0), (0.1, 0.5, 1)],
                               "ttft_ms": [7.0], "prefill_ms": [5.0]},
                      summary=Summary(window_s=2.0, busy_s=1.5,
                                      device_s_by_name={"phi_fused_stream_kernel": 1.0,
                                                        "lif_kernel": 0.5},
                                      breakdown={}))
    assert read(run) == pytest.approx(BY_HAND[base])


@pytest.mark.parametrize("make", [lm_cell, snn_cell], ids=["lm", "snn"])
@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_result_line(make, trace):
    cell = make()
    res = run(cell, trace=trace)
    assert [k for k in res if k != "breakdown"] == KEYS
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(res["metrics"]) <= want
    if not trace:
        assert set(res["metrics"]) == want
    assert res["device"]["count"] == 1
    if trace:
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert res["device"]["window_s"] > 0
    json.dumps(res)


def test_lm_token_altered_is_not_correct(monkeypatch):
    from repro_torch.serve import engine

    real = engine.sample

    def altered(logits, gen, **kw):
        out = real(logits, gen, **kw)
        return (out + 1) % logits.shape[-1]

    monkeypatch.setattr(engine, "sample", altered)
    assert not run(lm_cell())["correct"]


def test_lm_logits_altered_is_not_correct(monkeypatch):
    """Logits scaled where the decode step produces them keep every served
    token (the same argmax) and the served gap; the logit rows catch it."""
    from repro_torch.models import model

    real = model.decode_step

    def scaled(*a, **k):
        logits, state = real(*a, **k)
        return logits * 1.25, state

    monkeypatch.setattr(model, "decode_step", scaled)
    res = run(lm_cell())
    assert not res["correct"]
    assert res["checks"]["served_logit_gap_mean"]["value"] <= 0.005
    assert res["checks"]["logit_err_mean"]["value"] > 0.005


def test_snn_half_batch_left_out_is_not_correct(monkeypatch):
    from repro_torch.snn import models as M

    real = M.phi_apply

    def half(params, cfg, phi, x, *a, **k):
        out = real(params, cfg, phi, x[: x.shape[0] // 2], *a, **k)
        return torch.cat([out, out.mean(0, keepdim=True).expand_as(out)])

    monkeypatch.setattr(M, "phi_apply", half)
    assert not run(snn_cell())["correct"]


def test_snn_answer_altered_is_not_correct(monkeypatch):
    from repro_torch.snn import models as M

    real = M.phi_apply

    def altered(*a, **k):
        out = real(*a, **k).clone()
        out[0, 0] += 0.5
        return out

    monkeypatch.setattr(M, "phi_apply", altered)
    assert not run(snn_cell())["correct"]


def test_lm_control_is_not_correct():
    cell = lm_cell()
    res = run(cell, control=True)
    limit = cell.traffic["check"]["served_logit_gap_mean"]
    assert res["checks"]["served_logit_gap_mean"]["value"] <= limit
    assert res["control"]["float8_activations"]["gap_mean"] > limit
    logit_limit = cell.traffic["check"]["logit_err_mean"]
    assert res["checks"]["logit_err_mean"]["value"] <= logit_limit
    for name in ("float8_activations", "bfloat16_gemm"):
        assert res["control"][name]["logit_err_mean"] > logit_limit


def test_snn_control_is_not_correct():
    cell = snn_cell()
    cell.config["sizes"].update(dim=96, heads=3, blocks=2)
    cell.traffic["batch"] = 16
    res = run(cell, control=True)
    limit = cell.traffic["check"]["logit_mean_err"]
    assert res["checks"]["logit_mean_err"]["value"] <= limit
    assert res["control"]["tf32"]["mean_err"] > limit


def _bare_run(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "phibench/run.py", "--workload",
                           "spikformer-4-384.b128", "--seed", str(SEED), "--seconds", "1",
                           "--trace", "0"], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=120)


def test_no_card_no_result():
    proc = _bare_run(ROOT)
    assert proc.returncode != 0 and proc.stdout == ""


def test_no_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "phibench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _bare_run(tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_spikformer_cell_on_the_card(card):
    res = harness.run_cell(spec.cell("spikformer-4-384.b128"), SEED, 2.0, False, card, 0.0)
    assert res["correct"] and res["metrics"]["images_per_s"]["value"] > 0
