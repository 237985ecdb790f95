"""The port's static checker, ``repro_torch.analysis``: every rule fires on a
fixture, the registry covers every lowering, the production tree is clean,
and the baseline and CLI gate as the reference's ``repro.analysis`` does
(``tests/test_analysis.py``). CPU only: the card's half of the contracts
(library exports, ptxas) runs in ``chip_smoke.py``'s ``analysis`` phase.
"""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from repro_torch.analysis import contracts, lint
from repro_torch.analysis.contracts import Cover
from repro_torch.analysis.registry import (
    ATTN_CASES, CONTRACTS, DECODE_CASES, LIF_CASES, MATMUL_CASES, run_contracts)

ROOT = Path(__file__).resolve().parents[1]


def _rules(findings) -> set[str]:
    return {f.rule for f in findings}


# ------------------------------------------------------------ fixtures: L1 ---
def test_fixture_uncovered_tail_flagged():
    """A grid of floor(M / 32) blocks leaves the tail rows unwritten."""
    got = contracts.check_coverage("k", "c", [Cover("M", 293, 293 // 32, 32, "m < M")],
                                   "if (m < M)")
    assert _rules(got) == {contracts.RULE_COV_GRID} and got[0].detail == "M"


def test_fixture_unguarded_tail_flagged():
    """ceil(M / 32) blocks reach past M: the source must hold the guard."""
    cover = [Cover("M", 293, 10, 32, "if (row >= M) continue;")]
    assert contracts.check_coverage("k", "c", cover, "if (row >= M) continue;") == []
    got = contracts.check_coverage("k", "c", cover, "out[row] = v;")
    assert _rules(got) == {contracts.RULE_COV_GRID} and got[0].detail == "M:guard"
    # a grid-stride loop needs its guard too, whatever its grid
    stride = [Cover("n", 10 ** 6, 4, 256, "i < n;", stride=True)]
    assert contracts.check_coverage("k", "c", stride, "for (;;)") != []


def test_fixture_plain_lowering_shape_and_plan_export_flagged():
    assert _rules(contracts.check_shape("coo", "c", (256, 8), (293, 8))) == {
        contracts.RULE_COV_GRID}
    assert contracts.check_plan("k", "c", (10, 2), (10, 2)) == []
    assert contracts.check_plan("k", "c", (10, 2), (9, 2))[0].detail == "plan:export"


def test_fixture_counter_past_its_exact_range_flagged():
    assert contracts.check_counter("k", "c", "l2_nnz", 2 ** 31 - 1, "int32") == []
    assert _rules(contracts.check_counter("k", "c", "l2_nnz", 2 ** 31, "int32")) == {
        contracts.RULE_ACC_WIDTH}
    # a float counter is exact only to 2^24
    assert contracts.check_counter("k", "c", "nnz", 2 ** 24 + 1, "float32") != []


def test_fixture_smem_model_flagged():
    """Past 227 KB where the gate admits the shape, or below the library's
    export."""
    limit = 232448
    assert contracts.check_smem("k", "c", limit, limit, True) == []
    assert contracts.check_smem("k", "c", limit + 16, limit, False) == []
    assert _rules(contracts.check_smem("k", "c", limit + 16, limit, True)) == {
        contracts.RULE_SMEM_MODEL}
    got = contracts.check_smem("k", "c", 4096, limit, True, real=4112)
    assert [f.detail for f in got] == ["smem:export"]


PTXAS = [
    "ptxas info    : Compiling entry function '_ZN2_17attn_kernelILb0ELi1EEEv' for 'sm_90a'",
    "ptxas info    : Function properties for _ZN2_17attn_kernelILb0ELi1EEEv",
    "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
    "ptxas info    : Compiling entry function '_ZN2_13lif_step_kernelEv' for 'sm_90a'",
    "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
]


def test_fixture_ptxas_spill_flagged():
    spills = contracts.ptxas_spills(PTXAS)
    assert spills == {"_ZN2_17attn_kernelILb0ELi1EEEv": 8, "_ZN2_13lif_step_kernelEv": 0}
    got = contracts.check_spills("phi_flash_attention", ("attn_kernel",), spills)
    assert [f.key for f in got] == ["PHI-SMEM-MODEL:phi_flash_attention:ptxas:spill:attn_kernel"]
    assert contracts.check_spills("lif_sequence", ("lif_step_kernel",), spills) == []


# ------------------------------------------------------------ fixtures: L2 ---
FIXTURES = {
    lint.RULE_IMPORT: ("import jax.numpy as jnp\nfrom repro.kernels import ops\n"
                       "from repro_torch.kernels import ops as ok\n", 2),
    lint.RULE_FALLBACK: (
        "def f(x):\n"
        "    try:\n"
        "        return phi_fused_cuda(x)\n"
        "    except RuntimeError:\n"
        "        return phi_fused_plain(x)\n"
        "def g(x):\n"
        "    try:\n"
        "        _build.library()\n"
        "    except OSError as e:\n"
        "        raise RuntimeError('no library') from e\n", 1),
    lint.RULE_HWCONST: ("HBM_B_PER_S = 3.35e12\nSM_SMEM = 228 * 1024\n"
                        "from x import HBM_BW\nMY_TILE = 32\n", 2),
    lint.RULE_PLACEMENT_DUP: ("P = (None, ('model', 'data'), 'data')\nQ = ('data', 'model')\n"
                              "R = ('data', 'x', 'data')\n", 1),
    lint.RULE_HOSTSYNC: (
        "def l2_spmm_cuda(x):\n"
        "    n = x.sum().item()\n"
        "    if torch.any(x < 0):\n"
        "        raise ValueError\n"
        "    return x.tolist()\n"
        "def helper(x):\n"
        "    return x.item()\n", 3),
}


@pytest.mark.parametrize("rule", lint.RULES)
def test_fixture_lint_rule_fires(rule):
    src, n = FIXTURES[rule]
    path = ("src/repro_torch/kernels/fixture.py" if rule == lint.RULE_HOSTSYNC
            else "src/repro_torch/fixture.py")
    got = [f for f in lint.lint_source(src, path) if f.rule == rule]
    assert len(got) == n, got
    assert all(f.key.startswith(f"{rule}:{path}:") for f in got)


def test_hwconst_allowed_in_its_home_and_hostsync_only_in_scope():
    assert lint.lint_source("HBM_B_PER_S = 3.35e12\n", "src/repro_torch/core/hwconst.py") == []
    src = "def f(x):\n    return x.item()\n"
    assert lint.lint_source(src, "src/repro_torch/sim/trace.py") == []
    assert _rules(lint.lint_source(src, "src/repro_torch/models/model.py")) == {
        lint.RULE_HOSTSYNC}


# ------------------------------------------------------- registry + tree ---
def test_registry_covers_every_lowering_and_the_kernels_outside_the_policy():
    from repro_torch.kernels import ATTN_IMPLS, IMPLS

    covered = {c for entry in CONTRACTS for c in entry.covers}
    assert set(IMPLS) | set(ATTN_IMPLS) | {"lif", "decode"} <= covered
    for entry in CONTRACTS:
        if entry.source is not None:
            assert (ROOT / "src" / "repro_torch" / "kernels" / "csrc" / entry.source).exists()


def test_registry_completeness_gate_raises_on_an_uncovered_lowering(monkeypatch):
    from repro_torch import kernels
    from repro_torch.analysis import registry

    monkeypatch.setattr(kernels, "IMPLS", kernels.IMPLS + ("prosperity",))
    with pytest.raises(AssertionError, match="prosperity"):
        registry._assert_complete()


def test_shape_matrix_holds_a_non_divisible_extent_in_every_dim():
    assert any(c.M % 32 for c in MATMUL_CASES) and any(c.N % 128 for c in MATMUL_CASES)
    assert any(c.T % 2 for c in MATMUL_CASES) and any(c.q % 16 for c in MATMUL_CASES)
    assert any(c.S % 64 for c in ATTN_CASES) and any(c.D % 16 for c in ATTN_CASES)
    assert any(c.Smax % 64 for c in DECODE_CASES) and any(c.D % 64 for c in DECODE_CASES)
    assert any(c.n % 256 for c in LIF_CASES)


@pytest.mark.parametrize("entry", CONTRACTS, ids=lambda c: c.name)
def test_production_contracts_pass_clean(entry):
    assert run_contracts((entry.name,)) == []


def test_a_dropped_guard_is_caught_on_the_real_kernel(monkeypatch):
    """The coverage check is not vacuous: the decode kernel's source with its
    key-tail guard removed fails PHI-COV-GRID at the ragged cache length."""
    from repro_torch.analysis import registry

    src = registry._source("decode_attention.cu")
    monkeypatch.setattr(registry, "_source", lambda name: src.replace(
        "const int rows = min(CHUNK, Smax - c0);", "const int rows = CHUNK;"))
    got = run_contracts(("decode_attention",))
    assert [f.key for f in got] == ["PHI-COV-GRID:decode_attention:dec_tail:Smax:guard"]


def test_production_tree_lints_clean_and_imports_no_jax():
    findings = lint.lint_paths(ROOT)
    from repro_torch.analysis.__main__ import load_baseline

    allow, bad = load_baseline()
    assert bad == []
    assert [f.key for f in findings if f.key not in allow] == []
    assert not [f for f in findings if f.rule == lint.RULE_IMPORT]


# ------------------------------------------------------------ baseline/CLI --
def test_baseline_requires_justifications(tmp_path):
    from repro_torch.analysis.__main__ import load_baseline

    p = tmp_path / "baseline.json"
    p.write_text(json.dumps([{"key": "PHI-LINT-HWCONST:x.py:FREQ"}]))
    allow, bad = load_baseline(p)
    assert allow == {} and len(bad) == 1
    p.write_text(json.dumps([{"key": "PHI-LINT-HWCONST:x.py:FREQ",
                              "justification": "a vendored table"}]))
    allow, bad = load_baseline(p)
    assert bad == [] and "PHI-LINT-HWCONST:x.py:FREQ" in allow


def test_cli_reports_live_findings_and_exits_1(tmp_path, monkeypatch):
    import repro_torch.analysis.__main__ as main_mod

    root = tmp_path / "repo"
    (root / "src" / "repro_torch").mkdir(parents=True)
    (root / "src" / "repro_torch" / "bad.py").write_text("P = ('data', 'data')\n")
    monkeypatch.setattr(main_mod, "_REPO_ROOT", root)
    monkeypatch.setattr(main_mod, "_BASELINE", tmp_path / "none.json")
    out = tmp_path / "report.json"
    assert main_mod.main(["--layer", "lint", "--json", str(out)]) == 1
    report = json.loads(out.read_text())
    assert report["summary"]["live"] == 1
    assert report["findings"][0]["rule"] == lint.RULE_PLACEMENT_DUP


def test_cli_exits_2_on_a_stale_or_bare_entry_and_0_when_clean(tmp_path, monkeypatch):
    import repro_torch.analysis.__main__ as main_mod

    root = tmp_path / "repo"
    (root / "src" / "repro_torch").mkdir(parents=True)
    (root / "src" / "repro_torch" / "ok.py").write_text("X = 1\n")
    monkeypatch.setattr(main_mod, "_REPO_ROOT", root)
    base = tmp_path / "baseline.json"
    monkeypatch.setattr(main_mod, "_BASELINE", base)
    base.write_text("[]")
    assert main_mod.main(["--layer", "lint"]) == 0
    base.write_text(json.dumps([{"key": "PHI-LINT-HWCONST:src/repro_torch/ok.py:X",
                                 "justification": "fixed long ago"}]))
    assert main_mod.main(["--layer", "lint"]) == 2          # stale
    # an entry of a rule that did not run (contracts) is not stale under --layer lint
    base.write_text(json.dumps([{"key": "PHI-COV-GRID:k:c:M", "justification": "x"}]))
    assert main_mod.main(["--layer", "lint"]) == 0
    # a ptxas entry is stale only where the card's checks ran
    base.write_text(json.dumps([{"key": "PHI-SMEM-MODEL:k:ptxas:spill:k", "justification": "x"}]))
    assert main_mod.main(["--layer", "contracts"]) == 0
    base.write_text(json.dumps([{"key": "PHI-LINT-HWCONST:a.py:X"}]))
    assert main_mod.main(["--layer", "lint"]) == 2          # bare


def test_cli_on_the_committed_tree_exits_0():
    import repro_torch.analysis.__main__ as main_mod

    assert main_mod.main([]) == 0
