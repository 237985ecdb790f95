"""The phase tool's patch tables against the current kernel sources, on the CPU.

``repro_torch.kernels.phases`` takes kernels apart on the card by building
copies of their CUDA sources with text patches. A patch whose anchor the
source no longer holds once stops a chip run; here every table is applied
without nvcc, so a redesign that leaves a table stale fails on the CPU.
"""
from __future__ import annotations

import pytest

from repro_torch.kernels import _build, phases

KINDS = {kind: (fname, table, cycles) for fname, kind, table, cycles in phases.PATCHES}


def test_every_kernel_of_the_tool_is_covered():
    assert sorted(KINDS) == ["attn", "first", "matcher", "stream"]


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_patch_tables_apply_to_the_current_sources(kind):
    """Each variant of one kernel: every anchor found exactly once, the copy
    differs from the full source, and the all-off copy holds every patch."""
    fname, table, cycles = KINDS[kind]
    src = (_build.CSRC / fname).read_text()
    variants = phases._variants(kind)
    want = {f"{kind}_full", f"{kind}_all_off", *(f"{kind}_{name}" for name in table)}
    if cycles:
        want.add(f"{kind}_cycles")
    assert set(variants) == want
    assert variants[f"{kind}_full"] == src
    for name, text in variants.items():
        if name != f"{kind}_full":
            assert text != src, name
    for patches in table.values():
        for old, new in patches:
            assert src.count(old) == 1, old
            assert new in variants[f"{kind}_all_off"], new
    if cycles:
        assert variants[f"{kind}_cycles"].endswith(phases._CYCLES_READ)


def test_a_stale_anchor_stops_the_tool():
    with pytest.raises(RuntimeError, match="patch anchor not found once"):
        phases._patch("x.cu", "int a;\nint a;\n", [("int a;", "int b;")])
