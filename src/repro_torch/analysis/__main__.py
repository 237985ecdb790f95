"""``python -m repro_torch.analysis``: run both layers and gate on the
committed baseline.

Exit codes:
  0  no finding outside the baseline, and every baseline entry justified and,
     where its rule ran, still live
  1  a finding outside the baseline
  2  an invalid baseline: an entry with no justification, or a stale entry
     (its rule ran and no finding matched it)

On the card (``torch.cuda.is_available()`` with nvcc), ``--layer contracts``
or ``all`` builds the kernel library and also holds each plan and model
against its exports and ptxas's lines.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis import contracts, lint

_BASELINE = Path(__file__).with_name("baseline.json")
_REPO_ROOT = Path(__file__).resolve().parents[3]


def load_baseline(path: Path | None = None) -> tuple[dict[str, str], list[str]]:
    """{finding key: justification}, and the invalid entries (default: the
    committed ``baseline.json``)."""
    path = _BASELINE if path is None else path
    if not path.exists():
        return {}, []
    allow: dict[str, str] = {}
    bad: list[str] = []
    for e in json.loads(path.read_text()):
        key, just = e.get("key", ""), e.get("justification", "")
        if not key or not just.strip():
            bad.append(f"baseline entry {e!r} lacks a key or a justification "
                       "(no bare suppressions)")
        else:
            allow[key] = just
    return allow, bad


def _library():
    """The built kernel library and ptxas's lines where a card and nvcc are
    here, else (None, None)."""
    import torch

    if not torch.cuda.is_available():
        return None, None
    from repro_torch.kernels import _build

    return _build.library(), list(_build.build_info.get("ptxas", []))


def run(root: Path | None = None, *, layers: str = "all") -> tuple[list, set[str]]:
    """(findings, the rule ids that ran)."""
    root = _REPO_ROOT if root is None else root
    findings: list = []
    ran: set[str] = set()
    if layers in ("all", "lint"):
        findings += lint.lint_paths(root)
        ran |= set(lint.RULES)
    if layers in ("all", "contracts"):
        from repro_torch.analysis.registry import run_contracts

        lib, ptxas = _library()
        findings += run_contracts(lib=lib, ptxas=ptxas)
        ran |= set(contracts.RULES)
        if lib is not None:
            ran.add("card")
    return findings, ran


def _stale(key: str, ran: set[str]) -> bool:
    """Whether an unmatched entry's rule ran (a card-only finding, keyed on
    ptxas, runs only with the library)."""
    rule = key.split(":", 1)[0]
    if rule not in ran:
        return False
    return ":ptxas:" not in key or "card" in ran


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the structured findings report here")
    ap.add_argument("--layer", choices=("all", "lint", "contracts"), default="all")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, ignoring the allowlist")
    args = ap.parse_args(argv)

    findings, ran = run(layers=args.layer)
    allow, invalid = ({}, []) if args.no_baseline else load_baseline()
    live, allowlisted = [], []
    for f in findings:
        (allowlisted if f.key in allow else live).append(f)
    matched = {f.key for f in allowlisted}
    stale = sorted(k for k in set(allow) - matched if _stale(k, ran))

    report = {
        "findings": [f.to_json() for f in live],
        "allowlisted": [f.to_json() | {"justification": allow[f.key]} for f in allowlisted],
        "stale_baseline": stale,
        "invalid_baseline": invalid,
        "card": "card" in ran,
        "summary": {"live": len(live), "allowlisted": len(allowlisted), "stale": len(stale),
                    "invalid": len(invalid)},
    }
    if args.json:
        Path(args.json).write_text(json.dumps(report, indent=2) + "\n")
    for f in live:
        print(f"FINDING  {f.key}\n         {f.message}")
    for f in allowlisted:
        print(f"allowed  {f.key}  ({allow[f.key]})")
    for k in stale:
        print(f"STALE    baseline entry no longer matches any finding: {k}")
    for msg in invalid:
        print(f"INVALID  {msg}")
    print(f"repro_torch.analysis: {len(live)} finding(s), {len(allowlisted)} allowlisted, "
          f"{len(stale)} stale, {len(invalid)} invalid baseline entr(y/ies)"
          + (" [card: library exports and ptxas checked]" if "card" in ran else ""))
    if invalid or stale:
        return 2
    return 1 if live else 0


if __name__ == "__main__":
    sys.exit(main())
