"""Finds a cell's files by the names in ``BENCHMARK.json``.

* a configuration ``<config>``: the ``file`` its entry names, under
  ``configs/``; its ``reference`` key names a module of ``reference/``;
* a traffic mix: ``workloads/<cell>.json``, whose ``kind`` names a module of
  ``drivers/``;
* a metric ``<metric>``: ``metrics/<metric>.py``, whose ``read(run)`` returns
  the metric's value or None where the run has nothing to read; a metric
  ``<base>.<class>`` with no file of its own is read by ``metrics/<base>.py``.

A later change adds a configuration, a cell or a metric by adding such files
and entries; no file here needs an edit.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict                 # the configuration file
    traffic: dict                # the traffic file
    end_to_end: list[dict]       # the cell's end-to-end metric entries
    per_layer: list[dict]        # the cell's per-layer metric entries


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(entry: dict, cell: str, reported: set | None = None) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return reported is None or entry["moves"] in reported


def cell(name: str, bench: dict | None = None, root: Path = ROOT) -> Cell:
    bench = bench if bench is not None else load_benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
    conf_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((root / conf_entry["file"]).read_text())
    traffic = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, reported)]
    return Cell(name, entry["chips"], config, traffic, e2e, per_layer)


def driver(traffic: dict):
    return importlib.import_module(f"phibench.drivers.{traffic['kind']}")


def reference(config: dict):
    return importlib.import_module(f"phibench.reference.{config['reference']}")


def metric_reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``. A name ``<base>.<class>``
    (the class of cell that reports it) without a file of its own is read by
    ``metrics/<base>.py``, so one reader serves every class of cell."""
    stem = name
    while not (HERE / "metrics" / f"{stem}.py").exists() and "." in stem:
        stem = stem.rsplit(".", 1)[0]
    path = HERE / "metrics" / f"{stem}.py"
    spec = importlib.util.spec_from_file_location(f"phibench.metrics.{stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
