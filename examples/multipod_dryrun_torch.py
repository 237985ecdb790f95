"""Run one multi-pod dry-run cell of the PyTorch port and print its roofline.

    PYTHONPATH=src python examples/multipod_dryrun_torch.py --arch olmo_1b --shape decode_32k --phi
    PYTHONPATH=src python examples/multipod_dryrun_torch.py --arch yi_34b --shape train_4k  # CUDA build
    PYTHONPATH=src python examples/multipod_dryrun_torch.py --table   # every saved cell

The port's counterpart of ``examples/multipod_dryrun.py``: the cell's step is
traced for one rank on fake tensors in a fake world of 256 (``--multipod``:
512) ranks, no card needed (a train cell needs a PyTorch built with CUDA);
the terms are on the H100 SXM's data-sheet rates.
"""
import argparse
import glob
import json
import os
import sys

sys.path.insert(0, "src")

from repro_torch.launch import dryrun  # noqa: E402


def summary(rec: dict) -> str:
    """The cell's roofline, its per-rank memory and its kernel plan as text."""
    if "roofline" not in rec:
        return f"{rec['arch']} × {rec['shape']} on {rec['mesh']}: " \
               f"{rec.get('skipped') or rec.get('error')}"
    r, m = rec["roofline"], rec["memory"]
    return "\n".join([
        f"{rec['arch']} × {rec['shape']} on {rec['mesh']} (fake cuda), "
        f"roofline on the H100's data-sheet rates:",
        f"  compute    {r['compute_s']:.4f} s",
        f"  memory     {r['memory_s']:.4f} s",
        f"  collective {r['collective_s']:.4f} s",
        f"  bottleneck: {r['bottleneck']}  |  MFU {r['mfu']:.3f}  |  "
        f"useful-FLOP ratio {r['useful_ratio']:.2f}",
        f"  per rank: arguments {m['argument_bytes'] / 2**30:.2f} GiB, temporaries "
        f"{m['temp_bytes'] / 2**30:.2f} GiB",
        f"  kernel launches: {rec['launches']['kernels']}"])


_BOUND = {"compute": "C", "memory": "M", "collective": "N"}


def _cell(rec: dict | None) -> str:
    """One record in a table cell: ``skip``, ``ERR``, ``-`` (not run), or the
    bottleneck's letter (C compute, M memory, N collective) and the per-rank
    argument + temporary GiB."""
    if rec is None:
        return "-"
    if "skipped" in rec:
        return "skip"
    if "error" in rec:
        return "ERR"
    m, gib = rec["memory"], 2 ** 30
    return (f"{_BOUND[rec['roofline']['bottleneck']]} {m['argument_bytes'] / gib:.1f}"
            f"+{m['temp_bytes'] / gib:.0f}")


def table(results: str = dryrun.RESULTS) -> str:
    """A markdown table of every cell saved under ``results``: a row per
    arch, a column per shape, each cell plain 16x16 / plain 2x16x16 / Phi
    16x16 / Phi 2x16x16."""
    recs = {}
    for path in glob.glob(os.path.join(results, "*.json")):
        rec = json.load(open(path))
        if not rec.get("tag"):
            recs[(rec["arch"], rec["shape"], rec["mesh"], rec["phi"])] = rec
    order = [(mesh, phi) for phi in (False, True) for mesh in ("16x16", "2x16x16")]
    lines = ["| arch | " + " | ".join(dryrun.SHAPES) + " |",
             "| --- |" + " --- |" * len(dryrun.SHAPES)]
    for arch in dryrun.ARCH_IDS:
        lines.append(f"| {arch} | " + " | ".join(
            " / ".join(_cell(recs.get((arch, shape, mesh, phi))) for mesh, phi in order)
            for shape in dryrun.SHAPES) + " |")
    return "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo_1b")
    ap.add_argument("--shape", default="decode_32k", choices=list(dryrun.SHAPES))
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--phi", action="store_true")
    ap.add_argument("--table", action="store_true",
                    help="print every saved cell as a markdown table and exit")
    args = ap.parse_args()
    if args.table:
        print(table())
        return
    rec = dryrun.run_and_save(args.arch, args.shape, args.multipod, args.phi,
                              force=True, tag="example")
    print("\n" + summary(rec))


if __name__ == "__main__":
    main()
