"""Layer-1 static analysis of the port's kernels: launch plans, counters and
shared-memory models, checked without a card.

Each hand-written kernel launches a grid of blocks, each block writing a
tile of its output; the Python side mirrors the plan (``registry``). The
checks read those plans and models over a shape matrix with a non-divisible
extent in every dimension:

  PHI-COV-GRID    every output element is some block's: along each output
                  dim the grid's blocks times the tile's extent reach the
                  dim, and where they overshoot it (a tail) the kernel's
                  source holds the guard the registry names. A plain
                  lowering (no kernel) is run at the case on the CPU and its
                  output must have the logical shape.
  PHI-ACC-WIDTH   an exact counter (the per-block int32 ``l2_nnz``, a float
                  counter) holds the registry's per-block bound within its
                  dtype's exact-integer range.
  PHI-SMEM-MODEL  a Python shared-memory model stays within the 227 KB a
                  block may use wherever the policy's gate admits the shape;
                  on the card, with the library built, it is at least what
                  the library's export says the kernel uses, and ptxas
                  reports no spill for the kernel.

The checks are pure functions of ints; the registry calls them.
"""
from __future__ import annotations

import dataclasses
import re

RULE_COV_GRID = "PHI-COV-GRID"
RULE_ACC_WIDTH = "PHI-ACC-WIDTH"
RULE_SMEM_MODEL = "PHI-SMEM-MODEL"
RULES = (RULE_COV_GRID, RULE_ACC_WIDTH, RULE_SMEM_MODEL)

# The largest n such that every integer in [0, n] is exact in the dtype.
EXACT_RANGE = {"bfloat16": 2 ** 8, "float16": 2 ** 11, "float32": 2 ** 24,
               "float64": 2 ** 53, "int16": 2 ** 15 - 1, "int32": 2 ** 31 - 1,
               "int64": 2 ** 63 - 1}


@dataclasses.dataclass(frozen=True)
class ContractFinding:
    rule: str
    kernel: str        # registry entry
    case: str          # shape-matrix case
    detail: str        # stable sub-key: the dim, counter or model
    message: str

    @property
    def key(self) -> str:
        return f"{self.rule}:{self.kernel}:{self.case}:{self.detail}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self) | {"key": self.key, "layer": "contracts"}


@dataclasses.dataclass(frozen=True)
class Cover:
    """How a launch covers one output dim: ``blocks`` along it, each writing
    ``per_block`` entries (``stride``: a grid-stride loop, whose blocks walk
    the dim until it ends), and the source text of the guard that stops a
    block at the dim's end."""

    dim: str
    extent: int
    blocks: int
    per_block: int
    guard: str | None = None
    stride: bool = False


def check_coverage(kernel: str, case: str, covers: list[Cover], source: str
                   ) -> list[ContractFinding]:
    out = []
    for c in covers:
        reach = c.blocks * c.per_block
        if c.extent == 0:
            continue
        if c.blocks < 1 or (reach < c.extent and not c.stride):
            out.append(ContractFinding(
                RULE_COV_GRID, kernel, case, c.dim,
                f"{c.blocks} blocks of {c.per_block} cover {reach} of the {c.extent} "
                f"entries along {c.dim}: the tail is never written"))
        elif (reach > c.extent or c.stride) and (c.guard is None or c.guard not in source):
            out.append(ContractFinding(
                RULE_COV_GRID, kernel, case, f"{c.dim}:guard",
                f"the grid reaches {reach} entries along {c.dim} of {c.extent}, and the "
                f"kernel's source holds no guard {c.guard!r}: the tail block writes past "
                "the output"))
    return out


def check_shape(kernel: str, case: str, got: tuple, want: tuple) -> list[ContractFinding]:
    if tuple(got) == tuple(want):
        return []
    return [ContractFinding(RULE_COV_GRID, kernel, case, "shape",
                            f"the plain lowering returns {tuple(got)} where the logical "
                            f"output is {tuple(want)}")]


def check_counter(kernel: str, case: str, name: str, bound: int, dtype: str
                  ) -> list[ContractFinding]:
    limit = EXACT_RANGE[dtype]
    if bound <= limit:
        return []
    return [ContractFinding(RULE_ACC_WIDTH, kernel, case, name,
                            f"counter {name} ({dtype}) may reach {bound} in one block, past "
                            f"its exact range {limit}")]


def check_smem(kernel: str, case: str, model: int, limit: int, admitted: bool,
               real: int | None = None, name: str = "smem") -> list[ContractFinding]:
    out = []
    if admitted and model > limit:
        out.append(ContractFinding(
            RULE_SMEM_MODEL, kernel, case, name,
            f"the model gives {model} bytes of shared memory where the gate admits the "
            f"shape, past the {limit} a block may use"))
    if real is not None and model < real:
        out.append(ContractFinding(
            RULE_SMEM_MODEL, kernel, case, f"{name}:export",
            f"the model gives {model} bytes where the library's export gives {real}: "
            "the model is below the kernel's real use"))
    return out


def check_plan(kernel: str, case: str, model: tuple, real: tuple) -> list[ContractFinding]:
    """A Python launch plan against the library's export of it."""
    if tuple(model) == tuple(real):
        return []
    return [ContractFinding(RULE_COV_GRID, kernel, case, "plan:export",
                            f"the Python plan {tuple(model)} differs from the library's "
                            f"{tuple(real)}: the coverage was checked on the wrong grid")]


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def ptxas_spills(lines: list[str]) -> dict[str, int]:
    """{mangled kernel: spill store + load bytes} from ptxas's ``-v`` lines
    (``_build.build_info["ptxas"]``)."""
    out: dict[str, int] = {}
    entry = None
    for line in lines:
        m = _ENTRY.search(line)
        if m:
            entry = m.group(1)
            continue
        m = _SPILL.search(line)
        if m and entry is not None:
            out[entry] = out.get(entry, 0) + int(m.group(1)) + int(m.group(2))
    return out


def check_spills(kernel: str, symbols: tuple[str, ...], spills: dict[str, int]
                 ) -> list[ContractFinding]:
    """A finding for each compiled entry of ``kernel`` (mangled names holding
    one of ``symbols``) that ptxas says spills."""
    out = []
    for entry, n in sorted(spills.items()):
        if n and any(s in entry for s in symbols):
            sym = next(s for s in symbols if s in entry)
            out.append(ContractFinding(
                RULE_SMEM_MODEL, kernel, "ptxas", f"spill:{sym}",
                f"ptxas spills {n} bytes (stores + loads) in {entry}"))
    # one finding per symbol: the entries of one template share a key
    seen, kept = set(), []
    for f in out:
        if f.key not in seen:
            seen.add(f.key)
            kept.append(f)
    return kept
