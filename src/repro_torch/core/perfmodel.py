"""Packer-budget view of the execution policy's ``l2_nnz`` counters.

The part of the reference package's ``core/perfmodel.py`` that the policy's
``report()`` reads. The fused kernels are budget-free but emit per-M-block
``l2_nnz`` counters, which the policy aggregates per call site; this turns
them into the static capacity a budgeted pipeline (the ASIC packer, or the
``pallas``/``coo`` lowerings' per-block ``cap``) would have needed to run
the same workload without dropping an L2 entry.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PackerBudget:
    """Observed L2 load of one dispatch site, as a packer capacity demand."""

    site: str
    executions: int             # fused-kernel launches observed
    rows: int                   # total activation rows processed
    block_m: int
    k_dim: int
    l2_nnz_total: int
    l2_nnz_max_block: int
    mean_density: float         # l2_nnz_total / (rows · K)
    peak_block_density: float   # l2_nnz_max_block / (block_m · K)
    cap_required: int           # per-M-block entry slots with zero drops
    nnz_budget_required: float  # smallest phi_matmul nnz_budget that keeps
                                # every budgeted path drop-free


def packer_budget_report(site_counters: dict[str, dict]) -> list[PackerBudget]:
    """Aggregate the policy's per-site counters ({executions, rows,
    l2_nnz_total, l2_nnz_max_block, block_m, k_dim}). The required
    ``nnz_budget`` inverts the two capacities ``ops.phi_matmul`` derives from
    it: the per-block cap ``4·budget·block_m·K`` must cover the worst
    observed block, and the global cap ``budget·rows·K`` the observed mean."""
    out: list[PackerBudget] = []
    for site, c in sorted(site_counters.items()):
        bm, K = int(c["block_m"]), int(c["k_dim"])
        rows = max(int(c["rows"]), 1)
        total = int(c["l2_nnz_total"])
        peak = int(c["l2_nnz_max_block"])
        mean_density = total / (rows * K)
        peak_block_density = peak / (bm * K)
        out.append(PackerBudget(
            site=site, executions=int(c["executions"]), rows=rows, block_m=bm, k_dim=K,
            l2_nnz_total=total, l2_nnz_max_block=peak, mean_density=mean_density,
            peak_block_density=peak_block_density, cap_required=peak,
            nnz_budget_required=max(peak_block_density / 4.0, mean_density)))
    return out
