"""Telemetry-driven request scheduler for the serving engine (port of
``repro/serve/scheduler.py``).

The FIFO admission the engine started with ignores everything the dispatch
policy already knows about the traffic. This scheduler scores the queue
against ``PhiExecutionPolicy.site_telemetry()`` — the per-site calibration
skew (``usage_ratio`` / ``p_active`` from the pattern-usage histograms) and
the runtime execution counters — and picks admissions so the sparsity
structure steers serving, the paper's §4 premise applied one level up:

* **Cold sites** (calibrated, never executed): the first fused_prefetch
  trace pays the activation pre-pass that seeds the runtime match
  telemetry. Admitting a *single* request first (``admit_warmup_single``)
  makes that one request pay the pre-pass; everything admitted afterwards
  shares the derived runtime sets.
* **Skewed sites** (active pattern sets cover a small slice of the PWP
  bank, ``usage_ratio`` below the threshold): the prefetch path is live and
  its gathered rows are shared per shape.
  The scheduler then admits a *cohort* of queued requests whose prompts
  bucket to the same padded length (``admit_skew_cohort``), so co-batched
  traffic shares one prefill shape and one gather-set shape instead of
  interleaving shapes.
* **Otherwise** (no phi sites, or usage is flat so every path streams the
  whole bank anyway): plain FIFO (``admit_fifo``).

Eviction is the scheduler's too: when the page pool runs dry mid-decode the
engine asks :meth:`TelemetryScheduler.pick_victim` for the active slot to
preempt — the one with the most remaining budget (it would hold pages
longest), ties broken toward the youngest request. Victims re-queue at the
front with their generated prefix (``requeue_preempted``) and resume
token-identically (tested).

Every decision increments a named counter — a ``kind``-labelled series of
the ``scheduler_decisions`` metric in an ``obs.metrics`` registry (the
engine shares its own engine-scoped registry with the scheduler it
constructs, so two engines in one process never bleed counts into each
other). ``report()`` stays the thin dict view the engine's
``serve_report`` and the launcher print.
"""
from __future__ import annotations

import dataclasses

from repro_torch.obs.metrics import MetricsRegistry


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Knobs for :class:`TelemetryScheduler` (defaults serve fine).

    ``site_prefix`` scopes the telemetry snapshot to the served model's
    dispatch sites (the LM registers under ``lm.*``). ``skew_threshold`` is
    the mean ``usage_ratio`` below which traffic counts as skewed (the
    prefetch gather streams under that fraction of the PWP bank).
    ``warmup_single`` admits one request alone while all phi sites are cold.
    """

    site_prefix: str = "lm."
    skew_threshold: float = 0.75
    warmup_single: bool = True


class TelemetryScheduler:
    """Scores queued requests on dispatch-policy telemetry; counts decisions."""

    def __init__(self, config: SchedulerConfig | None = None,
                 metrics: MetricsRegistry | None = None) -> None:
        """Start with zeroed decision counters and the given config.

        ``metrics`` is the registry the decision counter registers in —
        the engine passes its own engine-scoped registry; standalone
        schedulers get a private one."""
        self.config = config or SchedulerConfig()
        self.metrics = metrics if metrics is not None else \
            MetricsRegistry(namespace="serve")
        self._counter = self.metrics.counter(
            "scheduler_decisions", "admission/eviction decisions by kind",
            labelnames=("kind",))

    def note(self, kind: str, n: int = 1) -> None:
        """Increment decision counter ``kind`` by ``n`` (engine-side events
        — ``admit_blocked_pool``, ``requeue_preempted`` — use this too)."""
        if n:
            self._counter.inc(n, kind=kind)

    # ------------------------------------------------------------ telemetry --
    def snapshot(self) -> dict:
        """Aggregate the policy's per-site telemetry into the three signals
        admission scores on: number of phi sites, whether any has executed,
        and the mean calibration usage ratio (1.0 = whole bank streams)."""
        from repro_torch.kernels import dispatch
        rows = dispatch.get_policy().site_telemetry(self.config.site_prefix)
        ratios = [r["usage_ratio"] for r in rows]
        return {
            "sites": len(rows),
            "warm": any(r["warm"] for r in rows),
            "mean_usage_ratio": (sum(ratios) / len(ratios)) if ratios else 1.0,
        }

    # ------------------------------------------------------------ admission --
    def select(self, queue: list, free_slots: int,
               cap: int, snapshot: dict | None = None) -> list:
        """Pick up to ``free_slots`` requests to admit, removing them from
        ``queue`` (in place). ``cap`` is the engine's max_context, used for
        the prompt-bucket cohort grouping. ``snapshot`` overrides the live
        telemetry (tests); default is :meth:`snapshot`.
        """
        if not queue or free_slots <= 0:
            return []
        snap = self.snapshot() if snapshot is None else snapshot
        if snap["sites"] and not snap["warm"] and self.config.warmup_single:
            self.note("admit_warmup_single")
            return [queue.pop(0)]
        if snap["sites"] and snap["mean_usage_ratio"] <= self.config.skew_threshold:
            from repro_torch.serve.engine import bucket_len
            cohorts: dict[int, list[int]] = {}
            for i, req in enumerate(queue):
                cohorts.setdefault(bucket_len(len(req.tokens), cap), []).append(i)
            # Largest cohort wins; ties break to the smallest bucket (cheapest
            # prefill). Within the cohort, submission order is kept.
            best = max(sorted(cohorts), key=lambda b: len(cohorts[b]))
            idxs = cohorts[best][:free_slots]
            picks = [queue[i] for i in idxs]
            for i in reversed(idxs):
                queue.pop(i)
            self.note("admit_skew_cohort", len(picks))
            return picks
        picks = [queue.pop(0) for _ in range(min(free_slots, len(queue)))]
        self.note("admit_fifo", len(picks))
        return picks

    # ------------------------------------------------------------- eviction --
    def pick_victim(self, candidates: list[tuple[int, int, int]]) -> int:
        """Choose the slot to preempt when the page pool runs dry.

        ``candidates`` are ``(slot, remaining_budget, rid)`` for every
        preemptable active slot. The victim is the request with the most
        tokens still to generate (it would pin pages the longest), ties
        broken toward the youngest (highest rid) — both deterministic.
        """
        if not candidates:
            raise ValueError("pick_victim needs at least one candidate")
        slot = max(candidates, key=lambda c: (c[1], c[2]))[0]
        self.note("preempt_pool_dry")
        return slot

    # ------------------------------------------------------------ reporting --
    def report(self) -> dict[str, int]:
        """Decision counts accumulated so far (name -> count), sorted — the
        thin view over the ``serve_scheduler_decisions`` counter."""
        return {key[0]: int(v) for key, v in self._counter.items()}
