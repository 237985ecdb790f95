"""Continuous-batching serving engine (port of ``repro/serve/engine.py``).

A fixed pool of ``batch_slots`` decode lanes over one batched decode state,
allocated once on the params' device. Per tick:
  1. admit queued requests into free slots — the telemetry-driven scheduler
     (``serve/scheduler.py``) picks *which* queued requests go first, from
     the dispatch policy's per-site telemetry; each admitted prompt is
     prefilled (batch=1) and its caches are written into the batched state
     at the slot index, in place;
  2. one ``decode_step`` advances *all* active slots;
  3. finished slots (EOS / budget) emit results and free up.

Spans (``obs.trace.span``; off, they cost a call and read no clock): the
tick (``serve.tick``), each prefill to its first token's logits on the host
(``serve.prefill``), the decode step to its logits on the host
(``serve.decode_step``), each host sampling (``serve.sample``), and the
request events ``serve.submit``, ``serve.admit``, ``serve.first_token``,
``serve.retire``.

Paged KV cache (``paged=True``): full-attention KV leaves live in a shared
page pool (``serve/page_manager.py``) and each slot holds a page *table*;
slot memory is O(tokens generated) and decode is bitwise identical to the
contiguous engine. When the pool runs dry the scheduler picks a victim to
preempt — it re-queues with its generated prefix and resumes
token-identically. Ring caches (swa/chunked) and recurrent state (Mamba-2,
the hybrid) keep dense slots — the same capability gate as ``bucketed``.

Prompt bucketing: admissions pad the prompt to the next power-of-two length
(capped at ``max_context``) and read the logits at the true last position,
so mixed prompt lengths share a handful of prefill shapes. Right-padding is
exact only for causal full attention; other archs prefill at the raw length.

The reference jit-compiles its entry points; here they are plain calls, and
the reference's functional slot insert and page splice are in-place writes
into the preallocated state. Phi mode: the engine never names a kernel —
every spiking GEMM routes through the ``kernels.dispatch`` execution policy.
``matmul`` (default: the config's own, ``model.make_matmul``) lets the same
engine serve the spiking-dense oracle (``model.spiking_dense_matmul``).
Sampling draws from a ``torch.Generator`` seeded with ``seed`` on the host.

On a mesh (``mesh=``, the rank's ``launch.mesh.make_mesh``), every rank runs
this engine over its shards of the params: the host loop is global and the
same on every rank (the same queue, scheduler decisions and greedy tokens,
from logits the model gathers over the mesh), while each rank keeps only its
shards of the decode state (``train.step.init_decode_state``: slots over
``data`` where its size divides them, heads over ``model``). A prompt is
prefilled on every rank (batch 1 replicates over ``data``), and its state is
written only on the ``data`` rank that owns the slot. The calls run under
``sharding.use_rules(SERVE_RULES, mesh)`` (:meth:`Engine._ctx`), so each Phi
GEMM re-gates on its local shape. Paged, a rank's pools hold its KV heads
and every page (``model.init_paged_state``): the page manager, preemption
and the table stay host-side and the same on every rank, every rank splices
each prefill into its pages, and the decode step reads a rank's rows of the
table. A rank's pools are the one device's divided by ``model`` only.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.distributed.sharding import SERVE_RULES, local_shape, use_rules
from repro_torch.models import model
from repro_torch.models.config import ModelConfig
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import DEFAULT_BUCKETS, TICK_BUCKETS, MetricsRegistry
from repro_torch.obs.trace import Tracer
from repro_torch.serve.page_manager import PageManager
from repro_torch.serve.sampling import sample
from repro_torch.serve.scheduler import TelemetryScheduler


@dataclasses.dataclass
class Request:
    """One generation request. ``prefix`` is engine-internal preemption
    bookkeeping (tokens already generated before a re-queue) — leave it
    empty on submit."""

    rid: int
    tokens: np.ndarray              # prompt tokens (P,)
    max_new_tokens: int = 32
    temperature: float = 0.0
    prefix: list[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Result:
    """Finished generation: every token generated for ``rid`` (across
    preemptions, in order) and the original prompt length."""

    rid: int
    tokens: list[int]
    prompt_len: int


def bucket_len(plen: int, cap: int) -> int:
    """Next power-of-two >= ``plen``, capped at ``cap``.

    Raises ValueError when ``cap < plen`` — a prompt longer than the
    context window has no valid bucket (the engine rejects such prompts at
    ``submit()``).
    """
    if cap < plen:
        raise ValueError(f"prompt length {plen} exceeds bucket cap {cap}")
    b = 1
    while b < plen:
        b *= 2
    return min(b, cap)


class Engine:
    """Continuous-batching serve loop over one model (see module docstring).

    ``paged=True`` enables the paged KV cache for full-attention families
    (silently kept dense otherwise — the capability gate). ``num_pages``
    defaults to the contiguous capacity (``batch_slots`` full lanes) so
    admission is never pool-blocked unless the caller constrains it;
    ``record_logits=True`` keeps a per-request trace of every sampled-from
    logits row (parity tests). The state lives on the params' device.
    """

    def __init__(self, cfg: ModelConfig, params: Any, *, batch_slots: int = 4,
                 max_context: int = 512, eos_id: int = 2, seed: int = 0,
                 paged: bool = False, page_size: int = 16,
                 num_pages: int | None = None,
                 scheduler: TelemetryScheduler | None = None,
                 record_logits: bool = False,
                 tracer: Tracer | None = None,
                 wall_time: bool = False, matmul=None, mesh=None):
        """Allocate the decode state (dense slots or page pool).

        ``tracer`` records the request lifecycle as spans (obs/trace.py),
        which also go into the profiled record while ``torch.profiler``
        records; ``wall_time=True`` additionally observes each
        decoded token's gap since its request's previous token into the
        ``serve_token_latency_ms`` histogram — off by default so the metric
        snapshot stays deterministic. Both are host-side only: instrumented
        runs are bitwise identical to uninstrumented ones.
        """
        if cfg.frontend != "none":
            raise ValueError("the engine serves token-in token-out archs")
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.matmul = matmul
        self.mesh = mesh
        self.B = batch_slots
        self.max_context = max_context
        self.eos_id = eos_id
        self.gen = torch.Generator().manual_seed(seed)
        # Engine-scoped metrics: every run counter lives in this registry,
        # so a second engine in the same process starts from zero and
        # reset_telemetry() can zero this engine without touching others.
        self.metrics = MetricsRegistry(namespace="serve")
        self.scheduler = scheduler or TelemetryScheduler(metrics=self.metrics)
        self.tracer = tracer
        self.wall_time = wall_time
        self._m_ticks = self.metrics.counter("ticks", "engine iterations")
        self._m_decoded = self.metrics.counter(
            "decoded_tokens", "tokens decoded across all slots")
        self._m_submitted = self.metrics.counter(
            "requests_submitted", "requests accepted into the queue")
        self._m_retired = self.metrics.counter(
            "requests_retired", "requests finished (incl. context_full)")
        self._m_preempted = self.metrics.counter(
            "requests_preempted", "pool-dry evictions (re-queued)")
        self._m_latency_ticks = self.metrics.histogram(
            "request_latency_ticks",
            "admit -> retire latency in engine ticks (per slot residency)",
            buckets=TICK_BUCKETS)
        self._m_token_ms = self.metrics.histogram(
            "token_latency_ms",
            "gap between a request's consecutive tokens, one per decoded token, "
            "stalls by prefills included (wall_time engines only)",
            buckets=DEFAULT_BUCKETS)
        self._admit_tick = [0] * batch_slots
        self._token_ns = [0] * batch_slots      # when each slot's last token came
        self.record_logits = record_logits
        self.logit_trace: dict[int, list[np.ndarray]] = {}
        # Right-padding is exact only for causal full attention (see module
        # docstring); other archs keep raw-length prefill.
        self.bucketed = (cfg.family not in ("ssm", "hybrid")
                         and getattr(cfg, "attn_type", "full") == "full")
        # Paged KV shares the capability gate: ring caches are already
        # O(window), recurrent state has no sequence axis to page.
        self.paged = paged and self.bucketed
        if paged and not self.paged:
            self.scheduler.note("paged_gate_dense")

        self.pm: PageManager | None = None
        self._placements = None
        if self.paged:
            if num_pages is None:
                num_pages = batch_slots * (max_context // page_size)
            self.pm = PageManager(num_pages=num_pages, page_size=page_size,
                                  slots=batch_slots, max_context=max_context)
            self.pools, _ = model.init_paged_state(
                cfg, num_pages, page_size, self.device, mesh, SERVE_RULES)
            self.state = None
        else:
            from repro_torch.train.step import init_decode_state
            self.state, self._placements = init_decode_state(
                cfg, batch_slots, max_context, mesh, SERVE_RULES, self.device)
        self.pos = np.zeros(batch_slots, np.int64)
        self.active = np.zeros(batch_slots, bool)
        self.budget = np.zeros(batch_slots, np.int64)
        self.out_tokens: list[list[int]] = [[] for _ in range(batch_slots)]
        self.slot_req: list[Request | None] = [None] * batch_slots
        self.queue: list[Request] = []
        self.results: list[Result] = []

    @property
    def ticks(self) -> int:
        """Engine iterations so far (thin view over ``serve_ticks``)."""
        return int(self._m_ticks.get())

    @property
    def decoded_tokens(self) -> int:
        """Tokens decoded so far (thin view over ``serve_decoded_tokens``)."""
        return int(self._m_decoded.get())

    def _event(self, name: str, **attrs: Any) -> None:
        """A request event (``obs.trace.event``); the tracer's record carries
        the current tick counter."""
        if self.tracer is not None:
            attrs["tick"] = self.ticks
        obs_trace.event(name, self.tracer, **attrs)

    def _span(self, name: str, **attrs: Any):
        """A span around engine work (``obs.trace.span``); the tracer's
        record carries the tick counter at its start."""
        if self.tracer is not None:
            attrs["tick"] = self.ticks
        return obs_trace.span(name, self.tracer, **attrs)

    def _ctx(self):
        """The context of the model calls: on a mesh, its serving rules (the
        Phi GEMMs then run in per-rank bodies and re-gate on local shapes)."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return use_rules(SERVE_RULES, self.mesh)

    # ------------------------------------------------------------- plumbing
    def _insert(self, new_state, slot: int) -> None:
        """Write a prefill's state (caches extended to ``max_context``) into
        the batched state at ``slot``, in place: each leaf at its own batch
        axis (the hybrid's main Mamba-2 states carry it on axis 2, behind
        (n_sites, g); the reference writes every leaf at axis 1, which there
        clamps onto slot 0). On a mesh a leaf whose slots are split over
        ``data`` is written only on the rank that holds ``slot``."""
        axes = model.state_leaves(model.state_batch_axes(self.cfg, self.state))
        places = self._placements if self._placements is not None else [()] * len(axes)
        for dst, src, axis, place in zip(model.state_leaves(self.state),
                                         model.state_leaves(new_state), axes, places):
            ax = place[axis] if axis < len(place) else None
            local = slot
            if ax is not None:
                n = dst.shape[axis]                      # this rank's slots
                if self.mesh.index(ax) != slot // n:
                    continue
                local = slot % n
            dst.select(axis, local).copy_(src.select(axis, 0))

    def _splice(self, new_state, pages: np.ndarray) -> None:
        """Scatter a prefill's caches, (n_groups, 1, bl, H, hd), into this
        slot's physical pages, in place: the sequence axis is padded to a
        whole number of pages and chopped into page chunks. Junk in the pad
        tail is exactly the junk the contiguous engine keeps past the prompt
        — masked, then progressively overwritten by decode. On a mesh every
        rank splices its KV heads: every rank holds every page."""
        idx = torch.as_tensor(pages, dtype=torch.long, device=self.device)
        for pool_kv, new_kv in zip(self.pools, new_state):
            for pool, n in zip(pool_kv, new_kv):
                ps = pool.shape[2]
                npg = len(pages)
                n = torch.nn.functional.pad(n, [0, 0, 0, 0, 0, npg * ps - n.shape[2]])
                chunks = n.reshape((n.shape[0], npg, ps) + n.shape[3:])
                pool[:, idx] = chunks.to(pool.dtype)

    def submit(self, req: Request) -> None:
        """Queue a request. Prompts longer than ``max_context - 1`` are
        rejected here — there would be no cache slot left for even one
        generated token (see ``bucket_len``)."""
        plen = len(req.tokens)
        if plen > self.max_context - 1:
            raise ValueError(
                f"request {req.rid}: prompt length {plen} exceeds "
                f"max_context - 1 = {self.max_context - 1}; raise "
                f"max_context or truncate the prompt")
        self.queue.append(req)
        self._m_submitted.inc()
        self._event("serve.submit", rid=req.rid, prompt_len=plen)

    # ----------------------------------------------------------------- tick
    def _admit(self) -> int:
        """Admit queued requests into free slots; returns how many were
        prefilled."""
        free = [s for s in range(self.B) if not self.active[s]]
        if not free or not self.queue:
            return 0
        admitted = 0
        # Non-phi models have no dispatch sites of their own: pin FIFO via an
        # empty snapshot so leftover telemetry from other models served in
        # this process can never steer their admission order.
        snap = (None if self.cfg.phi is not None else
                {"sites": 0, "warm": False, "mean_usage_ratio": 1.0})
        picks = self.scheduler.select(self.queue, len(free), self.max_context,
                                      snapshot=snap)
        while free and picks:
            req = picks.pop(0)
            prompt = np.concatenate([np.asarray(req.tokens, np.int64),
                                     np.asarray(req.prefix, np.int64)])
            plen = len(prompt)
            if plen > self.max_context - 1:
                # A re-queued prefix grew to the context edge: finish with
                # what we have (the unpreempted run would truncate there too).
                self.results.append(
                    Result(req.rid, list(req.prefix), len(req.tokens)))
                self.scheduler.note("retire_context_full")
                self._m_retired.inc()
                self._event("serve.retire", rid=req.rid, reason="context_full",
                            tokens=len(req.prefix))
                continue
            if self.paged:
                bl = bucket_len(plen, self.max_context)
                if not self.pm.reserve_prefill(free[0], bl):
                    # Pool dry: stop admitting, put the rest back in order.
                    self.scheduler.note("admit_blocked_pool")
                    self._event("serve.admit_blocked", rid=req.rid)
                    picks.insert(0, req)
                    break
            self._admit_one(free.pop(0), req, prompt)
            admitted += 1
        if picks:
            self.queue[:0] = picks
        return admitted

    def _admit_one(self, slot: int, req: Request, prompt: np.ndarray) -> None:
        plen = len(prompt)
        bl = bucket_len(plen, self.max_context) if self.bucketed else plen
        self._event("serve.resume" if req.prefix else "serve.admit", rid=req.rid,
                    slot=slot, prompt_len=plen, bucket=bl)
        # to the first token's logits on the host: the copy waits for the card
        with self._span("serve.prefill", rid=req.rid, slot=slot, bucket=bl, prompt_len=plen):
            tokens = np.zeros((1, bl), np.int32)
            tokens[0, :plen] = prompt
            batch = {"tokens": torch.as_tensor(tokens, device=self.device)}
            with self._ctx():
                if self.bucketed:
                    last = torch.full((1,), plen - 1, dtype=torch.int32, device=self.device)
                    logits, new_state = model.prefill_padded(self.cfg, self.params, batch,
                                                             last, matmul=self.matmul)
                else:
                    logits, new_state = model.prefill(self.cfg, self.params, batch,
                                                      matmul=self.matmul)
            if self.paged:
                n = max(1, -(-bl // self.pm.page_size))
                self._splice(new_state, self.pm.tables[slot, :n].copy())
            else:
                self._insert(model.extend_caches(self.cfg, new_state, self.max_context), slot)
            logits = logits.to(torch.float32).cpu()
        with self._span("serve.sample", rows=1, rid=req.rid):
            first = sample(logits, self.gen, temperature=req.temperature)
        if not req.prefix:
            self._event("serve.first_token", rid=req.rid, slot=slot)
        if self.wall_time:
            self._token_ns[slot] = obs_trace.now_ns()
        if self.record_logits:
            self.logit_trace.setdefault(req.rid, []).append(logits[0].numpy())
        self.out_tokens[slot] = [int(first[0])]
        self.pos[slot] = plen
        self.budget[slot] = req.max_new_tokens - len(req.prefix)
        self.active[slot] = True
        self.slot_req[slot] = req
        self._admit_tick[slot] = self.ticks

    # ------------------------------------------------------------ preemption
    def _preempt(self, slot: int) -> None:
        """Evict ``slot``: free its pages and re-queue the request at the
        front with its generated prefix (it resumes token-identically)."""
        req = self.slot_req[slot]
        req.prefix = list(req.prefix) + list(self.out_tokens[slot])
        self.queue.insert(0, req)
        self.scheduler.note("requeue_preempted")
        self._m_preempted.inc()
        self._event("serve.preempt", rid=req.rid, slot=slot,
                    generated=len(self.out_tokens[slot]))
        self.pm.release(slot)
        self.active[slot] = False
        self.slot_req[slot] = None
        self.out_tokens[slot] = []

    def _ensure_pages(self) -> None:
        """Map the page each active slot's next token lands in, preempting
        scheduler-chosen victims while the pool is dry. Terminates: every
        preemption frees >= 1 page, and a sole survivor always fits
        (``num_pages >= logical_pages``, checked at construction)."""
        for slot in range(self.B):
            if not self.active[slot]:
                continue
            while self.active[slot] and \
                    not self.pm.ensure(slot, int(self.pos[slot])):
                cands = [(s, int(self.budget[s]) - len(self.out_tokens[s]),
                          self.slot_req[s].rid)
                         for s in range(self.B) if self.active[s]]
                self._preempt(self.scheduler.pick_victim(cands))

    def _retire(self) -> None:
        for slot in range(self.B):
            if not self.active[slot]:
                continue
            toks = self.out_tokens[slot]
            done = len(toks) >= self.budget[slot] or (toks and toks[-1] == self.eos_id)
            if done or self.pos[slot] >= self.max_context - 1:
                req = self.slot_req[slot]
                self.results.append(Result(
                    req.rid, list(req.prefix) + list(toks), len(req.tokens)))
                if self.paged:
                    self.pm.release(slot)
                self.active[slot] = False
                self.slot_req[slot] = None
                self._m_retired.inc()
                # Latency covers this slot residency (admit -> retire); a
                # preempted request's earlier residencies were traced as
                # their own admit/preempt spans.
                lat = self.ticks - self._admit_tick[slot]
                self._m_latency_ticks.observe(lat)
                self._event("serve.retire", rid=req.rid, slot=slot,
                            tokens=len(req.prefix) + len(toks),
                            latency_ticks=lat)

    def tick(self) -> bool:
        """One engine iteration; returns False when fully idle."""
        with torch.no_grad(), self._span("serve.tick") as span:
            return self._tick(span)

    def _tick(self, span) -> bool:
        admitted = self._admit()
        if self.paged:
            self._ensure_pages()
        if not self.active.any():
            span.set(admitted=admitted, rows=0)
            return bool(self.queue)
        last = np.array([self.out_tokens[b][-1] if self.active[b] else 0
                         for b in range(self.B)], np.int32)
        last_t = torch.as_tensor(last, device=self.device)
        pos = torch.as_tensor(self.pos.astype(np.int32), device=self.device)
        n_active = int(self.active.sum())
        span.set(admitted=admitted, rows=n_active)
        with self._span("serve.decode_step", rows=n_active):
            with self._ctx():
                if self.paged:
                    table = torch.as_tensor(self.pm.tables, device=self.device)
                    logits, self.pools = model.decode_step_paged(
                        self.cfg, self.params, last_t, pos, self.pools, table,
                        matmul=self.matmul)
                else:
                    logits, self.state = model.decode_step(self.cfg, self.params, last_t, pos,
                                                           self.state, matmul=self.matmul)
            logits = logits.to(torch.float32).cpu()       # waits for the card
        # Per-slot temperatures: a sampled request batched next to a greedy
        # one must not perturb the greedy stream.
        temps = np.array([r.temperature if r is not None else 0.0
                          for r in self.slot_req], np.float32)
        with self._span("serve.sample", rows=n_active):
            nxt = sample(logits, self.gen, temperature=temps).numpy()
        now = obs_trace.now_ns() if self.wall_time else 0
        if self.record_logits:
            logits_np = logits.numpy()
            for b in range(self.B):
                if self.active[b]:
                    self.logit_trace.setdefault(
                        self.slot_req[b].rid, []).append(logits_np[b])
        decoded = 0
        for b in range(self.B):
            if self.active[b]:
                self.out_tokens[b].append(int(nxt[b]))
                self.pos[b] += 1
                decoded += 1
                if self.wall_time:
                    self._m_token_ms.observe((now - self._token_ns[b]) / 1e6)
                    self._token_ns[b] = now
        self._event("serve.decode", active=n_active, tokens=decoded)
        self._m_decoded.inc(decoded)
        self._m_ticks.inc()
        self._retire()
        return True

    def run(self, max_ticks: int = 10_000) -> list[Result]:
        """Tick until queue and slots drain (or ``max_ticks``); returns the
        accumulated Results."""
        while self.tick() or self.queue or self.active.any():
            if self.ticks >= max_ticks:
                break
            if not self.queue and not self.active.any():
                break
        if self.cfg.phi is not None:
            from repro_torch.kernels import dispatch
            from repro_torch.obs.drift import DriftMonitor
            from repro_torch.utils import log
            dispatch.get_policy().log_report(prefix="serve")
            # Drift pass over the served sites: publishes per-site
            # drift_score gauges and the drift_alert counter.
            verdict = DriftMonitor(
                dispatch.get_policy(),
                prefix=self.scheduler.config.site_prefix).check()
            if verdict["alerts"]:
                log.warning("sparsity drift past threshold at %s",
                            ", ".join(verdict["alerts"]))
        return self.results

    # ------------------------------------------------------------ reporting
    def reset_telemetry(self, include_policy: bool = True) -> None:
        """Zero every run counter so a fresh run over this engine (or the
        next engine in this process) reports from scratch.

        Clears the engine-scoped metric registry (and the scheduler's, when
        the caller wired its own), the logit traces, and — unless
        ``include_policy=False`` — the process dispatch policy's *runtime*
        telemetry. The policy's calibration usage registry survives
        (``reset(keep_usage=True)``): it describes the model, not the run.
        """
        self.metrics.reset()
        if self.scheduler.metrics is not self.metrics:
            self.scheduler.metrics.reset()
        self.logit_trace.clear()
        if include_policy:
            from repro_torch.kernels import dispatch
            dispatch.get_policy().reset(keep_usage=True)

    def cache_report(self) -> dict:
        """Cache-memory accounting: the contiguous allocation this
        configuration would need, and (paged mode) the pool size and the
        high-water mark actually touched. On a mesh the bytes are this
        rank's, and ``bytes_of`` says so (one device's report is the
        reference's)."""
        specs = model.decode_state_specs(self.cfg, self.B, self.max_context)
        shapes = [s.shape for s in model.state_leaves(specs)]
        if self.mesh is not None:
            from repro_torch.train.step import _leaf_shardings

            places = _leaf_shardings(self.cfg, specs, self.mesh, SERVE_RULES, self.B)
            shapes = [local_shape(sh, pl, self.mesh) for sh, pl in zip(shapes, places)]
        contig = sum(math.prod(sh) * s.dtype.itemsize
                     for sh, s in zip(shapes, model.state_leaves(specs)))
        out: dict[str, Any] = {"contig_cache_bytes": int(contig)}
        if self.mesh is not None:
            out["bytes_of"] = f"rank {self.mesh.rank}"
        if self.paged:
            pool_bytes = sum(t.numel() * t.element_size() for t in model.state_leaves(self.pools))
            per_page = pool_bytes // (self.pm.num_pages + 1)
            out.update(self.pm.report())
            out["pool_bytes"] = int(pool_bytes)
            out["page_bytes"] = int(per_page)
            out["page_hwm_bytes"] = int(per_page * self.pm.hwm_pages)
        return out

    def serve_report(self) -> dict:
        """Scheduler decision counts + cache accounting + run counters."""
        return {
            "scheduler_decisions": self.scheduler.report(),
            "cache": self.cache_report(),
            "ticks": self.ticks,
            "decoded_tokens": self.decoded_tokens,
            "paged": self.paged,
        }
