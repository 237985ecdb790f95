"""Phi execution-policy layer (port of ``repro/kernels/dispatch.py``).

The model layer never names a lowering: every Phi matmul and every spiking
attention site routes through a :class:`PhiExecutionPolicy`, which resolves
the lowering per call with the reference's rows in the reference's order
(``resolve``, ``resolve_attention``) and its reason strings, so decisions
compare word for word on the CPU.

Matmul rows, first match wins: a per-call ``override`` > ``config_override``
(``PhiConfig.impl``) > the policy's own (the ``PHI_IMPL`` environment
variable), each demoted where it cannot run (autodiff → ``coo``; a forced
``fused`` whose shape the gate streams → ``fused_stream``; a forced
``fused_prefetch`` without skew → the gate's kernel); then autodiff →
``coo``; then the gate ``ops.fused_shape_viable`` on the shape and the
site's calibration usage: ``fused_prefetch`` where the usage is skewed,
``fused_stream`` where the K loop is long, ``fused`` elsewhere, ``coo``
where no kernel takes the bank (on the CPU; on the card that row, and a
forced kernel demoted by it, raises). The reference's launch-cost row is a TPU
cost model it applies only on the TPU; no launch-cost row applies here
until it is re-derived for the H100. The SPMD rows wait for the
multi-device port.

The backend is the operands' device. On ``cuda`` the rows resolve to the
hand-written kernels (reason suffix ``_native``) and a bank or shape a
kernel cannot take raises: the card has no plain fallback. On the CPU the
plain versions run (suffix ``interpret`` for the matmul rows, as the
reference's interpret-mode Pallas off the TPU; ``_xla`` for the attention
rows). The autodiff rows read ``torch.is_grad_enabled()`` and
``requires_grad`` on the operands.

Telemetry: every decision is counted (``decisions()``, a view over the
``phi_dispatch_decisions`` counter of ``metrics``) and, when a tracer is
installed (``obs.trace.set_tracer``), emitted as a ``dispatch`` record. The
fused kernels' per-block ``l2_nnz`` counters and the prefetch pre-pass's
match histogram are summed into per-site accumulators on the device
(total, peak block, histogram; executions and rows are counted on the
host) and copied to the host in one transfer per site only where they are
read (``runtime_usage_for``, ``site_telemetry``, ``report``,
``metrics_snapshot``), as the reference flushes its unordered callbacks
there: no GEMM waits for the card. A
``fused_prefetch`` site's aggregated histogram supplies its gather sets
from its second execution on (reason suffix ``_runtime_sets``), which skips
the pre-pass.
"""
from __future__ import annotations

import dataclasses
import logging
import math
import os
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.core.patterns import active_pattern_sets, top_p_sets
from repro_torch.kernels import ATTN_IMPLS, IMPLS, ops
from repro_torch.kernels.phi_fused import MAX_K
from repro_torch.models import flash as flash_mod
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import MetricsRegistry

log = logging.getLogger("repro_torch")

# Lowerings with no backward (the kernels): demoted to "coo" under autodiff.
_PALLAS_IMPLS = ("fused", "fused_stream", "fused_prefetch", "pallas")
# Lowerings that emit the l2_nnz audit counter.
_FUSED_IMPLS = ("fused", "fused_stream", "fused_prefetch")
_CKPT_KEY = "phi_impl"
_USAGE_KEY = "phi_usage"


@dataclasses.dataclass(frozen=True)
class Decision:
    """One resolved dispatch: which lowering runs at a call site and why."""

    impl: str
    reason: str
    site: str
    shape: tuple            # matmul (M, K, N, T, q); attention (B·H·S, D, S, T, q)
    backend: str
    # fused kernels: (block_m of the l2_nnz counter, group_t; 0 = all
    # partitions per stage); attention: the (block_q, block_kv) both the Phi
    # arm and a forced dense arm run, for the bitwise A/B contract.
    blocks: tuple | None = None
    # fused_prefetch: the PWP-bank usage fraction (P+1)/(q+1) and the gather
    # size P from the calibration histogram.
    usage_ratio: float | None = None
    p_active: int | None = None
    # fused_prefetch with runtime match telemetry: the (T, P) gather sets
    # from the site's aggregated match histogram; the kernel then skips the
    # stripe_active_sets pre-pass. None = pre-pass.
    runtime_sets: Any = None


def _skew(usage: Any) -> tuple[int | None, float]:
    """(gather size P, usage fraction) of a usage histogram: (None, 1.0)
    without one or without skew."""
    if usage is None:
        return None, 1.0
    sets, ratio = active_pattern_sets(usage)
    return (None if sets is None else int(sets.shape[-1])), ratio


class PhiExecutionPolicy:
    """Resolves the lowering per call and aggregates its telemetry."""

    def __init__(self, override: str | None = None, telemetry: bool = True) -> None:
        if override is None:
            override = os.environ.get("PHI_IMPL") or None
        if override is not None and override not in IMPLS:
            raise ValueError(f"unknown Phi impl override {override!r}; expected one of {IMPLS}")
        self.override = override
        self.telemetry = telemetry and os.environ.get("PHI_TELEMETRY") != "0"
        self._lock = threading.Lock()
        self.metrics = MetricsRegistry(namespace="phi")
        self._dec = self.metrics.counter("dispatch_decisions", "dispatch resolutions",
                                         labelnames=("site", "impl", "reason"))
        # site -> most recent full Decision
        self._last: dict[str, Decision] = {}
        # site -> runtime counters folded in from the fused kernels' l2_nnz
        self._sites: dict[str, dict] = {}
        # site -> executions not yet read: host counts, device sums
        self._acc: dict[str, dict] = {}
        # site -> (T, q+1) calibration usage, and its skew computed once
        self._usage: dict[str, np.ndarray] = {}
        self._usage_skew: dict[str, tuple[int | None, float]] = {}
        # site -> (usage passed per call, its skew): computed once per object
        self._call_skew: dict[str, tuple[Any, int | None, float]] = {}
        # site -> (runtime sets, the same on the card), copied once per change
        self._sets_on_device: dict[str, tuple[np.ndarray, torch.Tensor]] = {}

    # --------------------------------------------------------------- usage --
    def register_usage(self, site: str, usage: Any) -> None:
        """Attach a calibration pattern-usage histogram ((T, q+1) counts) to
        a dispatch site. Re-registration with the same shape accumulates.
        The histogram's skew is computed here, once, not per resolve."""
        u = np.asarray(usage, np.int64)
        with self._lock:
            prev = self._usage.get(site)
            if prev is not None and prev.shape == u.shape:
                u = prev + u
            self._usage[site] = u
        skew = _skew(u)
        with self._lock:
            self._usage_skew[site] = skew

    def usage_for(self, site: str) -> np.ndarray | None:
        """The calibration usage registered for ``site``, or None."""
        with self._lock:
            return self._usage.get(site)

    def _skew_for(self, site: str, usage: Any) -> tuple[int | None, float]:
        if usage is None:
            with self._lock:
                return self._usage_skew.get(site, (None, 1.0))
        with self._lock:
            cached = self._call_skew.get(site)
        if cached is not None and cached[0] is usage:
            return cached[1], cached[2]
        p_active, ratio = _skew(usage)
        with self._lock:
            self._call_skew[site] = (usage, p_active, ratio)
        return p_active, ratio

    def runtime_shards_for(self, site: str) -> int:
        """Mesh extent recorded for ``site``'s runtime counters (1: the port
        runs on one device)."""
        self._flush(site)
        with self._lock:
            return int(self._sites.get(site, {}).get("shards", 1))

    def runtime_usage_for(self, site: str) -> np.ndarray | None:
        """The site's aggregated runtime match histogram ((T, q+1) int64),
        fed by the prefetch pre-pass; None until the site has executed (or
        when no observed row-partition matched). Reads the card only when a
        histogram is pending: on the path that is the site's first execution,
        once."""
        with self._lock:
            hist_pending = self._acc.get(site, {}).get("hist") is not None
        if hist_pending:
            self._flush(site)
        with self._lock:
            hist = self._sites.get(site, {}).get("usage_runtime")
            if hist is None or hist[:, :-1].sum() <= 0:
                return None
            return hist.copy()

    def site_telemetry(self, prefix: str = "") -> list[dict]:
        """Snapshot of every known dispatch site whose name starts with
        ``prefix``: calibration skew (``usage_ratio``, ``p_active``,
        ``skewed``), whether and how often it executed (``warm``,
        ``executions``), ``shards``, the PSI ``drift_score`` between its
        calibration and runtime histograms (None until both exist), and its
        most recent decision (``impl``, ``reason``). Sites come from the
        usage registry, the runtime counters and the decision log."""
        from repro_torch.obs.drift import site_drift

        self._flush()
        rows: list[dict] = []
        with self._lock:
            names = sorted(set(self._usage) | set(self._sites) | set(self._last))
            for site in names:
                if prefix and not site.startswith(prefix):
                    continue
                usage = self._usage.get(site)
                p_active, ratio = self._usage_skew.get(site, (None, 1.0))
                counters = self._sites.get(site)
                execs = 0 if counters is None else int(counters.get("executions", 0))
                hist = None if counters is None else counters.get("usage_runtime")
                drift = None
                if usage is not None and hist is not None and hist.sum() > 0:
                    drift = float(site_drift(usage, hist))
                last = self._last.get(site)
                rows.append({
                    "site": site,
                    "usage_ratio": float(ratio),
                    "p_active": p_active,
                    "skewed": p_active is not None,
                    "warm": execs > 0,
                    "executions": execs,
                    "shards": 1 if counters is None else int(counters.get("shards", 1)),
                    "drift_score": drift,
                    "impl": None if last is None else last.impl,
                    "reason": None if last is None else last.reason,
                })
        return rows

    # ------------------------------------------------------------- resolve --
    def resolve(self, *, site: str = "anon", m: int, k_dim: int, n: int, t: int, q: int,
                override: str | None = None, config_override: str | None = None,
                transform: bool = False, usage: Any = None, p_active: int | None = None,
                device: str | torch.device = "cpu") -> Decision:
        """Resolve the lowering for one matmul call. Override precedence:
        per-call ``override`` > ``config_override`` > the policy's own
        (``PHI_IMPL``).

        ``usage`` is the site's calibration histogram ((T, q+1) counts;
        default: the one registered for ``site``); a skewed one enables
        ``fused_prefetch``. A caller that already holds its gather size
        (``PhiState.p_active``) passes it as ``p_active``. ``transform``
        says a backward pass will run through the operands; ``device`` is
        where they lie.
        """
        for o in (override, config_override):
            if o is not None and o not in IMPLS:
                raise ValueError(f"unknown Phi impl override {o!r} at site {site!r}; "
                                 f"expected one of {IMPLS}")
        backend = torch.device(device).type
        shape = (m, k_dim, n, t, q)
        if p_active is None:
            p_active, usage_ratio = self._skew_for(site, usage)
        else:
            usage_ratio = (p_active + 1) / (q + 1)
        ov, which = next(((o, lbl) for o, lbl in ((override, "call"),
                                                  (config_override, "config"),
                                                  (self.override, "policy"))
                          if o is not None), (None, None))
        mode = "native" if backend == "cuda" else "interpret"
        if ov is not None:
            if transform and ov in _PALLAS_IMPLS:
                d = Decision("coo", f"autodiff_demotes_{ov}", site, shape, backend)
            elif ov == "fused_prefetch":
                gate = ops.fused_shape_viable(m, k_dim, n, t, q, p_active=p_active)
                if gate == "fused_prefetch":
                    d = Decision(ov, f"{which}_override", site, shape, backend)
                elif gate == "coo":
                    d = Decision("coo", "vmem_gate_demotes_fused_prefetch", site, shape,
                                 backend)
                elif p_active is not None:
                    # skew was measured; the gather set is what the kernel refuses
                    d = Decision(gate, "vmem_gate_streams_fused_prefetch", site, shape,
                                 backend)
                else:                                  # "fused" or "fused_stream"
                    d = Decision(gate, "no_skew_demotes_fused_prefetch", site, shape,
                                 backend)
            elif ov in _FUSED_IMPLS and (
                    gate := ops.fused_shape_viable(m, k_dim, n, t, q)) != ov:
                if gate == "coo":
                    d = Decision("coo", f"vmem_gate_demotes_{ov}", site, shape, backend)
                elif ov == "fused":                    # gate == "fused_stream"
                    d = Decision("fused_stream", "vmem_gate_streams_fused", site, shape,
                                 backend)
                else:                                  # "fused_stream" where "fused"
                    d = Decision(ov, f"{which}_override", site, shape, backend)  # also runs
            else:
                d = Decision(ov, f"{which}_override", site, shape, backend)
        elif transform:
            d = Decision("coo", "autodiff_or_vmap", site, shape, backend)
        else:
            gate = ops.fused_shape_viable(m, k_dim, n, t, q, p_active=p_active)
            if gate == "coo":
                d = Decision("coo", "fused_vmem_gate", site, shape, backend)
            elif gate == "fused_prefetch":
                d = Decision("fused_prefetch", f"pattern_usage_prefetch_{mode}", site, shape,
                             backend)
            elif gate == "fused_stream":
                d = Decision("fused_stream", f"vmem_gate_k_stream_{mode}", site, shape,
                             backend)
            else:
                d = Decision("fused", f"single_device_default_{mode}", site, shape, backend)
        if backend == "cuda" and d.impl == "coo" and (
                d.reason == "fused_vmem_gate" or d.reason.startswith("vmem_gate_demotes_")):
            # The reference's row runs its XLA lowering here; on the card the
            # kernels are the only lowerings of this row, and they refuse.
            raise ValueError(
                f"no Phi kernel takes site {site!r}: bank T={t} × k={k_dim // max(t, 1)} "
                f"with q={q} (every kernel takes k <= {MAX_K}; q > 512 needs a streaming "
                "stage that fits 227 KB of shared memory); the card has no plain fallback")
        # blocks[0]: the l2_nnz counter's rows and the prefetch stripe, by the
        # reference's rule; the kernels' own tiles do not depend on it.
        if d.impl == "fused":
            d = dataclasses.replace(d, blocks=(ops.autotune_fused_blocks(m, k_dim, n, q, t)[0],
                                               0))
        elif d.impl == "fused_stream":
            d = dataclasses.replace(d, blocks=(ops.autotune_stream_blocks(m, k_dim, n, q, t)[0],
                                               ops.stream_group_t(q, k_dim // t)))
        elif d.impl == "fused_prefetch":
            bm = ops.autotune_prefetch_blocks(m, k_dim, n, q, t, p_active)[0]
            d = dataclasses.replace(d, blocks=(bm, 0), usage_ratio=usage_ratio,
                                    p_active=p_active)
            # From the site's second execution on, its aggregated runtime
            # match histogram supplies the gather sets: no pre-pass.
            rt_hist = self.runtime_usage_for(site)
            if rt_hist is not None and d.p_active and rt_hist.shape == (t, q + 1):
                d = dataclasses.replace(d, runtime_sets=top_p_sets(rt_hist, d.p_active),
                                        reason=d.reason + "_runtime_sets")
        self._record_decision(d)
        return d

    # --------------------------------------------------------- attention --
    def resolve_attention(self, *, site: str = "anon", s: int, d: int, heads: int = 1,
                          batch: int = 1, t: int = 0, q: int = 0, kp: int = 0,
                          spike_qk: bool = False, has_patterns: bool = False,
                          override: str | None = None, config_override: str | None = None,
                          transform: bool = False,
                          device: str | torch.device = "cpu") -> Decision:
        """Resolve the attention lowering for one call site.

        The spike-input gate is declarative: the caller states whether its
        Q/K operands are binary spike tensors (``spike_qk``). Only spike
        sites with a calibrated pattern bank resolve ``"phi_flash"``;
        everything else (dense attention, autodiff, missing banks) keeps
        ``"flash"``. ``transform`` says a backward pass will run through the
        operands. ``device`` is where they lie: ``cuda`` resolves the kernel
        (``_native``), the CPU the plain lowering (``_xla``).
        ``Decision.shape`` maps the score GEMM: (batch·heads·s, d, s, t, q);
        ``Decision.blocks`` carries the (block_q, block_kv) that both the Phi
        arm and a forced dense-flash arm run.
        """
        for o in (override, config_override):
            if o is not None and o not in ATTN_IMPLS:
                raise ValueError(f"unknown attention impl override {o!r} at site {site!r}; "
                                 f"expected one of {ATTN_IMPLS}")
        backend = torch.device(device).type
        shape = (batch * heads * s, d, s, t, q)
        # Only the kernel on the card is native; on the CPU the plain
        # lowering runs, as the reference's XLA lowering does off the TPU.
        mode = "native" if backend == "cuda" else "xla"
        ov, which = next(((o, lbl) for o, lbl in ((override, "call"),
                                                  (config_override, "config"))
                          if o is not None), (None, None))
        viable = has_patterns and ops.attn_shape_viable(s, d, t, q, kp)
        if backend == "cuda" and has_patterns and not viable and not transform \
                and ov != "flash" and (spike_qk or ov == "phi_flash"):
            # The reference's row runs the XLA lowering here; on the card the
            # kernel is the only Phi lowering, and it refuses the shape.
            raise ValueError(
                f"phi_flash_attention kernel cannot take site {site!r}: bank T={t} × "
                f"kp={kp} (kp <= 64, T·kp <= D={d}) with qp={q}, or no block pair at S={s} "
                "fits 227 KB of shared memory")
        if ov == "flash":
            dec = Decision("flash", f"{which}_override", site, shape, backend)
        elif ov == "phi_flash":
            if transform:
                dec = Decision("flash", "autodiff_demotes_phi_flash", site, shape, backend)
            elif not has_patterns:
                dec = Decision("flash", "no_patterns_demotes_phi_flash", site, shape, backend)
            elif not viable:
                dec = Decision("phi_flash", "vmem_gate_phi_flash_xla", site, shape, backend)
            else:
                dec = Decision("phi_flash", f"{which}_override", site, shape, backend)
        elif transform:
            dec = Decision("flash", "autodiff_keeps_flash", site, shape, backend)
        elif not spike_qk:
            dec = Decision("flash", "dense_qk_keeps_flash", site, shape, backend)
        elif not has_patterns:
            dec = Decision("flash", "no_patterns_keeps_flash", site, shape, backend)
        elif not viable:
            # the bank or every block pair exceeds what the kernel takes
            dec = Decision("phi_flash", "vmem_gate_phi_flash_xla", site, shape, backend)
        else:
            dec = Decision("phi_flash", f"spike_qk_phi_flash_{mode}", site, shape, backend)
        dec = dataclasses.replace(dec, blocks=ops.autotune_attn_blocks(s, d, t, q, kp))
        self._record_decision(dec)
        return dec

    def attention(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  patterns: torch.Tensor | None = None, *, site: str = "anon",
                  causal: bool = False, window: int | None = None, chunk: int | None = None,
                  spike_qk: bool = False, override: str | None = None,
                  config_override: str | None = None,
                  packed: torch.Tensor | None = None) -> torch.Tensor:
        """Policy-dispatched flash attention: q/k/v (B, S, H, D).

        ``patterns`` is the (T, qp, kp) bank calibrated on the site's K spike
        rows (None for uncalibrated or dense sites), ``packed`` the same
        bank as the kernel reads it. Both lowerings run the blocks the
        decision carries, so a forced ``override="flash"`` arm is bitwise
        equal to the resolved ``phi_flash`` one for binary Q/K.
        """
        B, S, H, D = q.shape
        t = qp = kp = 0
        if patterns is not None:
            t, qp, kp = patterns.shape[-3:]
        dec = self.resolve_attention(
            site=site, s=S, d=D, heads=H, batch=B, t=t, q=qp, kp=kp, spike_qk=spike_qk,
            has_patterns=patterns is not None, override=override,
            config_override=config_override, transform=flash_mod.under_autograd(q, k, v),
            device=q.device)
        bq, bkv = dec.blocks
        if dec.impl == "flash":
            return flash_mod.flash_attention(q, k, v, causal, window, chunk, bq, bkv)
        return ops.phi_flash_attention(q, k, v, patterns, causal=causal, window=window,
                                       chunk=chunk, block_q=bq, block_kv=bkv, packed=packed)

    def _record_decision(self, d: Decision) -> None:
        first = self._dec.get(site=d.site, impl=d.impl, reason=d.reason) == 0
        self._dec.inc(site=d.site, impl=d.impl, reason=d.reason)
        with self._lock:
            self._last[d.site] = d
        tracer = obs_trace.get_tracer()
        if tracer is not None:
            tracer.emit("dispatch", site=d.site, impl=d.impl, reason=d.reason,
                        shape=[int(x) for x in d.shape],
                        blocks=None if d.blocks is None else [int(b) for b in d.blocks])
        if first:
            log.info("phi dispatch: %s -> %s (%s, M=%d K=%d N=%d)",
                     d.site, d.impl, d.reason, *d.shape[:3])

    # ------------------------------------------------------------- execute --
    def matmul(self, a: torch.Tensor, w: torch.Tensor, patterns: torch.Tensor,
               pwp: torch.Tensor, *, site: str = "anon", override: str | None = None,
               config_override: str | None = None, nnz_budget: float = 0.08,
               gather_dtype: torch.dtype | None = None, pwp_scale: torch.Tensor | None = None,
               usage: Any = None, p_active: int | None = None,
               packed: torch.Tensor | None = None) -> torch.Tensor:
        """Policy-dispatched ``phi_matmul``: resolve the lowering from the
        call's context, run it, and (fused kernels) keep the ``l2_nnz``
        counters for the site's telemetry.

        ``usage``/``p_active`` as in :meth:`resolve`; ``packed`` is the bank
        as the kernels read it (``pack_patterns``).
        """
        K = a.shape[-1]
        T, q, _ = patterns.shape
        N = w.shape[-1]
        M = math.prod(a.shape[:-1])
        d = self.resolve(site=site, m=M, k_dim=K, n=N, t=T, q=q, override=override,
                         config_override=config_override,
                         transform=flash_mod.under_autograd(a, w, patterns, pwp), usage=usage,
                         p_active=p_active, device=a.device)
        if d.impl not in _FUSED_IMPLS:
            return ops.phi_matmul(a, w, patterns, pwp, impl=d.impl, nnz_budget=nnz_budget,
                                  gather_dtype=gather_dtype, pwp_scale=pwp_scale,
                                  packed=packed)
        bm, group_t = d.blocks
        hist = None
        if d.impl == "fused":
            out, nnz = ops.phi_fused(a, patterns, pwp, w, pwp_scale=pwp_scale, block_m=bm,
                                     packed=packed)
        elif d.impl == "fused_stream":
            out, nnz = ops.phi_fused_stream(a, patterns, pwp, w, pwp_scale=pwp_scale,
                                            block_m=bm, group_t=group_t, packed=packed)
        elif d.runtime_sets is not None:
            out, nnz = ops.phi_fused_prefetch(
                a, patterns, pwp, w, p_active=d.p_active, pwp_scale=pwp_scale, block_m=bm,
                packed=packed, runtime_sets=self._sets_on(site, d.runtime_sets, a.device))
        elif self.telemetry:
            # pre-pass; its match histogram becomes the site's runtime telemetry
            out, nnz, hist = ops.phi_fused_prefetch(
                a, patterns, pwp, w, p_active=d.p_active, pwp_scale=pwp_scale, block_m=bm,
                packed=packed, return_hist=True)
        else:
            out, nnz = ops.phi_fused_prefetch(a, patterns, pwp, w, p_active=d.p_active,
                                              pwp_scale=pwp_scale, block_m=bm, packed=packed)
        if self.telemetry:
            self._accumulate(site, ops.effective_block_m(M, bm), K, M, nnz, group_t,
                             d.usage_ratio, hist)
        return out

    def _sets_on(self, site: str, sets: np.ndarray, device: torch.device) -> torch.Tensor:
        """The runtime sets on ``device``, copied there once per change."""
        with self._lock:
            cached = self._sets_on_device.get(site)
        if cached is not None and np.array_equal(cached[0], sets) \
                and cached[1].device == device:
            return cached[1]
        dev_sets = torch.as_tensor(sets, dtype=torch.int32, device=device)
        with self._lock:
            self._sets_on_device[site] = (sets, dev_sets)
        return dev_sets

    def _accumulate(self, site: str, block_m: int, k_dim: int, rows: int, nnz: torch.Tensor,
                    group_t: int, usage_ratio: float | None, hist: torch.Tensor | None) -> None:
        """Add one fused-kernel execution to the site's accumulators: the
        counts on the host, the ``l2_nnz`` sum and peak and the match
        histogram on the device, with no copy to the host. A site that ran on
        another device since its last read is folded in first."""
        with self._lock:
            acc = self._acc.get(site)
        if acc is not None and acc["nnz_total"].device != nnz.device:
            self._flush(site)
        with self._lock:
            acc = self._acc.get(site)
            if acc is None:
                acc = self._acc[site] = {
                    "executions": 0, "rows": 0, "hist": None,
                    "nnz_total": torch.zeros((), dtype=torch.int64, device=nnz.device),
                    "nnz_max": torch.zeros((), dtype=torch.int64, device=nnz.device)}
            acc["executions"] += 1
            acc["rows"] += rows
            if nnz.numel():
                acc["nnz_total"].add_(nnz.sum(dtype=torch.int64))
                torch.maximum(acc["nnz_max"], nnz.max(), out=acc["nnz_max"])
            acc.update(block_m=block_m, k_dim=k_dim, group_t=group_t, usage_ratio=usage_ratio)
            if hist is not None:
                h, prev = hist.to(torch.int64), acc["hist"]
                acc["hist"] = h if prev is None or prev.shape != h.shape else prev + h

    def _flush(self, site: str | None = None) -> None:
        """Fold the accumulated executions of ``site`` (default: every site)
        into the counters: the one place they leave the card, one copy per
        site."""
        with self._lock:
            names = list(self._acc) if site is None else [site]
            batches = [(s, self._acc.pop(s)) for s in names if s in self._acc]
        for s, acc in batches:
            parts = [acc["nnz_total"].view(1), acc["nnz_max"].view(1)]
            if acc["hist"] is not None:
                parts.append(acc["hist"].reshape(-1))
            host = torch.cat(parts).cpu().numpy()
            hist = None if acc["hist"] is None else host[2:].reshape(acc["hist"].shape)
            self._fold(s, acc["executions"], acc["rows"], int(host[0]), int(host[1]),
                       acc["block_m"], acc["k_dim"], acc["group_t"], acc["usage_ratio"], hist)

    def _record_nnz(self, site: str, block_m: int, k_dim: int, rows: int, nnz: Any,
                    group_t: int = 0, usage_ratio: float | None = None,
                    match_hist: Any = None, shards: int | None = None) -> None:
        """One execution's host-side counters, as the reference records them."""
        nnz = np.asarray(nnz)
        self._fold(site, 1, rows, int(nnz.sum()), int(nnz.max(initial=0)), block_m, k_dim,
                   group_t, usage_ratio, match_hist, shards)

    def _fold(self, site: str, executions: int, rows: int, nnz_total: int, nnz_max: int,
              block_m: int, k_dim: int, group_t: int, usage_ratio: float | None,
              match_hist: Any = None, shards: int | None = None) -> None:
        with self._lock:
            c = self._sites.setdefault(site, {
                "executions": 0, "rows": 0, "l2_nnz_total": 0, "l2_nnz_max_block": 0,
                "block_m": block_m, "k_dim": k_dim, "group_t": group_t,
                "usage_ratio": usage_ratio, "shards": shards or 1,
            })
            c["executions"] += executions
            c["rows"] += rows
            c["l2_nnz_total"] += nnz_total
            c["l2_nnz_max_block"] = max(c["l2_nnz_max_block"], nnz_max)
            c["block_m"], c["k_dim"], c["group_t"] = block_m, k_dim, group_t
            c["usage_ratio"] = usage_ratio
            if shards:
                c["shards"] = shards
            if match_hist is not None:
                # the site's (T, q+1) runtime match histogram; resolve()
                # derives later calls' gather sets from it
                h = np.asarray(match_hist, np.int64)
                prev = c.get("usage_runtime")
                if prev is not None and prev.shape == h.shape:
                    h = prev + h
                c["usage_runtime"] = h
            max_block = c["l2_nnz_max_block"]
        self.metrics.counter("site_executions", "fused-kernel executions",
                             labelnames=("site",)).inc(executions, site=site)
        self.metrics.counter("site_rows", "activation rows processed",
                             labelnames=("site",)).inc(rows, site=site)
        self.metrics.counter("site_l2_nnz", "L2 nonzeros",
                             labelnames=("site",)).inc(nnz_total, site=site)
        self.metrics.gauge("site_l2_nnz_max_block", "peak per-block L2 nnz",
                           labelnames=("site",)).set(max_block, site=site)

    # ----------------------------------------------------------- reporting --
    def decisions(self) -> dict[tuple[str, str, str], int]:
        """Decision counts keyed by (site, impl, reason): one per resolved
        call (the port runs eagerly, so these count calls, not traces). A
        view over the ``phi_dispatch_decisions`` counter."""
        return {key: int(v) for key, v in self._dec.items()}

    def last_decision(self, site: str) -> Decision | None:
        """The most recent Decision resolved for ``site``."""
        with self._lock:
            return self._last.get(site)

    def report(self) -> dict:
        """Decision counts and the packer-budget view of the aggregated
        fused-kernel ``l2_nnz`` counters."""
        from repro_torch.core.perfmodel import packer_budget_report

        self._flush()
        with self._lock:
            sites = {k: dict(v) for k, v in self._sites.items()}
        return {"decisions": self.decisions(), "packer_budgets": packer_budget_report(sites)}

    def metrics_snapshot(self) -> dict:
        """Deterministic JSON view of the policy's metric registry."""
        self._flush()
        return self.metrics.snapshot()

    def log_report(self, prefix: str = "phi") -> None:
        """Log :meth:`report` (decision counts and packer budgets) at INFO."""
        rep = self.report()
        for (site, impl, reason), count in sorted(rep["decisions"].items()):
            log.info("%s dispatch: %-28s -> %-6s %-28s %d call(s)",
                     prefix, site, impl, reason, count)
        for b in rep["packer_budgets"]:
            log.info("%s packer:   %-28s execs=%-5d l2_nnz=%-10d peak_block_density=%.4f -> "
                     "cap_required=%d (nnz_budget >= %.4f)", prefix, b.site, b.executions,
                     b.l2_nnz_total, b.peak_block_density, b.cap_required,
                     b.nnz_budget_required)

    def reset(self, keep_usage: bool = False) -> None:
        """Clear decisions, runtime counters and metrics, and the calibration
        usage registry unless ``keep_usage`` (the between-runs reset: the
        histograms describe the model, not the run)."""
        with self._lock:
            self._last.clear()
            self._sites.clear()
            self._acc.clear()
            self._sets_on_device.clear()
            if not keep_usage:
                self._usage.clear()
                self._usage_skew.clear()
                self._call_skew.clear()
        self.metrics.reset()


# ---------------------------------------------------------- default policy ---
_default_policy = PhiExecutionPolicy()


def get_policy() -> PhiExecutionPolicy:
    """The process-wide execution policy every call site dispatches through."""
    return _default_policy


def set_policy(policy: PhiExecutionPolicy) -> PhiExecutionPolicy:
    """Swap the process-wide policy; returns the previous one (tests use
    this to install a fresh policy and restore the old)."""
    global _default_policy
    prev, _default_policy = _default_policy, policy
    return prev


def phi_matmul(a: torch.Tensor, w: torch.Tensor, patterns: torch.Tensor, pwp: torch.Tensor,
               **kwargs: Any) -> torch.Tensor:
    """Module-level shorthand: policy-dispatched Phi matmul. Accepts the
    same keywords as :meth:`PhiExecutionPolicy.matmul`."""
    return _default_policy.matmul(a, w, patterns, pwp, **kwargs)


def phi_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        patterns: torch.Tensor | None = None, **kwargs: Any) -> torch.Tensor:
    """Module-level shorthand: policy-dispatched flash attention. Accepts the
    same keywords as :meth:`PhiExecutionPolicy.attention`."""
    return _default_policy.attention(q, k, v, patterns, **kwargs)


# -------------------------------------------------- checkpoint persistence ---
def checkpoint_extra(cfg: Any) -> dict:
    """Policy-relevant config to persist in a checkpoint's ``extra`` dict."""
    phi = getattr(cfg, "phi", None)
    if phi is not None and getattr(phi, "impl", None) is not None:
        return {_CKPT_KEY: phi.impl}
    return {}


def apply_checkpoint_extra(cfg: Any, extra: dict | None) -> Any:
    """Re-apply a persisted impl override onto a restored config (a
    dataclass with a ``phi`` field). A live override wins."""
    impl = (extra or {}).get(_CKPT_KEY)
    phi = getattr(cfg, "phi", None)
    if impl and phi is not None and getattr(phi, "impl", None) is None:
        return dataclasses.replace(cfg, phi=dataclasses.replace(phi, impl=impl))
    return cfg


def usage_checkpoint_extra(usage: dict | None) -> dict:
    """Pattern-usage histograms (name -> (T, q+1) counts, e.g.
    ``PhiState.usage``) as a JSON-able checkpoint ``extra`` payload."""
    if not usage:
        return {}
    return {_USAGE_KEY: {name: np.asarray(u).astype(np.int64).tolist()
                         for name, u in usage.items()}}


def usage_from_checkpoint_extra(extra: dict | None) -> dict:
    """Inverse of :func:`usage_checkpoint_extra`: name -> (T, q+1) int64."""
    raw = (extra or {}).get(_USAGE_KEY) or {}
    return {name: np.asarray(v, np.int64) for name, v in raw.items()}
