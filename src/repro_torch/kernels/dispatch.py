"""Phi execution-policy layer, attention half (port of ``repro/kernels/dispatch.py``).

The model layer never names an attention lowering: every spiking attention
site routes through a :class:`PhiExecutionPolicy`, which resolves the
lowering per call, with the reference's rows in the reference's order
(``resolve_attention``) and its reason strings, so decisions compare word
for word on the CPU.

The backend is the operands' device. On ``cuda`` the Phi rows resolve to the
hand-written kernel (reason suffix ``_native``), and a bank or shape the
kernel cannot take raises: the card has no plain fallback. On the CPU the
plain lowering runs, as the reference's XLA lowering does off the TPU
(suffix ``_xla``). The autodiff rows read ``torch.is_grad_enabled()`` and
``requires_grad`` on the operands; they resolve the dense lowering, as the
reference's do, and its forward-only ``flash_attention`` then raises, since
no backward is ported yet. The SPMD rows of the reference wait for the
multi-device port. The matmul half (``resolve``, ``matmul``, the usage
registry and its ``PHI_IMPL`` override, runtime match telemetry,
``site_telemetry``, the checkpoint helpers) is not ported yet (ROADMAP
queue 1 item 7b); until it is, ``phi_apply``'s matmuls take
``ops.fused_shape_viable``'s answer.

Telemetry: every decision is counted (``decisions()``) and, when a tracer is
installed (``obs.trace.set_tracer``), emitted as a ``dispatch`` record.
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import threading
from typing import Any

import torch

from repro_torch.kernels import ATTN_IMPLS, ops
from repro_torch.models import flash as flash_mod
from repro_torch.obs import trace as obs_trace

log = logging.getLogger("repro_torch")


@dataclasses.dataclass(frozen=True)
class Decision:
    """One resolved dispatch: which lowering runs at a call site and why."""

    impl: str
    reason: str
    site: str
    shape: tuple            # matmul (M, K, N, T, q); attention (B·H·S, D, S, T, q)
    backend: str
    # attention: the (block_q, block_kv) both the Phi arm and a forced dense
    # arm run, for the bitwise A/B contract.
    blocks: tuple | None = None


class PhiExecutionPolicy:
    """Resolves the lowering per call and counts its decisions."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # (site, impl, reason) -> resolved calls
        self._counts: collections.Counter = collections.Counter()
        # site -> most recent full Decision
        self._last: dict[str, Decision] = {}

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
        key = (d.site, d.impl, d.reason)
        with self._lock:
            first = key not in self._counts
            self._counts[key] += 1
            self._last[d.site] = d
        tracer = obs_trace.get_tracer()
        if tracer is not None:
            tracer.emit("dispatch", site=d.site, impl=d.impl, reason=d.reason,
                        shape=[int(x) for x in d.shape],
                        blocks=None if d.blocks is None else [int(b) for b in d.blocks])
        if first:
            log.info("phi dispatch: %s -> %s (%s, M=%d K=%d N=%d)",
                     d.site, d.impl, d.reason, *d.shape[:3])

    # ----------------------------------------------------------- reporting --
    def decisions(self) -> dict[tuple[str, str, str], int]:
        """Decision counts keyed by (site, impl, reason): one per resolved
        call (the port runs eagerly, so these count calls, not traces)."""
        with self._lock:
            return dict(self._counts)

    def last_decision(self, site: str) -> Decision | None:
        """The most recent Decision resolved for ``site``."""
        with self._lock:
            return self._last.get(site)

    def reset(self) -> None:
        """Clear the decision counts and log."""
        with self._lock:
            self._last.clear()
            self._counts.clear()


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


def phi_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        patterns: torch.Tensor | None = None, **kwargs: Any) -> torch.Tensor:
    """Module-level shorthand: policy-dispatched flash attention. Accepts the
    same keywords as :meth:`PhiExecutionPolicy.attention`."""
    return _default_policy.attention(q, k, v, patterns, **kwargs)
