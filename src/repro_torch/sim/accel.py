"""Phi accelerator + Eyeriss-class baseline: composed unit simulations.

``PhiAcceleratorSim.run_layer`` walks one :class:`~repro_torch.sim.trace
.LayerTrace` stripe-by-stripe through the paper's pipeline (Sec. 4):

    DRAM ──DMA──▶ matcher ──┬──▶ PWP buffer ─▶ L1 adder trees ──┐
                            └──▶ L2 packer  ─▶ sparse PE array ─┴─▶ DRAM

with double-buffered DMA (stripe ``s``'s loads wait only on the buffer
slot freed by stripe ``s − 2``), the usage-driven PWP prefetcher (the
*same* ``core.patterns.active_pattern_sets`` hot sets the
``fused_prefetch`` kernel consumes — rows matching a pattern outside the
active set fall to the L2 residual, exactly like the kernel's restricted
assignment), and a finite-capacity L2 packer that drains oversized
stripes in rounds instead of dropping entries.

Two dataflows:

  * ``"asic"`` — the paper's accelerator: compressed activation streams
    (idx + COO), int8 weights/PWPs fetched once per layer and buffered,
    ``reps`` timestep×batch passes amortising them (cold pass + scaled
    warm pass, see ``engine.merge_reports``);
  * ``"tpu_fused"`` — the byte-for-byte stream schedule of the reference
    package's fused kernels (its name kept, so the two packages' results
    compare key for key; it carries bytes only, no device time or size),
    used to cross-validate the simulator's DRAM accounting against
    ``core.perfmodel.phi_kernel_traffic`` (the reference's acceptance
    bound: within 10%).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core import hwconst as hw
from repro_torch.sim.engine import Engine, merge_reports
from repro_torch.sim.trace import LayerTrace
from repro_torch.sim.units import (
    AdderTreeArray,
    DensePeArray,
    DramChannel,
    L2Packer,
    MatcherArray,
    PwpBuffer,
)


@dataclasses.dataclass(frozen=True)
class PhiSimConfig:
    """Simulator knobs (defaults = paper Table 1 via ``core.hwconst``)."""

    block_m: int = 128              # rows per M-stripe
    pwp_buffer_kb: int = hw.PWP_BUFFER_KB
    packer_cap: int = hw.PACKER_CAP
    packer_rate: int = hw.PACKER_RATE
    pwp_bytes_per_el: int = 1       # int8 PWPs on the ASIC
    w_bytes_per_el: int = 1
    out_bytes_per_el: int = 1
    prefetch: bool = True           # usage-driven PWP prefetcher
    dataflow: str = "asic"          # "asic" | "tpu_fused" (the reference kernels' bytes)
    prefetch_prepass: bool = True   # tpu_fused: trace-time active-set
    #                                 pre-pass (False = runtime-telemetry
    #                                 sets, no extra activation read)
    keep_log: bool = False


@dataclasses.dataclass
class LayerSimResult:
    """One simulated layer: schedule, per-unit ledgers, invariants."""

    name: str
    m: int
    k_dim: int
    n: int
    reps: int
    stripes: int
    cycles: int
    ops: int                        # paper metric: one OP per activation bit
    dram_bytes: dict[str, int]      # per-stream totals (reps included)
    units: dict[str, dict]          # busy cycles / utilization / counters
    energy_pj: dict[str, float]     # per-unit + static_* breakdown
    energy_total_pj: float
    l2_processed: int               # sparse-PE entries (== packer entries)
    l2_nnz_max_stripe: int
    packer_cap_required: int
    packer_rounds_max: int
    usage_fraction: float           # (P+1)/(q+1) the prefetcher streamed
    p_active: int                   # 0 = prefetcher found no skew

    @property
    def seconds(self) -> float:
        return self.cycles / hw.FREQ

    @property
    def energy_j(self) -> float:
        return self.energy_total_pj * 1e-12


def _restricted_split(trace: LayerTrace, active: np.ndarray | None
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Apply the prefetcher's restricted assignment to the trace.

    Returns (l1_mask (M, T) bool, l2_per_tile (M, T) int64): a tile whose
    matched pattern is outside the active set contributes its *raw* bits
    to L2 (the decomposition changes, the product does not) — identical to
    ``kernels.phi_fused`` prefetch semantics.
    """
    assigned = trace.idx < trace.q
    if active is None:
        l1_mask = assigned
    else:
        T, q = trace.t, trace.q
        active_mask = np.zeros((T, q + 1), bool)
        for t in range(T):
            active_mask[t, active[t]] = True
        l1_mask = assigned & active_mask[np.arange(T)[None, :], trace.idx]
    l2_per_tile = np.where(l1_mask, trace.tile_res,
                           trace.tile_pop).astype(np.int64)
    return l1_mask, l2_per_tile


class PhiAcceleratorSim:
    """Cycle-approximate event simulation of the Phi accelerator."""

    def __init__(self, cfg: PhiSimConfig | None = None):
        self.cfg = cfg or PhiSimConfig()

    # ------------------------------------------------------------- passes --
    def _run_pass(self, trace: LayerTrace, *, warm: bool,
                  l1_mask: np.ndarray, l2_per_tile: np.ndarray,
                  want_rows: int,
                  p_active: int) -> tuple[dict, DramChannel, L2Packer]:
        cfg = self.cfg
        tpu = cfg.dataflow == "tpu_fused"
        eng = Engine(keep_log=cfg.keep_log)
        dram = DramChannel(eng)
        matcher = MatcherArray(eng)
        f32 = 4
        pwp_el = f32 if tpu else cfg.pwp_bytes_per_el
        w_el = f32 if tpu else cfg.w_bytes_per_el
        pwp = PwpBuffer(eng, dram, trace.n, pwp_el,
                        capacity_kb=cfg.pwp_buffer_kb)
        if warm:
            pwp.resident_rows = min(pwp.capacity_rows, want_rows)
        l1 = AdderTreeArray(eng, "l1_tree")
        packer = L2Packer(eng, cap=cfg.packer_cap, rate=cfg.packer_rate)
        pe = AdderTreeArray(eng, "l2_pe")
        T, q, N = trace.t, trace.q, trace.n
        bm = min(cfg.block_m, trace.m)
        stripes = math.ceil(trace.m / bm)
        gathered = p_active > 0

        if tpu and cfg.prefetch_prepass and gathered and not warm:
            # trace-time active-set pre-pass: one extra read of the
            # activations and the pattern bank (perfmodel's 2·M·K a_bytes).
            dram.transfer(0, trace.m * trace.k_dim * f32, "a_prepass")
            dram.transfer(0, T * q * trace.k * f32, "patterns")

        compute_done: list[int] = []
        for s in range(stripes):
            lo, hi = s * bm, min((s + 1) * bm, trace.m)
            rows = hi - lo
            tiles = rows * T
            l1_tiles = int(l1_mask[lo:hi].sum())
            nnz = int(l2_per_tile[lo:hi].sum())
            slot_free = compute_done[s - 2] if s >= 2 else 0

            if tpu:
                act_done = dram.transfer(slot_free, rows * trace.k_dim * f32,
                                         "a")
                if s == 0 and not gathered:
                    # full resident bank (plain fused); the gathered modes
                    # read pattern rows per stripe below (the pre-pass, when
                    # on, already streamed the bank once)
                    dram.transfer(slot_free, T * q * trace.k * f32,
                                  "patterns")
                if gathered:
                    # per-stripe DMA gather of the active pattern rows plus
                    # the scalar-prefetched (T, P) index tensor
                    dram.transfer(slot_free, T * p_active * trace.k * f32
                                  + T * p_active * 4, "patterns")
                    pwp_rows = T * (p_active + 1)
                    pwp_done = dram.transfer(slot_free,
                                             pwp_rows * N * pwp_el, "pwp")
                else:
                    pwp_done = dram.transfer(slot_free,
                                             T * (q + 1) * N * pwp_el, "pwp")
                w_done = dram.transfer(slot_free, trace.k_dim * N * w_el, "w")
            else:
                # compressed Phi activation stream: (rows, T) idx bytes +
                # 2 B/COO residual unit (paper Fig. 12a compact format)
                act_done = dram.transfer(slot_free, rows * T + nnz * 2, "act")
                if s == 0 and not warm:
                    w_done = dram.transfer(slot_free,
                                           trace.k_dim * N * w_el, "w")
                else:
                    w_done = 0
                pwp_done = pwp.fill(slot_free, want_rows)

            match_done = matcher.match(act_done, tiles)
            l1_done = l1.accumulate(max(match_done, pwp_done), l1_tiles, N)
            pwp.read(l1_tiles)
            pack_done, _rounds = packer.pack(match_done, nnz)
            pe_done = pe.accumulate(max(pack_done, w_done), nnz, N)
            done = max(l1_done, pe_done, match_done)
            out_el = f32 if tpu else cfg.out_bytes_per_el
            dram.transfer(done, rows * N * out_el + (4 if tpu else 0), "out")
            compute_done.append(done)

        rep = eng.report(static_w={"core": hw.CORE_POWER_W,
                                   "dram": hw.DRAM_STATIC_W}, freq=hw.FREQ)
        return rep, dram, packer

    # -------------------------------------------------------------- layer --
    def run_layer(self, trace: LayerTrace) -> LayerSimResult:
        cfg = self.cfg
        from repro_torch.core.patterns import active_pattern_sets

        active, usage_fraction = (active_pattern_sets(trace.usage)
                                  if cfg.prefetch else (None, 1.0))
        p_active = 0 if active is None else int(active.shape[-1])
        l1_mask, l2_per_tile = _restricted_split(trace, active)
        want_rows = trace.t * ((p_active + 1) if p_active
                               else (trace.q + 1))

        reps = 1 if cfg.dataflow == "tpu_fused" else max(1, trace.reps)
        cold, dram_c, packer_c = self._run_pass(
            trace, warm=False, l1_mask=l1_mask, l2_per_tile=l2_per_tile,
            want_rows=want_rows, p_active=p_active)
        if reps > 1:
            warm, dram_w, packer_w = self._run_pass(
                trace, warm=True, l1_mask=l1_mask, l2_per_tile=l2_per_tile,
                want_rows=want_rows, p_active=p_active)
            rep = merge_reports(cold, warm, reps)
            streams = dict(dram_c.stream_bytes)
            for k, v in dram_w.stream_bytes.items():
                streams[k] = streams.get(k, 0) + (reps - 1) * v
            packed = packer_c.packed_total + (reps - 1) * packer_w.packed_total
        else:
            rep = cold
            streams = dict(dram_c.stream_bytes)
            packed = packer_c.packed_total

        bm = min(cfg.block_m, trace.m)
        stripe_nnz = [int(l2_per_tile[s * bm:(s + 1) * bm].sum())
                      for s in range(math.ceil(trace.m / bm))]
        return LayerSimResult(
            name=trace.name, m=trace.m, k_dim=trace.k_dim, n=trace.n,
            reps=reps, stripes=len(stripe_nnz), cycles=rep["cycles"],
            ops=trace.bit_nnz * trace.n * reps,
            dram_bytes=streams, units=rep["units"],
            energy_pj=rep["energy_pj"],
            energy_total_pj=rep["energy_total_pj"],
            l2_processed=packed,
            l2_nnz_max_stripe=max(stripe_nnz, default=0),
            packer_cap_required=packer_c.cap_required,
            packer_rounds_max=packer_c.rounds_max,
            usage_fraction=usage_fraction, p_active=p_active)

    def run(self, traces: list[LayerTrace]) -> list[LayerSimResult]:
        return [self.run_layer(t) for t in traces]


class EyerissSim:
    """Dense-skipping Eyeriss-class baseline on the same event engine.

    All M·K·N MACs execute on ``PE_EYERISS`` PEs (dense schedule — cycles
    do not shrink with sparsity); zero-gating skips MAC *energy* on zero
    activations. Dense traffic: 1-bit activation bitmap per pass, int8
    weights once, int8 outputs per pass — the ``eyeriss_layer`` analytical
    model walked as events.
    """

    def __init__(self, block_m: int = 128, keep_log: bool = False):
        self.block_m = block_m
        self.keep_log = keep_log

    def _run_pass(self, trace: LayerTrace, *, warm: bool
                  ) -> tuple[dict, DramChannel]:
        eng = Engine(keep_log=self.keep_log)
        dram = DramChannel(eng)
        pes = DensePeArray(eng)
        N = trace.n
        bm = min(self.block_m, trace.m)
        stripes = math.ceil(trace.m / bm)
        compute_done: list[int] = []
        for s in range(stripes):
            lo, hi = s * bm, min((s + 1) * bm, trace.m)
            rows = hi - lo
            slot_free = compute_done[s - 2] if s >= 2 else 0
            act_done = dram.transfer(slot_free,
                                     math.ceil(rows * trace.k_dim / 8), "act")
            w_done = 0
            if s == 0 and not warm:
                w_done = dram.transfer(slot_free, trace.k_dim * N, "w")
            macs = rows * trace.k_dim * N
            nz_macs = int(trace.tile_pop[lo:hi].sum()) * N
            done = pes.run(max(act_done, w_done), macs, nz_macs)
            dram.transfer(done, rows * N, "out")
            compute_done.append(done)
        rep = eng.report(static_w={"core": hw.EYERISS_POWER_W,
                                   "dram": hw.DRAM_STATIC_W}, freq=hw.FREQ)
        return rep, dram

    def run_layer(self, trace: LayerTrace) -> LayerSimResult:
        reps = max(1, trace.reps)
        cold, dram_c = self._run_pass(trace, warm=False)
        if reps > 1:
            warm, dram_w = self._run_pass(trace, warm=True)
            rep = merge_reports(cold, warm, reps)
            streams = dict(dram_c.stream_bytes)
            for k, v in dram_w.stream_bytes.items():
                streams[k] = streams.get(k, 0) + (reps - 1) * v
        else:
            rep = cold
            streams = dict(dram_c.stream_bytes)
        return LayerSimResult(
            name=trace.name, m=trace.m, k_dim=trace.k_dim, n=trace.n,
            reps=reps, stripes=math.ceil(trace.m / min(self.block_m,
                                                       trace.m)),
            cycles=rep["cycles"], ops=trace.bit_nnz * trace.n * reps,
            dram_bytes=streams, units=rep["units"],
            energy_pj=rep["energy_pj"],
            energy_total_pj=rep["energy_total_pj"],
            l2_processed=0, l2_nnz_max_stripe=0, packer_cap_required=0,
            packer_rounds_max=0, usage_fraction=1.0, p_active=0)

    def run(self, traces: list[LayerTrace]) -> list[LayerSimResult]:
        return [self.run_layer(t) for t in traces]


def tpu_traffic_crosscheck(trace: LayerTrace, cfg: PhiSimConfig | None = None
                           ) -> dict:
    """Cross-validate the simulator's DRAM accounting against the
    analytical kernel model.

    Runs the trace through the ``tpu_fused`` dataflow and compares the
    summed DMA bytes with ``perfmodel.phi_kernel_traffic`` for the same
    (shape, blocks, usage) config — the tests hold the two within 10%, so
    the event-driven and closed-form perf stories can never silently
    diverge. Returns {sim_bytes, model_bytes, rel_err, entry}.
    """
    from repro_torch.core.perfmodel import GemmShape, phi_kernel_traffic

    cfg = dataclasses.replace(cfg or PhiSimConfig(), dataflow="tpu_fused")
    res = PhiAcceleratorSim(cfg).run_layer(trace)
    tr = phi_kernel_traffic(
        GemmShape(trace.m, trace.k_dim, trace.n), k=trace.k, q=trace.q,
        block_m=min(cfg.block_m, trace.m), block_n=trace.n,
        pwp_usage=(res.usage_fraction if res.p_active else None),
        prefetch_prepass=cfg.prefetch_prepass)
    entry = "fused_prefetch" if (cfg.prefetch and res.p_active) else "fused"
    model_bytes = tr[entry].total
    sim_bytes = sum(res.dram_bytes.values())
    return {
        "entry": entry,
        "sim_bytes": sim_bytes,
        "model_bytes": model_bytes,
        "rel_err": abs(sim_bytes - model_bytes) / model_bytes,
        "usage_fraction": res.usage_fraction,
        "p_active": res.p_active,
    }


def summarize_run(results: list[LayerSimResult]) -> dict:
    """Aggregate a multi-layer run (the ``perfmodel.summarize`` analogue)."""
    cycles = sum(r.cycles for r in results)
    ops = sum(r.ops for r in results)
    energy_j = sum(r.energy_j for r in results)
    dram = sum(sum(r.dram_bytes.values()) for r in results)
    secs = cycles / hw.FREQ
    return {
        "cycles": cycles,
        "ops": ops,
        "gops": ops / secs / 1e9 if secs else 0.0,
        "dram_bytes": dram,
        "energy_j": energy_j,
        "gop_per_j": ops / energy_j / 1e9 if energy_j else 0.0,
    }
