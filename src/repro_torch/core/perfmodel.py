"""First-order cycle & energy model of the Phi accelerator (paper Sec. 5).

This is the evaluation methodology the paper itself uses (a behavioural
simulator + synthesis numbers); no 28nm flow exists here, so we re-derive
performance analytically from the *same* architecture parameters (Table 1)
and the *measured* Phi sparsity statistics of a workload:

  Phi @ 500 MHz:   L1/L2 processors: 8 channels × 32-SIMD adder trees each.
    matcher cycles = row-tiles/16                (16-wide matcher array, overlapped)
    L1 cycles      = assigned_tiles · (N/32) / 8 / util   (PWP retrieval+reduce)
    L2 cycles      = nnz_L2 · (N/32) / 8 / util  (packed ±1 units)
    mem cycles     = bytes / (64 GB/s ÷ 500 MHz) (DDR4, Table 1)
    layer cycles   = max(compute=max(L1, L2), matcher, mem)  (K-first overlap)
  util = 0.7 covers pipeline sync/drain, the "straightforward" zero-skipping
  compromise (Sec 4.4) and packer residuals; timesteps×batch amortise weight
  and PWP fetches. DDR4 background power charges slow designs their idle DRAM.

  OPs are counted as the paper counts them (Sec. 5.1): one OP per '1' in the
  *bit-sparse* activation — so all designs are compared on identical work.

Baselines: the dense Spiking Eyeriss is modelled structurally (168 PEs,
perfect utilisation — generous to the baseline); SpinalFlow/SATO/PTB/Stellar
are taken from their *reported* Table 2 throughput/energy ratios over
Eyeriss, since their microarchitectures are not the paper's contribution.
The claim under reproduction is the Phi-side model + its ratio to those.

Energy: core power from Table 3 (346.6 mW total incl. buffers) + DRAM at
20 pJ/byte (DDR4 ballpark used by DRAMsim-class models).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.assign import PhiStats

# Hardware parameters live in core.hwconst — the single module both this
# analytical model and the event-driven simulator (repro_torch.sim) read, so
# the two perf stories can never drift apart on a constant. Names are
# re-bound here as the reference module re-binds them.
from repro_torch.core.hwconst import (  # noqa: F401  (re-exported constants)
    ARRAY_UTIL,
    CHANNELS,
    CORE_POWER_W,
    DRAM_BPC,
    DRAM_PJ_PER_BYTE,
    DRAM_STATIC_W,
    EYERISS_POWER_W,
    FREQ,
    PE_EYERISS,
    SIMD,
)

# Reported Table 2 ratios over Spiking Eyeriss (throughput, energy-eff):
REPORTED = {
    "eyeriss": (1.0, 1.0),
    "spinalflow": (6.29, 18.575),
    "sato": (3.96, 10.32),
    "ptb": (1.99, 2.06),
    "stellar": (6.39, 11.96),
}
PAPER_PHI = (26.70, 55.41)      # Phi's own reported ratios (Table 2)


@dataclasses.dataclass(frozen=True)
class GemmShape:
    """One GEMM problem: (M, K) activations against a (K, N) weight."""

    m: int
    k: int
    n: int


@dataclasses.dataclass
class LayerPerf:
    """Per-layer cycle/traffic ledger from the accelerator cycle model."""

    cycles: float
    ops: float                  # bit-sparsity OPs (paper metric)
    dram_bytes: float
    matcher_cycles: float
    l1_cycles: float
    l2_cycles: float
    mem_cycles: float


def phi_layer(shape: GemmShape, st: PhiStats, k: int = 16, q: int = 128,
              bytes_per_el: int = 1, pwp_util: float = 0.2773,
              timesteps: int = 4, batch: int = 8) -> LayerPerf:
    """Cycle model of one GEMM on the Phi accelerator.

    pwp_util: fraction of PWPs actually fetched (paper Sec. 4.4: 27.73% of
    patterns are used per tile; the prefetcher loads only those).
    SNN semantics: activations/compute repeat per timestep and batch element;
    weights and PWPs are fetched once (buffered) per layer pass.
    """
    M, K, N = shape.m, shape.k, shape.n
    reps = timesteps * batch
    tiles = M * (K / k)
    matcher = tiles / 16 * reps  # matcher array: 16 row-tiles per cycle
    l1_units = st.idx_density * tiles * (N / SIMD) * reps
    l2_units = st.l2_density * M * K * (N / SIMD) * reps
    l1 = l1_units / CHANNELS / ARRAY_UTIL
    l2 = l2_units / CHANNELS / ARRAY_UTIL
    # DRAM: weights (for L2) + prefetched PWPs + compressed activations + out
    w_bytes = K * N * bytes_per_el
    pwp_bytes = (K / k) * q * N * bytes_per_el * pwp_util
    act_bytes = (st.l2_density * M * K * 2 + M * (K / k)) * reps  # COO + idx
    out_bytes = M * N * bytes_per_el * reps
    dram = w_bytes + pwp_bytes + act_bytes + out_bytes
    mem = dram / DRAM_BPC
    cycles = max(max(l1, l2), matcher, mem)
    ops = st.bit_density * M * K * N * reps
    return LayerPerf(cycles, ops, dram, matcher, l1, l2, mem)


def eyeriss_layer(shape: GemmShape, st: PhiStats, bytes_per_el: int = 1,
                  timesteps: int = 4, batch: int = 8) -> LayerPerf:
    """Dense spiking Eyeriss: all MACs on 168 PEs, dense traffic."""
    M, K, N = shape.m, shape.k, shape.n
    reps = timesteps * batch
    compute = M * K * N / PE_EYERISS * reps
    dram = K * N * bytes_per_el + (M * K / 8 + M * N * bytes_per_el) * reps
    mem = dram / DRAM_BPC
    cycles = max(compute, mem)
    ops = st.bit_density * M * K * N * reps
    return LayerPerf(cycles, ops, dram, 0.0, 0.0, 0.0, mem)


def summarize(layers: list[LayerPerf], core_power: float = CORE_POWER_W) -> dict:
    """Aggregate per-layer ledgers into network totals (cycles, GOPS,
    DRAM GB, energy) at the modelled clock and power."""
    cycles = sum(lp.cycles for lp in layers)
    ops = sum(lp.ops for lp in layers)
    dram = sum(lp.dram_bytes for lp in layers)
    secs = cycles / FREQ
    gops = ops / secs / 1e9
    energy = secs * (core_power + DRAM_STATIC_W) + dram * DRAM_PJ_PER_BYTE * 1e-12
    gopj = ops / energy / 1e9
    return {"cycles": cycles, "ops": ops, "gops": gops,
            "dram_gb": dram / 1e9, "energy_j": energy, "gop_per_j": gopj}


def compare(shapes: list[GemmShape], stats: list[PhiStats]) -> dict:
    """Full comparison table: Phi (modelled) vs baselines (Eyeriss modelled;
    others via their reported ratios). Returns ratios over Spiking Eyeriss."""
    phi = summarize([phi_layer(s, st) for s, st in zip(shapes, stats)])
    eye = summarize([eyeriss_layer(s, st) for s, st in zip(shapes, stats)],
                    core_power=EYERISS_POWER_W)
    out = {
        "phi_gops": phi["gops"],
        "phi_gop_per_j": phi["gop_per_j"],
        "phi_speedup_vs_eyeriss": eye["cycles"] / phi["cycles"],
        "phi_energy_eff_vs_eyeriss": phi["gop_per_j"] / eye["gop_per_j"],
        "paper_phi_speedup": PAPER_PHI[0],
        "paper_phi_energy_eff": PAPER_PHI[1],
    }
    for name, (thr, en) in REPORTED.items():
        if name == "eyeriss":
            continue
        out[f"phi_speedup_vs_{name}"] = out["phi_speedup_vs_eyeriss"] / thr
        out[f"phi_energy_eff_vs_{name}"] = out["phi_energy_eff_vs_eyeriss"] / en
        out[f"paper_speedup_vs_{name}"] = PAPER_PHI[0] / thr
        out[f"paper_energy_eff_vs_{name}"] = PAPER_PHI[1] / en
    return out


# ----------------------------------------------------- kernel HBM traffic ---
# First-order HBM byte model of the reference package's two kernel lowerings
# of phi_matmul (the per-unit pipeline and the fused single-pass kernels),
# following their block-revisit rule: a block is re-fetched iff its index
# map changes between consecutive grid steps, held in fast memory otherwise.
# The formulas are the reference's, so the port's numbers equal its numbers;
# chip_smoke.py prints them at the Hopper kernels' tiles beside each GEMM's
# bound and measured time (the Hopper kernels' L2 cache, which this model
# does not have, serves the repeated PWP and weight stripes).

@dataclasses.dataclass(frozen=True)
class KernelTraffic:
    """Per-stream HBM bytes of one phi_matmul lowering."""

    a_bytes: float          # binary activation blocks
    patterns_bytes: float   # pattern tensor streams
    pwp_bytes: float        # PWP stripe streams
    w_bytes: float          # weight stripe streams (L2 side)
    idx_bytes: float        # (M, T) index write + re-reads   (3-kernel only)
    residual_bytes: float   # (M, K) residual write + read    (3-kernel only)
    coo_bytes: float        # packed/bucketed COO round-trips (3-kernel only)
    out_bytes: float        # partial + final output traffic

    @property
    def total(self) -> float:
        """Sum of every per-stream byte count (the gated headline number)."""
        return (self.a_bytes + self.patterns_bytes + self.pwp_bytes
                + self.w_bytes + self.idx_bytes + self.residual_bytes
                + self.coo_bytes + self.out_bytes)


def phi_kernel_traffic(shape: GemmShape, *, k: int = 16, q: int = 128,
                       block_m: int = 256, block_n: int = 256,
                       nnz_budget: float = 0.08, pwp_bytes_per_el: int = 4,
                       w_bytes_per_el: int = 4,
                       pwp_usage: float | None = None,
                       prefetch_prepass: bool = True
                       ) -> dict[str, KernelTraffic]:
    """HBM bytes of the 3-kernel pipeline vs the fused single-pass kernels.

    Returns {"three_kernel": ..., "fused": ..., "fused_stream": ...,
    "fused_prefetch": ...}. The fused savings are the index and residual
    round-trips, the per-M-stripe pattern re-fetches, and the collapse of
    two partial (M, N) f32 outputs into one write. The K-streaming variant
    keeps every one of those savings — activations and weights are still
    fetched once per M-stripe per N-block and there is still no
    index/residual round-trip — but its manually-DMA'd operands are not
    held across grid steps by the pipeline revisit rule, so the activation
    block and pattern groups are re-streamed per N-block (a (gn−1)·M·K cost
    the all-resident kernel avoids; gn == 1 for the large-K layer shapes
    the streaming path exists for).

    ``pwp_usage`` is the measured fraction of the PWP bank the prefetching
    kernel streams ((P+1)/(q+1) from ``patterns.active_pattern_sets``; the
    paper measures ≈0.2773). The ``fused_prefetch`` entry scales the PWP
    stream by it and additionally pays the trace-time active-set pre-pass
    (one extra read of the activations and pattern bank, plus the tiny
    scalar-prefetched index tensor). With ``pwp_usage=None`` the entry is
    modelled at usage 1.0 — i.e. strictly worse than "fused", which is why
    the policy only picks it when a histogram shows skew.

    ``prefetch_prepass=False`` models the runtime-telemetry variant of the
    prefetching kernel (``dispatch`` feeds ``ops.phi_fused_prefetch`` the
    site's aggregated match histogram as ``runtime_sets``): the trace-time
    pre-pass — one extra read of the activations and the full pattern
    bank — disappears from the ``fused_prefetch`` entry.
    """
    M, K, N = shape.m, shape.k, shape.n
    T = K // k
    gm, gn = -(-M // block_m), -(-N // block_n)
    f32 = 4
    pwp_stream = gm * T * (q + 1) * N * pwp_bytes_per_el  # per-M-stripe PWP
    w_stream = gm * K * N * w_bytes_per_el                # per-M-stripe W
    cap = max(128, int(nnz_budget * M * K))
    per_block = max(8, min(cap, int(4 * nnz_budget * block_m * K)))

    three = KernelTraffic(
        a_bytes=M * K * f32,                       # matcher reads a once
        patterns_bytes=gm * T * q * k * f32,       # matcher re-streams per i
        pwp_bytes=pwp_stream,                      # l1_gather
        w_bytes=w_stream,                          # l2_spmm
        idx_bytes=M * T * 4 * (1 + gn),            # write + per-n-block reads
        residual_bytes=M * K * (1 + 1),            # int8 write + pack read
        coo_bytes=cap * (4 + 4 + 1) * 2            # global COO write + read
                  + gm * per_block * (4 + 4 + 4) * 2,  # bucketed write + read
        out_bytes=M * N * f32 * 5,                 # out1+out2 w, both r, sum w
    )
    fused = KernelTraffic(
        a_bytes=M * K * f32,                       # a block held over n sweep
        patterns_bytes=T * q * k * f32,            # constant index map: once
        pwp_bytes=pwp_stream,
        w_bytes=w_stream,
        idx_bytes=0.0,                             # lives in registers
        residual_bytes=0.0,                        # lives in registers
        coo_bytes=0.0,                             # no packing stage
        out_bytes=M * N * f32 + gm * 4,            # single write + nnz audit
    )
    fused_stream = KernelTraffic(
        a_bytes=gn * M * K * f32,                  # group DMAs per (i, j)
        patterns_bytes=gm * gn * T * q * k * f32,  # group DMAs per (i, j)
        pwp_bytes=pwp_stream,                      # (q+1, bn) stripes: same
        w_bytes=w_stream,                          # (gk, bn) stripes: same
        idx_bytes=0.0,                             # lives in registers
        residual_bytes=0.0,                        # lives in registers
        coo_bytes=0.0,                             # no packing stage
        out_bytes=M * N * f32 + gm * 4,            # single write + nnz audit
    )
    usage = 1.0 if pwp_usage is None else float(pwp_usage)
    p_active = max(1, int(round(usage * (q + 1))) - 1)
    prepass = 1 if prefetch_prepass else 0
    fused_prefetch = KernelTraffic(
        # trace-time active-set pre-pass reads a once more; kernel holds the
        # block over the n sweep like "fused". With runtime-telemetry sets
        # (prefetch_prepass=False) the extra read disappears.
        a_bytes=(1 + prepass) * M * K * f32,
        # pre-pass reads the full bank once; the kernel DMA-gathers the
        # per-stripe active rows inside the body, i.e. once per (i, j) grid
        # step (gm·gn — same accounting as fused_stream's group DMAs); the
        # scalar-prefetched (gm, T, P) index tensor rides along (int32)
        patterns_bytes=(prepass * T * q * k * f32
                        + gm * gn * T * p_active * k * f32
                        + gm * T * p_active * 4),
        pwp_bytes=pwp_stream * usage,              # only referenced rows
        w_bytes=w_stream,
        idx_bytes=0.0,                             # lives in registers
        residual_bytes=0.0,                        # lives in registers
        coo_bytes=0.0,                             # no packing stage
        out_bytes=M * N * f32 + gm * 4,            # single write + nnz audit
    )
    return {"three_kernel": three, "fused": fused,
            "fused_stream": fused_stream, "fused_prefetch": fused_prefetch}


# ------------------------------------------- coo path & launch overhead ---
# hwconst.KERNEL_LAUNCH_BYTES: one kernel launch in HBM byte-equivalents.
# Read by ops.launch_cost_prefers_coo: for tiny M the fused kernels' fixed
# full-bank streams plus this constant lose to the "coo" lowering, whose
# gathers touch only referenced rows.


def phi_coo_traffic(shape: GemmShape, *, k: int = 16, q: int = 128,
                    nnz_budget: float = 0.08, pwp_bytes_per_el: int = 4,
                    w_bytes_per_el: int = 4) -> float:
    """First-order HBM bytes of the "coo" lowering (gathers, no kernel).

    Unlike the fused kernels (which stream the whole PWP bank and weight
    stripe per M-stripe), the coo path's gathers read only the rows the
    workload references, so every term scales with M:

      * activations once, (M, T) index write+read, (M, K) int8 residual
        write+read (the round-trips fusion eliminates);
      * L1: one (N,)-row PWP gather per assigned row-partition;
      * L2: the capacity-bounded COO arrays plus one weight-row gather per
        residual entry;
      * out1/out2 partials written, read and summed.

    ``q`` only shapes the bank, not the traffic — which is exactly why this
    path wins at tiny M and loses at scale.
    """
    del q  # gathers touch referenced rows only; bank size cancels
    M, K, N = shape.m, shape.k, shape.n
    T = K // k
    f32 = 4
    a_bytes = M * K * f32
    idx_bytes = M * T * 4 * 2
    l1_bytes = M * T * N * pwp_bytes_per_el
    residual_bytes = M * K * 2
    nnz = nnz_budget * M * K
    l2_bytes = nnz * (4 + 4 + 1) + nnz * N * w_bytes_per_el
    out_bytes = M * N * f32 * 3
    return (a_bytes + idx_bytes + l1_bytes + residual_bytes + l2_bytes
            + out_bytes)


# --------------------------------------------- sharded (SPMD) HBM traffic ---
def phi_sharded_traffic(shape: GemmShape, *, shards: int,
                        row_parallel: bool = True, k: int = 16, q: int = 128,
                        block_m: int = 256, block_n: int = 256,
                        nnz_budget: float = 0.08, pwp_bytes_per_el: int = 4,
                        w_bytes_per_el: int = 4,
                        pwp_usage: float | None = None) -> dict:
    """Per-device HBM bytes of one GEMM sharded ``shards``-ways, comparing
    the mesh-aware dispatch (best fused lowering on the LOCAL shape) against
    the old blanket coo demotion on the same local shape.

    Row-parallel (Megatron-style ``k_ax``): each device owns K/shards of the
    contraction — and with it T/shards K-partitions of the pattern bank and
    PWPs — N replicates, and a psum over the (M, N) f32 out tile completes
    the reduction. Column-parallel: K, the bank and the PWP rows replicate;
    each device owns N/shards output columns. The psum cost is identical for
    both lowerings (it happens outside the kernel), so it is reported
    separately and included in neither total.

    Returns {"local_shape": GemmShape, "fused_impl": str,
    "fused": KernelTraffic, "coo": float, "psum_bytes": float}.
    """
    M, K, N = shape.m, shape.k, shape.n
    if row_parallel:
        assert K % (k * shards) == 0, (K, k, shards)
        local = GemmShape(M, K // shards, N)
    else:
        assert N % shards == 0, (N, shards)
        local = GemmShape(M, K, N // shards)
    traffic = phi_kernel_traffic(local, k=k, q=q, block_m=block_m,
                                 block_n=block_n, nnz_budget=nnz_budget,
                                 pwp_bytes_per_el=pwp_bytes_per_el,
                                 w_bytes_per_el=w_bytes_per_el,
                                 pwp_usage=pwp_usage)
    candidates = ["fused", "fused_stream"]
    if pwp_usage is not None:
        candidates.append("fused_prefetch")
    impl = min(candidates, key=lambda c: traffic[c].total)
    coo = phi_coo_traffic(local, k=k, q=q, nnz_budget=nnz_budget,
                          pwp_bytes_per_el=pwp_bytes_per_el,
                          w_bytes_per_el=w_bytes_per_el)
    # ring all-reduce: each device sends+receives 2·(s−1)/s of the tile
    psum = 2.0 * (shards - 1) / shards * M * N * 4 if row_parallel else 0.0
    return {"local_shape": local, "fused_impl": impl,
            "fused": traffic[impl], "coo": coo, "psum_bytes": psum}


# ----------------------------------------------- Phi attention HBM traffic ---
def phi_attention_traffic(s: int, d: int, *, heads: int = 1, batch: int = 1,
                          k: int = 16, q: int = 128, block_q: int = 128,
                          block_kv: int = 128,
                          l2_density: float = 0.03) -> dict[str, float]:
    """First-order HBM bytes of ``phi_flash`` vs dense flash attention.

    Dense flash re-streams the full K/V panels once per q-block (the classic
    flash cost: O(nq·S·D) f32 bytes), plus Q and the output once. The Phi
    lowering exploits what dense flash cannot: binary spike K rows stream as
    1-byte one-hot *indices* into the pattern bank (matched once, re-read per
    q-block) plus the sparse ±1 L2 residual as COO — so the per-q-block K
    traffic scales with ``l2_density`` (Table 4's L2⁺+L2⁻ residual density)
    instead of D f32 columns, and spike V panels stream at 1 byte/element.
    Q and the output stay f32 in both lowerings, so the ratio is driven by
    the K/V re-streaming term exactly as score FLOPs are by the L1/L2 split.

    ``l2_density`` is the residual nnz fraction of the K spike matrix
    (``core.patterns.PhiStats.l2_density``); paper Table-4 spike suites sit
    at 0.026–0.068 for 5–20 % input densities.

    Returns ``{"dense_flash": bytes, "phi_flash": bytes,
    "phi_attn_ratio": dense/phi}`` — the ratio is the reference
    benchmark's no-shrink column.
    """
    bq = min(block_q, s)
    bkv = min(block_kv, s)
    nq = -(-s // bq)
    skv = -(-s // bkv) * bkv
    bh = batch * heads
    f32 = 4
    t = max(d // k, 1)
    # dense flash: Q + out once; K,V f32 panels re-streamed per q-block.
    dense = bh * (s * d * f32                 # Q
                  + nq * skv * d * f32 * 2    # K, V per q-block
                  + s * d * f32)              # out
    # phi_flash: Q + out once (f32); per q-block the K panel is the pattern
    # bank (binary, kp·qp per partition) + a 1-byte idx stream + the sparse
    # L2 residual COO (4-byte col + 1-byte sign per entry... row implicit in
    # the block walk) + the binary V panel.
    coo_entry = 2                             # packed (col:int16-ish, ±1 sign)
    phi = bh * (s * d * f32                   # Q
                + nq * (t * q * k             # binary pattern bank
                        + skv * t             # one-hot idx stream, 1 B
                        + l2_density * skv * d * coo_entry   # L2 residual COO
                        + skv * d)            # binary V panel, 1 B
                + s * d * f32)                # out
    return {"dense_flash": float(dense), "phi_flash": float(phi),
            "phi_attn_ratio": float(dense) / float(phi)}


# --------------------------------------------------- packer budget report ---
# The fused kernels are budget-free but emit per-M-block l2_nnz counters,
# which the execution policy (kernels.dispatch) aggregates per call site.
# This converts those runtime counters into the static capacity a budgeted
# pipeline — the ASIC packer of paper Sec. 4.3, or the coo/pallas
# lowerings' per-block ``cap`` — would have needed to run the same workload
# without dropping a single L2 entry.

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


def vgg16_gemm_shapes(img: int = 32, classes: int = 100) -> list[GemmShape]:
    """VGG-16 (CIFAR variant: 13 convs + 1 FC) as im2col GEMMs."""
    cfg = [(64, 3), (64, 64), (128, 64), (128, 128), (256, 128), (256, 256),
           (256, 256), (512, 256), (512, 512), (512, 512), (512, 512),
           (512, 512), (512, 512)]
    sizes = [32, 32, 16, 16, 8, 8, 8, 4, 4, 4, 2, 2, 2]
    shapes = [GemmShape(s * s, 9 * cin, cout) for (cout, cin), s in zip(cfg, sizes)]
    shapes += [GemmShape(1, 512, classes)]
    return shapes


# --------------------------------------------------------------------------
# Serving-cache byte models.
#
# The reference's paged serving engine reports its decode-cache footprint;
# these two closed forms are the model it is checked against. A contiguous
# engine reserves
# slots x max_context key/value rows per scan step up front; a paged pool
# holds num_pages fixed-size pages (plus one scratch page for inactive
# lanes) and only the high-water mark of pages ever backs real tokens.

def kv_cache_bytes(*, n_scan: int, slots: int, context: int,
                   kv_heads: int, head_dim: int,
                   dtype_bytes: int = 4) -> int:
    """Bytes of a contiguous decode KV cache.

    ``n_scan`` is the number of scanned layer groups (each holding one K and
    one V leaf of shape ``(slots, context, kv_heads, head_dim)``).
    """
    per_leaf = slots * context * kv_heads * head_dim * dtype_bytes
    return 2 * n_scan * per_leaf


def paged_pool_bytes(*, n_scan: int, num_pages: int, page_size: int,
                     kv_heads: int, head_dim: int,
                     dtype_bytes: int = 4) -> int:
    """Bytes of a paged decode KV pool (includes the +1 scratch page)."""
    per_leaf = (num_pages + 1) * page_size * kv_heads * head_dim * dtype_bytes
    return 2 * n_scan * per_leaf


# --------------------------------------------------------------------------
# Observability byte-overhead model.
#
# The obs layer is host-side only — it never adds device traffic — but its
# artifacts (trace JSONL, metric snapshots) are bytes a production
# deployment ships per request. This closed form turns the measured artifact
# sizes into the two numbers the reference's benchmark pins: bytes of
# observability output per decoded token, and the overhead fraction against
# the payload the run actually served (the KV-cache bytes it touched).

def obs_overhead_report(*, trace_bytes: int, metrics_bytes: int,
                        decoded_tokens: int, payload_bytes: int) -> dict:
    """Observability overhead accounting for one serve run.

    ``trace_bytes``/``metrics_bytes`` are the serialized artifact sizes,
    ``decoded_tokens`` the run's decoded-token count, ``payload_bytes`` the
    reference payload (typically the engine's ``contig_cache_bytes``).
    Returns gate-named columns: ``*_bytes`` and ``*_frac`` are the
    reference benchmark's no-grow columns.
    """
    total = int(trace_bytes) + int(metrics_bytes)
    return {
        "obs_trace_bytes": int(trace_bytes),
        "obs_metrics_bytes": int(metrics_bytes),
        "obs_bytes_per_token": round(total / max(1, int(decoded_tokens)), 4),
        "obs_overhead_frac": round(total / max(1, int(payload_bytes)), 6),
    }
