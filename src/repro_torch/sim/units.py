"""Composable hardware units of the Phi accelerator simulator.

Each unit owns a FIFO timeline inside the shared :class:`~repro_torch.sim.engine
.Engine` and charges per-access dynamic energy from ``core.hwconst`` — the
same constants the analytical model reads. Durations are integer cycles
(ceil), dependencies are passed as ready-times, so a unit is both the
cycle *and* the energy ledger for its pipeline stage.

Paper mapping (Sec. 4): :class:`MatcherArray` — Fig. 4a matcher array;
:class:`PwpBuffer` — Fig. 4b PWP buffer + the Sec. 4.4 usage-driven
prefetcher; :class:`AdderTreeArray` — the 8-channel × 32-SIMD L1/L2
processors (instantiated once per level); :class:`L2Packer` — the Sec. 4.3
packer with a finite entry capacity; :class:`DramChannel` — the Table-1
DDR4 channel with double-buffered DMA.
"""
from __future__ import annotations

import math

from repro_torch.core import hwconst as hw
from repro_torch.sim.engine import Engine


class DramChannel:
    """Finite-bandwidth DRAM channel; per-stream byte + energy accounting.

    Double-buffered DMA is expressed by the *caller* passing ``ready`` =
    the cycle its buffer slot frees (compute done two stripes back); the
    channel itself serialises transfers at ``bpc`` bytes/cycle.
    """

    def __init__(self, engine: Engine, name: str = "dram",
                 bpc: float = hw.DRAM_BPC,
                 pj_per_byte: float = hw.DRAM_PJ_PER_BYTE):
        self.engine = engine
        self.name = name
        self.bpc = bpc
        self.pj_per_byte = pj_per_byte
        self.stream_bytes: dict[str, int] = {}

    def transfer(self, ready: int, nbytes: float, stream: str) -> int:
        nbytes = int(math.ceil(nbytes))
        if nbytes <= 0:
            return int(ready)
        self.stream_bytes[stream] = self.stream_bytes.get(stream, 0) + nbytes
        return self.engine.submit(
            self.name, ready, math.ceil(nbytes / self.bpc), kind=stream,
            count=nbytes, energy_pj=nbytes * self.pj_per_byte)


class MatcherArray:
    """16-wide pattern matcher: ``width`` row-tiles q-way-matched per cycle."""

    def __init__(self, engine: Engine, width: int = hw.MATCHER_WIDTH,
                 name: str = "matcher"):
        self.engine = engine
        self.width = width
        self.name = name

    def match(self, ready: int, row_tiles: int) -> int:
        if row_tiles <= 0:
            return int(ready)
        return self.engine.submit(
            self.name, ready, math.ceil(row_tiles / self.width),
            kind="tile_match", count=row_tiles,
            energy_pj=row_tiles * hw.E_MATCH_PJ)


class PwpBuffer:
    """On-chip PWP buffer + usage-driven prefetcher.

    Holds pattern-weight-product rows ((N,) vectors); capacity in rows is
    derived from the buffer size and the row byte width. ``fill`` fetches a
    row working set through the DRAM channel, keeping rows resident across
    stripes when they fit — the fraction that does not fit is re-fetched
    every stripe (the Fig. 7d refetch behaviour). Reads by the L1
    accumulator charge SRAM read energy but ride the L1 timeline.
    """

    def __init__(self, engine: Engine, dram: DramChannel, n: int,
                 bytes_per_el: int, capacity_kb: int = hw.PWP_BUFFER_KB,
                 name: str = "pwp_buffer"):
        self.engine = engine
        self.dram = dram
        self.name = name
        self.row_bytes = n * bytes_per_el
        self.capacity_rows = max(1, (capacity_kb * 1024) // self.row_bytes)
        self.resident_rows = 0

    def fill(self, ready: int, want_rows: int) -> int:
        """Make ``want_rows`` PWP rows available; returns the ready cycle.
        Rows already resident are free; misses stream from DRAM and charge
        an SRAM write per byte."""
        hit = min(self.resident_rows, want_rows, self.capacity_rows)
        miss = max(0, min(want_rows, self.capacity_rows) - hit) \
            + max(0, want_rows - self.capacity_rows)
        self.resident_rows = min(self.capacity_rows, want_rows)
        if miss == 0:
            return int(ready)
        nbytes = miss * self.row_bytes
        done = self.dram.transfer(ready, nbytes, "pwp")
        self.engine.charge(self.name, kind="fill_row", count=miss,
                           energy_pj=nbytes * hw.E_SRAM_WR_PJ_B)
        return done

    def read(self, rows: int) -> None:
        """Charge SRAM read energy for ``rows`` row reads (L1 side)."""
        if rows > 0:
            self.engine.charge(self.name, kind="read_row", count=rows,
                               energy_pj=rows * self.row_bytes
                               * hw.E_SRAM_RD_PJ_B)


class AdderTreeArray:
    """8-channel × 32-SIMD accumulate array (one instance per L1/L2 level)."""

    def __init__(self, engine: Engine, name: str,
                 channels: int = hw.CHANNELS, simd: int = hw.SIMD,
                 util: float = hw.ARRAY_UTIL):
        self.engine = engine
        self.name = name
        self.channels = channels
        self.simd = simd
        self.util = util

    def accumulate(self, ready: int, units: int, n: int) -> int:
        """``units`` retrievals/entries, each contracted over an (N,)-row in
        ``ceil(N / simd)`` SIMD ops spread over the channels."""
        if units <= 0:
            return int(ready)
        simd_ops = units * math.ceil(n / self.simd)
        cycles = math.ceil(simd_ops / self.channels / self.util)
        return self.engine.submit(self.name, ready, cycles, kind="simd_op",
                                  count=simd_ops,
                                  energy_pj=simd_ops * hw.E_SIMD_OP_PJ)


class L2Packer:
    """Finite-capacity L2 packer: groups residual nonzeros for the sparse
    PEs at ``rate`` entries/cycle, ``cap`` entries per round.

    A stripe whose residual exceeds ``cap`` drains in multiple rounds —
    nothing is dropped (the conservation invariant), the extra rounds just
    serialise (per-round drain latency models the pipeline flush the
    Sec. 4.4 "straightforward" compromise eats). ``cap_required`` tracks
    the capacity a single-round packer would have needed — the quantity
    cross-checked against ``perfmodel.packer_budget_report``.
    """

    DRAIN_CYCLES = 8

    def __init__(self, engine: Engine, cap: int = hw.PACKER_CAP,
                 rate: int = hw.PACKER_RATE, name: str = "packer"):
        self.engine = engine
        self.cap = cap
        self.rate = rate
        self.name = name
        self.packed_total = 0
        self.cap_required = 0
        self.rounds_max = 1

    def pack(self, ready: int, nnz: int) -> tuple[int, int]:
        """Pack one stripe's ``nnz`` residual entries; returns (done cycle,
        rounds)."""
        if nnz <= 0:
            return int(ready), 0
        rounds = math.ceil(nnz / self.cap)
        cycles = math.ceil(nnz / self.rate) \
            + (rounds - 1) * self.DRAIN_CYCLES
        self.packed_total += nnz
        self.cap_required = max(self.cap_required, nnz)
        self.rounds_max = max(self.rounds_max, rounds)
        done = self.engine.submit(self.name, ready, cycles, kind="entry",
                                  count=nnz, energy_pj=nnz * hw.E_PACK_PJ)
        return done, rounds


class DensePeArray:
    """Eyeriss-class dense PE array: ``pes`` MACs/cycle; zero-gating skips
    MAC *energy* (not cycles) on zero activations — the dense-skipping
    baseline the paper compares against."""

    def __init__(self, engine: Engine, pes: int = hw.PE_EYERISS,
                 name: str = "pe_array"):
        self.engine = engine
        self.pes = pes
        self.name = name

    def run(self, ready: int, macs: int, nz_macs: int) -> int:
        if macs <= 0:
            return int(ready)
        return self.engine.submit(
            self.name, ready, math.ceil(macs / self.pes), kind="mac",
            count=macs, energy_pj=nz_macs * hw.E_MAC_PJ)
