"""Hardware constants of the port — the single source of truth.

Two kinds of hardware are described here, and every module that needs a
number about either imports it from this one:

  * the Phi accelerator the paper models (28 nm, 500 MHz): the first-order
    analytical model (``core.perfmodel``) and the cycle-approximate
    event-driven simulator (``repro_torch.sim``) read the same parameters,
    which is what lets the tests cross-check the two stories;
  * the NVIDIA H100 the port's kernels run on: the kernels' shared-memory
    gates, the bounds ``chip_smoke.py`` prints, the launch-cost
    crossover (``ops.launch_cost_prefers_coo``) and the dry run's roofline
    (``distributed.cost_analysis``).

Architecture parameters (paper Table 1 / Sec. 4, 28nm @ 500 MHz) and the
Table 2/3 power figures are annotated inline; the per-access energies are
28nm-class ballparks (synthesis-report orders of magnitude, not measured)
chosen so that integrated core energy at full utilisation is consistent
with the Table 3 core power — the simulator's energy claims are *ratios*
against a baseline modelled with the same constants.
"""
from __future__ import annotations

# ------------------------------------------------------------------ clock ---
FREQ = 500e6                    # Hz (Table 1)

# ------------------------------------------------------------------- DRAM ---
DRAM_GBPS = 64e9                # DDR4, Table 1: 64 GB/s
DRAM_BPC = DRAM_GBPS / FREQ     # bytes per core cycle (= 128 B/cycle)
DRAM_PJ_PER_BYTE = 20.0         # pJ per byte (DRAMsim-class DDR4 ballpark)
DRAM_STATIC_W = 0.5             # DDR4 4-channel background power

# ------------------------------------------------------------- core power ---
CORE_POWER_W = 0.3466           # Phi total incl. buffers (Table 3)
EYERISS_POWER_W = 0.56          # area-scaled from Table 2 (1.068 vs 0.662 mm²)

# ------------------------------------------------------ Phi microarch dims ---
MATCHER_WIDTH = 16              # row-tiles matched per cycle (matcher array)
CHANNELS = 8                    # L1/L2 adder-tree channels
SIMD = 32                       # vector lanes per channel
ARRAY_UTIL = 0.7                # adder-tree pipeline/sync/skipping efficiency
PE_EYERISS = 168                # Eyeriss PE count (paper baseline config)
PWP_BUFFER_KB = 128             # on-chip PWP buffer (prefetcher working set)
PACKER_CAP = 4096               # L2 packer entry capacity per M-stripe round
PACKER_RATE = 16                # L2 entries packed per cycle

# -------------------------------------------------- per-access energy (pJ) ---
# 28nm-class dynamic energies per primitive event. The simulator charges
# exactly these (its energy total is, by construction, the sum over unit
# ledgers — asserted in tests/test_torch_sim.py), so the constants are the whole
# dynamic-energy story.
E_MATCH_PJ = 2.0                # one q-way Hamming match of a k-wide row tile
E_SIMD_OP_PJ = 1.2              # one 32-lane adder-tree accumulate
E_PACK_PJ = 0.3                 # one L2 entry through the packer
E_SRAM_RD_PJ_B = 0.05           # on-chip buffer read, per byte
E_SRAM_WR_PJ_B = 0.08           # on-chip buffer write, per byte
E_MAC_PJ = 2.3                  # one baseline 8-bit PE MAC (Eyeriss-class)

# ------------------------------------------------------------ NVIDIA H100 ---
# The card the port's kernels run on. Peaks from NVIDIA's H100 SXM data
# sheet (dense rates, at the full 700 W power limit); shared-memory sizes
# from the CUDA C++ documentation's table for compute capability 9.0.
HBM_BYTES_PER_S = 3.35e12       # data sheet: 80 GB HBM3 at 3.35 TB/s
F32_FLOP_PER_S = 67e12          # data sheet: float32 outside the tensor cores
INT8_OPS_PER_S = 1979e12        # data sheet: dense int8 on the tensor cores
BF16_FLOP_PER_S = 989e12        # data sheet: dense bf16 on the tensor cores
NVLINK_BYTES_PER_S = 900e9      # data sheet: NVLink 4, a GPU's 18 links, both directions
NVLINK_DIR_BYTES_PER_S = NVLINK_BYTES_PER_S / 2  # one direction: the roofline's collective rate
SM_COUNT = 132                  # data sheet: SMs of the SXM part
SMEM_PER_BLOCK = 232448         # CUDA docs: 227 KB a block may opt into
SM_SMEM = 228 * 1024            # CUDA docs: shared memory of one SM
SM_SMEM_PER_BLOCK_RESERVED = 1024  # CUDA docs: reserved by the system per block

# One kernel launch in HBM byte-equivalents: the CUDA-event time of the
# smallest launch of an existing kernel (``lif_sequence_cuda`` on one
# element, wrapper included), 0.0321 ms measured by chip_smoke.py's accel_sim
# phase on NVIDIA H100 80GB HBM3, 700.00 W, times HBM_BYTES_PER_S, rounded
# (the phase prints each run's value beside this one). Read by
# ops.launch_cost_prefers_coo.
KERNEL_LAUNCH_BYTES = 107_500_000
