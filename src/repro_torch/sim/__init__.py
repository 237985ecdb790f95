"""Cycle-approximate, event-driven simulator of the Phi accelerator.

The analytical model (``core.perfmodel``) answers "what do the closed-form
cycle/energy expressions say"; this package answers "what does a
discrete-event walk of the microarchitecture over a *real trace* say" —
matcher array, PWP buffer + usage-driven prefetcher, L1 accumulator,
finite-capacity L2 packer, sparse PE array and a DRAM channel with
double-buffered DMA, each a composable unit with cycle and per-access
energy ledgers (``repro_torch.core.hwconst`` is the single parameter source
for both stories). A port of the reference package's ``sim``, key for key.

Entry points:

  * :mod:`repro_torch.sim.trace` — ``LayerTrace`` capture (the SNN model
    path, on the card through the matcher kernel; synthetic Zipf/density
    sweeps);
  * :mod:`repro_torch.sim.accel` — ``PhiAcceleratorSim`` / ``EyerissSim``;
  * ``chip_smoke.py``'s ``accel_sim`` phase — the Table-2-class comparison
    on traces the port captures on the H100.
"""
from repro_torch.sim.accel import (  # noqa: F401
    EyerissSim,
    LayerSimResult,
    PhiSimConfig,
    PhiAcceleratorSim,
    summarize_run,
)
from repro_torch.sim.trace import (  # noqa: F401
    LayerTrace,
    density_sweep_traces,
    synthetic_zipf_trace,
    trace_from_acts,
    vgg16_table4_traces,
)
