"""Discrete-event simulation core: units, job events, energy ledgers.

The model is a network of FIFO *units* (hardware pipelines). Work is
submitted as *jobs* — (unit, ready-time, duration, energy) tuples — in
program order; each job is an event whose start time resolves to
``max(ready, unit.free_at)`` (its data dependencies are expressed through
``ready``, its structural hazard through the unit's timeline). Every
completion is appended to an event log, so the result is an exact
discrete-event schedule of the submitted dependency graph, in integer
cycles, with no wall-clock or randomness anywhere — same submission
sequence, same schedule, bit-identical reports.

Energy: each job charges per-access dynamic energy (pJ) to its unit's
ledger; static power sources are closed out by :meth:`Engine.report` as
pseudo-units (``static_*``) over the makespan, so the report's total is
*by construction* the sum of its per-unit entries — the conservation
invariant ``tests/test_torch_sim.py`` pins.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class JobEvent:
    """One completed unit job (an entry of the event log)."""

    unit: str
    kind: str
    start: int
    done: int
    count: int
    energy_pj: float


class Unit:
    """A FIFO hardware unit: service timeline + cycle/energy/access ledger."""

    __slots__ = ("name", "free_at", "busy_cycles", "energy_pj", "counters")

    def __init__(self, name: str):
        self.name = name
        self.free_at = 0
        self.busy_cycles = 0
        self.energy_pj = 0.0
        self.counters: dict[str, int] = {}


class Engine:
    """Event engine: resolves submitted jobs into a deterministic schedule."""

    def __init__(self, keep_log: bool = False):
        self.units: dict[str, Unit] = {}
        self.keep_log = keep_log
        self.log: list[JobEvent] = []

    def unit(self, name: str) -> Unit:
        u = self.units.get(name)
        if u is None:
            u = self.units[name] = Unit(name)
        return u

    def submit(self, unit: str, ready: int, cycles: int, *,
               kind: str = "work", count: int = 0,
               energy_pj: float = 0.0) -> int:
        """Submit one job; returns its completion cycle.

        ``ready`` carries the job's data dependencies (max over producer
        completion times); the unit's own timeline serialises structural
        conflicts. ``count`` accumulates into the unit's per-kind access
        counter (the quantity the per-access energy was charged for).
        """
        u = self.unit(unit)
        cycles = max(0, int(cycles))
        start = max(int(ready), u.free_at)
        done = start + cycles
        u.free_at = done
        u.busy_cycles += cycles
        u.energy_pj += energy_pj
        if count:
            u.counters[kind] = u.counters.get(kind, 0) + int(count)
        if self.keep_log:
            self.log.append(JobEvent(unit, kind, start, done, int(count),
                                     energy_pj))
        return done

    def charge(self, unit: str, *, kind: str, count: int,
               energy_pj: float) -> None:
        """Charge energy/accesses to a unit without occupying its timeline
        (e.g. buffer reads that happen inside another unit's cycles)."""
        u = self.unit(unit)
        u.energy_pj += energy_pj
        u.counters[kind] = u.counters.get(kind, 0) + int(count)

    @property
    def makespan(self) -> int:
        return max((u.free_at for u in self.units.values()), default=0)

    def report(self, static_w: dict[str, float] | None = None,
               freq: float | None = None) -> dict:
        """Schedule + energy summary.

        ``static_w`` maps a source name to Watts; each is closed out over
        the makespan at ``freq`` as a ``static_<name>`` entry of the energy
        breakdown. The returned ``energy_total_pj`` is exactly
        ``sum(energy_pj.values())``.
        """
        span = self.makespan
        units = {}
        energy: dict[str, float] = {}
        for name, u in sorted(self.units.items()):
            units[name] = {
                "busy_cycles": u.busy_cycles,
                "utilization": (u.busy_cycles / span) if span else 0.0,
                "counters": dict(sorted(u.counters.items())),
            }
            energy[name] = u.energy_pj
        if static_w and freq:
            secs = span / freq
            for name, watts in sorted(static_w.items()):
                energy[f"static_{name}"] = watts * secs * 1e12
        return {
            "cycles": span,
            "units": units,
            "energy_pj": energy,
            "energy_total_pj": sum(energy.values()),
        }


def merge_reports(cold: dict, warm: dict, reps: int) -> dict:
    """Combine a cold-pass report with ``reps - 1`` warm (steady-state)
    passes: cycles add, per-unit busy cycles / counters / energies add with
    the warm side scaled. SNN semantics — weights and PWPs are fetched once
    per layer (cold), activations and compute repeat per timestep × batch
    element (warm)."""
    n = max(0, reps - 1)
    cycles = cold["cycles"] + n * warm["cycles"]
    units: dict[str, dict] = {}
    for src, scale in ((cold, 1), (warm, n)):
        for name, u in src["units"].items():
            dst = units.setdefault(name, {"busy_cycles": 0, "counters": {}})
            dst["busy_cycles"] += scale * u["busy_cycles"]
            for kind, cnt in u["counters"].items():
                dst["counters"][kind] = (dst["counters"].get(kind, 0)
                                         + scale * cnt)
    for u in units.values():
        u["utilization"] = (u["busy_cycles"] / cycles) if cycles else 0.0
    energy = {}
    for src, scale in ((cold, 1), (warm, n)):
        for name, e in src["energy_pj"].items():
            energy[name] = energy.get(name, 0.0) + scale * e
    return {
        "cycles": cycles,
        "units": units,
        "energy_pj": energy,
        "energy_total_pj": sum(energy.values()),
    }
