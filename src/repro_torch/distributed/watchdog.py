"""Step-time watchdog: straggler detection + checkpoint-now triggering.

On a real multi-host deployment each host reports step wall-times; a step
slower than ``threshold × median`` flags a straggler (failing HBM, thermal
throttle, network flake) and raises the signal the launcher uses to trigger
an early checkpoint + job replacement. Here the detector is host-local but
the policy logic (windowed median, consecutive-slow-step escalation) is the
production one and is unit-tested. A copy of the reference's
``distributed/watchdog.py`` (numpy only).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.utils import log


@dataclasses.dataclass
class WatchdogConfig:
    window: int = 50           # steps in the rolling window
    slow_factor: float = 2.0   # step > factor × median ⇒ slow
    escalate_after: int = 3    # consecutive slow steps ⇒ escalate
    warmup: int = 10           # ignore the first N steps (compile, cache)


class StepWatchdog:
    def __init__(self, cfg: WatchdogConfig | None = None):
        self.cfg = cfg if cfg is not None else WatchdogConfig()
        self.times: list[float] = []
        self.consecutive_slow = 0
        self.escalations = 0

    def record(self, step_time: float) -> str:
        """Returns "ok" | "slow" | "escalate"."""
        self.times.append(step_time)
        if len(self.times) <= self.cfg.warmup:
            return "ok"
        window = self.times[-self.cfg.window:]
        med = float(np.median(window))
        if step_time > self.cfg.slow_factor * med:
            self.consecutive_slow += 1
            if self.consecutive_slow >= self.cfg.escalate_after:
                self.escalations += 1
                self.consecutive_slow = 0
                log.warning("watchdog: %d consecutive slow steps (%.3fs vs median %.3fs)"
                            " — requesting checkpoint + replacement",
                            self.cfg.escalate_after, step_time, med)
                return "escalate"
            return "slow"
        self.consecutive_slow = 0
        return "ok"

    @property
    def median(self) -> float:
        return float(np.median(self.times[-self.cfg.window:])) if self.times else 0.0
