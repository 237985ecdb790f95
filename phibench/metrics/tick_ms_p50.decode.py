"""Median wall time of the engine ticks that admit nothing (a decode step,
sampling and the host loop), timed around ``Engine.tick``."""
from phibench.stats import median


def read(run):
    return median([(t1 - t0) * 1e3 for t0, t1, admitted in run.records.get("ticks", [])
                   if admitted == 0])
