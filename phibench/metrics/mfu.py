"""The window's dense-equivalent work over its length at the H100's bf16
dense peak, %."""
from phibench.stats import mfu


def read(run):
    return mfu(run)
