"""The share of the traced window in which no operation ran on the card, %."""
from phibench.stats import idle


def read(run):
    return idle(run)
