"""device_idle_pct.tba: 100 x the share of the window in which the card
ran no kernel and no copy (the union of the profiler's device
intervals)."""

from mzbench.devtrace import idle_pct


def read(run):
    return idle_pct(run)
