"""tba_refbases_per_s: the reference bases of every tba completed in the
window over the window, from its start to the end of the last tba."""

from mzbench.rates import rate


def read(run):
    return rate(run.ops, run.window)
