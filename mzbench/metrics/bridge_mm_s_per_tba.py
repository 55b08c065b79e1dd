"""bridge_mm_s_per_tba: seconds a tba spends in the bridging iterations
of tba.c's multi x multi branch (two multiz calls, four projections and
a strip_top a pair): the program's counter ``tba.bridge.mm`` (a bridge's
wall, charged to no span), over the tbas. None where the program counts
no such bridge."""

from mzbench.progtrace import counter_s_per_tba, counters

NAMES = ("tba.bridge.mm",)


def read(run):
    cs = counters(run)
    if not cs or not any(k in cs for k in NAMES):
        return None
    return counter_s_per_tba(run, NAMES)
