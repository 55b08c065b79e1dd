"""bridge_ml_s_per_tba: seconds a tba spends in the bridging iterations
of tba.c's multi x leaf branches (a pair threaded, projected and merged
into the deep side; from a node's second pair on, through get_covered):
the program's counters ``tba.bridge.ml`` and ``tba.bridge.lm`` (a
bridge's wall, charged to no span), over the tbas. None where the
program counts no such bridge."""

from mzbench.progtrace import counter_s_per_tba, counters

NAMES = ("tba.bridge.ml", "tba.bridge.lm")


def read(run):
    cs = counters(run)
    if not cs or not any(k in cs for k in NAMES):
        return None
    return counter_s_per_tba(run, NAMES)
