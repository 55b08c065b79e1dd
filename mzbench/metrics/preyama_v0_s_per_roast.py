"""preyama_v0_s_per_roast: seconds a roast spends in pre_yama's v == 0
coroutines (``preyama.py``, the numpy plan of two dependent DPs a job):
the program's timed counters ``preyama.plan.v0`` (a job's first DP
planned) and ``preyama.fold.v0`` (each result folded in, the second DP
planned after the first), over the roasts. None where the program counts
neither."""

from mzbench.roastspans import counter_s_per_roast


def read(run):
    return counter_s_per_roast(run, ("preyama.plan.v0", "preyama.fold.v0"))
