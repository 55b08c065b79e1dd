"""preyama_s_per_tba: seconds a tba spends in pre_yama's coroutines
(``preyama.py``): the program's timed counters ``preyama.plan`` (a DP
job's planning) and ``preyama.fold`` (its result folded in), over the
tbas."""

from mzbench.progtrace import counter_s_per_tba


def read(run):
    return counter_s_per_tba(run, ("preyama.plan", "preyama.fold"))
