"""preyama_s_per_roast: seconds a roast spends in pre_yama's coroutines
of its v == 1 ``multiz`` calls (``preyama.py``, the native plan and
fold): the program's timed counters ``preyama.plan`` and
``preyama.fold``, over the roasts. A program that does not count the
v == 0 calls apart (``preyama_v0_s_per_roast``) counts them here too."""

from mzbench.roastspans import counter_s_per_roast


def read(run):
    return counter_s_per_roast(run, ("preyama.plan", "preyama.fold"))
