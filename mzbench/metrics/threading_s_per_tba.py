"""threading_s_per_tba: seconds a tba spends in the threading tools
(``threading_tools.py``: pair2tb, get_covered, the top row's strip): the
self time of the program's spans ``threading.*``, over the tbas."""

from mzbench.progtrace import self_s_per_tba


def read(run):
    return self_s_per_tba(run, prefix="threading.")
