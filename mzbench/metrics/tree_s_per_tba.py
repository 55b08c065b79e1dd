"""tree_s_per_tba: seconds a tba spends in the tree's own bookkeeping
(``tree.py``): the self time of the program's spans ``tba`` (the run's
root) and ``tba.merge`` (a tree node), over the tbas."""

from mzbench.progtrace import self_s_per_tba


def read(run):
    return self_s_per_tba(run, ("tba", "tba.merge"))
