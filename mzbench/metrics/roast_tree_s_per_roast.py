"""roast_tree_s_per_roast: seconds a roast spends in the tree's own
bookkeeping (``tree.py``, ``Roast``): the self time of the program's
spans ``roast`` (the run's root, ``roast_run``) and ``roast.merge`` (a
tree node), over the roasts. None where the program records no
``roast.merge``."""

from mzbench.roastspans import self_s_per_roast


def read(run):
    return self_s_per_roast(run, ("roast", "roast.merge"), "roast.merge")
