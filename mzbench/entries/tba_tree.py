"""Entry ``tba_tree``: entry ``tba`` (``tree.tba_run`` on the program's
packed DP stream, the MAF rendered in memory, back to back over one
region, checked block by block against ``reference/tba.py``) over a
region of the traffic kind ``tba_tree_region``: one genome a species and
the pairwise MAF of every pair the configuration's tree joins.

Only the region differs: ``tba.Entry`` makes it through the module it
names ``tba_region``, which set-up points at ``tba_tree_region`` while
it runs.
"""

from __future__ import annotations

from ..traffic import tba_tree_region
from . import tba


class Entry(tba.Entry):
    def setup(self) -> None:
        made = tba.tba_region
        tba.tba_region = tba_tree_region
        try:
            super().setup()
        finally:
            tba.tba_region = made
