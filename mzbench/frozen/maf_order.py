# Frozen copy of multiz_tpu_torch/maf_order.py at commit 1de2067, kept by the benchmark
# (mzbench/) so that its inputs and its reference never import the program.
# Changes: the native runtime is never loaded (numpy only).
"""maf_order: reorder/select rows of each block by a species list.

Port of maf_order.c:16-99."""

from __future__ import annotations

from typing import List, Optional

from .blocks import col_dash_rm, rc
from .maf import Ali


def order_ali(a: Ali, species: List[str]) -> Optional[Ali]:
    """maf_order_ali (maf_order.c:30-81): keep only listed species (matched
    on comp name), order rows by the list, drop dash columns, rc if top is
    '-'. Returns None if nothing remains."""
    location: List[Optional[object]] = [None] * len(species)
    for c in a.comps:
        try:
            i = species.index(c.name)
        except ValueError:
            continue
        if location[i] is not None:
            raise ValueError(f"species `{c.src}' named more than once")
        location[i] = c
    comps = [c for c in location if c is not None]
    if not comps:
        return None
    a.comps = comps
    a = col_dash_rm(a)
    if a is not None and a.comps[0].strand == "-":
        rc(a)
    return a


def order_list(alis: List[Ali], species: List[str]) -> List[Ali]:
    """maf_order_list (maf_order.c:84-99): output order is reversed."""
    out: List[Ali] = []
    for a in alis:
        r = order_ali(a, species)
        if r is not None:
            out.append(r)
    out.reverse()
    return out
