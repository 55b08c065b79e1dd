"""The reference tba: the frozen host modules (``frozen/tree.py`` and
what it imports) with the reference DP (``reference/dp.py``) in the
batch slot of the merge scan, the MAF rendered as the program renders
it. Imports nothing of the program."""

from __future__ import annotations

import time

import torch

from ..frozen import scores as sc
from ..frozen.maf import format_ali
from ..frozen.multiz import MultizConfig
from ..frozen.tree import tba_run
from . import dp


def maf(ds: dict, device="cpu", radius: int = 30, min_output_wid: int = 1,
        dtype=torch.int64, minint: int = dp.MININT, clamp: bool = False,
        times: dict | None = None) -> str:
    """The rendered MAF of one tba over the dataset ``ds`` (the traffic
    kind ``tba_region``'s dict) with the tba options R= and M=; ``times``
    gets the seconds of the DP (``dp_s``) and of the whole (``all_s``)."""
    sp = sc.init_scores70()
    t = {"dp_s": 0.0}
    t0 = time.perf_counter()

    def batch_fn(jobs, sp=None):
        t1 = time.perf_counter()
        out = dp.yama_batch(jobs, sp, device=device, dtype=dtype,
                            minint=minint, clamp=clamp)
        t["dp_s"] += time.perf_counter() - t1
        return out

    blocks = tba_run(ds["tree"], list(ds["pairs"]), src_dir=ds["src_dir"],
                     cfg=MultizConfig(radius=radius,
                                     min_output_wid=min_output_wid,
                                     batch_fn=batch_fn), sp=sp)
    text = "".join(format_ali(a) for a in blocks)
    t["all_s"] = time.perf_counter() - t0
    if times is not None:
        times.update(t)
    return text
