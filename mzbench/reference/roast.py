"""The reference roast: the frozen roast (``frozen/roast.py`` on the
frozen host modules) with the reference DP (``reference/dp.py``) in the
batch slot of the merge scan, the MAF rendered as the program renders
it. Imports nothing of the program."""

from __future__ import annotations

import time

import torch

from ..frozen import scores as sc
from ..frozen.maf import format_ali
from ..frozen.multiz import MultizConfig
from ..frozen.roast import roast_run
from . import dp


def ref_pairs(ds: dict, ref: str) -> list:
    """The pair files of ``ds`` that hold the reference ``ref`` first,
    the ones a roast reads (``all_bz``'s roast mode writes only those)."""
    return [p for p in ds["pairs"] if p.split(".")[0] == ref]


def maf(ds: dict, device="cpu", ref: str = "human", radius: int = 30,
        min_output_wid: int = 1, dtype=torch.int64, minint: int = dp.MININT,
        clamp: bool = False, times: dict | None = None) -> str:
    """The rendered MAF of one roast E=``ref`` over the dataset ``ds``
    (the traffic kind ``tba_tree_region``'s dict) with the options R= and
    M=; ``times`` gets the seconds of the DP (``dp_s``) and of the whole
    (``all_s``)."""
    sp = sc.init_scores70()
    t = {"dp_s": 0.0}
    t0 = time.perf_counter()

    def batch_fn(jobs, sp=None):
        t1 = time.perf_counter()
        out = dp.yama_batch(jobs, sp, device=device, dtype=dtype,
                            minint=minint, clamp=clamp)
        t["dp_s"] += time.perf_counter() - t1
        return out

    blocks = roast_run(ref, ds["tree"], ref_pairs(ds, ref),
                       src_dir=ds["src_dir"],
                       cfg=MultizConfig(radius=radius,
                                        min_output_wid=min_output_wid,
                                        batch_fn=batch_fn), sp=sp)
    text = "".join(format_ali(a) for a in blocks)
    t["all_s"] = time.perf_counter() - t0
    if times is not None:
        times.update(t)
    return text
