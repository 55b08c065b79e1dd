# Frozen copy of multiz_tpu_torch/single_cov.py at commit 1de2067, kept by the benchmark
# (mzbench/) so that its inputs and its reference never import the program.
# Changes: the native runtime is never loaded (numpy only).
"""single_cov2: enforce single coverage on a pairwise blockset.

Port of single_cov2.c:16-158 — pairwise overlap scan on the top row,
keeping whichever side loses less score, run once per orientation.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from . import scores as sc
from .blocks import maf_slice, sort_by_top_start
from .maf import Ali, pos2col

IGNORE = 6  # don't make alignments smaller than this (single_cov2.c:12)
STOP_CRITERIA = 0.99


def maf_overlap(
    alis: List[Ali],
    log: Optional[Callable[[str], None]] = None,
    sp: sc.ScoreParams | None = None,
) -> List[Ali]:
    """mafOverlap (single_cov2.c:16-108)."""
    if not alis:
        return []
    A: List[Optional[Ali]] = sort_by_top_start(alis)
    nali = len(A)
    min_later_beg = [0] * nali
    min_later_beg[nali - 1] = A[nali - 1].comps[0].start
    for i in range(nali - 2, -1, -1):
        min_later_beg[i] = min(A[i].comps[0].start, min_later_beg[i + 1])

    for i in range(nali - 1):
        for j in range(i + 1, nali):
            if A[i] is None:
                break
            c = A[i].comps[0]
            c_end = c.start + c.size - 1
            if min_later_beg[j] > c_end:
                break
            if A[j] is None:
                continue
            d = A[j].comps[0]
            d_end = d.start + d.size - 1
            if d_end < c.start:
                continue
            if c_end < d.start:
                continue
            L = max(d.start, c.start)
            R = min(c_end, d_end)
            if c_end >= d_end:
                if log:
                    log(f"deleted {c.src}:{d.start}-{d_end}\n")
                A[j] = None
                continue
            col_beg = pos2col(c, L)
            lost1 = sc.score_range(A[i], col_beg, A[i].text_size - col_beg, sp=sp)
            col_end = pos2col(d, R)
            lost2 = sc.score_range(A[j], 0, col_end + 1, sp=sp)
            if log:
                log(f"deleting {c.src}:{L}-{R}\n")
            if lost1 <= lost2:
                A[i] = maf_slice(A[i], 0, pos2col(c, L))
            else:
                A[j] = maf_slice(A[j], pos2col(d, c_end + 1), A[j].text_size)
            if A[i] is not None and A[i].text_size < IGNORE:
                A[i] = None
            if A[j] is not None and A[j].text_size < IGNORE:
                A[j] = None
    return [a for a in A if a is not None]


def iterative_single_cov(
    alis: List[Ali],
    log: Optional[Callable[[str], None]] = None,
    sp: sc.ScoreParams | None = None,
) -> List[Ali]:
    """iterative_single_cov (single_cov2.c:110-158): per-top-src passes."""
    result: List[Ali] = []
    cp = list(alis)
    while cp:
        chrom = cp[0].comps[0].src
        wk = [a for a in cp if a.comps[0].src == chrom]
        cp = [a for a in cp if a.comps[0].src != chrom]
        result.extend(maf_overlap(wk, log=log, sp=sp))
    return result
