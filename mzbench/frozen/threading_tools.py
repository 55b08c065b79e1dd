# Frozen copy of multiz_tpu_torch/threading_tools.py at commit 1de2067, kept by the benchmark
# (mzbench/) so that its inputs and its reference never import the program.
# Changes: the native runtime is never loaded (numpy only).
"""Threaded-blockset helpers: pair2tb gap filling and get_covered.

Ports of maftop2tb.c:16-169 (getMafBetween) and get_covered.c:10-117.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np

from . import scores as sc
from .blocks import keep_ali, part_ali_by_pos, sort_by_top_start
from .maf import Ali, Comp
from .seqio import Contig, parse_header, read_fasta_spec as read_fasta

WriteFn = Callable[[Ali], None]


def _single_row_block(meta, seq_slice: np.ndarray, start: int,
                      size: int | None = None) -> Ali:
    """``size`` may exceed the text when the header-declared end lies
    past the real sequence: the C sets C.size from header arithmetic but
    its %s-printed text stops at the buffer's NUL (maftop2tb.c:135-142),
    emitting an inconsistent block. Replicated for byte-equality."""
    comp = Comp(
        src=f"{meta.name}.{meta.contig}",
        start=start,
        size=int(seq_slice.shape[0]) if size is None else size,
        strand="+",
        src_size=meta.size,
        text=seq_slice.copy(),
    )
    return Ali(comps=[comp], score=0.0)


def get_maf_between(
    alis: List[Ali], seqfile: str, write: WriteFn
) -> List[Ali]:
    """getMafBetween (maftop2tb.c:16-169): per contig of ``seqfile``, emit
    single-row blocks covering the top-row gaps between aligned intervals.
    Returns the input blocks (re-grouped, as the C's bkup list)."""
    cp_list = list(alis)
    bkup: List[Ali] = []
    contigs = read_fasta(seqfile)
    for contig in contigs:
        meta = parse_header(seqfile, contig)
        s = contig.seq
        start, end = meta.start, meta.end
        if not cp_list:
            write(_single_row_block(meta, s[: end - start + 1], start - 1,
                                    size=end - start + 1))
            break
        wk: List[Ali] = []
        rest: List[Ali] = []
        for a in cp_list:
            c = a.comps[0]
            if (
                c.name == meta.name
                and c.contig == meta.contig
                and c.start >= start - 1
                and c.start + c.size <= end
            ):
                wk.append(a)
            else:
                rest.append(a)
        cp_list = rest
        if not wk:
            write(_single_row_block(meta, s[: end - start + 1], start - 1,
                                    size=end - start + 1))
            continue
        A = sort_by_top_start(wk)
        flag1 = start - 1
        for a in A:
            flag2 = a.comps[0].start
            if flag2 > flag1:
                write(
                    _single_row_block(
                        meta,
                        s[flag1 - start + 1 : flag1 - start + 1 + (flag2 - flag1)],
                        flag1,
                    )
                )
            if a.comps[0].start + a.comps[0].size > flag1:
                flag1 = a.comps[0].start + a.comps[0].size
        if flag1 <= end - 1:
            write(
                _single_row_block(
                    meta, s[flag1 - start + 1 : flag1 - start + 1 + (end - flag1)],
                    flag1, size=end - flag1,
                )
            )
        bkup = wk + bkup
    if cp_list:
        bkup = cp_list + bkup
    return bkup


def get_covered(
    wk1: List[Ali], wk2: List[Ali], write: WriteFn,
    sp: sc.ScoreParams | None = None,
) -> None:
    """get_covered merge scan (get_covered.c:10-73): emit the parts of wk1
    blocks whose top-row interval is covered by wk2 blocks."""
    i1 = i2 = 0

    def pop1():
        nonlocal i1
        if i1 >= len(wk1):
            return None
        a = wk1[i1]
        i1 += 1
        return a

    def pop2():
        nonlocal i2
        if i2 >= len(wk2):
            return None
        a = wk2[i2]
        i2 += 1
        return a

    a1 = pop1()
    a2 = pop2()
    while True:
        while (
            a1 is not None and a2 is not None
            and a1.comps[0].end - 1 < a2.comps[0].start
        ):
            a1 = pop1()
        while (
            a1 is not None and a2 is not None
            and a2.comps[0].end - 1 < a1.comps[0].start
        ):
            a2 = pop2()
        if a1 is None:
            return
        if a2 is None:
            return
        if a1.comps[0].end - 1 < a2.comps[0].start:
            continue
        if a2.comps[0].end - 1 < a1.comps[0].start:
            continue
        end1 = a1.comps[0].end - 1
        end2 = a2.comps[0].end - 1
        beg = max(a1.comps[0].start, a2.comps[0].start)
        end = min(end1, end2)
        part = part_ali_by_pos(a1, beg, end, sp=sp)
        if part is not None:
            write(part)
        if end1 < end2:
            a1 = pop1()
            a2 = keep_ali(a2, end1 + 1, sp=sp)
        elif end2 < end1:
            a2 = pop2()
            a1 = keep_ali(a1, end2 + 1, sp=sp)
        else:
            a1 = pop1()
            a2 = pop2()
