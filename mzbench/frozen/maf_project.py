# Frozen copy of multiz_tpu_torch/maf_project.py at commit 1de2067, kept by the benchmark
# (mzbench/) so that its inputs and its reference never import the program.
# Changes: the native runtime is never loaded (numpy only).
"""maf_project: project a MAF onto one reference species.

Port of maf_project.c:61-781 — move the reference row to top (rc if '-'),
sort by reference start, fuse abutting blocks, optionally "beautify"
(fuse narrow blocks into neighbors, wedging orphan blocks or discarding
rows), reorder rows by a guide tree, slice [from,to].
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from . import scores as sc
from .blocks import col_dash_rm, rc, sort_by_top_start
from .maf import Ali, Comp, DASH

FUSE_SIZE = 30
DISCARD_SIZE = 20
MUST_FUSE = 10


def _find(comps: List[Comp], src: str) -> Optional[Comp]:
    for d in comps:
        if d.src == src:
            return d
    return None


def abut(a: Ali, b: Ali) -> bool:
    """All rows of a and b pair up exactly adjacently (maf_project.c:61-81)."""
    for c in a.comps:
        d = _find(b.comps, c.src)
        if (
            d is None or d.paralog != c.paralog or c.strand != d.strand
            or c.start + c.size != d.start
        ):
            return False
    for c in b.comps:
        d = _find(a.comps, c.src)
        if (
            d is None or d.paralog != c.paralog or c.strand != d.strand
            or d.start + d.size != c.start
        ):
            return False
    return True


def accordion(a: Ali, n1: int) -> None:
    """Close a dash seam left by fuse (maf_project.c:86-111)."""
    n = a.text_size
    min_space = n
    for c in a.comps:
        t = c.text
        sp = 0
        i = n1 - 1
        while i >= 0 and t[i] == DASH:
            sp += 1
            i -= 1
        i = n1
        while i < n and t[i] == DASH:
            sp += 1
            i += 1
        min_space = min(sp, min_space)
    if min_space > 0:
        for c in a.comps:
            t = c.text
            i = n1
            while i > 0 and t[i - 1] == DASH:
                i -= 1
            c.text = np.concatenate([t[:i], t[i + min_space :]])


def fuse(a: Ali, b: Ali, sp: sc.ScoreParams | None = None) -> None:
    """Fuse block b onto the end of a, in place (maf_project.c:114-172)."""
    n1 = a.text_size
    n2 = b.text_size
    for c in a.comps:
        d = _find(b.comps, c.src)
        if d is not None:
            if d.strand != c.strand or d.start != c.start + c.size:
                raise ValueError("possible use of unprojected alignment")
            c.text = np.concatenate([c.text, d.text])
            c.size += d.size
        else:
            c.text = np.concatenate(
                [c.text, np.full(n2, DASH, dtype=np.uint8)]
            )
    # b-only rows, dash-padded on the left; the C push-front reverses them
    unmatched = []
    for d in b.comps:
        if _find(a.comps, d.src) is None:
            nc = d.copy(
                text=np.concatenate(
                    [np.full(n1, DASH, dtype=np.uint8), d.text]
                )
            )
            unmatched.append(nc)
    a.comps.extend(reversed(unmatched))
    accordion(a, n1)
    a.score = sc.score_range(a, 0, a.text_size, sp=sp)


def fuse_left(a: Ali, b: Ali, orphans: List[Ali],
              sp: sc.ScoreParams | None = None) -> bool:
    """fuseLeft (maf_project.c:175-269): fuse b onto a, possibly wedging an
    orphan block into the gap."""
    is_abut = True
    for c in a.comps:
        d = _find(b.comps, c.src)
        if d is None or c.strand != d.strand:
            return False
        sep = d.start - c.start - c.size
        if sep < 0 or sep > DISCARD_SIZE:
            return False
        if sep > 0:
            is_abut = False
    if is_abut:
        fuse(a, b, sp=sp)
        return True
    # find a row of a that does not abut its b row
    cg = dg = None
    for c in a.comps:
        d = _find(b.comps, c.src)
        if d is None or c.start + c.size < d.start:
            cg, dg = c, d
            break
    if cg is None or dg is None:
        raise ValueError("bad left wedge")
    wedge = None
    for wa in orphans:
        w = _find(wa.comps, cg.src)
        if w is not None and w.strand == cg.strand and w.start == cg.start + cg.size:
            wedge = wa
            break
    if wedge is None:
        return False
    # does the wedge completely fill the hole?
    for c in a.comps:
        comp_end = c.start + c.size
        w = _find(wedge.comps, c.src)
        if w is not None:
            if c.strand != w.strand or comp_end != w.start:
                return False
            comp_end += w.size
        d = _find(b.comps, c.src)
        if d is not None and d.start != comp_end:
            return False
    # copy of wedge restricted to b's rows (push-front => reversed)
    xw = Ali(score=0.0)
    for d in b.comps:
        w = _find(wedge.comps, d.src)
        if w is not None and w.strand == d.strand and w.start + w.size == d.start:
            xw.comps.insert(0, w.copy())
    fuse(xw, b, sp=sp)
    _replace(b, xw)
    fuse(a, b, sp=sp)
    return True


def fuse_right(a: Ali, b: Ali, orphans: List[Ali],
               sp: sc.ScoreParams | None = None) -> bool:
    """fuseRight (maf_project.c:272-365): fuse b onto a, possibly wedging."""
    is_abut = True
    for c in b.comps:
        d = _find(a.comps, c.src)
        if d is None or c.strand != d.strand:
            return False
        sep = c.start - d.start - d.size
        if sep < 0 or sep > DISCARD_SIZE:
            return False
        if sep > 0:
            is_abut = False
    if is_abut:
        fuse(a, b, sp=sp)
        return True
    cg = dg = None
    for c in b.comps:
        d = _find(a.comps, c.src)
        if d is None or c.start > d.start + d.size:
            cg, dg = c, d
            break
    if cg is None or dg is None:
        raise ValueError("bad right wedge")
    wedge = None
    for wa in orphans:
        w = _find(wa.comps, cg.src)
        if w is not None and w.strand == dg.strand and w.start == dg.start + dg.size:
            wedge = wa
            break
    if wedge is None:
        return False
    for c in b.comps:
        comp_start = c.start
        w = _find(wedge.comps, c.src)
        if w is not None:
            if w.start + w.size != comp_start:
                return False
            comp_start = w.start
        d = _find(a.comps, c.src)
        if d is not None and d.start + d.size != comp_start:
            return False
    xw = Ali(score=0.0)
    for c in a.comps:
        w = _find(wedge.comps, c.src)
        if w is not None and w.strand == c.strand and w.start == c.start + c.size:
            xw.comps.insert(0, w.copy())
    fuse(a, xw, sp=sp)
    fuse(a, b, sp=sp)
    return True


def _replace(dst: Ali, src: Ali) -> None:
    dst.comps = src.comps
    dst.score = src.score


def beautify(blocks: List[Ali], orphans: List[Ali],
             sp: sc.ScoreParams | None = None) -> List[Ali]:
    """beautify (maf_project.c:367-481): fuse narrow blocks into neighbors."""
    ai = -1  # index of A (last kept block), -1 = none
    bi = 0
    while bi < len(blocks):
        B = blocks[bi]
        ci = bi + 1
        if B.text_size > FUSE_SIZE:
            ai = bi
            bi = ci
        elif ai >= 0 and fuse_right(blocks[ai], B, orphans, sp=sp):
            del blocks[bi]  # A->next = C; B removed; indices shift
        elif ci < len(blocks) and fuse_left(B, blocks[ci], orphans, sp=sp):
            del blocks[ci]  # same B re-examined next iteration
        elif B.text_size <= DISCARD_SIZE and ai >= 0:
            A = blocks[ai]
            i = 0
            for c in B.comps:
                d = _find(A.comps, c.src)
                if d is None or d.strand != c.strand or d.start + d.size != c.start:
                    i += 1
            if ci >= len(blocks):
                break  # C == NULL: beautify ends (maf_project.c:397-398)
            C = blocks[ci]
            j = 0
            for c in B.comps:
                d = _find(C.comps, c.src)
                if d is None or d.strand != c.strand or c.start + c.size != d.start:
                    j += 1
            if i <= j and (i <= 3 or B.text_size <= MUST_FUSE):
                # drop B's non-fusable rows (first row always kept)
                B.comps = [B.comps[0]] + [
                    n for n in B.comps[1:]
                    if (d := _find(A.comps, n.src)) is not None
                    and d.strand == n.strand
                    and d.start + d.size == n.start
                ]
                col_dash_rm(B)
                if fuse_right(A, B, orphans, sp=sp):
                    del blocks[bi]
                else:
                    ai = bi
                    bi = ci
            elif j <= 3 or B.text_size <= MUST_FUSE:
                B.comps = [B.comps[0]] + [
                    n for n in B.comps[1:]
                    if (d := _find(C.comps, n.src)) is not None
                    and d.strand == n.strand
                    and n.start + n.size == d.start
                ]
                col_dash_rm(B)
                if fuse_left(B, C, orphans, sp=sp):
                    del blocks[ci]
                else:
                    ai = bi
                    bi = ci
            else:
                ai = bi
                bi = ci
        else:
            ai = bi
            bi = ci
    return blocks


def fuse_abutting(blocks: List[Ali], sp: sc.ScoreParams | None = None) -> List[Ali]:
    """The a/A fuse walk (maf_project.c:696-701)."""
    i = 0
    while i + 1 < len(blocks):
        if abut(blocks[i], blocks[i + 1]):
            fuse(blocks[i], blocks[i + 1], sp=sp)
            del blocks[i + 1]
        else:
            i += 1
    return blocks


def get_names(target: str, tree_spec: str) -> List[str]:
    """get_names (maf_project.c:484-548): DFS leaf order with the target's
    subtree first at every internal node."""
    stack: List[Tuple[str, bool, List[str]]] = []  # (type, target?, names)
    i = 0
    q = tree_spec
    while i < len(q):
        ch = q[i]
        if ch == "(":
            stack.append(("(", False, []))
        elif ch == ")":
            if (
                len(stack) < 2 or stack[-1][0] != 0
                or stack[-2][0] != "("
            ):
                raise ValueError(f"parse error: {q[: i + 1]}")
            top = stack.pop()
            stack.pop()
            stack.append(top)
        elif ch.isalpha():
            j = i
            while j < len(q) and (q[j].isalnum() or q[j] in "_."):
                j += 1
            name = q[i:j]
            i = j - 1
            stack.append((0, name == target, [name]))
        elif ch != " ":
            raise ValueError(f"improper character in tree spec: {ch}")
        while (
            len(stack) >= 2 and stack[-1][0] == 0 and stack[-2][0] == 0
        ):
            t2 = stack.pop()
            t1 = stack.pop()
            if t1[1] and t2[1]:
                raise ValueError("both children have the target species")
            if t2[1]:
                names = t2[2] + t1[2]
            else:
                names = t1[2] + t2[2]
            stack.append((0, t1[1] or t2[1], names))
        i += 1
    return stack[-1][2]


def project(
    alis: List[Ali],
    target: str,
    species: Optional[List[str]] = None,
    beg: int = -1,
    end: int = -1,
    do_beautify: bool = True,
    sp: sc.ScoreParams | None = None,
):
    """The per-file projection pipeline (maf_project.c:632-777).

    Returns (written_blocks_in_order, other_blocks_in_input_order).
    ``do_beautify`` corresponds to no other-mafs file being given."""
    from .maf_order import order_ali

    with_target: List[Ali] = []
    others: List[Ali] = []
    for a in alis:
        idx = None
        for k, c in enumerate(a.comps):
            if c.name == target or c.src == target:
                idx = k
                break
        if idx is None:
            others.append(a)
            continue
        if idx != 0:
            c = a.comps.pop(idx)
            a.comps.insert(0, c)
        if a.comps[0].strand == "-":
            rc(a)
        with_target.append(a)
    A = list(reversed(with_target))  # the C push-front order
    orphans = list(reversed(others))

    out: List[Ali] = []
    while A:
        ref_chr = A[0].comps[0].src
        cur = [a for a in A if a.comps[0].src == ref_chr]
        B = list(reversed([a for a in A if a.comps[0].src != ref_chr]))
        blocks = sort_by_top_start(cur)
        fuse_abutting(blocks, sp=sp)
        if do_beautify:
            blocks = beautify(blocks, orphans, sp=sp)
        fuse_abutting(blocks, sp=sp)
        for a in blocks:
            c = a.comps[0]
            if beg < 0 or (c.start <= end and c.start + c.size > beg):
                if species is not None:
                    a = order_ali(a, species)
                if a is not None:
                    out.append(a)
        A = B
    return out, others
