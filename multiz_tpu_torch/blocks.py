"""MAF block algebra: revcomp, slicing, partial-block emission, sorting.

Vectorized re-implementation of the reference's multi_util.c / maf.c block
operations (cited per function). Operates on multiz_tpu.maf.Ali/Comp with
numpy uint8 texts; all coordinate recomputation uses cumulative-sum position
maps instead of per-character scans. The merge scan's cuts (``keep_ali``,
``make_part_ali_col``, ``nd_col``, ``nondash_before``) are one native pass
each over a block's rows.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from . import scores as sc
from .maf import Ali, Comp, DASH
from .native import load

_mzcore = load()  # the native host runtime (native/mzcore.cpp)

# DNA complement table, byte-for-byte from multi_util.c:34-41 (note: '-' maps
# to '-', unmapped characters map to ' ').
_COMPL_STR = (
    "                                             -                  "
    " TVGH  CD  M KN   YSA BWXR       tvgh  cd  m kn   ysa bwxr      "
    "                                                                "
    "                                                                "
)
DNA_COMPL = np.frombuffer(_COMPL_STR.encode("latin-1"), dtype=np.uint8).copy()


def revcomp_text(text: np.ndarray) -> np.ndarray:
    """do_revcompl (multi_util.c:44-53)."""
    return DNA_COMPL[text[::-1]]


def rev_comp_comp(c: Comp, text_size: int) -> None:
    """rev_comp (multi_util.c:55-59), in place."""
    c.start = c.src_size - (c.start + c.size)
    c.strand = "+" if c.strand == "-" else "-"
    c.text = revcomp_text(c.text)


def rc(a: Ali) -> None:
    """Reverse-complement every component (multi_util.c:62-67)."""
    for c in a.comps:
        rev_comp_comp(c, a.text_size)


def flip_comp(a: Ali) -> None:
    """Swap the first two rows; normalize new top to '+' (multi_util.c:441-458)."""
    if not a.comps:
        raise ValueError("alignment does not have rows")
    if len(a.comps) < 2:
        return
    a.comps[0], a.comps[1] = a.comps[1], a.comps[0]
    c2 = a.comps[0]
    if c2.strand == "-":
        for c in (a.comps[0], a.comps[1]):
            rev_comp_comp(c, a.text_size)


def flip_comps(alis: List[Ali]) -> None:
    for a in alis:
        flip_comp(a)


def score_of(a: Ali, sp: sc.ScoreParams | None = None) -> float:
    return sc.score_range(a, 0, a.text_size, sp=sp)


def col_dash_rm(a: Optional[Ali]) -> Optional[Ali]:
    """Remove all-dash columns in place (mafColDashRm, maf.c:357-381)."""
    if a is None or not a.comps:
        return a
    texts = a.texts()
    keep = (texts != DASH).any(axis=0)
    if not keep.all():
        for c in a.comps:
            c.text = c.text[keep]  # fancy indexing: already a fresh array
    return a


def row_dash_rm(a: Optional[Ali]) -> Optional[Ali]:
    """Drop all-dash rows; None if nothing left (mafRowDashRm, maf.c:384-417)."""
    if a is None:
        return None
    a.comps = [c for c in a.comps if bool((c.text != DASH).any())]
    if not a.comps:
        return None
    return a


def maf_slice(a: Ali, start_col: int, beyond_col: int) -> Ali:
    """mafSlice (multi_util.c:662-687): column slice keeping all rows,
    score unset."""
    out = Ali(score=a.score)
    for c in a.comps:
        nc = c.copy(text=c.text[start_col:beyond_col])  # view: no memcpy
        nc.start = c.start + c.nondash_before(start_col)
        nc.size = int(np.count_nonzero(nc.text != DASH))
        out.comps.append(nc)
    return out


def make_part_ali(a: Ali, cbeg: int, cend: int,
                  sp: sc.ScoreParams | None = None) -> Optional[Ali]:
    """make_part_ali (maf.c:488-523): slice, drop dash rows, rescore."""
    out = maf_slice(a, cbeg, cend + 1)
    out = row_dash_rm(out)
    if out is not None:
        out.score = sc.score_range(out, 0, cend - cbeg + 1, sp=sp)
    return out


def _pm_of(c: Comp) -> Optional[np.ndarray]:
    """c's cached position map where it is current, else None."""
    pm = c._pm
    return pm[1] if pm is not None and pm[0] is c.text else None


def make_part_ali_col(a: Ali, cbeg: int, cend: int,
                      sp: sc.ScoreParams | None = None) -> Optional[Ali]:
    """make_part_ali_col (multi_util.c:570-617): slice columns, drop dash
    rows, remove dash columns, rescore, in one native pass over the rows
    (``part_cut``); a cut outside the block raises ValueError."""
    if cend - cbeg + 1 == 0:
        return None
    if sp is None:
        sp = sc.current
    comps = a.comps
    befores, sizes, mask, score = _mzcore.part_cut(
        [c.text for c in comps], [_pm_of(c) for c in comps], cbeg, cend,
        sp.ss, sp.gop)
    keep = None if mask is None else np.frombuffer(mask, dtype=np.bool_)
    out = Ali()
    for c, before, size in zip(comps, befores, sizes):
        if size == 0:
            continue
        text = c.text[cbeg : cend + 1]  # view: no memcpy
        nc = c.copy(text=text if keep is None else text[keep])
        nc.start = c.start + before
        nc.size = size
        out.comps.append(nc)
    if not out.comps:
        return None
    out.score = float(score)
    return out


def part_ali_by_pos(a: Ali, beg: int, end: int,
                    sp: sc.ScoreParams | None = None) -> Optional[Ali]:
    """print_part_ali (multi_util.c:515-568): beg/end are top-row sequence
    positions; emits the column range without dash-column removal."""
    top = a.comps[0]
    rel_beg = beg - top.start
    rel_end = end - top.start
    nond = top.nd_idx()
    # C returns silently unless 0 <= rel_beg <= rel_end < #non-dash
    if not (0 <= rel_beg <= rel_end < nond.shape[0]):
        return None
    col_beg = int(nond[rel_beg])
    col_end = int(nond[rel_end])
    out = Ali(score=sc.score_range(a, col_beg, col_end - col_beg + 1, sp=sp))
    for c in a.comps:
        pm = c.pos_map()
        before = int(pm[col_beg - 1]) if col_beg > 0 else 0
        chs = int(pm[col_end]) - before
        if chs == 0:
            continue
        nc = c.copy(text=c.text[col_beg : col_end + 1])  # view
        nc.start = c.start + before
        nc.size = chs
        out.comps.append(nc)
    if not out.comps:
        return None
    return out


def keep_ali(a: Ali, beg: int, sp: sc.ScoreParams | None = None) -> Ali:
    """Truncate a block to start at top-row position beg
    (multi_util.c:468-511). Returns a NEW Ali; the input block and its
    comps are left intact — deferred DP coroutines hold references to
    scan-time blocks, and this non-mutating contract is what lets them
    skip per-overlap snapshot copies (preyama.pre_yama_gen).

    The cut column and each row's count before it come from one native
    pass (``keep_cut``): O(1) from a row's current position map, else a
    byte count up to the cut, so a block truncated many times never pays
    O(length) a cut. The child's coordinate caches start empty. A beg
    outside the top row raises ValueError."""
    comps = a.comps
    top = comps[0]
    k = beg - top.start
    if not 0 <= k < top.size:
        raise ValueError(f"pos2col: {beg} not in {top.start}-{top.end - 1}")
    nd = top._nd
    col_beg, counts = _mzcore.keep_cut(
        [c.text for c in comps], [_pm_of(c) for c in comps],
        nd[1] if nd is not None and nd[0] is top.text else None, k)
    new_comps = []
    for c, count in zip(comps, counts):
        if c.size - count < 1:
            continue
        nc = c.copy(text=c.text[col_beg:])  # view: no memcpy
        nc.start += count
        nc.size -= count
        new_comps.append(nc)
    out = Ali(comps=new_comps)
    if new_comps:
        # lazy: most truncated blocks are re-truncated or consumed by
        # the next overlap DP before anyone reads the score (the write
        # path reads it and pays the one rescore then)
        out.set_lazy_score(
            lambda b: sc.score_range(b, 0, b.text_size, sp=sp)
        )
    return out


def nd_col(c: Comp, k: int) -> int:
    """Column of c's (k+1)-th non-dash char, ``pos2col(c, c.start + k)``;
    ``len(c.text)`` where k == c.size, so that ``nd_col(c, k + 1) - 1`` is
    the C's walk right from the (k+1)-th over dash columns (multiz.c:
    117-133). Natively a scan from the row's nearer end (``nd_col``),
    with no nd_idx over the whole row; a k outside [0, c.size] raises
    ValueError, as ``pos2col``."""
    return _mzcore.nd_col(c.text, k, c.size)


def nondash_before(c: Comp, col: int) -> int:
    """``c.nondash_before(col)`` without building the row's position
    map: O(1) from the map where it is current, else one native byte
    count (``nondash_count``)."""
    pm = c._pm
    if pm is not None and pm[0] is c.text:
        return 0 if col <= 0 else int(pm[1][col - 1])
    return _mzcore.nondash_count(c.text, col)


def sort_by_top_start(alis: List[Ali]) -> List[Ali]:
    """mafArray / maf_sort_top ordering: stable sort by top-row start
    (multi_util.c:126-149; glibc qsort is a stable merge sort here)."""
    return sorted(alis, key=lambda a: a.comps[0].start)


def separate_by_src(alis: List[Ali], src: str):
    """seperate_cp_wk (multi_util.c:816-843): stable partition by top src."""
    wk = [a for a in alis if a.comps[0].src == src]
    cp = [a for a in alis if a.comps[0].src != src]
    return cp, wk


def ref_to_top(alis: List[Ali], ref: str, collect_unused: bool = False):
    """ref_mvto_top (maf_sort.c:23-53): move ref row to top, rc to '+',
    drop (or collect) blocks without ref. NOTE: output order is the REVERSE
    of input order (the C builds a push-front list), which maf_sort_top's
    stable sort then preserves for equal starts."""
    kept: List[Ali] = []
    unused: List[Ali] = []
    for a in alis:
        idx = None
        for i, c in enumerate(a.comps):
            if c.name == ref or c.src == ref:
                idx = i
                break
        if idx is None:
            if collect_unused:
                unused.append(a)
            continue
        if idx != 0:
            c = a.comps.pop(idx)
            a.comps.insert(0, c)
        if a.comps[0].strand != "+":
            rc(a)
        kept.append(a)
    kept.reverse()
    unused.reverse()
    return kept, unused


def maf_sort_list(alis: List[Ali], ref: str, collect_unused: bool = False):
    """maf_sort_list (maf_sort.c:80-86)."""
    kept, unused = ref_to_top(alis, ref, collect_unused)
    return sort_by_top_start(kept), unused
