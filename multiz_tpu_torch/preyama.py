"""pre_yama: slice overlapping blocks, build the DP band, run yama, rebuild.

Port of mz_preyama.c with vectorized band construction. Two reference
quirks are reproduced deterministically because they affect byte-equality
of multiz v=0 output (both are out-of-bounds reads that are stable under
glibc/x86-64, observed by differential testing against the built reference):

  * ``mapping(A, 1, K, ...)`` (mz_preyama.c:279) scans rows 1..K of columns
    that only have rows 0..K-1: the dash test effectively uses rows 1..K-1
    of column i plus row 0 of column i+1; for the last column the
    past-the-end byte is heap garbage, overwhelmingly non-dash.
  * the a2-side band walk (mz_preyama.c:320) evaluates ``map4[map2[i]]``
    before checking ``map2[i] == -1``; ``map4[-1]`` reads the high half of
    the glibc chunk size field, which is 0 for any real allocation, so the
    walk scatters 0 into LB/RB at ref-only columns.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

from . import scores as sc
from .blocks import make_part_ali_col, nd_col
from .maf import Ali, DASH, pos2col
from .native import load
from .yama import yama_numpy

_mzcore = load()  # the native host runtime (native/mzcore.cpp)

DPFn = Callable[..., np.ndarray]
_U8 = np.dtype(np.uint8)
_I64 = np.dtype(np.int64)


def smooth(LB: np.ndarray, RB: np.ndarray, M: int, N: int, radius: int):
    """Monotonize band bounds, then dilate into a radius-R sausage
    (mz_preyama.c:17-35), natively (``mzcore.smooth_into``); returns new
    int64 arrays."""
    L2 = LB[: M + 1].astype(np.int64, copy=True)
    R2 = RB[: M + 1].astype(np.int64, copy=True)
    _mzcore.smooth_into(L2, R2, M, N, radius)
    return L2, R2


def rm_col_dash(X: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Drop all-dash columns of column-major X (ncol, nrow)
    (mz_preyama.c:87-108). Returns (newX, map_) where map_ is 1-indexed:
    map_[old_col] = new_col or -1."""
    ncol = X.shape[0]
    keep = (X != DASH).any(axis=1)
    map_ = np.full(ncol + 1, -1, dtype=np.int64)
    map_[1:][keep] = np.arange(1, int(keep.sum()) + 1)
    return X[keep], map_


def mapping_pairs(alldash_a: np.ndarray, alldash_b: np.ndarray) -> np.ndarray:
    """mapping (mz_preyama.c:111-148): pair the t-th non-all-dash column of
    A with the t-th of B. ``alldash_*`` are boolean arrays over 1..ncol
    (index 0 unused). Returns map_ with map_[a_col] = b_col or -1."""
    na = alldash_a.shape[0] - 1
    map_ = np.full(na + 1, -1, dtype=np.int64)
    ia = np.flatnonzero(~alldash_a[1:]) + 1
    ib = np.flatnonzero(~alldash_b[1:]) + 1
    n = min(ia.shape[0], ib.shape[0])
    map_[ia[:n]] = ib[:n]
    return map_


def _alldash(X: np.ndarray, row_lo: int, row_hi: int) -> np.ndarray:
    """1-indexed all-dash flags of columns of X over rows [row_lo, row_hi)."""
    ncol = X.shape[0]
    out = np.zeros(ncol + 1, dtype=bool)
    out[1:] = (X[:, row_lo:row_hi] == DASH).all(axis=1)
    return out


def _alldash_shifted(X: np.ndarray) -> np.ndarray:
    """A-side quirk of mapping(A, 1, K, ...): dash over rows 1..K-1 of
    column i AND row 0 of column i+1 (past-the-end byte of the last column
    treated as non-dash)."""
    ncol, K = X.shape
    out = np.zeros(ncol + 1, dtype=bool)
    core = (X[:, 1:K] == DASH).all(axis=1)  # rows 1..K-1 (vacuous for K==1)
    nxt = np.zeros(ncol, dtype=bool)
    if ncol > 1:
        nxt[:-1] = X[1:, 0] == DASH
    nxt[-1] = False  # heap garbage: non-dash
    out[1:] = core & nxt
    return out


def maf_build(
    A_new: np.ndarray,
    a2: Ali,
    cbeg2: int,
    a3: Ali,
    cbeg3: int,
    top: int,
    sp: sc.ScoreParams | None = None,
    befores: Optional[bytes] = None,
) -> Optional[Ali]:
    """Reconstitute an Ali from the merged column matrix (mz_preyama.c:38-81).

    Template rows: all of a2's comps, then a3's comps (skipping a3's first
    when top == 0). One native pass (``preyama_fold``: the transpose, the
    rows' sizes and starts, their Comps and the score). ``befores``: each
    template row's #non-dash before its cut, int64, where the plan
    counted them (``preyama_plan1``)."""
    if sp is None:
        sp = sc.current
    A_new = np.ascontiguousarray(A_new)
    comps, score = _mzcore.preyama_fold(
        A_new, np.empty(A_new.shape[::-1], _U8), a2.comps, cbeg2, a3.comps,
        1 if top == 0 else 0, cbeg3, sp.ss, sp.gop, befores)
    return Ali(comps, score) if comps else None


def pre_yama(
    a1: Ali,
    a2: Ali,
    beg: int,
    end: int,
    radius: int,
    v: int,
    unused2_sink=None,
    sp: sc.ScoreParams | None = None,
    dp_fn: DPFn = yama_numpy,
) -> Optional[Ali]:
    """pre_yama (mz_preyama.c:152-359): drive :func:`pre_yama_gen` with a
    synchronous per-problem DP function."""
    gen = pre_yama_gen(
        a1, a2, beg, end, radius, v, unused2_sink=unused2_sink, sp=sp,
        snapshot=False,  # driven to completion before the scan resumes
    )
    try:
        job = next(gen)
        while True:
            job = gen.send(dp_fn(*job, sp=sp))
    except StopIteration as e:
        return e.value


def pre_yama_gen(
    a1: Ali,
    a2: Ali,
    beg: int,
    end: int,
    radius: int,
    v: int,
    unused2_sink=None,
    sp: sc.ScoreParams | None = None,
    snapshot: bool = False,
):
    """Coroutine form of pre_yama: yields (A, B, LB, RB) DP jobs and
    receives merged column matrices back via ``send``; returns the final
    Ali (or None). This is the seam that lets the multiz merge scan
    *plan* all DP jobs, execute them as batched device launches, and
    stitch results in scan order (SURVEY.md §7 step 4).

    v == 1: a1's reference row is fixed; single DP merging a1 (all rows)
    with a2's non-ref rows. v == 0: neither fixed; first DP aligns the
    non-ref rows of both, second DP re-aligns the bare reference against
    the merged block.

    ``unused2_sink(ali)`` receives a2's slice when a1 contributes no rows
    (K == 0, mz_preyama.c:193-200).

    A v == 1 job is planned in one native pass (``preyama_plan1``: the
    column lookups, A, B without its all-dash columns, the band); the
    numpy code below is the v == 0 plan."""
    # When driven deferred, the merge scan resumes this coroutine after
    # it has moved past a1/a2 — safe without copies because keep_ali is
    # non-mutating (returns a fresh Ali) and Comp text buffers are
    # replaced, never mutated in place. ``snapshot=True`` restores the
    # defensive per-overlap copies for callers without that guarantee.
    if snapshot:
        a1 = Ali(
            comps=[c.copy(text=c.text) for c in a1.comps], score=a1.score
        )
        a2 = Ali(
            comps=[c.copy(text=c.text) for c in a2.comps], score=a2.score
        )
    if v == 1:
        job = _mzcore.preyama_plan1(a1.comps, a2.comps, beg, end, radius)
        if not job:  # B keeps no column
            return None
        a, b, lb, rb, M, K, N, L, cbeg1, cbeg2, befores = job
        AL_new = yield (
            np.ndarray((M, K), _U8, a), np.ndarray((N, L), _U8, b),
            np.ndarray(M + 1, _I64, lb), np.ndarray(M + 1, _I64, rb),
        )
        return maf_build(AL_new, a1, cbeg1, a2, cbeg2, 0, sp=sp,
                         befores=befores)

    # ---- v == 0 ----
    K = len(a1.comps) - 1
    L = len(a2.comps) - 1

    top1, top2 = a1.comps[0], a2.comps[0]
    cbeg1 = nd_col(top1, beg - top1.start)
    cend1 = nd_col(top1, end - top1.start)
    cbeg2 = nd_col(top2, beg - top2.start)
    cend2 = nd_col(top2, end - top2.start)
    M = cend1 - cbeg1 + 1
    N = cend2 - cbeg2 + 1

    # column-major slices. L == 0 (a2 is a single-row block, e.g. a
    # pair2tb gap filler): the (N, 0) columns are vacuously all-dash,
    # rmColDash drops every one and pre_yama returns NULL
    # (mz_preyama.c:94-98 with row==0 never breaking, :183-188)
    if L > 0:
        B_full = np.stack(
            [c.text[cbeg2 : cend2 + 1] for c in a2.comps[1:]], axis=1
        )  # (N, L)
    else:
        B_full = np.empty((N, 0), dtype=np.uint8)
    N_cp = N
    B, map2 = rm_col_dash(B_full)
    N = B.shape[0]
    if N < 1:
        return None

    if K == 0:
        if unused2_sink is not None:
            part = make_part_ali_col(a2, cbeg2, cend2, sp=sp)
            unused2_sink(part)
        return None

    A_full = np.stack(
        [c.text[cbeg1 : cend1 + 1] for c in a1.comps[1:]], axis=1
    )  # (M, K)
    M_cp = M
    A, map1 = rm_col_dash(A_full)
    M = A.shape[0]
    if M < 1:
        return None

    # band from the lockstep walk of the two reference rows
    # (mz_preyama.c:240-258): the t-th non-dash of top1's slice pairs with
    # the t-th non-dash of top2's slice; scatter through map1/map2.
    LB = np.zeros(M + 1, dtype=np.int64)
    RB = np.full(M + 1, N, dtype=np.int64)
    i_cols = np.flatnonzero(top1.text[cbeg1 : cend1 + 1] != DASH) + 1
    j_cols = np.flatnonzero(top2.text[cbeg2 : cend2 + 1] != DASH) + 1
    n = min(i_cols.shape[0], j_cols.shape[0])
    curr1 = map1[i_cols[:n]]
    curr2 = map2[j_cols[:n]]
    valid = (curr1 != -1) & (curr2 != -1)
    LB[curr1[valid]] = curr2[valid]
    RB[curr1[valid]] = curr2[valid]
    LB, RB = smooth(LB, RB, M, N, radius)

    AL_new = yield (A, B, LB, RB)
    M_new = AL_new.shape[0]

    # second DP of the bare reference vs the merged block
    A2 = top1.text[cbeg1 : cend1 + 1].reshape(-1, 1)  # (M_cp, 1)
    A2r, map3 = rm_col_dash(A2)
    M3 = A2r.shape[0]

    # mapping A -> AL_new with the reference's shifted row window (quirk 1)
    map4 = mapping_pairs(
        _alldash_shifted(A), _alldash(AL_new, 0, K - 1 + 1)
    )
    LB2 = np.zeros(M3 + 1, dtype=np.int64)
    RB2 = np.full(M3 + 1, M_new, dtype=np.int64)
    idx = np.arange(1, M_cp + 1)
    t1 = map3[idx]
    m1 = map1[idx]
    ok = (m1 != -1)
    t2 = np.where(ok, map4[np.where(ok, m1, 1)], -1)
    good = (t1 != -1) & (t2 != -1) & ok
    # scatter honoring the C update rule; map3 injective => one writer/slot
    LB2[t1[good]] = np.where(
        (LB2[t1[good]] == 0) | (LB2[t1[good]] > t2[good]), t2[good],
        LB2[t1[good]],
    )
    RB2[t1[good]] = t2[good]
    LB2, RB2 = smooth(LB2, RB2, M3, M_new, radius)

    B2 = top2.text[cbeg2 : cend2 + 1].reshape(-1, 1)
    B2r, map3b = rm_col_dash(B2)
    N3 = B2r.shape[0]
    map4b = mapping_pairs(
        _alldash(B, 0, L), _alldash(AL_new, K, K + L)
    )
    LBb = np.zeros(N3 + 1, dtype=np.int64)
    RBb = np.full(N3 + 1, M_new, dtype=np.int64)
    idx = np.arange(1, N_cp + 1)
    t1 = map3b[idx]
    m2 = map2[idx]
    # quirk 2: map4[-1] reads as 0 (no -1 guard on map2 in the C)
    t2 = np.where(m2 != -1, map4b[np.where(m2 != -1, m2, 1)], 0)
    good = (t1 != -1) & (t2 != -1)
    tg, vg = t1[good], t2[good]
    LBb[tg] = np.where((LBb[tg] == 0) | (LBb[tg] > vg), vg, LBb[tg])
    RBb[tg] = np.where((RBb[tg] == M_new) | (RBb[tg] < vg), vg, RBb[tg])
    LBb, RBb = smooth(LBb, RBb, N3, M_new, radius)

    if M3 != N3:
        raise ValueError("M3 != N3 in pre_yama v==0")
    LBf = np.minimum(LBb, LB2)
    RBf = np.maximum(RBb, RB2)

    AL_new2 = yield (A2r, AL_new, LBf, RBf)
    return maf_build(AL_new2, a1, cbeg1, a2, cbeg2, 0, sp=sp)


def _must_equal(x: int, y: int, who: str) -> None:
    """must_equal (mz_preyama.c:362-384): case-insensitive equality of
    presumed-identical sequence characters."""
    if chr(x).upper() != chr(y).upper():
        raise ValueError(
            f"pre_yama2: sequence mismatch {chr(x)!r} != {chr(y)!r} ({who})"
        )


def pre_yama2(
    a1: Ali,
    a2: Ali,
    a3: Ali,
    beg1: int,
    end1: int,
    begN: int,
    endN: int,
    radius: int,
    pws,
    sp: sc.ScoreParams | None = None,
    dp_fn: DPFn = yama_numpy,
) -> Optional[Ali]:
    """pre_yama2 (mz_preyama.c:387-521): merge a2 and a3 where the
    pairwise bridge block a1 dictates the column correspondence. The
    band comes from a1's two rows exactly (then smooth-dilated); the
    merge is gated on >=50% pairwise support (``connection_agreement2``,
    mz_preyama.c:436). ``pws`` is an ``align_util.PwUAliFiles``."""
    from .align_util import connection_agreement2

    if len(a1.comps) != 2:
        raise ValueError("pre_yama2: a1 is not a pairwise alignment")
    c, c1 = a1.comps[0], a1.comps[1]
    c2, c3 = a2.comps[0], a3.comps[0]
    K = len(a2.comps)
    L = len(a3.comps)
    if K == 0 or L == 0:
        raise ValueError("pre_yama2: an alignment has 0 rows")
    if c.src != c2.src:
        raise ValueError(
            f"pre_yama2: first rows for sequences {c.src} != {c2.src}"
        )
    if c.src_size != c2.src_size or c.strand != c2.strand:
        raise ValueError("pre_yama2: first rows incompatible")
    if c1.src != c3.src:
        raise ValueError(
            f"pre_yama2: first rows (2) for sequences {c1.src} != {c3.src}"
        )
    if c1.src_size != c3.src_size or c1.strand != c3.strand:
        raise ValueError("pre_yama2: first rows (2) incompatible")

    cbeg1 = pos2col(c, beg1)
    cend1 = pos2col(c, end1)
    if cbeg1 != pos2col(c1, begN) or cend1 != pos2col(c1, endN):
        raise ValueError("pre_yama2: mismatch of beg/end columns")
    cbeg2 = pos2col(c2, beg1)
    cend2 = pos2col(c2, end1)
    cbeg3 = pos2col(c3, begN)
    cend3 = pos2col(c3, endN)

    if connection_agreement2(a2, a3, cbeg2, cend2, cbeg3, cend3, pws) == 0:
        return None

    M = cend2 - cbeg2 + 1
    N = cend3 - cbeg3 + 1
    if max(M, N) < 2:
        return None

    A = np.stack([d.text[cbeg2 : cend2 + 1] for d in a2.comps], axis=1)
    B = np.stack([d.text[cbeg3 : cend3 + 1] for d in a3.comps], axis=1)

    # ---- band from a1's two rows (mz_preyama.c:473-506), vectorized ----
    # the t-th non-dash char of c over [cbeg1, cend1] lands on the t-th
    # column of A whose top row is non-dash (checked equal); same for c1/B
    ct = c.text[cbeg1 : cend1 + 1]
    c1t = c1.text[cbeg1 : cend1 + 1]
    ndc = ct != DASH
    ndc1 = c1t != DASH
    posA = np.flatnonzero(A[:, 0] != DASH) + 1  # 1-based A columns
    posB = np.flatnonzero(B[:, 0] != DASH) + 1
    if int(ndc.sum()) > posA.shape[0]:
        raise ValueError("pre_yama2: bad scene")
    if int(ndc1.sum()) > posB.shape[0]:
        raise ValueError("pre_yama2: ouch")
    for x, z in zip(ct[ndc], A[posA[: int(ndc.sum())] - 1, 0]):
        _must_equal(int(x), int(z), "file 2")
    for y, z in zip(c1t[ndc1], B[posB[: int(ndc1.sum())] - 1, 0]):
        _must_equal(int(y), int(z), "file 3")

    cumA = np.cumsum(ndc)
    cumB = np.cumsum(ndc1)
    i_arr = np.where(cumA > 0, posA[np.maximum(cumA - 1, 0)], 0)
    j_arr = np.where(cumB > 0, posB[np.maximum(cumB - 1, 0)], 0)
    if (int(i_arr[-1]) if i_arr.size else 0) != M or (
        int(j_arr[-1]) if j_arr.size else 0
    ) != N:
        raise ValueError(
            f"pre_yama2: i = {int(i_arr[-1])}, M = {M}, "
            f"j = {int(j_arr[-1])}, N = {N}"
        )
    LB = np.zeros(M + 1, dtype=np.int64)
    RB = np.full(M + 1, N, dtype=np.int64)
    # LB[i] = first nonzero j in i's group (the C's `if (LB[i]==0)` rule);
    # RB[i] = last (max) j; j is nondecreasing so min/max scatters match
    nz = j_arr > 0
    if nz.any():
        tmp = np.full(M + 1, np.iinfo(np.int64).max, dtype=np.int64)
        np.minimum.at(tmp, i_arr[nz], j_arr[nz])
        touched = tmp != np.iinfo(np.int64).max
        LB[touched] = tmp[touched]
    rbt = np.full(M + 1, -1, dtype=np.int64)
    np.maximum.at(rbt, i_arr, j_arr)
    RB[rbt >= 0] = rbt[rbt >= 0]
    LB, RB = smooth(LB, RB, M, N, radius)

    AL_new = dp_fn(A, B, LB, RB, sp=sp)
    return maf_build(AL_new, a2, cbeg2, a3, cbeg3, 1, sp=sp)
