"""The "yama" DP: banded alignment of two alignments (align-two-alignments).

Re-derivation of the reference kernel ``mz_yama.c:50-320`` in a form that
vectorizes on TPU. The reference spends O(K*L) work per DP cell adjusting
Altschul quasi-natural gap-open counts (mz_yama.c:123-137,174-187,211-225)
and summing sum-of-pairs substitution scores (mz_yama.c:199-201). Both
collapse to bilinear forms of per-column statistics:

  * substitution:  SUB[m,n] = histA[m] . S6 . histB[n]   (6-category base
    histograms per alignment column)
  * gap corrections: products of per-column dash counts and adjacent-column
    dash-pattern pair counts (4 categories per column pair), because
    GAP(s,t,u,v) factors over (s,u) from A and (t,v) from B
    (mz_scores.c:56-80).

This module holds the exact integer DP of the host, ``yama_numpy`` (the
JAX package's name for it), which runs the native C++ recurrence
(``native/mzcore.cpp`` ``yama_into``); ``multiz_tpu.ops.yama_jax``
implements the same recurrence as a jitted wavefront for device
execution. Tie-breaking (C >= D > I preference,
mz_yama.c:138-154,189-198,226-235) and traceback-start choice
(mz_yama.c:262-267) are replicated bit-for-bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import scores as sc
from .native import load

_mzcore = load()  # the native host runtime (native/mzcore.cpp)


class YamaError(Exception):
    pass


@dataclass
class ColStats:
    """Per-column statistics of one column-major alignment (ncol, nrow).

    All arrays are 1-indexed by column (index 0 unused) to mirror the C
    code's 1-based columns.
    """

    nrow: int
    ncol: int
    ndash: np.ndarray  # (ncol+1,) dashes per column
    nond: np.ndarray  # (ncol+1,) non-dashes per column
    hist: np.ndarray  # (ncol+1, 6) category histogram per column
    # pair[i, (first<<1)|second] = #rows with given dash pattern in
    # columns (i-1, i); pair[1] has first-bit forced to 0.
    pair: np.ndarray  # (ncol+1, 4)


def column_stats(X: np.ndarray) -> ColStats:
    """Compute ColStats for X of shape (ncol, nrow), uint8 text bytes."""
    ncol, nrow = X.shape
    hist = np.zeros((ncol + 1, sc.NCAT), dtype=np.int32)
    nond = np.zeros(ncol + 1, dtype=np.int32)
    ndash = np.zeros(ncol + 1, dtype=np.int32)
    pair = np.zeros((ncol + 1, 4), dtype=np.int32)
    _mzcore.colstats_into(
        np.ascontiguousarray(X), ncol, nrow, sc.BYTE2CAT,
        hist, nond, ndash, pair,
    )
    return ColStats(
        nrow=nrow, ncol=ncol, ndash=ndash, nond=nond, hist=hist, pair=pair
    )


def _check_band(LB: np.ndarray, RB: np.ndarray, M: int, N: int) -> None:
    """Entry sanity checks of yama (mz_yama.c:58-71)."""
    if LB[0] != 0 or RB[M] != N:
        raise YamaError(f"LB and RB not terminated properly: {LB[0]} {RB[M]} {N}")
    w = RB[: M + 1] - LB[: M + 1]
    if np.any(w < min(N, 10)):
        r = int(np.argmax(w < min(N, 10)))
        raise YamaError(f"RB[{r}] - LB[{r}] < {min(N, 10)}")
    if np.any(np.diff(LB[: M + 1]) < 0):
        raise YamaError("LB not monotonic")
    if np.any(np.diff(RB[: M + 1]) < 0):
        raise YamaError("RB not monotonic")


def yama_numpy(
    A: np.ndarray,
    B: np.ndarray,
    LB: np.ndarray,
    RB: np.ndarray,
    sp: sc.ScoreParams | None = None,
) -> np.ndarray:
    """Exact integer port of yama (mz_yama.c:50-320).

    A: (M, K) uint8 column-major alignment (A[i] is alignment column i+1).
    B: (N, L) uint8. LB/RB: (M+1,) int band bounds over columns of B.
    Returns the merged column-major alignment (M_new, K+L) uint8.

    One native call (``mzcore.yama_into``): the band checks of
    :func:`_check_band`, the DP, the traceback and the replay. M == 0
    takes the same path: an empty A and an empty B merge into no
    columns; with N > 0 the walk leaves the matrix, a YamaError, as in
    the JAX package's DP.
    """
    if sp is None:
        sp = sc.current
    M, K = A.shape
    N, L = B.shape
    out = np.empty((M + N, K + L), dtype=np.uint8)
    try:
        nedit = _mzcore.yama_into(
            np.ascontiguousarray(A), M, K,
            np.ascontiguousarray(B), N, L,
            np.ascontiguousarray(LB[: M + 1], dtype=np.int64),
            np.ascontiguousarray(RB[: M + 1], dtype=np.int64),
            np.ascontiguousarray(sp.ss_cat.astype(np.int32)),
            sc.BYTE2CAT, int(sp.gap_open), int(sp.gap_extend), out,
        )
    except ValueError as e:
        raise YamaError(str(e))
    # copy: results are retained pipeline-wide; a view would pin the
    # full worst-case (M+N, K+L) backing buffer.
    return out[:nedit].copy()


def traceback(
    flags: np.ndarray, LB: np.ndarray, M: int, N: int, C: int, D: int, I: int
) -> np.ndarray:
    """Edit-script extraction over the dense (M+1, N+1) flag matrix
    (mz_yama.c:257-291), natively (``mzcore.traceback_into``). Returns
    ops oldest-first."""
    script = np.empty(M + N, dtype=np.uint8)
    try:
        nedit = _mzcore.traceback_into(
            np.ascontiguousarray(flags), int(M), int(N),
            int(C), int(D), int(I), script,
        )
    except ValueError as e:
        raise YamaError(str(e))
    return script[:nedit][::-1].copy()
