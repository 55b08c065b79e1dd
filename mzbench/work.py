"""The work of DP jobs, counted from the jobs themselves: what any
implementation of yama has to do for them, not what today's kernels do.

Operations. One band cell of mz_yama.c's recurrence (mz_yama.c:96-255)
needs, in int32:

* each of the three states (C, D, I) takes three candidates, each the
  state it comes from less its gap-open correction (3 subtractions),
  keeps the largest (2 comparisons) and adds its own term (1: the
  extension for D and I, the column score for C): 3 x 6 = 18;
* the column score, the sum-of-pairs substitution score of the two
  columns: with each B column's six category scores formed once per
  column, a 6-term dot product with the A column's category histogram,
  6 multiplications and 5 additions: 11.

That is 29 operations a cell. The gap-open corrections are products of
a row's and a column's dash counts; what of them can be formed once per
row or column is not counted, so the count is a floor.

Cells are the band cells of rows 1..M, sum of RB - LB + 1: row 0 is the
initial state.

Bytes, unpadded, each once: the texts read (M K + N L bytes), the band
read (LB and RB for rows 0..M as int32), the edit script written (two
bits an op for the max(M, N) ops a script has at least, and its length
as 4 bytes). The forward alone reads the
texts and band and writes its three two-bit choices a cell, 6 bits.
"""

from __future__ import annotations

import numpy as np

OPS_PER_CELL = 29
FLAG_BITS_PER_CELL = 6


def cells(job) -> int:
    A, _, LB, RB = job
    M = A.shape[0]
    return int(np.sum(np.asarray(RB[1 : M + 1]) - np.asarray(LB[1 : M + 1]) + 1))


def band_cells(job) -> int:
    """Band cells of rows 0..M (the unit of ``dp_band_cells_per_s``)."""
    A, _, LB, RB = job
    M = A.shape[0]
    return int(np.sum(np.asarray(RB[: M + 1]) - np.asarray(LB[: M + 1]) + 1))


def input_bytes(job) -> int:
    A, B, _, _ = job
    return A.size + B.size + 8 * (A.shape[0] + 1)


def script_bytes(job) -> int:
    """Bytes of the job's edit script: it has at least max(M, N) ops."""
    A, B, _, _ = job
    return 4 + -(-max(A.shape[0], B.shape[0]) // 4)


def dp_work(jobs) -> tuple:
    """(int32 operations, bytes) of the three kernels over ``jobs``."""
    c = sum(cells(j) for j in jobs)
    b = sum(input_bytes(j) + script_bytes(j) for j in jobs)
    return OPS_PER_CELL * c, b


def forward_work(jobs) -> tuple:
    """(int32 operations, bytes) of the forward alone over ``jobs``."""
    c = sum(cells(j) for j in jobs)
    b = sum(input_bytes(j) for j in jobs) + c * FLAG_BITS_PER_CELL // 8
    return OPS_PER_CELL * c, b


def roofline_pct(ops: int, nbytes: int, seconds: float, peaks: dict):
    """100 x the least time the card could take over ``seconds``; None
    where there is no time or no peak to hold it to."""
    if seconds <= 0 or not peaks or not peaks.get("hbm_bytes_per_s"):
        return None
    least = max(ops / peaks["int32_per_s"], nbytes / peaks["hbm_bytes_per_s"])
    return 100.0 * least / seconds
