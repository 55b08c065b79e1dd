# Frozen copy of multiz_tpu_torch/ops/synth.py at commit 1de2067, kept by the benchmark
# (mzbench/) so that its inputs and its reference never import the program.
# Changes: the native runtime is never loaded (numpy only); cut to what
# the benchmark's sequential tba and inputs call.
"""Synthetic banded DP problem generator (bench / dryrun workloads).

Shapes mimic what the multiz merge scan feeds pre_yama on real data: local
alignment blocks of a few hundred to a few thousand columns, K x L row
counts small (2..8), band = diagonal sausage of radius R=30 (the reference
default, multi_util.c:13; band built per mz_preyama.c:240-259 smooth()).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
DASH = ord("-")


def diag_band(M: int, N: int, radius: int) -> Tuple[np.ndarray, np.ndarray]:
    """Monotone diagonal band of the given radius satisfying yama's entry
    checks (mz_yama.c:58-71): LB[0]=0, RB[M]=N, width >= min(N, 10)."""
    i = np.arange(M + 1, dtype=np.int64)
    c = (i * N) // max(M, 1)
    w = max(min(N, 10), 2 * radius)
    LB = np.maximum(0, c - radius)
    RB = np.minimum(N, np.maximum(c + radius, LB + w))
    RB = np.maximum.accumulate(RB)
    LB = np.minimum(LB, np.maximum(0, RB - w))
    LB[0] = 0
    RB[M] = N
    return LB, RB


def synth_block(rng: np.random.Generator, ncol: int, nrow: int,
                p_dash: float = 0.1) -> np.ndarray:
    """Random (ncol, nrow) column-major alignment text with no all-dash
    columns (pre_yama removes those before the DP, mz_preyama.c:87-108)."""
    X = BASES[rng.integers(0, 4, size=(ncol, nrow))]
    if nrow > 1:
        dash = rng.random((ncol, nrow)) < p_dash
        # keep at least one non-dash per column
        keep = rng.integers(0, nrow, size=ncol)
        dash[np.arange(ncol), keep] = False
        X = np.where(dash, np.uint8(DASH), X)
    return X


def synth_jobs(
    n: int,
    m_lo: int = 64,
    m_hi: int = 1024,
    k_lo: int = 1,
    k_hi: int = 4,
    radius: int = 30,
    seed: int = 0,
) -> List[tuple]:
    """Generate n (A, B, LB, RB) problems with mixed sizes."""
    rng = np.random.default_rng(seed)
    jobs = []
    for _ in range(n):
        M = int(rng.integers(m_lo, m_hi + 1))
        N = int(M + rng.integers(-M // 8, M // 8 + 1))
        N = max(N, 16)
        K = int(rng.integers(k_lo, k_hi + 1))
        L = int(rng.integers(k_lo, k_hi + 1))
        A = synth_block(rng, M, K)
        B = synth_block(rng, N, L)
        LB, RB = diag_band(M, N, radius)
        jobs.append((A, B, LB, RB))
    return jobs

