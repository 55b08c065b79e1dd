"""Job sets of the kernels' checks, made from a seed with numpy: the
ladder of window widths the DP kernel must take (both sides of each
warp-path width of 32, 64, 96 and 128 lanes, the bench's 61 lanes, the
widest real band of 113 lanes, and the block path's wide windows), buckets of sizes that leave a partial block, and jobs of odd
shapes. ``chip_smoke.py`` and the tests run both kernels on them. And
the shapes of the device prep's launches in a real tba (``REAL_LAUNCHES``),
rebuilt from a seed by ``real_launch_jobs`` (``tools/kernel_ab.py``).
For the full-row DP's kernels (``ops/yama_full.py``): the ladder of
bucket pads ``FULL_PAD_LADDER`` (``full_ladder_jobs``), one problem
far wider than any of them (``full_wide_jobs``), and the jobs of a case
that the forward's warp path takes (``full_warp_jobs``).
"""

from __future__ import annotations

import numpy as np

from .. import yama as Y
from ..ops.synth import diag_band, synth_block, synth_jobs

FW_LADDER = (1, 31, 32, 33, 61, 64, 65, 113, 127, 128, 129, 301, 701)

# The launches of the 2 Mb x 5-species tba (tools/bench_pipeline.py's
# dataset at MZ_PIPE_REFLEN=2000000 MZ_PIPE_SPECIES=5) at the card's
# default routing (ops/yama_pack.ROUTING_DEFAULTS["cuda"]), in launch
# order: (problems, m_pad = n_pad), every one at Kp = Lp = 8. Smoke phase
# 14 logs the launches it sees beside these.
REAL_LAUNCHES = (
    (778, 512), (1530, 256), (789, 512), (1051, 64), (1938, 128),
    (279, 1024), (1012, 256), (107, 512), (1598, 256), (830, 512),
    (3304, 128), (1570, 256), (2572, 64), (40, 1024), (187, 512),
    (382, 128), (177, 256), (1646, 256), (3351, 128), (4185, 64),
    (2587, 32), (489, 512), (1571, 256), (1794, 128),
)


# The full-row DP's pads: both ends of the path's power-of-two pads and
# the bench's 1024; FULL_WIDE_N columns pad to 16384, a column record of
# 983 KB a problem
FULL_PAD_LADDER = (16, 32, 256, 1024, 2048)
FULL_WIDE_N = 9000


def _job(rng, M, N, LB, RB, rows=None):
    K, L = ((rows, rows) if rows else
            (int(x) for x in rng.integers(1, 6, size=2)))
    return (synth_block(rng, M, K), synth_block(rng, N, L),
            np.asarray(LB, dtype=np.int64), np.asarray(RB, dtype=np.int64))


def ladder_jobs(fw: int, seed: int = 0):
    """Jobs whose widest band row is fw - 1 lanes: a full band that pins
    the width, an M = 0 problem, a row whose LB jumps 40 columns (where
    the band is wide enough) and diagonal bands narrower than the
    window. At fw = 1 no band is valid for yama (a band must span
    min(N, 10) columns), so its jobs are one column wide."""
    rng = np.random.default_rng(seed + fw)
    W = fw - 1
    if W == 0:
        return [_job(rng, M, 1, [0] + [1] * M, [0] + [1] * M)
                for M in (3, 20)]
    jobs = [
        _job(rng, 23, W, np.zeros(24), np.full(24, W)),
        _job(rng, 0, min(W, 7), [0], [min(W, 7)]),
    ]
    if W >= 34:
        M, N = 30, W + 40
        LB = np.where(np.arange(M + 1) < 12, 0, 40)
        RB = np.where(np.arange(M + 1) < 12, W, N)
        jobs.append(_job(rng, M, N, LB, RB))
    for M in (17, 48):
        N = M + int(rng.integers(-8, 9))
        LB, RB = diag_band(M, N, max(1, W // 3))
        if int((RB - LB).max()) <= W:
            jobs.append(_job(rng, M, N, LB, RB))
    return jobs


def ragged_jobs(n: int, seed: int = 3):
    """``n`` small jobs in one bucket of 61 lanes at most: a bucket size
    that is not a multiple of the problems per block."""
    rng = np.random.default_rng(seed)
    jobs = []
    for _ in range(n):
        M = int(rng.integers(20, 31))
        N = M + int(rng.integers(-3, 4))
        jobs.append(_job(rng, M, N, *diag_band(M, N, 20)))
    return jobs


def edge_jobs(n=64, seed=123):
    """Valid jobs of odd shapes: 1-40 columns of A, 1-300 of B, up to 13
    rows a side (both nibbles of the packed texts), narrow to wide
    bands, dash rates 0-0.5, non-ACGT bytes. Jobs whose walk leaves the
    band (the oracle raises) are skipped."""
    rng = np.random.default_rng(seed)
    jobs = []
    while len(jobs) < n:
        M = int(rng.choice([1, 2, 3, 5, 9, 17, 40]))
        N = int(rng.choice([1, 2, 5, 10, 11, 33, 80, 300]))
        K, L = (int(x) for x in rng.integers(1, 14, size=2))
        LB, RB = diag_band(M, N, int(rng.choice([1, 3, 8, 30, 100])))
        A = synth_block(rng, M, K, p_dash=float(rng.choice([0.0, 0.1, 0.5])))
        B = synth_block(rng, N, L, p_dash=float(rng.choice([0.0, 0.1, 0.5])))
        if len(jobs) % 5 == 0:
            A = np.where(A == ord("A"), np.uint8(ord("n")), A)
        try:
            Y.yama_numpy(A, B, LB, RB)
        except Y.YamaError:
            continue
        jobs.append((A, B, LB, RB))
    return jobs


def real_launch_jobs(problems: int, pad: int, seed: int = 0):
    """``problems`` synthetic jobs of 8 rows a side that fill a bucket of
    ``pad`` columns (the stream's bucket of ``REAL_LAUNCHES``' shape)."""
    return synth_jobs(problems, m_lo=pad // 2 + 1, m_hi=pad - pad // 8 - 1,
                      k_lo=8, k_hi=8, radius=30, seed=seed)


def full_ladder_jobs(pad: int, seed: int = 0):
    """Jobs of one full-row bucket of ``pad`` x ``pad``: a diagonal band
    that fills it, a wide band at 8 rows a side, an M = 0 problem, a
    one-column B and, where ``pad`` allows, a row whose LB jumps 40
    columns."""
    rng = np.random.default_rng(seed + pad)
    M = pad - int(rng.integers(0, pad // 8 + 1))
    m2 = pad // 2 + 1
    jobs = [
        _job(rng, M, pad, *diag_band(M, pad, min(30, pad // 2))),
        _job(rng, m2, M, *diag_band(m2, M, max(4, pad // 4)), rows=8),
        _job(rng, 0, min(pad, 7), [0], [min(pad, 7)]),
        _job(rng, 5, 1, np.zeros(6), np.ones(6)),
    ]
    if pad >= 128:
        W, N = pad - 41, pad - 1
        LB = np.where(np.arange(31) < 12, 0, 40)
        RB = np.where(np.arange(31) < 12, W, N)
        jobs.append(_job(rng, 30, N, LB, RB))
    return jobs


def full_warp_jobs(jobs, m_pad: int, n_pad: int):
    """The jobs that the full-row forward's warp path takes in a bucket of
    their own at these pads (``ops/yama_full.full_window``)."""
    from ..ops import yama_full as F

    keep = []
    for job in jobs:
        h = F.stack_host([job], m_pad, n_pad)
        window, monotone = F.full_window(h["LB"], h["RB"], h["M"], m_pad,
                                         n_pad)
        if monotone and window <= F.FULL_WARP_LANES:
            keep.append(job)
    return keep


def full_wide_jobs(seed: int = 0):
    """One problem of FULL_WIDE_N columns (n_pad 16384, a column record
    far past a block's shared memory) over 40 rows, its band a few
    thousand columns wide: each row takes many tiles."""
    rng = np.random.default_rng(seed)
    return [_job(rng, 40, FULL_WIDE_N, *diag_band(40, FULL_WIDE_N, 1200))]
