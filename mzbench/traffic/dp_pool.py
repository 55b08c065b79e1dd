"""Traffic kind ``dp_pool``: a pool of DP jobs shaped as a tba plans them,
cut into calls.

Each job is (A, B, LB, RB) as the merge scan hands it to the DP:

* M, the columns of A, drawn from the quantiles the mix lists (piecewise
  log-linear between them);
* N = M plus a uniform offset in [-n_jitter, n_jitter], at least 1;
* K, the rows of A, drawn with the mix's weights; L, the rows of B,
  fixed;
* texts as ``frozen/synth.synth_block`` makes them (dashes at p_dash, no
  all-dash column) and a diagonal band of the mix's radius
  (``frozen/synth.diag_band``).

Every seed gets the same work. The shapes come from the mix's
``shape_seed``, not from the run's seed, and are cut into calls in that
fixed order: each call takes the next jobs until they hold ``call_cells``
band cells, as long as the pool has ``pool_jobs`` jobs; a trailing part
that would not fill a call is left out. So every seed has the same calls,
shape for shape: the program routes each the same way (which of a call's
buckets fill enough to launch and which go to the host lane), and does
the same work. The run's seed draws the order of the calls, the order of
the jobs inside each call, and every text.
"""

from __future__ import annotations

import numpy as np

from ..frozen.synth import diag_band, synth_block
from .tba_region import rng_seed


def draw_m(rng, n: int, quantiles) -> np.ndarray:
    """n column counts from [[q, value], ...] (q from 0 to 1)."""
    q = np.array([p for p, _ in quantiles], dtype=float)
    v = np.log(np.array([m for _, m in quantiles], dtype=float))
    u = rng.random(n)
    return np.maximum(1, np.rint(np.exp(np.interp(u, q, v)))).astype(np.int64)


def band_cells(M: int, N: int, radius: int) -> int:
    """Band cells of rows 0..M of the mix's diagonal band: the job's
    ``work.band_cells``, the unit of a call's ``call_cells``."""
    LB, RB = diag_band(M, N, radius)
    return int((RB[: M + 1] - LB[: M + 1] + 1).sum())


def layout(mix: dict, salt: int = 1) -> list:
    """The mix's calls, each a list of (M, N, K) shapes, the same for
    every seed."""
    rng = np.random.default_rng(rng_seed(int(mix["shape_seed"]), salt))
    n = int(mix["pool_jobs"])
    Ms = draw_m(rng, n, mix["m_quantiles"])
    jit = int(mix["n_jitter"])
    Ns = np.maximum(1, Ms + rng.integers(-jit, jit + 1, size=n))
    kw = np.array(mix["k_weights"], dtype=float)
    Ks = 1 + rng.choice(len(kw), size=n, p=kw / kw.sum())
    radius, limit = int(mix["radius"]), int(mix["call_cells"])
    calls, call, c = [], [], 0
    for M, N, K in zip(Ms.tolist(), Ns.tolist(), Ks.tolist()):
        call.append((M, N, K))
        c += band_cells(M, N, radius)
        if c >= limit:
            calls.append(call)
            call, c = [], 0
    return calls or [call]


def make_calls(mix: dict, seed: int, salt: int = 1) -> tuple:
    """(jobs, calls): the pool laid out call after call in the seed's
    order, and each call's job indices."""
    rng = np.random.default_rng(rng_seed(seed, salt))
    fixed = layout(mix, salt)
    L, radius = int(mix["l_rows"]), int(mix["radius"])
    jobs, calls = [], []
    for ci in rng.permutation(len(fixed)):
        shapes = fixed[ci]
        idx = []
        for si in rng.permutation(len(shapes)):
            M, N, K = shapes[si]
            A = synth_block(rng, M, K, mix["p_dash"])
            B = synth_block(rng, N, L, mix["p_dash"])
            LB, RB = diag_band(M, N, radius)
            idx.append(len(jobs))
            jobs.append((A, B, LB, RB))
        calls.append(idx)
    return jobs, calls


def make(mix: dict, seed: int, salt: int = 1) -> list:
    """The pool's jobs, call after call."""
    return make_calls(mix, seed, salt)[0]
