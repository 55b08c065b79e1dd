"""Batched DP throughput of the port on one card. Counterpart of
``bench.py``.

    python -m multiz_tpu_torch.tools.bench [--device cuda|cpu]

Workload: ``bench.py``'s, 1024 (MZ_BENCH_N) synthetic align-two-
alignments problems, ``synth_jobs(m 256..1024, k 1..4, radius 30, seed
42)``, every one routed to the device (this tool sets
MZ_HOST_JOB_CELLS=0 and MZ_HOST_ROUTE_CELLS=0, so that it measures the
device path whatever the routing defaults). Times ``yama_batch_packed``
end to end (host pack, H2D, the three kernels, D2H, replay) after one
warm call, and keeps the best of ITERS (5) calls, as ``bench.py`` does.
It raises
if a result of the warm call differs from ``yama_numpy``, if a job of
that call stayed on the host lane, or, on a card, if a kernel of the
best call never launched or the prep launched other than once a DP
launch.

In the same call it times the port's native host DP, ``mzcore.yama_many``
(the host lane's C++ DP, held bit-equal to ``yama_numpy``), over the same
jobs on the calling thread alone, best of ITERS: the single-core
baseline. It raises if the baseline's results differ from the device
path's.

Prints one JSON line with ``bench.py``'s keys ``metric``
(``yama_dp_cells_per_sec``), ``value`` (band cells per second, unrounded)
and ``unit``, and without its ``vs_baseline``: that C rate was measured
on the TPU host. Beside them: ``device``, ``seconds`` and the kernel
``launches`` of the best call (``yama_dp``, ``yama_tb``,
``yama_prep``), ``native_1core_cells_per_sec`` (the
baseline's band cells per second) and ``vs_native_1core`` (``value``
over it). ``--device cuda`` (the default) raises without a card;
``--device cpu`` runs the kernels' plain versions (keep MZ_BENCH_N small
there).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from . import check_launches, environ, launches, reset_launches

SEED = 42
ITERS = 5


def bench_jobs(n: int | None = None):
    from ..ops.synth import synth_jobs

    n = int(os.environ.get("MZ_BENCH_N", "1024")) if n is None else n
    return synth_jobs(n, m_lo=256, m_hi=1024, k_lo=1, k_hi=4, radius=30,
                      seed=SEED)


def bench_bucket(n: int = 1024):
    """The largest bucket of ``bench_jobs(n)`` as the packed stream
    buckets it (637 jobs at 1024 x 1024 for n = 1024): (jobs, window
    width)."""
    import numpy as np

    from ..ops import yama_pack as P

    buckets: dict = {}
    for A, B, LB, RB in bench_jobs(n):
        M, N = A.shape[0], B.shape[0]
        cw = P.route_band(np.asarray(LB), np.asarray(RB), M, N)[0]
        key = (max(P._pad_to(M), P._pad_to(N)), P._pad8(A.shape[1]),
               P._pad8(B.shape[1]), cw)
        buckets.setdefault(key, []).append((A, B, LB, RB))
    key = max(buckets, key=lambda k: len(buckets[k]))
    return buckets[key], key[3]


def native_1core(jobs, iters: int = ITERS) -> tuple:
    """(best seconds, merged matrices of the last run) of
    ``mzcore.yama_many`` over ``jobs`` on the calling thread (one core),
    output buffers included, at the current scores."""
    import numpy as np

    from .. import scores as sc
    from .. import yama as Y

    sp = sc.current
    go, ge = int(sp.gap_open), int(sp.gap_extend)
    best = None
    for _ in range(iters):
        t0 = time.perf_counter()
        probs = []
        for A, B, LB, RB in jobs:
            (M, K), (N, L) = A.shape, B.shape
            probs.append((
                np.ascontiguousarray(A), M, K, np.ascontiguousarray(B), N, L,
                np.ascontiguousarray(LB[: M + 1], dtype=np.int64),
                np.ascontiguousarray(RB[: M + 1], dtype=np.int64),
                np.empty((M + N, K + L), dtype=np.uint8),
            ))
        nedits = Y._mzcore.yama_many(probs, sp.ss_cat, sc.BYTE2CAT, go, ge)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best, [p[-1][:ne] for p, ne in zip(probs, nedits)]


def measure(device="cuda", iters: int = ITERS, jobs=None) -> dict:
    """The JSON line's dict for ``jobs`` (default ``bench_jobs()``)."""
    import numpy as np
    import torch

    from ..ops import yama_pack as P
    from ..ops.synth import band_cells
    from ..parallel.sharding import require_device
    from ..yama import yama_numpy

    dev = require_device(device)
    jobs = bench_jobs() if jobs is None else jobs
    cells = band_cells(jobs)
    best = None
    with environ(MZ_HOST_JOB_CELLS="0", MZ_HOST_ROUTE_CELLS="0"):
        P.reset_route_stats()
        out = P.yama_batch_packed(jobs, device=dev)  # warm
        routes = dict(P.route_stats)
        for i, (job, got) in enumerate(zip(jobs, out)):
            if not np.array_equal(got, yama_numpy(*job)):
                raise AssertionError(f"bench job {i} differs from "
                                     "yama_numpy")
        if routes["device_jobs"] + routes["fallback_jobs"] != len(jobs):
            raise AssertionError(f"bench: not every job on the device: "
                                 f"{routes}")
        for _ in range(iters):
            reset_launches()
            t0 = time.perf_counter()
            P.yama_batch_packed(jobs, device=dev)
            dt = time.perf_counter() - t0
            if best is None or dt < best[0]:
                best = (dt, launches())
    dt, counts = best
    check_launches(counts, dev, "bench")
    t_native, native_out = native_1core(jobs, iters)
    for i, (got, want) in enumerate(zip(native_out, out)):
        if not np.array_equal(got, want):
            raise AssertionError(f"bench job {i}: yama_many differs from the "
                                 "device path")
    native = cells / t_native
    return {
        "metric": "yama_dp_cells_per_sec", "value": cells / dt,
        "unit": f"band-cells/s ({len(jobs)}-problem batch, end-to-end)",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "seconds": dt, "launches": counts,
        "native_1core_cells_per_sec": native,
        "vs_native_1core": cells / dt / native,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m multiz_tpu_torch.tools.bench")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    a = ap.parse_args(argv)
    print(json.dumps(measure(a.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
