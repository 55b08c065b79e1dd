"""Entry points of the port: the batched full-row DP step and the
multi-device dryrun. Port of ``__graft_entry__.py``.

    python -m multiz_tpu_torch.entry [--device D]            # entry()
    python -m multiz_tpu_torch.entry dryrun [N] [--device D]  # N ranks

``--device`` defaults to ``cuda`` and raises where torch sees no card;
``--device cpu`` (the kernels' plain versions) is asked for by name, as
the JAX dryrun runs on virtual CPU devices off a TPU host. A dryrun over
more ranks than cards puts several ranks on one card; it never puts one
on the CPU in place of a card.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

# Problems per sublane group in the JAX dryrun off a TPU, where it sizes
# the packed workload (multiz_tpu/ops/yama_pack.py:_np_active)
JAX_INTERPRET_GROUP = 8


def entry(device="cuda"):
    """(fn, example_args): ``fn(*example_args)`` runs the batched
    full-row DP forward and traceback (``ops/yama_full.py``) on
    ``synth_jobs(8, m 128..200, seed 7)`` stacked at m_pad = n_pad = 256
    on ``device``, and returns (scripts, nedits)."""
    from . import scores as sc
    from .ops.synth import synth_jobs
    from .ops.yama_full import (
        STACK_KEYS, full_plan, stack_host, traceback_core, upload, yama_core,
    )
    from .parallel.sharding import require_device
    from .scores import from_score_params

    dev = require_device(device)
    st = from_score_params(sc.current, dev)
    go, ge = st.gap_open, st.gap_extend
    m_pad = n_pad = 256
    host = stack_host(synth_jobs(8, m_lo=128, m_hi=200, seed=7), m_pad, n_pad)
    plan = full_plan(host["LB"], host["RB"], host["M"], m_pad, n_pad)
    stacked = upload(host, dev)

    def fn(*args):
        ops, ss = args[:-1], args[-1]
        flags, *last = yama_core(*ops, ss, go, ge, m_pad, n_pad, plan=plan)
        lb, rb, m, n = ops[8:12]
        return traceback_core(flags, lb, rb, m, n, *last, m_pad, n_pad)

    return fn, tuple(stacked[k] for k in STACK_KEYS) + (st.ss_cat,)


def packed_dryrun_jobs(n: int):
    """The JAX dryrun's mixed packed workload for ``n`` devices: several
    buckets, K/L up to 8 rows, and a wide-radius set whose windows need
    the 512-lane rung of the ladder (``__graft_entry__.py:117-129``)."""
    from .ops.synth import synth_jobs

    return (
        synth_jobs(2 * n * JAX_INTERPRET_GROUP + 3, m_lo=20, m_hi=40,
                   radius=8, seed=5)
        + synth_jobs(n + 1, m_lo=150, m_hi=400, k_lo=4, k_hi=8, radius=12,
                     seed=6)
        + synth_jobs(n + 1, m_lo=300, m_hi=340, radius=140, seed=7)
    )


def count_unequal(jobs, outs) -> int:
    """How many of ``outs`` differ from ``yama_numpy`` on ``jobs``, or
    are missing."""
    from .yama import yama_numpy

    bad = 0
    for (A, B, LB, RB), out in zip(jobs, outs):
        want = yama_numpy(A, B, LB, RB)
        bad += out is None or out.shape != want.shape or not (out == want).all()
    return bad + abs(len(jobs) - len(outs))


def _dryrun_rank(n: int, device_type: str):
    """One rank of the dryrun's packed run: (rank, device, jobs, unequal
    results, DP launches, traceback launches)."""
    import torch.distributed as dist

    from .ops.yama_dp import dp_forward
    from .ops.yama_tb import traceback
    from .parallel.distributed import (
        distributed_yama_batch_packed, rank_device,
    )

    dev = rank_device() if device_type == "cuda" else torch.device("cpu")
    if dev.type != device_type:
        raise RuntimeError(f"dryrun rank: wanted {device_type}, got {dev}")
    jobs = packed_dryrun_jobs(n)
    dp_forward.launches = traceback.launches = 0
    outs = distributed_yama_batch_packed(jobs, device=dev)
    return (dist.get_rank(), str(dev), len(jobs), count_unequal(jobs, outs),
            dp_forward.launches, traceback.launches)


def dryrun_multichip(n_devices: int, device="cuda", timeout: float = 600.0):
    """The multi-device check of ``__graft_entry__.dryrun_multichip``.

    1. The full-row ``yama_batch`` over the JAX dryrun's mesh of
       ``n_devices`` entries on ``device`` (cards reused round-robin when
       there are fewer): ``(blocks, band)`` with ``band = 2`` for an even
       n >= 4, else 1, on ``synth_jobs(2 blocks band, m 20..30, radius 8,
       seed 3)``.
    2. ``distributed_yama_batch_packed`` over ``n_devices`` gloo ranks,
       each spawned fresh, on ``packed_dryrun_jobs(n)``.
    Every result of both, on every rank, must equal ``yama_numpy``;
    otherwise, or if a rank fails, this raises."""
    from .ops.synth import synth_jobs
    from .ops.yama_full import yama_batch
    from .ops.yama_pack import route_band
    from .parallel.distributed import spawn_ranks
    from .parallel.sharding import make_mesh, require_device

    dev = require_device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        devices = [torch.device("cuda", i % count) for i in range(n_devices)]
    else:
        devices = [dev] * n_devices
    band = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh = make_mesh(devices, band=band)
    jobs = synth_jobs(2 * mesh.shape["blocks"] * band, m_lo=20, m_hi=30,
                      radius=8, seed=3)
    bad = count_unequal(jobs, yama_batch(jobs, mesh=mesh))
    if bad:
        raise AssertionError(f"dryrun: {bad} sharded full-row results "
                             "differ from yama_numpy")
    print(f"dryrun_multichip ok: mesh={mesh.shape} on "
          f"{sorted({str(d) for d in devices})} jobs={len(jobs)} bit-equal "
          "to yama_numpy", flush=True)

    pjobs = packed_dryrun_jobs(n_devices)
    cws = {route_band(np.asarray(LB), np.asarray(RB), A.shape[0],
                      B.shape[0])[0] for A, B, LB, RB in pjobs}
    if 512 not in cws:
        raise AssertionError(f"dryrun workload lost its 512-lane shapes: {cws}")
    ranks = spawn_ranks(_dryrun_rank, n_devices, args=(n_devices, dev.type),
                        timeout=timeout)
    for rank, rdev, njobs, nbad, n_dp, n_tb in ranks:
        if nbad or njobs != len(pjobs):
            raise AssertionError(f"dryrun rank {rank} on {rdev}: {nbad} of "
                                 f"{njobs} packed results differ")
        # the counts move only where a kernel launches: on a card
        if dev.type == "cuda" and (n_dp <= 0 or n_tb <= 0):
            raise AssertionError(f"dryrun rank {rank}: a kernel never ran")
    print(f"dryrun_multichip ok: packed DP over {n_devices} gloo ranks "
          f"({', '.join(r[1] for r in ranks)}), {len(pjobs)} jobs (window "
          f"ladder {sorted(c for c in cws if c)}) bit-equal to yama_numpy "
          "on every rank", flush=True)
    return ranks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m multiz_tpu_torch.entry")
    ap.add_argument("cmd", nargs="?", choices=["dryrun"])
    ap.add_argument("n", nargs="?", type=int, default=8,
                    help="ranks of the dryrun (default 8)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    a = ap.parse_args(argv)
    if a.cmd == "dryrun":
        dryrun_multichip(a.n, a.device)
        return 0
    fn, args = entry(a.device)
    out = fn(*args)
    print("entry ok:", [tuple(o.shape) for o in out], flush=True)
    return 0


if __name__ == "__main__":
    # run the imported module's main, so that the rank function pickles
    # by its import path rather than as __main__'s
    from multiz_tpu_torch.entry import main as _main

    sys.exit(_main())
