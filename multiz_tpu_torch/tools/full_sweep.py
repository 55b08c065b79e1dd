"""The full-row DP's kernels at the bench bucket over their launch
shapes, timed on one card in one run.

    python -m multiz_tpu_torch.tools.full_sweep [--reps K]

Stacks the bench workload's largest bucket (637 jobs at 1024 x 1024,
``tools/bench.bench_bucket``) on the card, then times the forward
(``ops/yama_full.yama_core``) on the warp path at 1, 2 and 4 problems a
block and on the block path, and the traceback (``traceback_core``) at
1, 2 and 4 walks a block: each one warm call, then the mean of ``K``
calls between CUDA events with the stream held (``tools.cuda_ms``).
Every variant's outputs must equal the planned launch's. Prints one JSON
line of milliseconds, the bounds beside them, then the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import card_label, cuda_ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m multiz_tpu_torch.tools.full_sweep")
    ap.add_argument("--reps", type=int, default=10)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("full_sweep: torch sees no CUDA device")
    from .. import scores as sc
    from ..ops import yama_full as F
    from ..ops import yama_pack as P
    from ..scores import from_score_params
    from .bench import bench_bucket

    jobs, _ = bench_bucket()
    m_pad, n_pad, *_ = P.bucket_of(jobs)
    host = F.stack_host(jobs, m_pad, n_pad)
    st = F.upload(host, "cuda")
    s = from_score_params(sc.init_scores70(), "cuda")
    call = (*(st[k] for k in F.STACK_KEYS), s.ss_cat, s.gap_open,
            s.gap_extend, m_pad, n_pad)
    bands = (host["LB"], host["RB"], host["M"], m_pad, n_pad)
    planned = F.full_plan(*bands)
    want = F.yama_core(*call, plan=planned)
    out = {"plan": planned._asdict()}
    B = len(jobs)
    plans = {f"warp_{pb}": planned._replace(per_block=pb, grid=-(-B // pb),
                                            threads=32 * pb)
             for pb in (1, 2, 4)}
    plans["block"] = F.full_plan(*bands, path="block")
    for name, plan in plans.items():
        got = F.yama_core(*call, plan=plan)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"full_sweep: forward {name} differs")
        out[f"dp_{name}_ms"] = cuda_ms(lambda: F.yama_core(*call, plan=plan),
                                       a.reps)
    tb_args = (want[0], st["LB"], st["RB"], st["M"], st["N"], *want[1:],
               m_pad, n_pad)
    script, nedit = F.traceback_core(*tb_args)
    planned_per_block = F.per_block_for
    try:
        for pb in (1, 2, 4):
            F.per_block_for = lambda B, pb=pb: pb
            got = F.traceback_core(*tb_args)
            if not (torch.equal(got[0], script) and torch.equal(got[1], nedit)):
                raise AssertionError(f"full_sweep: traceback at {pb} differs")
            out[f"tb_{pb}_ms"] = cuda_ms(lambda: F.traceback_core(*tb_args),
                                         a.reps)
    finally:
        F.per_block_for = planned_per_block
    out["dp_bound_ms"] = F.full_dp_bound(st, m_pad, n_pad)[0] * 1e3
    out["dp_chain_bound_ms"] = F.full_dp_chain_bound(st, m_pad, n_pad) * 1e3
    out["tb_bound_ms"] = F.full_tb_bound(nedit, st, m_pad, n_pad)[0] * 1e3
    out["tb_chain_bound_ms"] = F.full_tb_chain_bound(nedit) * 1e3
    print(json.dumps(out), flush=True)
    print(card_label(torch.device("cuda", 0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
