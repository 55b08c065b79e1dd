"""The full-row DP path (mode ``full``) of several checkouts of the port,
timed on one card in one run: smoke phase 8's two walls.

    python -m multiz_tpu_torch.tools.full_ab TREE [TREE ...] [--reps K]

This checkout stacks the bench workload's largest bucket (637 jobs at
1024 x 1024, ``tools/bench.bench_bucket``) with ``ops/yama_full.
stack_jobs`` and builds the realistic tba's dataset (``tools/
bench_pipeline.build_dataset``: 2 Mb x 5 species, seed 9) once. Each
TREE (the root of a checkout whose ``multiz_tpu_torch/ops/yama_full.py``
has ``_run_bucket`` and ``batch_fn_for``) then runs in a process of its
own, in the order given, so ``A B B A`` shows the drift between turns:

  * the bucket's forward and traceback (``_run_bucket`` on the card),
    then each kernel alone (``yama_core``, ``traceback_core``; a tree
    with ``full_plan`` is handed its plan, made on the host once): one
    warm call, then the mean of ``K`` calls between CUDA events,
    enqueued while a spin kernel holds the stream (``tools.cuda_ms``);
    a path of eager torch launches is timed with its host's enqueue;
  * ``tree.tba_run`` over the dataset with ``batch_fn_for("cuda")``, one
    run, its host wall in seconds.

Every tree must give the same scripts and the same MAF (one digest). One
JSON line per tree, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import torch

from . import run_trees

CHILD = r"""
import hashlib, json, sys, time
tree, path, reps = sys.argv[1], sys.argv[2], int(sys.argv[3])
HOLD_CYCLES = int(sys.argv[4])
sys.path.insert(0, tree)
#CUDA_MS#
import torch
from multiz_tpu_torch import scores as sc
from multiz_tpu_torch.maf import format_ali
from multiz_tpu_torch.multiz import MultizConfig
from multiz_tpu_torch.ops import yama_full as F
from multiz_tpu_torch.scores import from_score_params
from multiz_tpu_torch.tree import tba_run

saved = torch.load(path)
st = from_score_params(sc.init_scores70(), "cuda")
stacked = {k: v.cuda() for k, v in saved["stacked"].items()}
m_pad, n_pad = saved["m_pad"], saved["n_pad"]
kw = {}
if hasattr(F, "full_plan"):  # a tree that plans its forward on the host
    kw["plan"] = F.full_plan(*(saved["stacked"][k].numpy()
                               for k in ("LB", "RB", "M")), m_pad, n_pad)
h = hashlib.sha256()
scripts, nedits = F._run_bucket(stacked, st, m_pad, n_pad, **kw)
h.update(scripts.cpu().numpy().tobytes())
h.update(nedits.cpu().numpy().tobytes())
ms = cuda_ms(lambda: F._run_bucket(stacked, st, m_pad, n_pad, **kw), reps)
dp_call = (*(stacked[k] for k in F.STACK_KEYS), st.ss_cat, st.gap_open,
           st.gap_extend, m_pad, n_pad)
flags, *last = F.yama_core(*dp_call, **kw)
tb_args = (flags, stacked["LB"], stacked["RB"], stacked["M"], stacked["N"],
           *last, m_pad, n_pad)
dp_ms = cuda_ms(lambda: F.yama_core(*dp_call, **kw), reps)
tb_ms = cuda_ms(lambda: F.traceback_core(*tb_args), reps)
del stacked, scripts, nedits, flags, last, tb_args
torch.cuda.empty_cache()
t0 = time.perf_counter()
blocks = tba_run(saved["tree"], saved["pairs"], src_dir=saved["dir"],
                 cfg=MultizConfig(batch_fn=F.batch_fn_for("cuda")),
                 sp=sc.init_scores70())
wall = time.perf_counter() - t0
h.update("".join(format_ali(a) for a in blocks).encode())
print(json.dumps({"tree": tree, "bucket_ms": ms, "dp_ms": dp_ms,
                  "tb_ms": tb_ms, "tba_s": wall,
                  "blocks": len(blocks), "digest": h.hexdigest()}))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m multiz_tpu_torch.tools.full_ab")
    ap.add_argument("trees", nargs="+", help="checkout roots, in turn")
    ap.add_argument("--reps", type=int, default=3)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("full_ab: torch sees no CUDA device")
    from ..ops import yama_full as F
    from ..ops import yama_pack as P
    from .bench import bench_bucket
    from .bench_pipeline import build_dataset

    jobs, _ = bench_bucket()
    m_pad, n_pad, *_ = P.bucket_of(jobs)
    with tempfile.TemporaryDirectory() as d:
        tree, pairs = build_dataset(d, 2_000_000, 5)
        path = os.path.join(d, "full_ab.pt")
        torch.save({"stacked": F.stack_jobs(jobs, m_pad, n_pad),
                    "m_pad": m_pad, "n_pad": n_pad, "tree": tree,
                    "pairs": list(pairs), "dir": d}, path)
        run_trees(CHILD, a.trees, path, a.reps, "full_ab")
    from . import card_label

    print(card_label(torch.device("cuda", 0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
