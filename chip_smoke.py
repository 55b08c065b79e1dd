#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (multiz_tpu_torch) on one GPU.

Run it from the root of a checkout: ``python3 chip_smoke.py``. It needs
one CUDA device and nvcc on PATH; without either it exits nonzero and
prints no result. Phases 1-13 force every DP job onto the device
(MZ_HOST_JOB_CELLS=0, MZ_HOST_ROUTE_CELLS=0), so that each of them
proves the kernels whatever the routing; phase 14 runs the tba as a user
does, at the port's default routing.

Phases, in order (any failure exits nonzero):
  1. device check, and the card's name and power limit;
  2. build of the CUDA kernels from csrc/ (with ptxas' register report);
  3. each kernel (the device prep, the DP, the traceback) against its
     plain PyTorch version on the card, bit for bit (the prep's astat and
     bstat over every element), every replayed payload equal to the
     port's yama_numpy: the
     ladder of window widths (1 to 701 lanes: both paths of the DP
     kernel, the warp path up to 128 lanes and the block path beyond,
     M = 0 problems, LB jumps wider than 32 lanes), buckets that leave a
     partial block, window widths 256/512/1024, mixed sizes, odd shapes
     (1 column, 13 rows a side), and the bench workload's largest bucket,
     where the three kernels are timed beside their plain versions and
     their bounds (ops/prep.prep_bound, ops/yama_dp.dp_bound,
     ops/yama_tb.tb_bound) and their chain bounds (prep_chain_bound,
     dp_chain_bound, tb_chain_bound: the longest chain of dependent
     steps); each case logs the prep's path (ops/prep.prep_plan). Then
     the full-row DP's two kernels (csrc/yama_full.cu: yama_core and
     traceback_core of ops/yama_full.py) against their plain versions
     (yama_core_reference, traceback_reference), bit for bit over every
     flag, the last cells, the scripts and nedit, every valid job's
     replay equal to yama_numpy, the forward on both of its paths (the
     block path on every job, the warp path on the jobs it takes; each
     line names the path, its lanes a thread and the window), the
     traceback after each: the pad ladder 16, 32, 256, 1024, 2048
     (tools/kernel_cases.full_ladder_jobs: M = 0 problems, a one-column
     B, 8 rows a side, LB jumps), one problem of 9000 columns (n_pad
     16384), the odd shapes of kernel_cases.edge_jobs, and the bench
     bucket, where the forward (its planned warp path, and the block
     path) and the traceback are timed beside their plain versions,
     full_dp_bound/full_tb_bound and
     full_dp_chain_bound/full_tb_chain_bound;
  4. the bench workload (1024 synthetic jobs) through yama_batch_packed
     (multiz_tpu_torch.tools.bench), every result equal to the port's
     yama.yama_numpy, every job on the device, both kernels launched;
  5. the multiz v0/v1, tba4 and roast4 goldens, byte-equal;
  6. a simulated 2 Mb, 5-species tba (ENCODE-pilot-region size), its
     output byte-equal to the inline host run;
  7. the kernels' launch counts over phase 6, each > 0, the prep's equal
     to the DP's (one of each per bucket);
  8. the full-row DP path (ops/yama_full.py, its two kernels) on the
     card: the bench workload equal to yama_numpy, the goldens and phase
     6's tba (same dataset) under MULTIZ_TPU_TORCH_DEVICE=full,
     byte-equal, every bucket on the card launching both kernels once,
     the forward's launches counted by path; each bucket's (B, m_pad,
     n_pad, path) logged, and every bucket of the bench workload and of
     the tba must take the warp path; then both kernels at each of the
     tba's buckets, their CUDA-event times summed beside their bounds
     and chain bounds summed; the device time of the bench's largest
     bucket (both kernels) beside the plain versions' (phase 3) and the
     packed path's on the same jobs (CUDA events);
  9. the multi-process packed DP: the bench workload through
     distributed_yama_batch_packed over 2 gloo ranks sharing the card
     (one rank per card where there are several), every rank's full
     result list equal to yama_numpy and both kernels launched in every
     rank; then entry.dryrun_multichip(2). A rank that fails or does not
     finish in time fails the smoke;
 10. the band mesh axis: the bench's largest bucket through the full-row
     yama_batch on a band-2 mesh (cuda:0 and cuda:1, or cuda:0 twice),
     every result equal to the packed path's, and its device time
     beside phase 8's band=1 time (CUDA events), its scripts (the
     torch-op column-sharded forward, then the traceback kernel) equal
     to phase 8's (both kernels); entry.dryrun_multichip(4)
     on the JAX dryrun's 2x2 mesh; one stage profile of the packed path
     (multiz_tpu_torch.tools.profile_pack, bench workload, its BEST
     line); one width (96 jobs) of multiz_tpu_torch.tools.scaling_proxy.
     The profile and the proxy's ranks must launch both kernels;
 11. the port is self-contained: its own native host runtime
     (multiz_tpu_torch._mzcore, the host lane and replay_into of the
     measured path) is loaded, and no module of jax or of the JAX package
     (multiz_tpu) was imported by any phase (it runs last, after 13);
 12. the TBA workflow from FASTA files (multiz_tpu_torch/tools/
     fasta_pipeline.py) on a 2 Mb, 5-species dataset of its own: all_bz
     in execute mode (blastzWrapper, lav2maf, maf_sort, single_cov2),
     with a stand-in lastz that prints the lav maf2lav made from the
     simulator's pairwise MAFs (lastz is external), then the tba and
     roast (E=human) CLIs over the .sing.maf files it wrote, on the card
     and inline on the host: byte-equal, both kernels launched, every
     stage's wall logged;
 13. tba_run(parallel=4) on the card over phase 6's dataset (concurrent
     merges whose DP jobs pool into shared batches, tree.SharedBatch):
     byte-equal to phase 6's inline run, both kernels launched;
 14. the tba CLIs' own path at the defaults: tba_run over phase 6's
     dataset with ops.dispatch.default_batch_fn(), MULTIZ_TPU_TORCH_DEVICE
     and every routing variable (MZ_HOST_JOB_CELLS, MZ_HOST_ROUTE_CELLS,
     MZ_FLUSH_CELLS, MZ_HOST_LANE_CELLS) unset for this phase alone:
     byte-equal to phase 6's inline run, both kernels launched; its wall
     beside phase 6's. Every launch's wire buffer is kept (a clone, taken
     by a wrapper of yama_pack.device_batch for this phase alone); after
     the run the prep kernel runs at each: bit-equal to its plain version,
     its CUDA-event time beside prep_bound and prep_chain_bound, one line
     a launch and one of sums (and whether the shapes are
     tools/kernel_cases.REAL_LAUNCHES).

The kernels line counts the packed stream's kernels' launches over the
realistic phases (6, 12, 13 and 14), every count read right after its
own run; over them the prep's count must be > 0 and equal to the DP's, as it
must in each rank of phase 9, the profile and the scaling proxy of phase
10. The line before last is {"kernels": [...]} (yama_dp, yama_tb,
yama_prep, yama_full_dp, yama_full_tb; their chain bounds are in phase
3's "# kernels ... times" and "# full kernels ... times" lines). The
full-row kernels' launches there are phase 8's (the bench, the goldens
and the tba under mode full), where they must be > 0 and equal, one of
each per bucket. The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import sys
import tempfile
import time
import traceback as tb_mod

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")
DATA = os.path.join(GOLDEN, "data")
EXPECT = os.path.join(GOLDEN, "expect")
TREE4 = "(((human chimp) mouse) rat)"
PAIRS4 = ["human.chimp.sing.maf", "human.mouse.sing.maf", "human.rat.sing.maf"]

# the realistic runs: bench_pipeline.py's dataset at MZ_PIPE_REFLEN=2000000,
# MZ_PIPE_SPECIES=5 (multiz_tpu_torch/tools/bench_pipeline.py)
SIM_REFLEN = 2_000_000
SIM_NSPECIES = 5
# the bench workload: bench.py's 1024 synthetic jobs
# (multiz_tpu_torch/tools/bench.py)
BENCH_N = 1024
def log(msg: str) -> None:
    print(msg, flush=True)


def block_lines(text: str):
    return [l for l in text.split("\n") if l and not l.startswith("#")]


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False)")
    from multiz_tpu_torch.tools import card_label

    smi = card_label(torch.device("cuda", 0))
    log(f"# device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}"
        f", CUDA {torch.version.cuda}")
    return smi


def phase_build():
    from multiz_tpu_torch import _build

    out = _build.build(force=True, extra_flags=("-Xptxas", "-v"))
    for line in out.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"# ptxas: {line.strip()}")
    _build.load()
    log(f"# build: {_build.build_seconds:.2f} s")


def _kernel_case(name, jobs, cw_want, timing=False, fw=None):
    """Kernel vs plain version on the card for one launch of ``jobs``, in
    a window of ``fw`` lanes (default: the bucket's widest band)."""
    import numpy as np
    import torch

    from multiz_tpu_torch import scores as sc
    from multiz_tpu_torch import yama as Y
    from multiz_tpu_torch.ops import yama_pack as P
    from multiz_tpu_torch.ops.prep import (
        decode_wire, prep, prep_bound, prep_chain_bound, prep_plan,
        prep_reference,
    )
    from multiz_tpu_torch.ops.yama_dp import (
        dp_bound, dp_chain_bound, dp_forward, dp_forward_reference,
        dp_plan,
    )
    from multiz_tpu_torch.ops.yama_tb import (
        payload_width, tb_bound, tb_chain_bound, traceback,
        traceback_reference,
    )
    from multiz_tpu_torch.scores import from_score_params
    from multiz_tpu_torch.tools import cuda_ms

    for A, B, LB, RB in jobs:
        cw = P.route_band(np.asarray(LB), np.asarray(RB), A.shape[0],
                          B.shape[0])[0]
        if cw_want is not None and cw != cw_want:
            raise AssertionError(f"{name}: job window {cw} != {cw_want}")
    m_pad, n_pad, Kp, Lp, need = P.bucket_of(jobs)
    fw = need if fw is None else fw
    if need > fw:
        raise AssertionError(f"{name}: band of {need} lanes in {fw}")
    st = from_score_params(sc.init_scores70(), "cuda")
    nb = len(jobs)
    buf = P.pack_wire(jobs, m_pad, n_pad, Kp, Lp).cuda()
    wire = decode_wire(buf, nb, m_pad, n_pad, Kp, Lp)
    ops = prep(*wire, st)
    ops_p = prep_reference(*wire, st)
    go, ge = st.gap_open, st.gap_extend
    pw = payload_width(m_pad, n_pad)

    flags, last = dp_forward(ops, go, ge, fw)
    flags_p, last_p = dp_forward_reference(ops, go, ge, fw)
    pay = traceback(flags, ops.lb, ops.mnkl, last, pw)
    pay_p = traceback_reference(flags, ops.lb, ops.mnkl, last, pw)
    torch.cuda.synchronize()
    err_prep = max(
        int((ops.astat.long() - ops_p.astat.long()).abs().max()),
        int((ops.bstat.long() - ops_p.bstat.long()).abs().max()),
    )
    err_dp = max(
        int((flags.long() - flags_p.long()).abs().max()),
        int((last.long() - last_p.long()).abs().max()),
    )
    err_tb = int((pay.long() - pay_p.long()).abs().max())
    # the kernels' payload replays to the oracle's merged alignment (jobs
    # the oracle refuses, the one-column bands of the 1-lane window, are
    # held to the plain versions only)
    want = {}
    for i, (A, B, LB, RB) in enumerate(jobs):
        try:
            want[i] = Y.yama_numpy(A, B, LB, RB)
        except Y.YamaError:
            pass
    valid = sorted(want)
    results = {}
    P._replay_payload_slots(pay.cpu().numpy()[valid], valid,
                            {i: jobs[i] for i in valid}, results)
    for i in valid:
        if not np.array_equal(results[i], want[i]):
            raise AssertionError(f"{name}: job {i} differs from yama_numpy")
    plan = dp_plan(fw, nb)
    pplan = prep_plan(nb, m_pad, n_pad)
    log(f"# kernels {name}: {nb} problems, m_pad {m_pad}, {fw} lanes, "
        f"cw {cw_want}, DP {plan.path} path ({plan.per_thread} lanes a "
        f"thread, {plan.per_block} problems a block), prep {pplan.path} "
        f"path ({pplan.cpl} columns a lane, {pplan.warps} warps a block, "
        f"clusters of {pplan.cluster}): prep err "
        f"{err_prep}, dp err {err_dp}, tb err {err_tb}; {len(valid)} "
        "replays equal to yama_numpy")
    if err_prep or err_dp or err_tb:
        raise AssertionError(f"{name}: kernel differs from its plain version")
    t = None
    if timing:
        dp_b, dp_by = dp_bound(ops, fw)
        tb_b, tb_by = tb_bound(pay, ops.mnkl)
        prep_b, prep_by = prep_bound(wire[0], wire[1], wire[4])
        t = {
            "prep_ms": cuda_ms(lambda: prep(*wire, st), 20),
            "prep_plain_ms": cuda_ms(lambda: prep_reference(*wire, st), 5),
            "prep_bound_ms": prep_b * 1e3, "prep_bound_by": prep_by,
            "dp_ms": cuda_ms(lambda: dp_forward(ops, go, ge, fw), 20),
            "dp_plain_ms": cuda_ms(
                lambda: dp_forward_reference(ops, go, ge, fw), 1),
            "dp_bound_ms": dp_b * 1e3, "dp_bound_by": dp_by,
            "tb_ms": cuda_ms(
                lambda: traceback(flags, ops.lb, ops.mnkl, last, pw), 20),
            "tb_plain_ms": cuda_ms(
                lambda: traceback_reference(flags, ops.lb, ops.mnkl, last,
                                            pw), 1),
            "tb_bound_ms": tb_b * 1e3, "tb_bound_by": tb_by,
            "dp_chain_bound_ms": dp_chain_bound(ops, fw) * 1e3,
            "tb_chain_bound_ms": tb_chain_bound(pay) * 1e3,
            "prep_chain_bound_ms": prep_chain_bound(wire[0], wire[1],
                                                    wire[4]) * 1e3,
        }
        log(f"# kernels {name} times (ms): " + json.dumps(t))
    return err_prep, err_dp, err_tb, t


def bench_bucket():
    """The bench workload's largest bucket, as the stream would launch
    it: (jobs, window width)."""
    from multiz_tpu_torch.tools.bench import bench_bucket as bucket

    return bucket(BENCH_N)


def _full_case(name, jobs, timing=False):
    """The full-row kernels against their plain versions on the card for
    one bucket of ``jobs`` at its pads, the forward on both paths: the
    block path on every job, the warp path on the jobs it takes (all of
    them where the bucket is eligible); the traceback after each. Returns
    (dp err, tb err, times or None)."""
    import numpy as np
    import torch

    from multiz_tpu_torch import scores as sc
    from multiz_tpu_torch import yama as Y
    from multiz_tpu_torch.ops import yama_full as F
    from multiz_tpu_torch.ops.yama_pack import _pad_to, replay_script
    from multiz_tpu_torch.scores import from_score_params
    from multiz_tpu_torch.tools import cuda_ms
    from multiz_tpu_torch.tools.kernel_cases import full_warp_jobs

    m_pad = _pad_to(max(A.shape[0] for A, *_ in jobs))
    n_pad = _pad_to(max(B.shape[0] for _, B, *_ in jobs))
    st = from_score_params(sc.init_scores70(), "cuda")
    err_dp = err_tb = 0
    t = None
    for path in ("warp", "block"):
        pjobs = jobs if path == "block" else full_warp_jobs(jobs, m_pad,
                                                            n_pad)
        if not pjobs:
            log(f"# full kernels {name}: no job the warp path takes")
            continue
        host = F.stack_host(pjobs, m_pad, n_pad)
        plan = F.full_plan(host["LB"], host["RB"], host["M"], m_pad, n_pad,
                           path=path)
        stacked = F.upload(host, "cuda")
        args = [stacked[k] for k in F.STACK_KEYS]
        tb_args = [stacked[k] for k in ("LB", "RB", "M", "N")]
        dp_call = (*args, st.ss_cat, st.gap_open, st.gap_extend, m_pad,
                   n_pad)
        got = F.yama_core(*dp_call, plan=plan)
        ref = F.yama_core_reference(*dp_call)
        script, nedit = F.traceback_core(got[0], *tb_args, *got[1:], m_pad,
                                         n_pad)
        rscript, rnedit = F.traceback_reference(got[0], *tb_args, *got[1:],
                                                m_pad, n_pad)
        torch.cuda.synchronize()
        e_dp = max(int((g.long() - r.long()).abs().max()) if g.numel() else 0
                   for g, r in zip(got, ref))
        e_tb = max(int((script.long() - rscript.long()).abs().max()),
                   int((nedit.long() - rnedit.long()).abs().max()))
        sn, nn = script.cpu().numpy(), nedit.cpu().numpy()
        nvalid = 0
        for i, (A, B, LB, RB) in enumerate(pjobs):
            try:
                want = Y.yama_numpy(A, B, LB, RB)
            except Y.YamaError:
                continue
            nvalid += 1
            if not np.array_equal(replay_script(sn[i], int(nn[i]), A, B),
                                  want):
                raise AssertionError(f"full {name} ({path}): job {i} differs "
                                     "from yama_numpy")
        log(f"# full kernels {name} ({path} path, {plan.per_thread} lanes a "
            f"thread, window {plan.window}): {len(pjobs)} of {len(jobs)} "
            f"problems at {m_pad}x{n_pad}: dp err {e_dp}, tb err {e_tb}; "
            f"{nvalid} replays equal to yama_numpy")
        if e_dp or e_tb:
            raise AssertionError(f"full {name} ({path}): a kernel differs from "
                                 "its plain version")
        err_dp, err_tb = max(err_dp, e_dp), max(err_tb, e_tb)
        if timing and path == "warp":
            dp_b, dp_by = F.full_dp_bound(stacked, m_pad, n_pad)
            tb_b, tb_by = F.full_tb_bound(nedit, stacked, m_pad, n_pad)
            # the plain versions ran once above; each takes seconds
            t = {
                "full_dp_path": plan.path, "full_dp_per_thread": plan.per_thread,
                "full_dp_per_block": plan.per_block,
                "full_dp_ms": cuda_ms(lambda: F.yama_core(*dp_call, plan=plan),
                                      10),
                "full_dp_plain_ms": cuda_ms(
                    lambda: F.yama_core_reference(*dp_call), 1, warm=False),
                "full_dp_bound_ms": dp_b * 1e3, "full_dp_bound_by": dp_by,
                "full_dp_chain_bound_ms": F.full_dp_chain_bound(
                    stacked, m_pad, n_pad) * 1e3,
                "full_tb_ms": cuda_ms(lambda: F.traceback_core(
                    got[0], *tb_args, *got[1:], m_pad, n_pad), 10),
                "full_tb_plain_ms": cuda_ms(lambda: F.traceback_reference(
                    got[0], *tb_args, *got[1:], m_pad, n_pad), 1, warm=False),
                "full_tb_bound_ms": tb_b * 1e3, "full_tb_bound_by": tb_by,
                "full_tb_chain_bound_ms": F.full_tb_chain_bound(nedit) * 1e3,
            }
        if timing and path == "block":
            block = F.full_plan(host["LB"], host["RB"], host["M"], m_pad,
                                n_pad, path="block")
            t["full_dp_block_path_ms"] = cuda_ms(
                lambda: F.yama_core(*dp_call, plan=block), 10)
            log(f"# full kernels {name} times (ms): " + json.dumps(t))
        del got, ref, script, rscript
        torch.cuda.empty_cache()
    return err_dp, err_tb, t


def phase_kernels():
    from multiz_tpu_torch.ops.synth import synth_jobs
    from multiz_tpu_torch.tools.kernel_cases import (
        FULL_PAD_LADDER, FW_LADDER, edge_jobs, full_ladder_jobs,
        full_wide_jobs, ladder_jobs, ragged_jobs,
    )

    ladder = [(f"ladder_fw{fw}", ladder_jobs(fw), None, fw)
              for fw in FW_LADDER]
    ragged = [(f"ragged_{n}", ragged_jobs(n), 256, 61) for n in (265, 531)]
    cases = ladder + ragged + [
        ("edge_shapes", edge_jobs(), None),
        ("cw256_mixed_96", synth_jobs(96, m_lo=40, m_hi=900, radius=30,
                                      seed=1), 256),
        ("cw512", synth_jobs(12, m_lo=300, m_hi=500, radius=150, seed=2),
         512),
        ("cw1024", synth_jobs(6, m_lo=720, m_hi=900, radius=350, seed=3),
         1024),
    ]
    bjobs, cw = bench_bucket()
    cases.append((f"bench_bucket_{len(bjobs)}", bjobs, cw))
    errs = [0, 0, 0, 0, 0]  # prep, dp, tb, full dp, full tb
    times = {}
    for name, jobs, cw, *fw in cases:
        *e, t = _kernel_case(name, jobs, cw, timing=name.startswith("bench"),
                             fw=fw[0] if fw else None)
        errs[:3] = [max(a, b) for a, b in zip(errs, e)]
        times.update(t or {})
    full = ([(f"pad{p}", full_ladder_jobs(p)) for p in FULL_PAD_LADDER]
            + [("wide", full_wide_jobs()), ("edge_shapes", edge_jobs()),
               (f"bench_bucket_{len(bjobs)}", bjobs)])
    for name, fjobs in full:
        *e, t = _full_case(name, fjobs, timing=name.startswith("bench"))
        errs[3:] = [max(a, b) for a, b in zip(errs[3:], e)]
        times.update(t or {})
    return errs, times


def phase_bench():
    from multiz_tpu_torch.tools import bench

    line = bench.measure("cuda", jobs=bench.bench_jobs(BENCH_N))
    log(f"# bench: {BENCH_N} jobs equal to yama_numpy, every one on the "
        f"device (tools/bench.py, best of {bench.ITERS}): {json.dumps(line)}")


def phase_goldens(mode="packed"):
    """The goldens with MULTIZ_TPU_TORCH_DEVICE=``mode`` (roast4 through
    the library with that mode's batch function)."""
    from multiz_tpu_torch import scores as sc
    from multiz_tpu_torch.maf import format_ali
    from multiz_tpu_torch.multiz import MultizConfig
    from multiz_tpu_torch.tree import roast_run
    from multiz_tpu_torch.cli import multiz as mz_cli
    from multiz_tpu_torch.cli import tba as tba_cli
    from multiz_tpu_torch.ops import yama_full as F
    from multiz_tpu_torch.ops import yama_pack as P

    def expect(name):
        with open(os.path.join(EXPECT, name)) as fh:
            return fh.read()

    os.environ["MULTIZ_TPU_TORCH_DEVICE"] = mode
    P.reset_route_stats()
    for v in (1, 0):
        out = io.StringIO()
        mz_cli.main([os.path.join(DATA, "human.chimp.sing.maf"),
                     os.path.join(DATA, "human.mouse.sing.maf"), str(v)],
                    out=out)
        got = [l for l in out.getvalue().split("\n")
               if not l.startswith("# multiz.v")]
        want = [l for l in expect(f"multiz_v{v}.maf").split("\n")
                if not l.startswith("# multiz.v")]
        if got != want:
            raise AssertionError(f"{mode}: multiz v{v} differs from its golden")
        log(f"# golden {mode} multiz_v{v}: byte-equal")
    with tempfile.TemporaryDirectory() as d:
        dest = os.path.join(d, "tba4.maf")
        cwd = os.getcwd()
        os.chdir(DATA)
        try:
            tba_cli.main([TREE4, *PAIRS4, dest])
        finally:
            os.chdir(cwd)
        with open(dest) as fh:
            if block_lines(fh.read()) != block_lines(expect("tba4.maf")):
                raise AssertionError(f"{mode}: tba4 differs from its golden")
    log(f"# golden {mode} tba4: byte-equal (ignoring '#' lines)")
    batch_fn = (P.batch_fn_for("cuda") if mode == "packed"
                else F.batch_fn_for("cuda"))
    blocks = roast_run("human", TREE4, PAIRS4, src_dir=DATA,
                       cfg=MultizConfig(batch_fn=batch_fn),
                       sp=sc.init_scores70())
    if (block_lines("".join(format_ali(a) for a in blocks))
            != block_lines(expect("roast4.maf"))):
        raise AssertionError(f"{mode}: roast4 differs from its golden")
    log(f"# golden {mode} roast4: byte-equal (ignoring '#' lines)")
    if mode == "packed":
        if P.route_stats["device_jobs"] == 0:
            raise AssertionError("goldens: no DP job ran on the device")
        log(f"# goldens routes {json.dumps(P.route_stats)}")


def build_realistic(d):
    """The realistic run's dataset in directory ``d``: (tree, pairs)."""
    from multiz_tpu_torch.tools.bench_pipeline import build_dataset

    t0 = time.perf_counter()
    tree, pairs = build_dataset(d, SIM_REFLEN, SIM_NSPECIES)
    log(f"# realistic: dataset {SIM_REFLEN} bp x {SIM_NSPECIES} species "
        f"built in {time.perf_counter() - t0:.2f} s")
    return tree, pairs


def run_tba(sim, batch_fn, parallel=None):
    """tba over the realistic dataset: (MAF text, blocks, seconds)."""
    from multiz_tpu_torch import scores as sc
    from multiz_tpu_torch.maf import format_ali
    from multiz_tpu_torch.multiz import MultizConfig
    from multiz_tpu_torch.tree import tba_run

    tree, pairs, d = sim
    t0 = time.perf_counter()
    blocks = tba_run(tree, pairs, src_dir=d,
                     cfg=MultizConfig(batch_fn=batch_fn),
                     sp=sc.init_scores70(), parallel=parallel)
    dt = time.perf_counter() - t0
    return "".join(format_ali(a) for a in blocks), len(blocks), dt


def _launched(counters, fn):
    """Run ``fn()`` with every kernel's count set to 0 just before it;
    returns (its value, the counts read just after)."""
    for c in counters:
        c.launches = 0
    out = fn()
    return out, [c.launches for c in counters]


def phase_realistic(sim, counters):
    from multiz_tpu_torch.ops import yama_pack as P

    want, nblocks, t_inline = run_tba(sim, None)
    P.reset_route_stats()
    (got, _, t_dev), launches = _launched(
        counters, lambda: run_tba(sim, P.batch_fn_for("cuda")))
    stats = dict(P.route_stats)
    if got != want:
        raise AssertionError("realistic tba: device output differs from the "
                             "inline host run")
    log(f"# realistic tba: {nblocks} blocks byte-equal; inline {t_inline:.3f} s"
        f", forced-device {t_dev:.3f} s; routes {json.dumps(stats)}")
    if stats["host_jobs"]:
        raise AssertionError(f"realistic tba: jobs left on the host: {stats}")
    return launches, t_inline, t_dev, want


@contextlib.contextmanager
def full_buckets(keep=False):
    """Records every full-row bucket run inside: its device type (in
    ``seen["devices"]``) and (B, m_pad, n_pad, forward path) (in
    ``seen["buckets"]``), and with ``keep`` a clone of its operands and its
    plan (in ``seen["kept"]``); and the full-row kernels' launches, counted
    from 0 on entry (``seen["launches"]``, [yama_full_dp, yama_full_tb],
    and ``seen["paths"]``, the forward's by path, read on exit). On exit,
    raises unless every bucket ran on the card and launched each kernel
    once, on the path of its plan."""
    from multiz_tpu_torch.ops import yama_full as F

    run = F._run_bucket
    seen = {"devices": [], "buckets": [], "kept": [], "launches": None,
            "paths": None}
    counters = (F.yama_core, F.traceback_core)

    def counted(stacked, st, m_pad, n_pad, plan=None):
        seen["devices"].append(stacked["M"].device.type)
        seen["buckets"].append((int(stacked["M"].shape[0]), m_pad, n_pad,
                                plan.path if plan else None))
        if keep:
            seen["kept"].append(({k: v.clone() for k, v in stacked.items()},
                                 plan, m_pad, n_pad))
        return run(stacked, st, m_pad, n_pad, plan)

    for c in counters:
        c.launches = 0
    F.yama_core.paths = dict.fromkeys(F.yama_core.paths, 0)
    F._run_bucket = counted
    try:
        yield seen
    finally:
        F._run_bucket = run
        seen["launches"] = [c.launches for c in counters]
        seen["paths"] = dict(F.yama_core.paths)
    n = len(seen["devices"])
    by_path = {p: sum(b[3] == p for b in seen["buckets"])
               for p in seen["paths"]}
    if (not n or set(seen["devices"]) != {"cuda"}
            or seen["launches"] != [n, n] or seen["paths"] != by_path):
        raise AssertionError(f"full-row buckets: ran on {seen['devices']}, "
                             f"kernel launches {seen['launches']}, by path "
                             f"{seen['paths']} for plans {by_path}")


def _all_warp(seen, what):
    """Raise unless every bucket of ``seen`` took the warp path."""
    off = [b for b in seen["buckets"] if b[3] != "warp"]
    if off:
        raise AssertionError(f"{what}: buckets off the warp path: {off}")


def hold_full_buckets(kept):
    """Both full-row kernels at each bucket kept from the full-mode tba:
    their CUDA-event times summed beside their bounds and chain bounds
    summed (the scripts of each launch already made the tba's output)."""
    import torch

    from multiz_tpu_torch import scores as sc
    from multiz_tpu_torch.ops import yama_full as F
    from multiz_tpu_torch.scores import from_score_params
    from multiz_tpu_torch.tools import cuda_ms

    st = from_score_params(sc.init_scores70(), "cuda")
    sums = {"buckets": len(kept), "problems": 0, "dp_ms": 0.0,
            "dp_bound_ms": 0.0, "dp_chain_bound_ms": 0.0, "tb_ms": 0.0,
            "tb_bound_ms": 0.0, "tb_chain_bound_ms": 0.0}
    for stacked, plan, m_pad, n_pad in kept:
        call = (*(stacked[k] for k in F.STACK_KEYS), st.ss_cat, st.gap_open,
                st.gap_extend, m_pad, n_pad)
        flags, *last = F.yama_core(*call, plan=plan)
        tb_args = (flags, stacked["LB"], stacked["RB"], stacked["M"],
                   stacked["N"], *last, m_pad, n_pad)
        _, nedit = F.traceback_core(*tb_args)
        torch.cuda.synchronize()
        sums["problems"] += int(stacked["M"].shape[0])
        sums["dp_ms"] += cuda_ms(lambda: F.yama_core(*call, plan=plan), 10)
        sums["tb_ms"] += cuda_ms(lambda: F.traceback_core(*tb_args), 10)
        sums["dp_bound_ms"] += F.full_dp_bound(stacked, m_pad, n_pad)[0] * 1e3
        sums["dp_chain_bound_ms"] += F.full_dp_chain_bound(
            stacked, m_pad, n_pad) * 1e3
        sums["tb_bound_ms"] += F.full_tb_bound(nedit, stacked, m_pad,
                                               n_pad)[0] * 1e3
        sums["tb_chain_bound_ms"] += F.full_tb_chain_bound(nedit) * 1e3
        del flags, last, nedit
    log(f"# full realistic tba, both kernels at each of its buckets, sums: "
        f"{json.dumps(sums)}")


def phase_full(sim, want_tba, times):
    """Phase 8: the full-row path on the card; returns (its bench
    bucket's time, its scripts, its kernels' launches)."""
    import numpy as np
    import torch

    from multiz_tpu_torch import scores as sc
    from multiz_tpu_torch import yama as Y
    from multiz_tpu_torch.ops import yama_full as F
    from multiz_tpu_torch.ops import yama_pack as P
    from multiz_tpu_torch.scores import from_score_params
    from multiz_tpu_torch.tools import cuda_ms
    from multiz_tpu_torch.tools.bench import bench_jobs

    launches = [0, 0]
    jobs = bench_jobs(BENCH_N)
    with full_buckets() as seen:
        t0 = time.perf_counter()
        out = F.yama_batch(jobs, device="cuda")
        dt = time.perf_counter() - t0
    launches = [a + b for a, b in zip(launches, seen["launches"])]
    for i, ((A, B, LB, RB), got) in enumerate(zip(jobs, out)):
        if not np.array_equal(got, Y.yama_numpy(A, B, LB, RB)):
            raise AssertionError(f"full bench job {i} differs from yama_numpy")
    log(f"# full bench: {len(jobs)} jobs equal to yama_numpy in {dt:.4f} s "
        f"({len(seen['devices'])} buckets; kernel launches "
        f"{seen['launches']}, forward by path {json.dumps(seen['paths'])}; "
        f"buckets (B, m_pad, n_pad, path) {json.dumps(seen['buckets'])})")
    _all_warp(seen, "full bench")

    # device time of the packed path's largest bench bucket, both ways,
    # from operands already on the card: the full-row DP and traceback
    # kernels against prep and the packed kernels (the plain full-row
    # versions' time is phase 3's)
    bjobs, _ = bench_bucket()
    m_pad, n_pad, Kp, Lp, fw = P.bucket_of(bjobs)
    st = from_score_params(sc.init_scores70(), "cuda")
    host = F.stack_host(bjobs, m_pad, n_pad)
    plan = F.full_plan(host["LB"], host["RB"], host["M"], m_pad, n_pad)
    stacked = F.upload(host, "cuda")
    full_ms = cuda_ms(lambda: F._run_bucket(stacked, st, m_pad, n_pad, plan),
                      10)
    buf = P.pack_wire(bjobs, m_pad, n_pad, Kp, Lp).to("cuda")
    packed_ms = cuda_ms(lambda: P.device_batch(
        buf, len(bjobs), m_pad, n_pad, Kp, Lp, fw, st), 10)
    scripts, nedits = F._run_bucket(stacked, st, m_pad, n_pad, plan)
    payload = P.device_batch(buf, len(bjobs), m_pad, n_pad, Kp, Lp, fw, st)
    got_full = {}
    sn, nn = scripts.cpu().numpy(), nedits.cpu().numpy()
    for i, (A, B, _, _) in enumerate(bjobs):
        got_full[i] = P.replay_script(sn[i], int(nn[i]), A, B)
    got_packed = {}
    P._replay_payload_slots(payload.cpu().numpy(), list(range(len(bjobs))),
                            dict(enumerate(bjobs)), got_packed)
    for i in range(len(bjobs)):
        if not np.array_equal(got_full[i], got_packed[i]):
            raise AssertionError(f"bench bucket job {i}: full-row and packed "
                                 "results differ")
    plain_ms = times["full_dp_plain_ms"] + times["full_tb_plain_ms"]
    log(f"# full bench bucket: {len(bjobs)} jobs at {m_pad}x{n_pad}: "
        f"full-row kernels {full_ms:.3f} ms, their plain versions "
        f"{plain_ms:.3f} ms (phase 3), packed (prep + both kernels) "
        f"{packed_ms:.3f} ms (CUDA events); results equal")
    del stacked, scripts, payload
    torch.cuda.empty_cache()

    with full_buckets() as seen:
        phase_goldens("full")
    launches = [a + b for a, b in zip(launches, seen["launches"])]
    log(f"# full goldens: forward by path {json.dumps(seen['paths'])}")
    with full_buckets(keep=True) as seen:
        got, nblocks, t_full = run_tba(sim, F.batch_fn_for("cuda"))
    launches = [a + b for a, b in zip(launches, seen["launches"])]
    if got != want_tba:
        raise AssertionError("realistic tba: full-row output differs from the "
                             "inline host run")
    log(f"# full realistic tba: {nblocks} blocks byte-equal to the inline run "
        f"in {t_full:.3f} s ({len(seen['devices'])} buckets; kernel launches "
        f"{seen['launches']}, forward by path {json.dumps(seen['paths'])})")
    log(f"# full realistic tba buckets (B, m_pad, n_pad, path): "
        f"{json.dumps(seen['buckets'])}")
    _all_warp(seen, "full realistic tba")
    hold_full_buckets(seen["kept"])
    del seen
    log(f"# full-row kernels launched in phase 8: yama_full_dp "
        f"{launches[0]}, yama_full_tb {launches[1]}")
    return full_ms, (sn, nn), launches


def _bench_rank():
    """One rank of phase 9: (rank, device, unequal results, seconds, its
    kernel launches by name)."""
    import numpy as np
    import torch.distributed

    from multiz_tpu_torch import yama as Y
    from multiz_tpu_torch.parallel.distributed import (
        distributed_yama_batch_packed, rank_device,
    )
    from multiz_tpu_torch.tools import launches, reset_launches
    from multiz_tpu_torch.tools.bench import bench_jobs

    jobs = bench_jobs(BENCH_N)
    dev = rank_device()
    distributed_yama_batch_packed(jobs, device=dev)  # warm
    reset_launches()  # the main path starts
    t0 = time.perf_counter()
    out = distributed_yama_batch_packed(jobs, device=dev)
    dt = time.perf_counter() - t0
    counts = launches()
    bad = sum(not np.array_equal(got, Y.yama_numpy(*job))
              for job, got in zip(jobs, out)) + abs(len(out) - len(jobs))
    return torch.distributed.get_rank(), str(dev), bad, dt, counts


def phase_distributed():
    """Phase 9: the multi-process packed DP on the card."""
    import numpy as np
    import torch

    from multiz_tpu_torch import yama as Y
    from multiz_tpu_torch.entry import dryrun_multichip
    from multiz_tpu_torch.parallel.distributed import (
        distributed_yama_batch_packed, spawn_ranks,
    )
    from multiz_tpu_torch.tools import check_launches
    from multiz_tpu_torch.tools.bench import bench_jobs

    jobs = bench_jobs(BENCH_N)
    distributed_yama_batch_packed(jobs, device="cuda")  # warm
    t0 = time.perf_counter()
    out = distributed_yama_batch_packed(jobs, device="cuda")
    t_single = time.perf_counter() - t0
    for i, (job, got) in enumerate(zip(jobs, out)):
        if not np.array_equal(got, Y.yama_numpy(*job)):
            raise AssertionError(f"1-process packed job {i} differs")
    ncards = torch.cuda.device_count()
    nranks = ncards if ncards > 1 else 2
    t0 = time.perf_counter()
    ranks = spawn_ranks(_bench_rank, nranks, timeout=300)
    t_spawn = time.perf_counter() - t0
    for rank, dev, bad, dt, counts in ranks:
        log(f"# distributed rank {rank} on {dev}: {len(jobs)} jobs, {bad} "
            f"unequal, {dt:.4f} s, launches {json.dumps(counts)}")
        if bad:
            raise AssertionError(f"rank {rank}: results differ from yama_numpy")
        check_launches(counts, torch.device("cuda"), f"rank {rank}")
    log(f"# distributed bench: 1 process {t_single:.4f} s; {nranks} ranks "
        f"{max(r[3] for r in ranks):.4f} s (slowest rank; {t_spawn:.1f} s "
        f"with spawn and warm-up)")
    t0 = time.perf_counter()
    dryrun_multichip(2, "cuda", timeout=300)
    log(f"# dryrun_multichip(2) on the card: {time.perf_counter() - t0:.1f} s")
    return ranks


@contextlib.contextmanager
def band_rows():
    """Records the shards' device types of every column-sharded row
    run inside."""
    from multiz_tpu_torch.ops import yama_full as F

    core, seen = F.yama_core_cols, []

    def counted(shards, *args):
        seen.append([s["M"].device.type for s in shards])
        return core(shards, *args)

    F.yama_core_cols = counted
    try:
        yield seen
    finally:
        F.yama_core_cols = core


def phase_band(full_ms, full_scripts, counters):
    """Phase 10: the band mesh axis on the card, the 2x2 dryrun, the
    packed path's stage profile and its scaling proxy."""
    import numpy as np
    import torch

    from multiz_tpu_torch import scores as sc
    from multiz_tpu_torch.entry import dryrun_multichip
    from multiz_tpu_torch.ops import yama_full as F
    from multiz_tpu_torch.ops import yama_pack as P
    from multiz_tpu_torch.parallel.sharding import make_mesh, shard_stacked
    from multiz_tpu_torch.scores import from_score_params
    from multiz_tpu_torch.tools import (
        check_launches, cuda_ms, profile_pack, scaling_proxy,
    )

    # (a) the bench bucket through yama_batch on a band-2 mesh, every
    # result equal to the packed path's
    bjobs, _ = bench_bucket()
    second = "cuda:1" if torch.cuda.device_count() > 1 else "cuda:0"
    mesh = make_mesh(["cuda:0", second], band=2)
    want = P.yama_batch_packed(bjobs, device="cuda")
    with band_rows() as seen:
        t0 = time.perf_counter()
        got = F.yama_batch(bjobs, mesh=mesh)
        t_batch = time.perf_counter() - t0
    if not seen or any(row != ["cuda", "cuda"] for row in seen):
        raise AssertionError(f"band mesh: rows ran on {seen}")
    for i, (g, w) in enumerate(zip(got, want)):
        if not np.array_equal(g, w):
            raise AssertionError(f"band bench bucket job {i} differs from the "
                                 "packed path")
    # its CUDA-event time stacked as phase 8 stacks it (one bucket at
    # the stream's square padding); the scripts equal phase 8's
    m_pad, n_pad, *_ = P.bucket_of(bjobs)
    st = from_score_params(sc.init_scores70(), "cuda")
    (row,) = shard_stacked(F.stack_jobs(bjobs, m_pad, n_pad), mesh)
    out = []
    band_ms = cuda_ms(lambda: out.append(F._run_cols(row, st, m_pad, n_pad)),
                      1, warm=False)
    scripts, nedits = (t.cpu().numpy() for t in out[0])
    if not (np.array_equal(scripts, full_scripts[0])
            and np.array_equal(nedits, full_scripts[1])):
        raise AssertionError("band bench bucket: scripts differ from band=1's")
    del row, out
    torch.cuda.empty_cache()
    log(f"# band bench bucket: {len(bjobs)} jobs at {m_pad}x{n_pad} on mesh "
        f"{mesh.shape} over cuda:0, {second}: band=2 {band_ms:.3f} ms "
        f"(torch-op forward, traceback kernel), band=1 {full_ms:.3f} ms "
        f"(phase 8, both kernels), CUDA events; yama_batch over "
        f"the mesh {t_batch:.3f} s ({len(seen)} buckets), every result equal "
        "to the packed path")

    # (b) the JAX dryrun's 2x2 mesh
    t0 = time.perf_counter()
    dryrun_multichip(4, "cuda", timeout=300)
    t_dry = time.perf_counter() - t0
    log(f"# dryrun_multichip(4) on the card: {t_dry:.1f} s")

    # (c) the stage profile at the default NPROB; the kernels it runs
    for c in counters:
        c.launches = 0
    profile_pack.profile("cuda", out=lambda s: log(f"# profile: {s}"))
    launches = [c.launches for c in counters]
    log(f"# profile launches: yama_dp {launches[0]}, yama_tb "
        f"{launches[1]}, yama_prep {launches[2]}")
    check_launches(dict(zip(("yama_dp", "yama_tb", "yama_prep"), launches)),
                   torch.device("cuda"), "profile_pack")

    # (d) one width of the scaling proxy
    line = scaling_proxy.measure(96, "cuda", timeout=300)
    log(f"# scaling_proxy: {json.dumps(line)}")
    check_launches(line["launches"], torch.device("cuda"), "scaling_proxy")


def phase_fasta(counters):
    """Phase 12: the TBA workflow from FASTA files; returns the launches
    of its card runs, tba and roast summed."""
    from multiz_tpu_torch.ops import yama_pack as P
    from multiz_tpu_torch.tools import fasta_pipeline as FP
    from multiz_tpu_torch.tools.bench_pipeline import species_of

    log("# fasta: the pairwise aligner is a stand-in (lastz is external and "
        "not in the repository): a lastz script on PATH prints the lav that "
        "maf2lav made from the simulator's pairwise MAF of the pair")
    species, div = species_of(SIM_NSPECIES)
    tree = FP.tree_of(species)
    total = [0] * len(counters)
    with tempfile.TemporaryDirectory() as d:
        walls = FP.stage(d, SIM_REFLEN, species, div)
        walls.update(FP.all_bz(d, tree))
        pairs = FP.sing_files(d)
        log(f"# fasta: all_bz wrote {len(pairs)} pair files: {pairs}")
        for tool in ("tba", "roast"):
            want, walls[f"{tool}_inline"] = FP.run_cli(d, tool, tree, pairs,
                                                       "none")
            P.reset_route_stats()
            (got, walls[f"{tool}_card"]), launches = _launched(
                counters, lambda: FP.run_cli(d, tool, tree, pairs, "packed"))
            stats = dict(P.route_stats)
            nblocks = sum(1 for l in want.split(b"\n") if l[:1] == b"a")
            log(f"# fasta {tool}: {nblocks} blocks, card and inline outputs "
                f"{'byte-equal' if got == want else 'DIFFER'}; launches "
                f"yama_dp {launches[0]}, yama_tb {launches[1]}, yama_prep "
                f"{launches[2]}; routes "
                f"{json.dumps(stats)}")
            if got != want:
                raise AssertionError(f"fasta {tool}: the card's output differs "
                                     "from the inline run")
            if stats["host_jobs"] or min(launches) <= 0:
                raise AssertionError(f"fasta {tool}: jobs left on the host or "
                                     f"a kernel never launched: {stats}")
            total = [a + b for a, b in zip(total, launches)]
    log(f"# fasta stage walls (s): {json.dumps(walls)}")
    return total


def phase_parallel(sim, want_tba, t_inline, t_dev, counters):
    """Phase 13: tba_run(parallel=4) on the card over phase 6's dataset;
    returns its launches."""
    from multiz_tpu_torch.ops import yama_pack as P

    P.reset_route_stats()
    (got, nblocks, t_par), launches = _launched(
        counters, lambda: run_tba(sim, P.batch_fn_for("cuda"), parallel=4))
    stats = dict(P.route_stats)
    log(f"# parallel tba (parallel=4): {nblocks} blocks in {t_par:.3f} s; "
        f"phase 6: packed {t_dev:.3f} s, inline {t_inline:.3f} s; launches "
        f"yama_dp {launches[0]}, yama_tb {launches[1]}, yama_prep "
        f"{launches[2]}; routes "
        f"{json.dumps(stats)}")
    if got != want_tba:
        raise AssertionError("parallel tba: output differs from phase 6's "
                             "inline run")
    if stats["host_jobs"] or min(launches) <= 0:
        raise AssertionError(f"parallel tba: jobs left on the host or a "
                             f"kernel never launched: {stats}")
    return launches


@contextlib.contextmanager
def kept_launches():
    """While inside, every ``yama_pack.device_batch`` call keeps a clone
    of its wire buffer and its shape (problems, m_pad, n_pad, Kp, Lp) in
    the list it yields; the call itself is unchanged."""
    from multiz_tpu_torch.ops import yama_pack as P

    kept, real = [], P.device_batch

    def keep(buf, nb, m_pad, n_pad, Kp, Lp, fw, st):
        kept.append((buf.clone(), (nb, m_pad, n_pad, Kp, Lp)))
        return real(buf, nb, m_pad, n_pad, Kp, Lp, fw, st)

    P.device_batch = keep
    try:
        yield kept
    finally:
        P.device_batch = real


def hold_real_launches(kept):
    """The prep kernel at each launch kept from phase 14: bit-equal to its
    plain version, its CUDA-event time beside its bounds; one line per
    launch and one of sums."""
    import torch

    from multiz_tpu_torch import scores as sc
    from multiz_tpu_torch.ops.prep import (
        decode_wire, prep, prep_bound, prep_chain_bound, prep_plan,
        prep_reference,
    )
    from multiz_tpu_torch.scores import from_score_params
    from multiz_tpu_torch.tools import cuda_ms
    from multiz_tpu_torch.tools.kernel_cases import REAL_LAUNCHES

    st = from_score_params(sc.init_scores70(), "cuda")
    sums = {"launches": len(kept), "problems": 0, "ms": 0.0, "bound_ms": 0.0,
            "chain_ms": 0.0}
    shapes = []
    for i, (buf, shape) in enumerate(kept):
        wire = decode_wire(buf, *shape)
        ops, ref = prep(*wire, st), prep_reference(*wire, st)
        torch.cuda.synchronize()
        if not (torch.equal(ops.astat, ref.astat)
                and torch.equal(ops.bstat, ref.bstat)):
            raise AssertionError(f"phase 14 launch {i} {shape}: the prep "
                                 "kernel differs from its plain version")
        nb, m_pad, n_pad, Kp, Lp = shape
        row = {"problems": nb, "m_pad": m_pad, "Kp": Kp, "Lp": Lp,
               "path": prep_plan(nb, m_pad, n_pad).path,
               "ms": cuda_ms(lambda: prep(*wire, st), 20),
               "bound_ms": prep_bound(wire[0], wire[1], wire[4])[0] * 1e3,
               "chain_ms": prep_chain_bound(wire[0], wire[1], wire[4]) * 1e3}
        log(f"# real launch {i}: {json.dumps(row)}")
        shapes.append((nb, m_pad))
        for k in ("problems", "ms", "bound_ms", "chain_ms"):
            sums[k] += row[k]
    sums["as_kernel_cases"] = tuple(shapes) == REAL_LAUNCHES
    log(f"# real launches, prep bit-equal to its plain version at each; "
        f"sums: {json.dumps(sums)}")


def phase_default_routing(sim, want_tba, t_inline, t_dev, counters):
    """Phase 14: phase 6's dataset as the tba CLI runs it when a user sets
    nothing; returns its launches. Each launch's wire buffer is kept, and
    after the run the prep kernel is held to its plain version and timed
    at each (``hold_real_launches``)."""
    from multiz_tpu_torch.ops import yama_pack as P
    from multiz_tpu_torch.ops.dispatch import default_batch_fn
    from multiz_tpu_torch.tools import environ

    unset = dict.fromkeys(("MULTIZ_TPU_TORCH_DEVICE", *P.ROUTING_ENV.values()))
    with environ(**unset):
        routing = P.routing_defaults("cuda")
        P.reset_route_stats()
        with kept_launches() as kept:
            (got, nblocks, t_def), launches = _launched(
                counters, lambda: run_tba(sim, default_batch_fn()))
    stats = dict(P.route_stats)
    log(f"# default-routing tba: {nblocks} blocks in {t_def:.3f} s at "
        f"{json.dumps(routing)}; phase 6: forced {t_dev:.3f} s, inline "
        f"{t_inline:.3f} s; launches yama_dp {launches[0]}, yama_tb "
        f"{launches[1]}, yama_prep {launches[2]}; routes "
        f"{json.dumps(stats)}")
    if got != want_tba:
        raise AssertionError("default-routing tba: output differs from phase "
                             "6's inline run")
    if min(launches) <= 0:
        raise AssertionError("default-routing tba: a kernel never launched")
    if len(kept) != launches[2]:
        raise AssertionError(f"default-routing tba: {len(kept)} buckets kept, "
                             f"{launches[2]} prep launches")
    hold_real_launches(kept)
    return launches


def native_runtime():
    """The port's own native host runtime (it is built at import, or the
    import raises), or raise where another module of that name was
    loaded."""
    from multiz_tpu_torch import yama as Y

    mz = Y._mzcore
    if mz.__name__ != "multiz_tpu_torch._mzcore":
        raise AssertionError(f"the port's native runtime is not loaded: {mz}")
    return mz


def phase_self_contained():
    """Phase 11: the native runtime is the port's, and nothing of jax or
    of the JAX package was imported."""
    mz = native_runtime()
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "multiz_tpu"))
    if foreign:
        raise AssertionError(f"imported: {foreign[:10]}")
    log(f"# self-contained: native runtime {mz.__file__}; no jax or "
        "multiz_tpu module loaded")


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "multiz_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    os.environ["MZ_HOST_JOB_CELLS"] = "0"
    os.environ["MZ_HOST_ROUTE_CELLS"] = "0"
    t_all = time.perf_counter()
    smi = phase_device()
    import torch

    phase_build()
    native_runtime()
    from multiz_tpu_torch.ops.prep import prep
    from multiz_tpu_torch.ops.yama_dp import dp_forward
    from multiz_tpu_torch.ops.yama_tb import traceback

    counters = (dp_forward, traceback, prep)
    (err_prep, err_dp, err_tb, err_fdp, err_ftb), times = phase_kernels()
    phase_bench()
    phase_goldens()
    with tempfile.TemporaryDirectory() as d:
        sim = (*build_realistic(d), d)
        launches, t_inline, t_dev, want = phase_realistic(sim, counters)
        log(f"# launches in the realistic run: yama_dp {launches[0]}, "
            f"yama_tb {launches[1]}, yama_prep {launches[2]}")
        if min(launches) <= 0:
            raise AssertionError("a kernel of the main path never launched")
        log(f"# phases 1-7 passed in {time.perf_counter() - t_all:.1f} s")
        full_ms, full_scripts, full_launches = phase_full(sim, want, times)
        log(f"# phase 8 passed at {time.perf_counter() - t_all:.1f} s")
        phase_distributed()
        log(f"# phase 9 passed at {time.perf_counter() - t_all:.1f} s")
        phase_band(full_ms, full_scripts, counters)
        log(f"# phase 10 passed at {time.perf_counter() - t_all:.1f} s")
        for n, phase in (
            (12, lambda: phase_fasta(counters)),
            (13, lambda: phase_parallel(sim, want, t_inline, t_dev,
                                        counters)),
            (14, lambda: phase_default_routing(sim, want, t_inline, t_dev,
                                               counters)),
        ):
            launches = [a + b for a, b in zip(launches, phase())]
            log(f"# phase {n} passed at {time.perf_counter() - t_all:.1f} s")
    phase_self_contained()
    n_dp, n_tb, n_prep = launches
    log(f"# launches over the realistic phases (6, 12, 13, 14): yama_dp "
        f"{n_dp}, yama_tb {n_tb}, yama_prep {n_prep}")
    if n_prep <= 0 or n_prep != n_dp:
        raise AssertionError(f"yama_prep launched {n_prep} times over the "
                             f"realistic phases, yama_dp {n_dp}")
    log(f"# all phases passed in {time.perf_counter() - t_all:.1f} s")
    kernels = [
        {"name": "yama_dp", "route": "cuda",
         "source": "multiz_tpu_torch/csrc/yama_dp.cu",
         "replaces": "multiz_tpu/ops/yama_pack.py:265",
         "launches": n_dp, "max_abs_err": err_dp,
         "ms": times["dp_ms"], "plain_ms": times["dp_plain_ms"],
         "bound_ms": times["dp_bound_ms"], "bound_by": times["dp_bound_by"],
         "library_ms": None},
        {"name": "yama_tb", "route": "cuda",
         "source": "multiz_tpu_torch/csrc/yama_tb.cu",
         "replaces": "multiz_tpu/ops/yama_pack.py:560",
         "launches": n_tb, "max_abs_err": err_tb,
         "ms": times["tb_ms"], "plain_ms": times["tb_plain_ms"],
         "bound_ms": times["tb_bound_ms"], "bound_by": times["tb_bound_by"],
         "library_ms": None},
        {"name": "yama_prep", "route": "cuda",
         "source": "multiz_tpu_torch/csrc/yama_prep.cu",
         "replaces": "multiz_tpu/ops/yama_pack.py:169",
         "launches": n_prep, "max_abs_err": err_prep,
         "ms": times["prep_ms"], "plain_ms": times["prep_plain_ms"],
         "bound_ms": times["prep_bound_ms"],
         "bound_by": times["prep_bound_by"], "library_ms": None},
        {"name": "yama_full_dp", "route": "cuda",
         "source": "multiz_tpu_torch/csrc/yama_full.cu",
         "replaces": "multiz_tpu/ops/yama_jax.py:66",
         "launches": full_launches[0], "max_abs_err": err_fdp,
         "ms": times["full_dp_ms"], "plain_ms": times["full_dp_plain_ms"],
         "bound_ms": times["full_dp_bound_ms"],
         "bound_by": times["full_dp_bound_by"], "library_ms": None},
        {"name": "yama_full_tb", "route": "cuda",
         "source": "multiz_tpu_torch/csrc/yama_full.cu",
         "replaces": "multiz_tpu/ops/yama_jax.py:225",
         "launches": full_launches[1], "max_abs_err": err_ftb,
         "ms": times["full_tb_ms"], "plain_ms": times["full_tb_plain_ms"],
         "bound_ms": times["full_tb_bound_ms"],
         "bound_by": times["full_tb_bound_by"], "library_ms": None},
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except SystemExit:
        raise
    except BaseException:
        tb_mod.print_exc()
        rc = 1
    sys.exit(rc)
