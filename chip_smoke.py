#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (multiz_tpu_torch) on one GPU.

Run it from the root of a checkout: ``python3 chip_smoke.py``. It needs
one CUDA device and nvcc on PATH; without either it exits nonzero and
prints no result. Every DP job is forced onto the device
(MZ_HOST_JOB_CELLS=0, MZ_HOST_ROUTE_CELLS=0): at the default routing
small jobs run on the host lane and the kernels would prove nothing.

Phases, in order (any failure exits nonzero):
  1. device check, and the card's name and power limit;
  2. build of the CUDA kernels from csrc/ (with ptxas' register report);
  3. each kernel against its plain PyTorch version on the card, bit for
     bit, at window widths 256/512/1024, a bucket of more than 64
     problems, mixed sizes, odd shapes (1 column, 13 rows a side), and
     the bench workload's largest bucket (where both are also timed);
  4. the bench workload (1024 synthetic jobs) through yama_batch_packed,
     every result equal to multiz_tpu.yama.yama_numpy;
  5. the multiz v0/v1, tba4 and roast4 goldens, byte-equal;
  6. a simulated 2 Mb, 5-species tba (ENCODE-pilot-region size), its
     output byte-equal to the inline host run;
  7. the kernels' launch counts over phase 6, each > 0.

The line before last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
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

# the realistic run: bench_pipeline.py's dataset at MZ_PIPE_REFLEN=2000000,
# MZ_PIPE_SPECIES=5
SIM_REFLEN = 2_000_000
SIM_SPECIES = ("chimp", "gorilla", "orang", "baboon")
SIM_DIV = tuple(
    round(0.02 + i * (0.30 - 0.02) / (len(SIM_SPECIES) - 1), 3)
    for i in range(len(SIM_SPECIES))
)


def log(msg: str) -> None:
    print(msg, flush=True)


def block_lines(text: str):
    return [l for l in text.split("\n") if l and not l.startswith("#")]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps runs (CUDA events)."""
    import torch

    fn()  # warm
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
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


def _kernel_case(name, jobs, cw_want, timing=False):
    """Kernel vs plain version on the card for one launch of ``jobs``."""
    import numpy as np
    import torch

    from multiz_tpu import scores as sc
    from multiz_tpu import yama as Y
    from multiz_tpu_torch.ops import yama_pack as P
    from multiz_tpu_torch.ops.prep import decode_wire, prep
    from multiz_tpu_torch.ops.yama_dp import dp_forward, dp_forward_reference
    from multiz_tpu_torch.ops.yama_tb import (
        payload_width, traceback, traceback_reference,
    )
    from multiz_tpu_torch.scores import from_score_params

    for A, B, LB, RB in jobs:
        cw = P.pick_cw(np.asarray(LB), np.asarray(RB), A.shape[0], B.shape[0])
        if cw_want is not None and cw != cw_want:
            raise AssertionError(f"{name}: job window {cw} != {cw_want}")
    m_pad, n_pad, Kp, Lp, fw = P.bucket_of(jobs)
    st = from_score_params(sc.init_scores70(), "cuda")
    nb = len(jobs)
    buf = P.pack_wire(jobs, m_pad, n_pad, Kp, Lp).cuda()
    ops = prep(*decode_wire(buf, nb, m_pad, n_pad, Kp, Lp), st)
    go, ge = st.gap_open, st.gap_extend
    pw = payload_width(m_pad, n_pad)

    flags, last = dp_forward(ops, go, ge, fw)
    flags_p, last_p = dp_forward_reference(ops, go, ge, fw)
    pay = traceback(flags, ops.lb, ops.mnkl, last, pw)
    pay_p = traceback_reference(flags, ops.lb, ops.mnkl, last, pw)
    torch.cuda.synchronize()
    err_dp = max(
        int((flags.long() - flags_p.long()).abs().max()),
        int((last.long() - last_p.long()).abs().max()),
    )
    err_tb = int((pay.long() - pay_p.long()).abs().max())
    # the kernels' payload replays to the oracle's merged alignment
    results = {}
    P._replay_payload_slots(pay.cpu().numpy(), list(range(nb)),
                            dict(enumerate(jobs)), results)
    for i, (A, B, LB, RB) in enumerate(jobs):
        if not np.array_equal(results[i], Y.yama_numpy(A, B, LB, RB)):
            raise AssertionError(f"{name}: job {i} differs from yama_numpy")
    log(f"# kernels {name}: {nb} problems, m_pad {m_pad}, {fw} lanes, "
        f"cw {cw_want}: dp err {err_dp}, tb err {err_tb}")
    if err_dp or err_tb:
        raise AssertionError(f"{name}: kernel differs from its plain version")
    t = None
    if timing:
        t = {
            "dp_ms": cuda_ms(lambda: dp_forward(ops, go, ge, fw), 10),
            "dp_plain_ms": cuda_ms(
                lambda: dp_forward_reference(ops, go, ge, fw), 1),
            "tb_ms": cuda_ms(
                lambda: traceback(flags, ops.lb, ops.mnkl, last, pw), 10),
            "tb_plain_ms": cuda_ms(
                lambda: traceback_reference(flags, ops.lb, ops.mnkl, last,
                                            pw), 1),
        }
        log(f"# kernels {name} times (ms): " + json.dumps(t))
    return err_dp, err_tb, t


def bench_jobs():
    from multiz_tpu.ops.synth import synth_jobs

    return synth_jobs(1024, m_lo=256, m_hi=1024, k_lo=1, k_hi=4, radius=30,
                      seed=42)


def phase_kernels():
    import numpy as np

    from multiz_tpu.ops.synth import synth_jobs
    from multiz_tpu_torch.ops import yama_pack as P

    from torch_cases import edge_jobs

    cases = [
        ("edge_shapes", edge_jobs(), None),
        ("cw256_mixed_96", synth_jobs(96, m_lo=40, m_hi=900, radius=30,
                                      seed=1), 256),
        ("cw512", synth_jobs(12, m_lo=300, m_hi=500, radius=150, seed=2),
         512),
        ("cw1024", synth_jobs(6, m_lo=720, m_hi=900, radius=350, seed=3),
         1024),
    ]
    # the bench workload's largest bucket, as the stream would launch it
    buckets: dict = {}
    for A, B, LB, RB in bench_jobs():
        M, N = A.shape[0], B.shape[0]
        cw = P.pick_cw(np.asarray(LB), np.asarray(RB), M, N)
        p = max(P._pad_to(M), P._pad_to(N))
        key = (p, P._pad8(A.shape[1]), P._pad8(B.shape[1]), cw)
        buckets.setdefault(key, []).append((A, B, LB, RB))
    key = max(buckets, key=lambda k: len(buckets[k]))
    cases.append((f"bench_bucket_{len(buckets[key])}", buckets[key], key[3]))
    err_dp = err_tb = 0
    times = None
    for name, jobs, cw in cases:
        e1, e2, t = _kernel_case(name, jobs, cw,
                                 timing=name.startswith("bench"))
        err_dp, err_tb = max(err_dp, e1), max(err_tb, e2)
        times = t or times
    return err_dp, err_tb, times


def phase_bench():
    import numpy as np

    from multiz_tpu import yama as Y
    from multiz_tpu.ops.synth import band_cells
    from multiz_tpu_torch.ops import yama_pack as P

    jobs = bench_jobs()
    cells = band_cells(jobs)
    P.yama_batch_packed(jobs, device="cuda")  # warm: allocator, pinned pool
    P.reset_route_stats()
    t0 = time.perf_counter()
    out = P.yama_batch_packed(jobs, device="cuda")
    dt = time.perf_counter() - t0
    stats = dict(P.route_stats)
    for i, ((A, B, LB, RB), got) in enumerate(zip(jobs, out)):
        if not np.array_equal(got, Y.yama_numpy(A, B, LB, RB)):
            raise AssertionError(f"bench job {i} differs from yama_numpy")
    if stats["device_jobs"] + stats["fallback_jobs"] != len(jobs):
        raise AssertionError(f"bench: not every job on the device: {stats}")
    log(f"# bench: {len(jobs)} jobs equal to yama_numpy; {cells} band cells "
        f"in {dt:.4f} s = {cells / dt:.1f} band-cells/s end to end; "
        f"routes {json.dumps(stats)}")
    return cells / dt


def phase_goldens():
    from multiz_tpu import scores as sc
    from multiz_tpu.maf import format_ali
    from multiz_tpu.multiz import MultizConfig
    from multiz_tpu.tree import roast_run
    from multiz_tpu_torch.cli import multiz as mz_cli
    from multiz_tpu_torch.cli import tba as tba_cli
    from multiz_tpu_torch.ops import yama_pack as P

    def expect(name):
        with open(os.path.join(EXPECT, name)) as fh:
            return fh.read()

    os.environ["MULTIZ_TPU_TORCH_DEVICE"] = "packed"
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
            raise AssertionError(f"multiz v{v} differs from its golden")
        log(f"# golden multiz_v{v}: byte-equal")
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
                raise AssertionError("tba4 differs from its golden")
    log("# golden tba4: byte-equal (ignoring '#' lines)")
    cfg = MultizConfig(batch_fn=P.batch_fn_for("cuda"))
    blocks = roast_run("human", TREE4, PAIRS4, src_dir=DATA, cfg=cfg,
                       sp=sc.init_scores70())
    if (block_lines("".join(format_ali(a) for a in blocks))
            != block_lines(expect("roast4.maf"))):
        raise AssertionError("roast4 differs from its golden")
    log("# golden roast4: byte-equal (ignoring '#' lines)")
    if P.route_stats["device_jobs"] == 0:
        raise AssertionError("goldens: no DP job ran on the device")
    log(f"# goldens routes {json.dumps(P.route_stats)}")


def phase_realistic(counters):
    from multiz_tpu import scores as sc
    from multiz_tpu.cli import single_cov2
    from multiz_tpu.maf import format_ali
    from multiz_tpu.multiz import MultizConfig
    from multiz_tpu.tree import tba_run
    from multiz_tpu_torch.ops import yama_pack as P

    from sim import SimConfig, simulate

    tree = "human"
    for s in SIM_SPECIES:
        tree = f"({tree} {s})"
    pairs = [f"human.{s}.sing.maf" for s in SIM_SPECIES]
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        simulate(SimConfig(seed=9, ref_len=SIM_REFLEN, species=SIM_SPECIES,
                           divergence=SIM_DIV), d)
        for s in SIM_SPECIES:
            with open(os.path.join(d, f"human.{s}.sing.maf"), "w") as fh:
                single_cov2.main([os.path.join(d, f"human.{s}.orig.maf")],
                                 out=fh)
        log(f"# realistic: dataset {SIM_REFLEN} bp x {len(SIM_SPECIES) + 1} "
            f"species built in {time.perf_counter() - t0:.2f} s")

        def run(batch_fn):
            t0 = time.perf_counter()
            blocks = tba_run(tree, pairs, src_dir=d,
                             cfg=MultizConfig(batch_fn=batch_fn),
                             sp=sc.init_scores70())
            dt = time.perf_counter() - t0
            return "".join(format_ali(a) for a in blocks), len(blocks), dt

        want, nblocks, t_inline = run(None)
        P.reset_route_stats()
        for c in counters:
            c.launches = 0  # the main path's run starts here
        got, _, t_dev = run(P.batch_fn_for("cuda"))
        launches = [c.launches for c in counters]
        stats = dict(P.route_stats)
    if got != want:
        raise AssertionError("realistic tba: device output differs from the "
                             "inline host run")
    log(f"# realistic tba: {nblocks} blocks byte-equal; inline {t_inline:.3f} s"
        f", forced-device {t_dev:.3f} s; routes {json.dumps(stats)}")
    if stats["host_jobs"]:
        raise AssertionError(f"realistic tba: jobs left on the host: {stats}")
    return launches, t_inline, t_dev


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "multiz_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 1
    # the package, and the jax-free test helpers (sim, torch_cases)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    os.environ["MZ_HOST_JOB_CELLS"] = "0"
    os.environ["MZ_HOST_ROUTE_CELLS"] = "0"
    t_all = time.perf_counter()
    smi = phase_device()
    import torch

    phase_build()
    from multiz_tpu_torch.ops.yama_dp import dp_forward
    from multiz_tpu_torch.ops.yama_tb import traceback

    err_dp, err_tb, times = phase_kernels()
    phase_bench()
    phase_goldens()
    (n_dp, n_tb), _, _ = phase_realistic((dp_forward, traceback))
    log(f"# launches in the realistic run: yama_dp {n_dp}, yama_tb {n_tb}")
    if n_dp <= 0 or n_tb <= 0:
        raise AssertionError("a kernel of the main path never launched")
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    log(f"# all phases passed in {time.perf_counter() - t_all:.1f} s")
    kernels = [
        {"name": "yama_dp", "route": "cuda",
         "source": "multiz_tpu_torch/csrc/yama_dp.cu",
         "replaces": "multiz_tpu/ops/yama_pack.py:265",
         "launches": n_dp, "max_abs_err": err_dp,
         "ms": times["dp_ms"], "plain_ms": times["dp_plain_ms"]},
        {"name": "yama_tb", "route": "cuda",
         "source": "multiz_tpu_torch/csrc/yama_tb.cu",
         "replaces": "multiz_tpu/ops/yama_pack.py:560",
         "launches": n_tb, "max_abs_err": err_tb,
         "ms": times["tb_ms"], "plain_ms": times["tb_plain_ms"]},
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
