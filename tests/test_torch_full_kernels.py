"""The full-row DP's two kernels (multiz_tpu_torch/csrc/yama_full.cu,
wrapped by ops/yama_full.yama_core and traceback_core) and their plain
versions.

On the CPU: the plain versions (yama_core_reference, traceback_reference)
against the JAX package's jitted scans (multiz_tpu/ops/yama_jax.py:
_yama_core and _traceback_core, vmapped and jitted on the CPU) on inputs
made from a seed with numpy, at error 0, with the usual score scheme and
one whose int32 sums and products wrap, and on walks that leave the
matrix; the dispatchers' choice of the plain versions for CPU tensors;
every entry point raising without a card; the forward's plan
(full_plan: the warp path and its lanes a thread, or the block path,
from the bucket's host arrays); the kernel source's constants against
the wrapper's; the bound functions' arithmetic; and the launch checks
of the packed tools beside the new counters.

Marked ``cuda`` (skipping where torch sees no card): each kernel against
its plain version, bit for bit: the forward on both paths, the block
path forced on every case and the warp path on every bucket it takes
(each case's warp-eligible jobs where the whole case is not), over the
pad ladder of smoke phase 3, the window-width ladder, the edge jobs and
one problem at n_pad 16384; the traceback on walks that leave the
matrix and on walks that cross its staged windows and LB jumps; entry()
on the card against entry("cpu"); and the packed tools' launch checks on
a card run. On a machine with a card:
``python -m pytest tests/test_torch_full_kernels.py -m cuda``.

Every comparison is exact (tolerance 0): the DP is integer arithmetic.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiz_tpu import scores as sc
from multiz_tpu.ops import yama_jax as YJ
from multiz_tpu.ops.synth import synth_jobs
from multiz_tpu_torch.ops import yama_full as F
from multiz_tpu_torch.ops.yama_pack import _pad_to
from multiz_tpu_torch.tools import kernel_cases as KC

# a score scheme whose products and sums wrap in int32
WRAP_SS = np.random.default_rng(77).integers(-2**30, 2**30, (6, 6))
WRAP_GO, WRAP_GE = 2**27 + 12345, 2**26 + 777


def _scheme(name):
    """(ss_cat (6, 6) int32, go, ge)."""
    if name == "wrapping":
        return WRAP_SS.astype(np.int32), WRAP_GO, WRAP_GE
    sp = sc.current
    return sp.ss_cat.astype(np.int32), int(sp.gap_open), int(sp.gap_extend)


def _jobs(case):
    """(jobs, m_pad, n_pad) of a named case."""
    if case == "synth":
        jobs = synth_jobs(7, m_lo=30, m_hi=56, k_lo=1, k_hi=4, radius=12,
                          seed=21)
    elif case == "edge":
        jobs = KC.edge_jobs()
    elif case == "wide":
        jobs = KC.full_wide_jobs()
    elif case == "long":
        # a 61-lane band over rows of 4,097 bytes
        jobs = synth_jobs(3, m_lo=2100, m_hi=2500, radius=30, seed=12)
    elif case == "bench":
        from multiz_tpu_torch.tools.bench import bench_bucket

        jobs = bench_bucket()[0]
    elif case.startswith("fw"):
        jobs = KC.ladder_jobs(int(case.removeprefix("fw")))
    else:
        jobs = KC.full_ladder_jobs(int(case.removeprefix("pad")))
    m_pad = _pad_to(max(A.shape[0] for A, *_ in jobs))
    n_pad = _pad_to(max(B.shape[0] for _, B, *_ in jobs))
    return jobs, m_pad, n_pad


@functools.lru_cache(maxsize=None)
def _jax_forward(case, scheme):
    """The JAX package's _yama_core and _traceback_core on a case:
    (stacked numpy operands, flags, lastC, lastD, lastI, script, nedit)."""
    jobs, m_pad, n_pad = _jobs(case)
    ss, go, ge = _scheme(scheme)
    stacked = {k: np.asarray(v)
               for k, v in YJ.stack_jobs(jobs, m_pad, n_pad).items()}
    core = functools.partial(YJ._yama_core, ss_cat=jnp.asarray(ss), go=go,
                             ge=ge, m_pad=m_pad, n_pad=n_pad)
    flags, lc, ld, li = jax.jit(jax.vmap(core))(
        *(stacked[k] for k in YJ.STACK_KEYS))
    tb = functools.partial(YJ._traceback_core, m_pad=m_pad, n_pad=n_pad)
    script, nedit = jax.jit(jax.vmap(tb))(
        flags, stacked["LB"], stacked["RB"], stacked["M"], stacked["N"],
        lc, ld, li)
    return (stacked, *(np.array(x) for x in (flags, lc, ld, li, script,
                                            nedit)))


def _port_args(stacked, device="cpu"):
    return [torch.tensor(stacked[k], device=device) for k in F.STACK_KEYS]


@pytest.mark.parametrize("case, scheme", [
    ("synth", "scores70"), ("synth", "wrapping"), ("pad16", "scores70"),
    ("pad32", "wrapping"), ("pad256", "scores70"),
])
def test_plain_forward_matches_jax(case, scheme):
    """yama_core_reference == yama_jax._yama_core, flags and last cells."""
    stacked, jflags, *jlast = _jax_forward(case, scheme)[:5]
    _, m_pad, n_pad = _jobs(case)
    ss, go, ge = _scheme(scheme)
    flags, *last = F.yama_core_reference(
        *_port_args(stacked), torch.from_numpy(ss), go, ge, m_pad, n_pad)
    assert flags.dtype == torch.uint8
    np.testing.assert_array_equal(flags.numpy(), jflags)
    for got, want in zip(last, jlast):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    if scheme == "wrapping":
        # the scheme does wrap: histB @ ss_cat.T, taken in int64, leaves
        # the int32 range
        sub = stacked["histB"].astype(np.int64) @ ss.astype(np.int64).T
        assert np.abs(sub).max() >= 2**31


def _invalid_walks(B=6, m_pad=16, n_pad=32, seed=8):
    """Random flag bytes (every pointer, 3 included, and high bits),
    bands and last cells: walks that leave the matrix, wrap their rows
    and run the whole trip."""
    rng = np.random.default_rng(seed)
    flags = rng.integers(0, 256, (B, m_pad + 1, n_pad + 1)).astype(np.uint8)
    LB = rng.integers(0, n_pad // 2, (B, m_pad + 1)).astype(np.int32)
    RB = (LB + rng.integers(0, n_pad, (B, m_pad + 1))).astype(np.int32)
    M = rng.integers(0, m_pad + 1, B).astype(np.int32)
    N = rng.integers(0, n_pad + 1, B).astype(np.int32)
    last = [rng.integers(-5, 5, B).astype(np.int32) for _ in range(3)]
    return flags, LB, RB, M, N, last, m_pad, n_pad


@pytest.mark.parametrize("kind", ["jax_flags", "invalid_walk"])
def test_plain_traceback_matches_jax(kind):
    """traceback_reference == yama_jax._traceback_core: on the JAX
    forward's flags, and on random flags whose walks leave the matrix."""
    if kind == "jax_flags":
        stacked, flags, lc, ld, li, jscript, jnedit = _jax_forward(
            "synth", "scores70")
        _, m_pad, n_pad = _jobs("synth")
        args = (flags, stacked["LB"], stacked["RB"], stacked["M"],
                stacked["N"], lc, ld, li)
    else:
        flags, LB, RB, M, N, last, m_pad, n_pad = _invalid_walks()
        args = (flags, LB, RB, M, N, *last)
        tb = functools.partial(YJ._traceback_core, m_pad=m_pad, n_pad=n_pad)
        jscript, jnedit = (np.array(x) for x in
                           jax.jit(jax.vmap(tb))(*args))
        # some walk steps past row 0: its row indexes from the end
        row_steps = ((jscript != 255) & (jscript != 1)).sum(1)
        assert (row_steps > M).any()
    script, nedit = F.traceback_reference(
        *(torch.tensor(a) for a in args),
        m_pad, n_pad)
    np.testing.assert_array_equal(script.numpy(), jscript)
    np.testing.assert_array_equal(nedit.numpy(), jnedit)


def test_dispatchers_take_the_plain_versions_on_cpu(monkeypatch):
    """CPU tensors run the plain versions and launch nothing; another
    device type has no kernel."""
    stacked = _jax_forward("synth", "scores70")[0]
    _, m_pad, n_pad = _jobs("synth")
    ss, go, ge = _scheme("scores70")
    args = _port_args(stacked)
    calls = []
    for name in ("yama_core_reference", "traceback_reference"):
        real = getattr(F, name)
        monkeypatch.setattr(F, name, lambda *a, _r=real, _n=name: (
            calls.append(_n), _r(*a))[1])
    n_dp, n_tb = F.yama_core.launches, F.traceback_core.launches
    flags, lc, ld, li = F.yama_core(*args, torch.from_numpy(ss), go, ge,
                                    m_pad, n_pad)
    F.traceback_core(flags, args[8], args[9], args[10], args[11], lc, ld,
                     li, m_pad, n_pad)
    assert calls == ["yama_core_reference", "traceback_reference"]
    assert (F.yama_core.launches, F.traceback_core.launches) == (n_dp, n_tb)
    meta = [torch.empty(a.shape, dtype=a.dtype, device="meta") for a in args]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        F.yama_core(*meta, torch.from_numpy(ss), go, ge, m_pad, n_pad)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        F.traceback_core(flags.to("meta"), *meta[8:12], *(
            t.to("meta") for t in (lc, ld, li)), m_pad, n_pad)


def test_band_forward_hands_the_traceback_contiguous_cells():
    """The column-sharded forward (band > 1, torch ops on every device)
    returns its last cells as the traceback kernel takes them: three
    contiguous (B,) int32 vectors, equal to the one-shard forward's."""
    from multiz_tpu_torch.parallel.sharding import make_mesh, shard_stacked

    stacked = _jax_forward("synth", "scores70")[0]
    _, m_pad, n_pad = _jobs("synth")
    ss, go, ge = _scheme("scores70")
    ops = dict(zip(F.STACK_KEYS, _port_args(stacked)))
    (row,) = shard_stacked(ops, make_mesh(["cpu"] * 2, band=2))
    flags, *last = F.yama_core_cols(row, torch.from_numpy(ss), go, ge,
                                    m_pad, n_pad)
    want = F.yama_core_reference(*ops.values(), torch.from_numpy(ss), go,
                                 ge, m_pad, n_pad)
    assert torch.equal(torch.cat(flags, dim=2), want[0])
    for got, w in zip(last, want[1:]):
        assert got.is_contiguous() and got.dtype == torch.int32
        assert torch.equal(got, w)


def _entry_points():
    from multiz_tpu_torch import entry
    from multiz_tpu_torch.ops import yama_pack as P
    from multiz_tpu_torch.tools import (
        bench, full_ab, full_sweep, profile_pack, route_sweep, scaling_proxy,
    )

    job = synth_jobs(1, m_lo=16, m_hi=20, seed=1)
    return {
        "entry": lambda: entry.entry(),
        "entry_main": lambda: entry.main([]),
        "dryrun_multichip": lambda: entry.dryrun_multichip(2),
        "yama_batch": lambda: F.yama_batch(job),
        "yama_full": lambda: F.yama_full(*job[0]),
        "full_batch_fn_for": lambda: F.batch_fn_for("cuda"),
        "yama_batch_packed": lambda: P.yama_batch_packed(job),
        "packed_batch_fn_for": lambda: P.batch_fn_for("cuda"),
        "packed_stream": lambda: P.PackedDPStream(),
        "bench": lambda: bench.measure(jobs=job),
        "profile_pack": lambda: profile_pack.profile(nprob=2),
        "scaling_proxy": lambda: scaling_proxy.measure(2),
        "route_sweep": lambda: route_sweep.sweep(),
        "full_ab": lambda: full_ab.main(["."]),
        "full_sweep": lambda: full_sweep.main([]),
    }


@pytest.mark.parametrize("name", [
    "entry", "entry_main", "dryrun_multichip", "yama_batch", "yama_full",
    "full_batch_fn_for", "yama_batch_packed", "packed_batch_fn_for",
    "packed_stream", "bench", "profile_pack",
    "scaling_proxy", "route_sweep", "full_ab", "full_sweep",
])
def test_entry_points_raise_without_a_card(name, monkeypatch):
    """Every entry point that defaults to the card raises where torch
    sees none; the CPU is asked for by name."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device|sees no CUDA"):
        _entry_points()[name]()


def test_bench_bucket_is_the_streams_largest_launch():
    """tools.bench.bench_bucket: the bench workload's largest packed
    launch (profile_pack's plan: 356, 637 and 31 jobs), at the pads of
    smoke phase 3's and full_ab's full-row bucket."""
    from multiz_tpu_torch.ops import yama_pack as P
    from multiz_tpu_torch.tools.bench import bench_bucket
    from multiz_tpu_torch.tools.profile_pack import plan_launches
    from multiz_tpu_torch.tools.bench import bench_jobs

    jobs, cw = bench_bucket()
    assert len(jobs) == 637 and cw == 256
    assert P.bucket_of(jobs)[:2] == (1024, 1024)
    launches, _ = plan_launches(bench_jobs(1024))
    assert max(len(part) for _, part, _ in launches) == 637


def test_bound_arithmetic():
    """The four bounds on a bucket worked out by hand: 2 problems at
    m_pad 2, n_pad 300; problem 0 has M 2 and rows of 11, 300 and 201
    band cells, problem 1 has M 0 and a row of 3."""
    from multiz_tpu_torch.ops.yama_dp import (
        CLOCK_HZ, HBM_BYTES_PER_S, INT32_OPS_PER_S,
    )

    m_pad, n_pad, B = 2, 300, 2
    mp, np1 = m_pad + 1, n_pad + 1
    z = lambda *s: torch.zeros((B, *s), dtype=torch.int32)
    stacked = {"histA": z(mp, 6), "a0": z(mp), "a1": z(mp), "pa": z(mp, 4),
               "histB": z(np1, 6), "b0": z(np1), "b1": z(np1),
               "pb": z(np1, 4),
               "LB": torch.tensor([[0, 0, 100], [0, 0, 0]], dtype=torch.int32),
               "RB": torch.tensor([[10, 299, 300], [2, 2, 2]],
                                  dtype=torch.int32),
               "M": torch.tensor([2, 0], dtype=torch.int32),
               "N": torch.tensor([300, 2], dtype=torch.int32),
               "K": z(), "L": z()}
    cells = 11 + 300 + 201 + 3
    operand_bytes = 4 * B * (mp * (6 + 1 + 1 + 4 + 1 + 1)
                             + np1 * (6 + 1 + 1 + 4) + 4)
    nbytes = operand_bytes + 36 * 4 + B * mp * np1 + 12 * B
    t, by = F.full_dp_bound(stacked, m_pad, n_pad)
    t_ops = 110 * cells / INT32_OPS_PER_S  # row_step's work a cell
    t_bytes = nbytes / HBM_BYTES_PER_S
    assert by == ("operations" if t_ops >= t_bytes else "bytes")
    assert t == pytest.approx(max(t_ops, t_bytes))
    # the longest problem's 2 rows, each the recurrence's dependent step:
    # 8 shuffles (20 cycles) and 23 operations (4 cycles), plus 3 maxima
    # of the in-thread scan (row 2's window, columns 0..300, 301 lanes,
    # counted as the warp's widest, 4 lanes a thread)
    row = 8 * 20 + (23 + 3) * 4
    assert F.full_dp_chain_bound(stacked, m_pad, n_pad) == pytest.approx(
        2 * row / CLOCK_HZ)
    nedit = torch.tensor([302, 2], dtype=torch.int32)
    t, by = F.full_tb_bound(nedit, stacked, m_pad, n_pad)
    assert by == "bytes"
    assert t == pytest.approx((304 + 8 * (3 + 1) + B * (m_pad + n_pad)
                               + B * 24) / HBM_BYTES_PER_S)
    assert F.full_tb_chain_bound(nedit) == pytest.approx(
        302 * (F.GLOBAL_CYCLES + F.FULL_TB_STEP_OPS * 4) / CLOCK_HZ)


def test_chain_bound_at_the_bench_bucket():
    """At the bench bucket the forward's chain bound is 1,024 rows of
    256 cycles (2 lanes a thread), about 0.132 ms."""
    from multiz_tpu_torch.ops.yama_dp import CLOCK_HZ

    jobs, m_pad, n_pad = _jobs("bench")
    st = F.stack_jobs(jobs, m_pad, n_pad)
    rows = int(st["M"].max())
    assert rows == 1024
    assert F.full_dp_chain_bound(st, m_pad, n_pad) == pytest.approx(
        rows * 256 / CLOCK_HZ)


def test_record_size_follows_the_kernel_source():
    """The wrapper's scratch record is the kernel's NREC ints a column,
    and its tile the kernel's THREADS columns."""
    import os
    import re

    from multiz_tpu_torch import _build

    with open(os.path.join(_build.CSRC, "yama_full.cu")) as fh:
        src = fh.read()
    assert int(re.search(r"constexpr int NREC = (\d+);", src)[1]) == \
        F.FULL_NREC
    assert int(re.search(r"constexpr int THREADS = (\d+);", src)[1]) == \
        F.FULL_THREADS


@pytest.mark.parametrize("name, value", [
    ("WARP_MAX_P", F.FULL_WARP_LANES // 32),
    ("MAX_PER_BLOCK", F.FULL_MAX_PER_BLOCK),
    ("CHUNK", F.FULL_CHUNK),
    ("FLUSH", F.FULL_FLUSH),
    ("TB_ROWS", F.TB_ROWS),
    ("TB_SLOT", F.TB_SLOT),
    ("TB_SCRIPT", F.TB_SCRIPT),
])
def test_kernel_constants_follow_the_source(name, value):
    """The warp path's and the traceback's constants in csrc/yama_full.cu
    are the wrapper's: the widest window, problems a block, rows of an
    operand chunk and of a flag flush, rows and band bytes a staged
    window, script bytes staged."""
    import os
    import re

    from multiz_tpu_torch import _build

    with open(os.path.join(_build.CSRC, "yama_full.cu")) as fh:
        src = fh.read()
    assert int(re.search(rf"constexpr int {name} = (\d+);", src)[1]) == value


def test_tb_slot_holds_the_widest_real_band():
    """A staged row holds the band of any warp-path window at any
    alignment: 128 lanes from up to 15 bytes past a 16-byte boundary, 9
    chunks (113 lanes, the widest real band, take at most 8)."""
    assert F.TB_SLOT % 16 == 0
    assert F.TB_SLOT == -(-(F.FULL_WARP_LANES + 15) // 16) * 16 == 144
    assert -(-(113 + 15) // 16) == 8


def _host_plan(case, **kw):
    jobs, m_pad, n_pad = _jobs(case)
    h = F.stack_host(jobs, m_pad, n_pad)
    return F.full_plan(h["LB"], h["RB"], h["M"], m_pad, n_pad, **kw)


@pytest.mark.parametrize("case, path, per_thread", [
    ("bench", "warp", 2), ("synth", "warp", 1), ("long", "warp", 2),
    ("pad16", "warp", 1),
    ("pad32", "warp", 2), ("edge", "warp", 3), ("fw61", "warp", 4),
    ("fw113", "block", 0), ("pad256", "block", 0), ("pad1024", "block", 0),
    ("pad2048", "block", 0), ("wide", "block", 0),
])
def test_full_plan_picks_the_path(case, path, per_thread):
    """The bench bucket and every bucket of windows up to 128 lanes take
    the warp path at ceil(window/32) lanes a thread (fw61: its 60-lane
    band and a 40-column LB jump, a 101-lane window); the ladder's pad/4
    bands and LB jumps past 128 lanes and the 16,384-column problem the
    block path."""
    plan = _host_plan(case)
    assert (plan.path, plan.per_thread) == (path, per_thread)
    assert plan.per_thread == (-(-plan.window // 32) if path == "warp" else 0)
    jobs = _jobs(case)[0]
    assert plan.grid == -(-len(jobs) // plan.per_block)
    assert plan.threads == (32 * plan.per_block if path == "warp"
                            else F.FULL_THREADS)
    if case == "bench":
        assert plan.per_block == 2 and plan.grid == 319


@pytest.mark.parametrize("what", ["lb_jump", "quarter_band"])
def test_full_plan_block_path_for_the_ladders_wide_jobs(what):
    """Alone in a bucket, the ladder's LB jump (40 columns, a 256-lane
    window at pad 256) and its pad/4 band (radius 64) take the block
    path."""
    jobs = KC.full_ladder_jobs(256)
    job = jobs[4] if what == "lb_jump" else jobs[1]
    LB, RB = job[2], job[3]
    if what == "lb_jump":
        assert LB[12] - LB[11] == 40
    h = F.stack_host([job], 256, 256)
    plan = F.full_plan(h["LB"], h["RB"], h["M"], 256, 256)
    assert plan.path == "block" and plan.window > F.FULL_WARP_LANES


def _non_monotone():
    """A bucket whose second problem's LB steps back a column."""
    jobs = synth_jobs(2, m_lo=30, m_hi=40, radius=8, seed=5)
    h = F.stack_host(jobs, 64, 64)
    r = int(h["M"][1]) // 2
    h["LB"][1, r] = h["LB"][1, r - 1] - 1
    return h


def test_full_plan_block_path_for_a_non_monotone_band():
    """A band whose LB steps back takes the block path, however narrow,
    and the warp path cannot be forced on it."""
    h = _non_monotone()
    window, monotone = F.full_window(h["LB"], h["RB"], h["M"], 64, 64)
    assert window <= F.FULL_WARP_LANES and not monotone
    assert F.full_plan(h["LB"], h["RB"], h["M"], 64, 64).path == "block"
    with pytest.raises(ValueError, match="warp path takes monotone"):
        F.full_plan(h["LB"], h["RB"], h["M"], 64, 64, path="warp")


def test_full_plan_forcing_and_batch_override():
    """``path`` forces the block path anywhere and the warp path where it
    is eligible; ``B`` sizes a launch of part of the bucket (a mesh row);
    anything else raises."""
    assert _host_plan("bench", path="block") == F.FullPlan(
        "block", 0, 1, 637, F.FULL_THREADS, 63)
    plan = _host_plan("bench", B=300)
    assert (plan.path, plan.per_block, plan.grid, plan.threads) == (
        "warp", 2, 150, 64)
    plan = _host_plan("bench", B=200)
    assert (plan.per_block, plan.grid, plan.threads) == (1, 200, 32)
    with pytest.raises(ValueError, match="warp path takes"):
        _host_plan("pad256", path="warp")
    with pytest.raises(ValueError, match="no path"):
        _host_plan("pad16", path="tile")


def test_full_window_by_hand():
    """Windows worked out by hand: row 0 alone (M = 0) spans RB[0] + 1
    lanes; a row spans its band joined with the previous row's; rows
    past M do not count; LB[0] != 0 or a band past n_pad is not
    monotone."""
    LB = np.array([[0, 0, 3, 9, 9], [0, 0, 0, 0, 0]])
    RB = np.array([[5, 7, 20, 30, 99], [40, 40, 40, 40, 40]])
    M = np.array([3, 0])
    # problem 0: rows 1..3: 8, 21 and 28 lanes; problem 1: row 0, 41
    assert F.full_window(LB, RB, M, 4, 64) == (41, True)
    assert F.full_window(LB, RB, np.array([3, 1]), 4, 64) == (41, True)
    assert F.full_window(LB[:1], RB[:1], M[:1], 4, 64) == (28, True)
    bad = LB.copy()
    bad[0, 0] = 1
    assert F.full_window(bad, RB, M, 4, 64)[1] is False
    assert F.full_window(LB, RB, M, 4, 25)[1] is False  # RB[3] = 30
    assert F.full_window(LB, RB, np.array([5, 0]), 4, 200)[1] is False


def test_yama_batch_plans_from_host_arrays(monkeypatch):
    """yama_batch plans each bucket from stack_host's numpy arrays (it
    never reads the card's tensors back to plan) and hands the plan to
    the bucket's forward."""
    jobs = synth_jobs(5, m_lo=20, m_hi=60, radius=8, seed=3)
    seen, run = [], F._run_bucket
    real_plan = F.full_plan

    def plan(*args, **kw):
        seen.append([type(a) for a in args[:3]])
        return real_plan(*args, **kw)

    def bucket(stacked, st, m_pad, n_pad, plan=None):
        seen.append(plan)
        return run(stacked, st, m_pad, n_pad, plan)

    monkeypatch.setattr(F, "full_plan", plan)
    monkeypatch.setattr(F, "_run_bucket", bucket)
    out = F.yama_batch(jobs, device="cpu")
    assert seen and all(t == [np.ndarray] * 3 for t in seen[::2])
    assert all(isinstance(p, F.FullPlan) and p.path == "warp"
               for p in seen[1::2])
    from multiz_tpu_torch import yama as TY

    for (A, B, LB, RB), got in zip(jobs, out):
        np.testing.assert_array_equal(got, TY.yama_numpy(A, B, LB, RB))


def test_launch_counts_by_path():
    """A launch counts on its wrapper and, for the forward, under its
    path; reset_launches clears both."""
    from multiz_tpu_torch import _build, tools

    saved = (F.yama_core.launches, dict(F.yama_core.paths))
    try:
        tools.reset_launches()
        _build.count_launch(F.yama_core, "warp")
        _build.count_launch(F.yama_core, "block")
        _build.count_launch(F.yama_core, "warp")
        assert F.yama_core.launches == 3
        assert F.yama_core.paths == {"warp": 2, "block": 1}
        tools.reset_launches()
        assert F.yama_core.paths == {"warp": 0, "block": 0}
    finally:
        F.yama_core.launches, F.yama_core.paths = saved[0], saved[1]


@pytest.mark.parametrize("counts, ok", [
    ({"yama_dp": 3, "yama_tb": 3, "yama_prep": 3, "yama_full_dp": 0,
      "yama_full_tb": 0}, True),
    ({"yama_dp": 3, "yama_tb": 3, "yama_prep": 3}, True),
    ({"yama_dp": 0, "yama_tb": 0, "yama_prep": 0, "yama_full_dp": 2,
      "yama_full_tb": 2}, False),
    ({"yama_dp": 3, "yama_tb": 3, "yama_prep": 2, "yama_full_dp": 2,
      "yama_full_tb": 2}, False),
])
def test_launch_checks_by_kernel_set(counts, ok):
    """The packed tools' check holds the packed stream's kernels only: a
    card run passes with the full-row counters at 0 or absent, and the
    full-row counts never stand in for a packed kernel's."""
    from multiz_tpu_torch.tools import PACKED, check_launches

    assert PACKED == ("yama_dp", "yama_tb", "yama_prep")
    if ok:
        check_launches(counts, torch.device("cuda"), "card run")
    else:
        with pytest.raises(AssertionError, match="card run"):
            check_launches(counts, torch.device("cuda"), "card run")


def test_launches_report_by_kernel_set():
    """``launches()`` reports the packed kernels; the full-row wrappers
    are counted beside them and reset with them."""
    from multiz_tpu_torch import tools

    saved = {n: w.launches for n, w in tools.kernel_counters().items()}
    try:
        tools.reset_launches()
        F.yama_core.launches, F.traceback_core.launches = 4, 5
        assert tools.launches() == {"yama_dp": 0, "yama_tb": 0,
                                    "yama_prep": 0}
        counters = tools.kernel_counters()
        assert (counters["yama_full_dp"], counters["yama_full_tb"]) == (
            F.yama_core, F.traceback_core)
        tools.reset_launches()
        assert (F.yama_core.launches, F.traceback_core.launches) == (0, 0)
    finally:
        for name, w in tools.kernel_counters().items():
            w.launches = saved[name]


# ---- on the card -------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


def _both(case, scheme="scores70", path="block", jobs=None):
    """Each kernel against its plain version on the card for one case,
    the forward on ``path`` (on the warp path, the case's jobs it takes):
    flags, last cells, scripts and nedit equal; every launch counted,
    the forward's under its path; the valid jobs' replays equal to
    yama_numpy. ``jobs`` replaces the case's jobs (at their own pads).
    Returns the plain traceback's nedit."""
    from multiz_tpu_torch import yama as TY
    from multiz_tpu_torch.ops.yama_pack import replay_script

    if jobs is None:
        jobs, m_pad, n_pad = _jobs(case)
        if path == "warp":
            jobs = KC.full_warp_jobs(jobs, m_pad, n_pad)
    else:
        m_pad = _pad_to(max(A.shape[0] for A, *_ in jobs))
        n_pad = _pad_to(max(B.shape[0] for _, B, *_ in jobs))
    assert jobs
    ss, go, ge = _scheme(scheme)
    host = F.stack_host(jobs, m_pad, n_pad)
    plan = F.full_plan(host["LB"], host["RB"], host["M"], m_pad, n_pad,
                       path=path)
    st = F.upload(host, "cuda")
    args = [st[k] for k in F.STACK_KEYS]
    ssc = torch.from_numpy(ss).cuda()
    n_dp, n_tb = F.yama_core.launches, F.traceback_core.launches
    n_path = F.yama_core.paths[path]
    got = F.yama_core(*args, ssc, go, ge, m_pad, n_pad, plan=plan)
    want = F.yama_core_reference(*args, ssc, go, ge, m_pad, n_pad)
    tb_args = (st["LB"], st["RB"], st["M"], st["N"])
    script, nedit = F.traceback_core(got[0], *tb_args, *got[1:], m_pad, n_pad)
    rscript, rnedit = F.traceback_reference(got[0], *tb_args, *got[1:],
                                            m_pad, n_pad)
    torch.cuda.synchronize()
    assert F.yama_core.launches == n_dp + 1
    assert F.yama_core.paths[path] == n_path + 1
    assert F.traceback_core.launches == n_tb + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(script, rscript) and torch.equal(nedit, rnedit)
    if scheme == "scores70":
        sn, nn = script.cpu().numpy(), nedit.cpu().numpy()
        for i, (A, B, LB, RB) in enumerate(jobs):
            try:
                ref = TY.yama_numpy(A, B, LB, RB)
            except TY.YamaError:
                continue
            np.testing.assert_array_equal(
                replay_script(sn[i], int(nn[i]), A, B), ref,
                err_msg=f"{case} job {i}")
    return rnedit


FW_CASES = [f"fw{w}" for w in KC.FW_LADDER if w <= 128]


@pytest.mark.cuda
@pytest.mark.parametrize("case", [f"pad{p}" for p in KC.FULL_PAD_LADDER]
                         + ["edge", "wide", "synth", "long"] + FW_CASES)
def test_kernels_match_plain_versions(case):
    """The block path, forced, on every case."""
    _card()
    _both(case)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [f"pad{p}" for p in KC.FULL_PAD_LADDER]
                         + ["edge", "synth", "long"] + FW_CASES)
def test_warp_path_matches_plain_versions(case):
    """The warp path on every case's jobs that it takes: the ladders'
    narrow bands, M = 0, one column of B, LB jumps within 128 lanes,
    windows of 1 to 128 lanes (1 to 4 lanes a thread), rows of 4,097
    bytes."""
    _card()
    _both(case, path="warp")


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["warp", "block"])
def test_kernels_wrapping_scheme(path):
    _card()
    _both("synth", scheme="wrapping", path=path)
    _both("pad256", scheme="wrapping", path=path)


@pytest.mark.cuda
@pytest.mark.parametrize("seed, B, m_pad, n_pad", [
    (8, 6, 16, 32), (9, 37, 80, 64), (10, 5, 200, 128), (11, 3, 16, 600),
])
def test_tb_kernel_on_invalid_walks(seed, B, m_pad, n_pad):
    """Random flags, bands and last cells: walks that leave the matrix,
    wrap their rows, cross staged windows and bands past the staged
    slot."""
    _card()
    flags, LB, RB, M, N, last, m_pad, n_pad = _invalid_walks(
        B, m_pad, n_pad, seed)
    args = [torch.from_numpy(np.ascontiguousarray(a)).cuda()
            for a in (flags, LB, RB, M, N, *last)]
    got = F.traceback_core(*args, m_pad, n_pad)
    want = F.traceback_reference(*args, m_pad, n_pad)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _jump_jobs(n=9, seed=4):
    """Problems of 100 to 180 rows whose diagonal band of 61 lanes jumps
    40 columns at row 50 (a window of 102 lanes there): walks over
    several staged windows and across the jump."""
    rng = np.random.default_rng(seed)
    jobs = []
    for _ in range(n):
        M = int(rng.integers(100, 181))
        N = M + 80
        r = np.arange(M + 1)
        jump = np.where(r < 50, 0, 40)
        LB = np.maximum(0, r - 20) + jump
        RB = np.minimum(N, r + 40 + jump)
        jobs.append(KC._job(rng, M, N, LB, RB))
    return jobs


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["warp", "block"])
def test_kernels_across_windows_and_lb_jumps(path):
    """Walks of over 64 steps across several 32-row staged windows and a
    40-column LB jump, after either forward path."""
    _card()
    jobs = _jump_jobs()
    m_pad = _pad_to(max(A.shape[0] for A, *_ in jobs))
    n_pad = _pad_to(max(B.shape[0] for _, B, *_ in jobs))
    h = F.stack_host(jobs, m_pad, n_pad)
    assert F.full_plan(h["LB"], h["RB"], h["M"], m_pad, n_pad).path == "warp"
    nedit = _both("jump", path=path, jobs=jobs)
    assert int(nedit.min()) > 2 * F.TB_ROWS


def test_jump_jobs_cross_windows_on_the_warp_path():
    """The jump jobs of the card test above: valid yama bands, warp-path
    eligible, M past three staged windows, the LB jump inside."""
    from multiz_tpu_torch.yama import _check_band

    jobs = _jump_jobs()
    for A, B, LB, RB in jobs:
        _check_band(LB, RB, A.shape[0], B.shape[0])
        assert A.shape[0] > 3 * F.TB_ROWS and LB[50] - LB[49] == 41
    h = F.stack_host(jobs, 256, 512)
    plan = F.full_plan(h["LB"], h["RB"], h["M"], 256, 512)
    assert plan.path == "warp" and plan.window == 102


@pytest.mark.cuda
def test_entry_on_the_card_matches_cpu():
    """entry() on the card runs both kernels once and returns what
    entry("cpu") returns."""
    _card()
    from multiz_tpu_torch.entry import entry
    from multiz_tpu_torch.tools import reset_launches

    fn, args = entry("cpu")
    want = fn(*args)
    fn, args = entry("cuda")
    reset_launches()
    got = fn(*args)
    torch.cuda.synchronize()
    assert (F.yama_core.launches, F.traceback_core.launches) == (1, 1)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_packed_tools_pass_their_launch_checks_on_a_card(monkeypatch, capsys):
    """bench and shard_bench check their launches on the card (they raise
    where a kernel of the packed stream never launched) with the
    full-row counters at 0."""
    _card()
    from multiz_tpu_torch.tools import bench, shard_bench

    line = bench.measure("cuda", iters=1, jobs=bench.bench_jobs(48))
    assert min(line["launches"].values()) > 0
    monkeypatch.setenv("MZ_PIPE_REFLEN", "10000")
    monkeypatch.setenv("MZ_PIPE_SPECIES", "3")
    monkeypatch.setenv("MZ_PIPE_CONTIGS", "2")
    assert shard_bench.main(["--device", "cuda"]) == 0
    assert (F.yama_core.launches, F.traceback_core.launches) == (0, 0)
