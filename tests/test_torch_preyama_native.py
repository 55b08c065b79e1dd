"""pre_yama's native plan and fold (``native/mzcore.cpp``
``preyama_plan1``, ``preyama_fold``) held to their numpy versions in
``multiz_tpu_torch/preyama.py`` (the module's ``_plan1`` / ``_fold`` set
to None): the v == 1 job field for field on random blocks, the fold's
Comps and score bit for bit, a tba's MAF byte for byte against a process
with ``MULTIZ_TPU_NO_NATIVE=1``, and the scan's counters
``preyama.native`` / ``preyama.numpy``."""

import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest

from multiz_tpu_torch import maf, preyama, scores, trace
from multiz_tpu_torch.multiz import MultizConfig
from multiz_tpu_torch.ops import yama_pack as P
from multiz_tpu_torch.tree import tba_run

from .test_torch_trace import DATA, PAIRS, TREE

SP = scores.init_scores70()
BASES = np.frombuffer(b"ACGTacgtN", dtype=np.uint8)
N_PAIRS = 150
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _native_built():
    assert preyama._plan1 is not None and preyama._fold is not None, \
        "the native runtime did not build"


@pytest.fixture(autouse=True)
def _fresh_trace(monkeypatch):
    monkeypatch.delenv("MZ_TIME", raising=False)
    monkeypatch.setattr(trace, "on", False)  # restored after the test
    trace.reset()
    yield
    trace.reset()


def _row(rng, W: int, dash: float) -> np.ndarray:
    """W columns of bases with dash runs."""
    t = rng.choice(BASES, size=W)
    c = 0
    while c < W:
        run = int(rng.geometric(0.25))
        if rng.random() < dash:
            t[c:c + run] = maf.DASH
        c += run
    return t


def _ali(rng, nrow: int, W: int, start: int, all_dash_cols: bool,
         ends: bool, src0: str) -> maf.Ali:
    """A block of nrow rows over W columns whose top row (``src0``)
    starts at ``start``; some columns all dash below the top row; with
    ``ends``, the top row holds a base in its first and last column."""
    T = np.stack([_row(rng, W, rng.uniform(0.1, 0.7)) for _ in range(nrow)])
    if all_dash_cols and nrow > 1:
        T[1:, rng.random(W) < 0.2] = maf.DASH
    if ends:
        T[0, 0] = T[0, -1] = ord("A")
    if not (T[0] != maf.DASH).any():
        T[0, rng.integers(0, W)] = ord("C")
    out = maf.Ali(score=0.0)
    for r in range(nrow):
        text = T[r].copy()
        size = int(np.count_nonzero(text != maf.DASH))
        s = start if r == 0 else int(rng.integers(0, 10_000))
        src = src0 if r == 0 else f"sp{r}.chr{int(rng.integers(1, 3))}"
        out.comps.append(maf.Comp(src, s, size,
                                  "+" if r == 0 or rng.random() < .5 else "-",
                                  s + size + 10_000, text,
                                  paralog="s" if rng.random() < .8 else "a"))
    return out


def _pair(seed: int):
    """(a1, a2, beg, end): two blocks whose top rows overlap on the
    reference; 1-8 rows a side; beg/end at random or on the overlap's
    first and last base, which can be a block's first and last column."""
    rng = np.random.default_rng(seed)
    K = int(rng.integers(1, 9))
    L1 = int(rng.integers(1, 9))  # a2's rows, its top row included
    ends = rng.random() < 0.3
    a1 = _ali(rng, K, int(rng.integers(1, 300)), 1000, False, ends,
              "human.chr1")
    s1, e1 = a1.comps[0].start, a1.comps[0].end
    s2 = int(rng.integers(max(0, s1 - 200), e1))
    a2 = _ali(rng, L1, int(rng.integers(1, 300)), s2, rng.random() < 0.5,
              ends, "human.chr1")
    if rng.random() < 0.1 and L1 > 1:  # every row of B all dash: N' = 0
        for c in a2.comps[1:]:
            c.text = np.full_like(c.text, maf.DASH)
    lo, hi = max(s1, s2), min(e1, a2.comps[0].end) - 1
    if lo > hi:
        return None
    if ends or rng.random() < 0.3:
        beg, end = lo, hi
    else:
        beg, end = sorted(int(x) for x in rng.integers(lo, hi + 1, size=2))
    if rng.random() < 0.3:  # current position maps on some rows
        for c in a1.comps + a2.comps:
            if rng.random() < 0.5:
                c.pos_map()
    return a1, a2, beg, end


def _comps_fields(a):
    """Every slot of every Comp (texts as bytes), and the score's bits."""
    if a is None:
        return None
    rows = []
    for c in a.comps:
        f = {}
        for s in maf.Comp.__slots__:
            v = getattr(c, s)  # raises where a slot is unset
            if s == "text":
                assert isinstance(v, np.ndarray) and v.dtype == np.uint8
                v = v.tobytes()
            f[s] = v
        rows.append(f)
    return rows, struct.pack("<d", a.score)


def _job_fields(job):
    return [(x.dtype, x.shape, x.flags.c_contiguous, x.flags.writeable,
             x.tobytes()) for x in job]


def _merge(A: np.ndarray, B: np.ndarray, rng) -> np.ndarray:
    """A merged (ncol, K + L) column matrix of A and B under a random
    edit script, as the DP returns."""
    (M, K), (N, L) = A.shape, B.shape
    ops = np.array([0] * M + [1] * N)
    rng.shuffle(ops)
    out, i, j = [], 0, 0
    for op in ops:
        if op == 0 and j < N and rng.random() < 0.5:  # a match
            out.append(np.concatenate([A[i], B[j]]))
            i, j = i + 1, j + 1
        elif op == 0 and i < M:
            out.append(np.concatenate([A[i], np.full(L, maf.DASH, np.uint8)]))
            i += 1
        elif j < N:
            out.append(np.concatenate([np.full(K, maf.DASH, np.uint8), B[j]]))
            j += 1
    while i < M:
        out.append(np.concatenate([A[i], np.full(L, maf.DASH, np.uint8)]))
        i += 1
    while j < N:
        out.append(np.concatenate([np.full(K, maf.DASH, np.uint8), B[j]]))
        j += 1
    return np.ascontiguousarray(np.stack(out))


def _drive(a1, a2, beg, end, radius, rng, tally):
    """pre_yama_gen at v == 1: its job, and the Ali folded from a merged
    matrix drawn from ``rng``."""
    gen = preyama.pre_yama_gen(a1, a2, beg, end, radius, 1, sp=SP,
                               tally=tally)
    try:
        job = next(gen)
    except StopIteration as e:
        return None, e.value
    try:
        gen.send(_merge(job[0], job[1], rng))
    except StopIteration as e:
        return job, e.value
    raise AssertionError("a v == 1 job yields once")


@pytest.mark.parametrize("radius", [0, 30])
def test_plan_matches_numpy(radius, monkeypatch):
    n = {"jobs": 0, "empty": 0, "vanished": 0, "ends": 0}
    for seed in range(N_PAIRS):
        case = _pair(seed)
        if case is None:
            continue
        a1, a2, beg, end = case
        tally = [0, 0]
        job, got = _drive(a1, a2, beg, end, radius,
                          np.random.default_rng(seed), tally)
        assert tally == [0, 1]
        with monkeypatch.context() as m:
            m.setattr(preyama, "_plan1", None)
            m.setattr(preyama, "_fold", None)
            tally = [0, 0]
            case = _pair(seed)
            job_np, want = _drive(*case, radius,
                                  np.random.default_rng(seed), tally)
            assert tally == [1, 0]
        assert (job is None) == (job_np is None), seed
        if job is None:
            n["empty"] += 1
            assert got is None and want is None
            continue
        n["jobs"] += 1
        assert _job_fields(job) == _job_fields(job_np), seed
        assert len(job[2]) == job[0].shape[0] + 1
        assert _comps_fields(got) == _comps_fields(want), seed
        if want is not None:
            n["vanished"] += len(want.comps) < len(a1.comps) + len(a2.comps) - 1
        top = a1.comps[0]
        n["ends"] += beg == top.start and top.text[0] != maf.DASH
    assert n["jobs"] > 60 and n["empty"] > 5 and n["ends"] > 5, n


def test_plan_of_a_long_job_releases_the_gil_and_matches_numpy(monkeypatch):
    """120,000 columns x 8 rows a side, past the size above which the
    plan runs without the GIL."""
    rng = np.random.default_rng(11)
    a1 = _ali(rng, 8, 120_000, 1000, False, True, "human.chr1")
    a2 = _ali(rng, 8, 120_000, 1000, True, True, "human.chr1")
    end = min(a1.comps[0].end, a2.comps[0].end) - 1
    job, got = _drive(a1, a2, 1000, end, 30, np.random.default_rng(1), None)
    with monkeypatch.context() as m:
        m.setattr(preyama, "_plan1", None)
        m.setattr(preyama, "_fold", None)
        job_np, want = _drive(a1, a2, 1000, end, 30,
                              np.random.default_rng(1), None)
    assert job[0].size > 500_000  # M x K alone
    assert _job_fields(job) == _job_fields(job_np)
    assert _comps_fields(got) == _comps_fields(want)


def test_plan_falls_back_where_a_text_is_not_contiguous(monkeypatch):
    case = None
    seed = 0
    while case is None or len(case[1].comps) < 2:
        seed += 1
        case = _pair(seed)
    a1, a2, beg, end = case
    wide = np.repeat(a2.comps[1].text, 2)
    a2.comps[1].text = wide[::2]  # equal bytes, strided
    assert preyama._plan1(a1.comps, a2.comps, beg, end, 30) is None
    tally = [0, 0]
    job, got = _drive(a1, a2, beg, end, 30, np.random.default_rng(seed),
                      tally)
    assert tally == [1, 0]
    monkeypatch.setattr(preyama, "_plan1", None)
    monkeypatch.setattr(preyama, "_fold", None)
    job_np, want = _drive(a1, a2, beg, end, 30, np.random.default_rng(seed),
                          None)
    assert _comps_fields(got) == _comps_fields(want)


def _fold_case(seed: int, top: int):
    """(A_new, a2, cbeg2, a3, cbeg3): templates of 1-8 rows a side, a
    merged matrix whose rows vanish at random, cuts anywhere in the
    templates, position maps on some of them."""
    rng = np.random.default_rng(seed)
    a2 = _ali(rng, int(rng.integers(1, 9)), int(rng.integers(1, 200)), 500,
              False, False, "human.chr1")
    a3 = _ali(rng, int(rng.integers(1 if top else 2, 9)),
              int(rng.integers(1, 200)), 700, False, False, "human.chr1")
    nrow = len(a2.comps) + len(a3.comps) - (1 - top)
    ncol = int(rng.integers(1, 300))
    A_new = np.stack([_row(rng, ncol, rng.uniform(0.1, 0.8))
                      for _ in range(nrow)], axis=1)
    A_new[:, rng.random(nrow) < 0.25] = maf.DASH  # rows that vanish
    if rng.random() < 0.05:
        A_new[:] = maf.DASH  # every row: no block
    for c in a2.comps + a3.comps:
        if rng.random() < 0.3:
            c.pos_map()
    cbeg2 = int(rng.integers(0, a2.text_size + 1))
    cbeg3 = int(rng.integers(0, a3.text_size + 1))
    return np.ascontiguousarray(A_new), a2, cbeg2, a3, cbeg3


@pytest.mark.parametrize("top", [0, 1])
def test_fold_matches_maf_build_numpy(top):
    n = {"none": 0, "vanished": 0, "one": 0}
    for seed in range(2 * N_PAIRS):
        A_new, a2, cbeg2, a3, cbeg3 = _fold_case(seed, top)
        got = preyama.maf_build(A_new, a2, cbeg2, a3, cbeg3, top, sp=SP)
        want = preyama._maf_build_numpy(A_new, a2, cbeg2, a3, cbeg3, top,
                                        SP)
        assert _comps_fields(got) == _comps_fields(want), seed
        if want is None:
            n["none"] += 1
            continue
        n["vanished"] += len(want.comps) < A_new.shape[1]
        n["one"] += len(want.comps) == 1
        for c in got.comps:  # each text is a view of a fresh buffer
            assert not np.shares_memory(c.text, A_new)
            for d in a2.comps + a3.comps:
                assert not np.shares_memory(c.text, d.text)
    assert n["vanished"] > 100 and n["none"] > 0 and n["one"] > 0, n


def test_fold_falls_back_on_a_fortran_matrix():
    A_new, a2, cbeg2, a3, cbeg3 = _fold_case(3, 0)
    F = np.asfortranarray(A_new)
    assert preyama._fold(F, np.empty(F.shape[::-1], np.uint8), a2.comps,
                         cbeg2, a3.comps, 1, cbeg3, SP.ss, SP.gop) is None
    assert _comps_fields(preyama.maf_build(F, a2, cbeg2, a3, cbeg3, 0,
                                           sp=SP)) == \
        _comps_fields(preyama._maf_build_numpy(A_new, a2, cbeg2, a3, cbeg3,
                                               0, SP))


_NO_NATIVE_TBA = """
import json, sys
from multiz_tpu_torch import maf, preyama, scores, trace
from multiz_tpu_torch.multiz import MultizConfig
from multiz_tpu_torch.ops import yama_pack as P
from multiz_tpu_torch.tree import tba_run
assert preyama._mzcore is None and preyama._plan1 is None
out = tba_run({tree!r}, {pairs!r}, src_dir={data!r},
              cfg=MultizConfig(batch_fn=P.batch_fn_for("cpu")),
              sp=scores.init_scores70())
c = trace.counters()
with open(sys.argv[1], "w") as f:
    json.dump({{"maf": "".join(maf.format_ali(a) for a in out),
               "counts": {{k: c[k].count for k in c}}}}, f)
"""


@pytest.fixture(scope="module")
def no_native_tba(tmp_path_factory):
    """The golden five species' tba (8 kb) in a process with
    ``MULTIZ_TPU_NO_NATIVE=1`` and ``MZ_TIME`` set: its MAF and
    counters."""
    out = tmp_path_factory.mktemp("no_native") / "tba.json"
    env = dict(os.environ, MULTIZ_TPU_NO_NATIVE="1", MZ_TIME="1",
               PYTHONPATH=ROOT)
    code = _NO_NATIVE_TBA.format(tree=TREE, pairs=PAIRS, data=DATA)
    subprocess.run([sys.executable, "-c", code, str(out)], env=env, cwd=ROOT,
                   check=True, timeout=600, capture_output=True)
    return json.loads(out.read_text())


def test_no_native_process_plans_every_job_in_numpy(no_native_tba):
    c = no_native_tba["counts"]
    assert c["preyama.numpy"] == c["preyama.plan"] > 100
    assert c["preyama.native"] == 0


@pytest.mark.parametrize("mz_time", [False, True], ids=["off", "on"])
@pytest.mark.parametrize("plan", ["native", "numpy"])
def test_tba_maf_and_plan_counters(plan, mz_time, no_native_tba,
                                   monkeypatch):
    """The tba's MAF equals the no-native process's byte for byte, with
    pre_yama native (every job counted under ``preyama.native``) or its
    numpy plan and fold in this process."""
    if plan == "numpy":
        monkeypatch.setattr(preyama, "_plan1", None)
        monkeypatch.setattr(preyama, "_fold", None)
    if mz_time:
        monkeypatch.setenv("MZ_TIME", "1")
    cfg = MultizConfig(batch_fn=P.batch_fn_for("cpu"))
    out = tba_run(TREE, PAIRS, src_dir=DATA, cfg=cfg, sp=SP)
    assert "".join(maf.format_ali(a) for a in out) == no_native_tba["maf"]
    c = trace.counters()
    if not mz_time:
        assert c == {} and trace.spans() == []
        return
    jobs = c["preyama.plan"].count
    assert jobs == no_native_tba["counts"]["preyama.plan"]
    native, numpy_ = c["preyama.native"], c["preyama.numpy"]
    assert (native.count, numpy_.count) == (
        (jobs, 0) if plan == "native" else (0, jobs))
    assert native.seconds == numpy_.seconds == 0.0
