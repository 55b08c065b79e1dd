"""pre_yama's native plan and fold (``native/mzcore.cpp``
``preyama_plan1``, ``preyama_fold``) held to the JAX package's numpy
pre_yama (``multiz_tpu/preyama.py`` with its native handles set to
None): the v == 1 job field for field on random blocks, the fold's
Comps and score bit for bit, a strided text and a Fortran-ordered
matrix on the same native path, a tba's MAF byte for byte against the
JAX package's and the scan's counters ``preyama.plan`` /
``preyama.fold``; and a failed build of the runtime, which raises with
the compiler's message.

Only numpy arrays, strings and files cross between the packages: each
block is built in both from the same seed."""

import struct
import subprocess

import numpy as np
import pytest

from multiz_tpu import maf as jmaf
from multiz_tpu import preyama as jpreyama
from multiz_tpu import scores as jscores
from multiz_tpu_torch import maf, native, preyama, scores, trace
from multiz_tpu_torch.multiz import MultizConfig
from multiz_tpu_torch.ops import yama_pack as P
from multiz_tpu_torch.tree import tba_run

from .test_torch_blockcut import REFS, jax_reference, jax_tba_maf
from .test_torch_trace import DATA, PAIRS, TREE

SP = scores.init_scores70()
JSP = jscores.init_scores70()
BASES = np.frombuffer(b"ACGTacgtN", dtype=np.uint8)
N_PAIRS = 150


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
         ends: bool, src0: str, M=maf):
    """A block of nrow rows over W columns whose top row (``src0``)
    starts at ``start``; some columns all dash below the top row; with
    ``ends``, the top row holds a base in its first and last column. An
    Ali of the package whose maf module is ``M``."""
    T = np.stack([_row(rng, W, rng.uniform(0.1, 0.7)) for _ in range(nrow)])
    if all_dash_cols and nrow > 1:
        T[1:, rng.random(W) < 0.2] = maf.DASH
    if ends:
        T[0, 0] = T[0, -1] = ord("A")
    if not (T[0] != maf.DASH).any():
        T[0, rng.integers(0, W)] = ord("C")
    out = M.Ali(score=0.0)
    for r in range(nrow):
        text = T[r].copy()
        size = int(np.count_nonzero(text != maf.DASH))
        s = start if r == 0 else int(rng.integers(0, 10_000))
        src = src0 if r == 0 else f"sp{r}.chr{int(rng.integers(1, 3))}"
        out.comps.append(M.Comp(src, s, size,
                                "+" if r == 0 or rng.random() < .5 else "-",
                                s + size + 10_000, text,
                                paralog="s" if rng.random() < .8 else "a"))
    return out


def _pair(seed: int, M=maf):
    """(a1, a2, beg, end): two blocks whose top rows overlap on the
    reference; 1-8 rows a side; beg/end at random or on the overlap's
    first and last base, which can be a block's first and last column."""
    rng = np.random.default_rng(seed)
    K = int(rng.integers(1, 9))
    L1 = int(rng.integers(1, 9))  # a2's rows, its top row included
    ends = rng.random() < 0.3
    a1 = _ali(rng, K, int(rng.integers(1, 300)), 1000, False, ends,
              "human.chr1", M)
    s1, e1 = a1.comps[0].start, a1.comps[0].end
    s2 = int(rng.integers(max(0, s1 - 200), e1))
    a2 = _ali(rng, L1, int(rng.integers(1, 300)), s2, rng.random() < 0.5,
              ends, "human.chr1", M)
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
    return [(x.dtype, x.shape, x.tobytes()) for x in job]


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


def _drive(a1, a2, beg, end, radius, rng, pkg=preyama):
    """pre_yama_gen of ``pkg`` (the port's or the JAX package's
    preyama) at v == 1: its job, and the Ali folded from a merged matrix
    drawn from ``rng``."""
    gen = pkg.pre_yama_gen(a1, a2, beg, end, radius, 1,
                           sp=SP if pkg is preyama else JSP)
    try:
        job = next(gen)
    except StopIteration as e:
        return None, e.value
    if pkg is preyama:  # the stream packs the arrays as they are
        assert all(x.flags.c_contiguous and x.flags.writeable for x in job)
    try:
        gen.send(_merge(job[0], job[1], rng))
    except StopIteration as e:
        return job, e.value
    raise AssertionError("a v == 1 job yields once")


def _jdrive(seed, radius, a1, a2, beg, end):
    """_drive on the JAX package's copy of the same blocks."""
    return _drive(a1, a2, beg, end, radius, np.random.default_rng(seed),
                  pkg=jpreyama)


@pytest.mark.parametrize("radius", [0, 30])
def test_plan_matches_numpy(radius, monkeypatch):
    jax_reference(monkeypatch, "jax-numpy")
    n = {"jobs": 0, "empty": 0, "vanished": 0, "ends": 0}
    for seed in range(N_PAIRS):
        case = _pair(seed)
        if case is None:
            continue
        a1, a2, beg, end = case
        job, got = _drive(a1, a2, beg, end, radius,
                          np.random.default_rng(seed))
        job_j, want = _jdrive(seed, radius, *_pair(seed, jmaf))
        assert (job is None) == (job_j is None), seed
        if job is None:
            n["empty"] += 1
            assert got is None and want is None
            continue
        n["jobs"] += 1
        assert _job_fields(job) == _job_fields(job_j), seed
        assert len(job[2]) == job[0].shape[0] + 1
        assert _comps_fields(got) == _comps_fields(want), seed
        if want is not None:
            n["vanished"] += len(want.comps) < len(a1.comps) + len(a2.comps) - 1
        top = a1.comps[0]
        n["ends"] += beg == top.start and top.text[0] != maf.DASH
    assert n["jobs"] > 60 and n["empty"] > 5 and n["ends"] > 5, n


def _long_pair(M):
    rng = np.random.default_rng(11)
    a1 = _ali(rng, 8, 120_000, 1000, False, True, "human.chr1", M)
    a2 = _ali(rng, 8, 120_000, 1000, True, True, "human.chr1", M)
    end = min(a1.comps[0].end, a2.comps[0].end) - 1
    return a1, a2, 1000, end


def test_plan_of_a_long_job_releases_the_gil_and_matches_numpy(
        monkeypatch):
    """120,000 columns x 8 rows a side, past the size above which the
    plan runs without the GIL."""
    jax_reference(monkeypatch, "jax-numpy")
    job, got = _drive(*_long_pair(maf), 30, np.random.default_rng(1))
    job_j, want = _jdrive(1, 30, *_long_pair(jmaf))
    assert job[0].size > 500_000  # M x K alone
    assert _job_fields(job) == _job_fields(job_j)
    assert _comps_fields(got) == _comps_fields(want)


def _strided(a):
    """a's second row's text replaced by a strided view of equal bytes."""
    wide = np.repeat(a.comps[1].text, 2)
    a.comps[1].text = wide[::2]
    assert not a.comps[1].text.flags.c_contiguous
    return a


@pytest.mark.parametrize("ref", REFS)
def test_plan_of_a_strided_text_matches_the_jax_package(ref, monkeypatch):
    """A text that is a strided view takes the native plan (read through
    its strides) and gives the JAX package's job and block."""
    jax_reference(monkeypatch, ref)
    seeds = [s for s in range(1, 200)
             if (c := _pair(s)) is not None and len(c[1].comps) >= 2]
    for seed in seeds[:20]:
        a1, a2, beg, end = _pair(seed)
        job, got = _drive(a1, _strided(a2), beg, end, 30,
                          np.random.default_rng(seed))
        ja1, ja2, _, _ = _pair(seed, jmaf)
        job_j, want = _jdrive(seed, 30, ja1, _strided(ja2), beg, end)
        assert (job is None) == (job_j is None), seed
        if job is not None:
            assert _job_fields(job) == _job_fields(job_j), seed
        assert _comps_fields(got) == _comps_fields(want), seed


def _fold_case(seed: int, top: int, M=maf):
    """(A_new, a2, cbeg2, a3, cbeg3): templates of 1-8 rows a side, a
    merged matrix whose rows vanish at random, cuts anywhere in the
    templates, position maps on some of them."""
    rng = np.random.default_rng(seed)
    a2 = _ali(rng, int(rng.integers(1, 9)), int(rng.integers(1, 200)), 500,
              False, False, "human.chr1", M)
    a3 = _ali(rng, int(rng.integers(1 if top else 2, 9)),
              int(rng.integers(1, 200)), 700, False, False, "human.chr1", M)
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


def _jfold(seed: int, top: int) -> tuple:
    """The JAX package's maf_build of _fold_case(seed, top)."""
    A_new, a2, cbeg2, a3, cbeg3 = _fold_case(seed, top, jmaf)
    return A_new, jpreyama.maf_build(A_new, a2, cbeg2, a3, cbeg3, top,
                                     sp=JSP)


@pytest.mark.parametrize("top", [0, 1])
def test_fold_matches_the_jax_package(top, monkeypatch):
    jax_reference(monkeypatch, "jax-numpy")
    n = {"none": 0, "vanished": 0, "one": 0}
    for seed in range(2 * N_PAIRS):
        A_new, a2, cbeg2, a3, cbeg3 = _fold_case(seed, top)
        got = preyama.maf_build(A_new, a2, cbeg2, a3, cbeg3, top, sp=SP)
        want = _jfold(seed, top)[1]
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


@pytest.mark.parametrize("ref", REFS)
def test_fold_of_a_fortran_matrix_matches_the_jax_package(ref, monkeypatch):
    """A merged matrix in Fortran order takes the native fold (copied to
    C order first) and gives the JAX package's block."""
    jax_reference(monkeypatch, ref)
    for seed in range(3, 13):
        A_new, a2, cbeg2, a3, cbeg3 = _fold_case(seed, 0)
        F = np.asfortranarray(A_new)
        assert not F.flags.c_contiguous or F.shape[1] == 1
        got = preyama.maf_build(F, a2, cbeg2, a3, cbeg3, 0, sp=SP)
        assert _comps_fields(got) == _comps_fields(_jfold(seed, 0)[1]), seed


@pytest.mark.parametrize("how", ["compile-error", "no-compiler"])
def test_a_failed_build_raises_with_the_compilers_message(
        how, monkeypatch, tmp_path):
    """``native.load()`` never returns None: a compile that fails (faked
    here in-process, into a library path of this test's own; the load
    uncached, ``load.__wrapped__``) raises RuntimeError with g++'s
    message, or with the error of a missing compiler. The shared library
    under ``_build/`` is not touched."""

    def run(cmd, **kw):
        assert cmd[0] == "g++" and cmd[-1].startswith(str(tmp_path))
        if how == "no-compiler":
            raise FileNotFoundError(2, "No such file or directory", "g++")
        return subprocess.CompletedProcess(
            cmd, 1, b"", b"mzcore.cpp:1:1: error: a faked compile error\n")

    monkeypatch.setattr(native, "_so_path",
                        lambda: str(tmp_path / "_mzcore.so"))
    monkeypatch.setattr(native.subprocess, "run", run)
    want = ("a faked compile error" if how == "compile-error"
            else "No such file or directory")
    with pytest.raises(RuntimeError, match=want):
        native.load.__wrapped__()
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("mz_time", [False, True], ids=["off", "on"])
@pytest.mark.parametrize("ref", REFS)
def test_tba_maf_and_plan_counters(ref, mz_time, monkeypatch):
    """The tba's MAF equals the JAX package's byte for byte, on its
    native runtime or its numpy code; with ``MZ_TIME`` set every job's
    plan and fold are counted (``preyama.plan``, ``preyama.fold``)."""
    want = jax_tba_maf(ref)
    if mz_time:
        monkeypatch.setenv("MZ_TIME", "1")
    cfg = MultizConfig(batch_fn=P.batch_fn_for("cpu"))
    out = tba_run(TREE, PAIRS, src_dir=DATA, cfg=cfg, sp=SP)
    assert "".join(maf.format_ali(a) for a in out) == want
    c = trace.counters()
    if not mz_time:
        assert c == {} and trace.spans() == []
        return
    plan, fold = c["preyama.plan"], c["preyama.fold"]
    assert plan.count > 100 and 0 < fold.count <= plan.count
    assert plan.seconds > 0 and fold.seconds > 0
