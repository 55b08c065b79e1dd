"""The merge scan's block cuts in the port's native runtime
(``native/mzcore.cpp`` ``keep_cut``, ``part_cut``, ``nd_col``) held to
their numpy versions in ``multiz_tpu_torch/blocks.py`` (the module's
``_mzcore`` set to None): ``keep_ali``, ``make_part_ali_col`` and
``nd_col`` field for field on random dash-heavy blocks, a long block
truncated many times, a tba's MAF byte for byte, and the scan's
counters ``multiz.cut`` / ``multiz.cut-numpy``."""

import numpy as np
import pytest

from multiz_tpu_torch import blocks, maf, scores, trace
from multiz_tpu_torch.multiz import MultizConfig
from multiz_tpu_torch.ops import yama_pack as P
from multiz_tpu_torch.tree import tba_run

from .test_torch_trace import DATA, PAIRS, TREE

SP = scores.init_scores70()
BASES = np.frombuffer(b"ACGTacgtN", dtype=np.uint8)
N_BLOCKS = 300


@pytest.fixture(autouse=True)
def _native_built():
    assert blocks._mzcore is not None, "the native runtime did not build"


@pytest.fixture(autouse=True)
def _fresh_trace(monkeypatch):
    monkeypatch.delenv("MZ_TIME", raising=False)
    monkeypatch.setattr(trace, "on", False)  # restored after the test
    trace.reset()
    yield
    trace.reset()


def _block(seed: int, nrow: int | None = None, width: int | None = None,
           dash: float | None = None) -> maf.Ali:
    """A dash-heavy block of 1-6 rows, each holding a base, with whole
    all-dash columns and rows whose bases sit at one end (they vanish
    from a cut on the other side)."""
    rng = np.random.default_rng(seed)
    nrow = int(rng.integers(1, 7)) if nrow is None else nrow
    W = int(rng.integers(1, 400)) if width is None else width
    dash = rng.uniform(0.3, 0.9) if dash is None else dash
    T = rng.choice(BASES, size=(nrow, W))
    T[rng.random((nrow, W)) < dash] = maf.DASH
    T[:, rng.random(W) < 0.1] = maf.DASH  # all-dash columns
    for r in range(nrow):
        if rng.random() < 0.25:  # bases only near one end
            lo, hi = sorted(rng.integers(0, W + 1, size=2))
            T[r, :lo] = maf.DASH
            T[r, hi:] = maf.DASH
        if not (T[r] != maf.DASH).any():
            T[r, rng.integers(0, W)] = ord("A")
    out = maf.Ali(score=0.0)
    for r in range(nrow):
        text = T[r].copy()
        size = int(np.count_nonzero(text != maf.DASH))
        start = int(rng.integers(0, 10_000))
        strand = "+" if r == 0 or rng.random() < 0.5 else "-"
        out.comps.append(maf.Comp(f"sp{r}.chr1", start, size, strand,
                                  start + size + 10_000, text))
    return out


def _maps(a: maf.Ali, which: str, seed: int) -> maf.Ali:
    """Compute the rows' coordinate caches as ``which`` says: none, the
    position maps (all rows, or some), the top row's nd_idx, or both."""
    rng = np.random.default_rng(seed)
    for i, c in enumerate(a.comps):
        if which in ("pm", "both") or (which == "some" and rng.random() < .5):
            c.pos_map()
        if i == 0 and which in ("nd", "both"):
            c.nd_idx()
    return a


def _fields(a):
    if a is None:
        return None
    return [(c.src, c.start, c.size, c.strand, c.text.tobytes())
            for c in a.comps] + [a.score]


def _numpy(monkeypatch, fn, *args, **kw):
    with monkeypatch.context() as m:
        m.setattr(blocks, "_mzcore", None)
        return fn(*args, **kw)


def _cuts(rng, W):
    """(cbeg, cend) pairs: random, the first and last column, one
    column, the whole block."""
    out = [(0, W - 1), (0, 0), (W - 1, W - 1)]
    for _ in range(4):
        lo, hi = sorted(int(x) for x in rng.integers(0, W, size=2))
        out.append((lo, hi))
    return out


MAPS = ["none", "pm", "some", "nd", "both"]


@pytest.mark.parametrize("maps", MAPS)
def test_keep_ali_matches_numpy(maps, monkeypatch):
    n = 0
    for seed in range(N_BLOCKS):
        rng = np.random.default_rng(10_000 + seed)
        top = _block(seed).comps[0]
        ks = {0, top.size - 1, int(rng.integers(0, top.size))}
        for k in sorted(ks):
            tally = [0, 0]
            got = blocks.keep_ali(_maps(_block(seed), maps, seed),
                                  top.start + k, sp=SP, tally=tally)
            want = _numpy(monkeypatch, blocks.keep_ali, _block(seed),
                          top.start + k, sp=SP)
            assert tally == [0, 1]
            assert _fields(got) == _fields(want), (seed, k)
            n += len(want.comps) < len(_block(seed).comps)
    assert n > 50  # rows vanished in many cuts


@pytest.mark.parametrize("maps", MAPS)
def test_make_part_ali_col_matches_numpy(maps, monkeypatch):
    masked = dropped = 0
    for seed in range(N_BLOCKS):
        rng = np.random.default_rng(20_000 + seed)
        W = _block(seed).text_size
        for cbeg, cend in _cuts(rng, W) + [(W - 1, W - 2)]:
            tally = [0, 0]
            got = blocks.make_part_ali_col(_maps(_block(seed), maps, seed),
                                           cbeg, cend, sp=SP, tally=tally)
            want = _numpy(monkeypatch, blocks.make_part_ali_col,
                          _block(seed), cbeg, cend, sp=SP)
            assert tally == ([0, 0] if cend < cbeg else [0, 1])
            assert _fields(got) == _fields(want), (seed, cbeg, cend)
            if want is not None:
                masked += want.text_size < cend - cbeg + 1
                dropped += len(want.comps) < len(_block(seed).comps)
    assert masked > 50 and dropped > 50


@pytest.mark.parametrize("maps", MAPS)
def test_nd_col_matches_pos2col(maps):
    for seed in range(N_BLOCKS):
        a = _maps(_block(seed), maps, seed)
        for c in a.comps:
            nd = np.flatnonzero(c.text != maf.DASH)
            for k in {0, c.size - 1, c.size // 2, c.size}:
                tally = [0, 0]
                want = (len(c.text) if k == c.size
                        else maf.pos2col(c, c.start + k))
                assert blocks.nd_col(c, k, tally) == want == (
                    nd[k] if k < c.size else len(c.text))
                assert tally == [0, 1]
            # the scan's front flank: nd_col(c, k + 1) - 1 is the C's walk
            # right from the (k+1)-th base over the dash columns after it
            k = c.size // 2
            col = maf.pos2col(c, c.start + k)
            while col + 1 < len(c.text) and c.text[col + 1] == maf.DASH:
                col += 1
            assert blocks.nd_col(c, k + 1) - 1 == col


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("fn", ["keep_ali", "nd_col"])
def test_out_of_range_cuts_raise(fn, native, monkeypatch):
    if not native:
        monkeypatch.setattr(blocks, "_mzcore", None)
    a = _block(7)
    top = a.comps[0]
    with pytest.raises(ValueError):
        if fn == "keep_ali":
            blocks.keep_ali(a, top.start + top.size, sp=SP)
        else:
            blocks.nd_col(top, top.size + 1)
    with pytest.raises(ValueError):
        if fn == "keep_ali":
            blocks.keep_ali(a, top.start - 1, sp=SP)
        else:
            blocks.nd_col(top, -1)


@pytest.mark.parametrize("maps", ["none", "both"])
def test_long_block_truncated_200_times(maps, monkeypatch):
    """One block of 50,000 columns cut 200 times in turn, as the scan
    cuts a long block; each piece's flanks cut beside it."""
    rng = np.random.default_rng(5)
    got = _maps(_block(3, nrow=5, width=50_000, dash=0.4), maps, 3)
    want = _block(3, nrow=5, width=50_000, dash=0.4)
    tally = [0, 0]
    for step in range(200):
        top = want.comps[0]
        beg = top.start + int(rng.integers(1, max(2, top.size // 150)))
        if beg >= top.end:
            break
        got = blocks.keep_ali(got, beg, sp=SP, tally=tally)
        want = _numpy(monkeypatch, blocks.keep_ali, want, beg, sp=SP)
        assert _fields(got) == _fields(want), step
        W = want.text_size
        ce = int(rng.integers(0, W))
        assert _fields(blocks.make_part_ali_col(got, 0, ce, sp=SP)) == \
            _fields(_numpy(monkeypatch, blocks.make_part_ali_col,
                           want, 0, ce, sp=SP)), step
        if maps == "both":
            _maps(got, maps, step)
    assert tally == [0, 200] and want.text_size < 50_000


def _tba_maf():
    cfg = MultizConfig(batch_fn=P.batch_fn_for("cpu"))
    out = tba_run(TREE, PAIRS, src_dir=DATA, cfg=cfg, sp=SP)
    return "".join(maf.format_ali(a) for a in out)


@pytest.fixture(scope="module")
def numpy_tba_maf():
    """The golden five species' tba with the numpy cuts."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(blocks, "_mzcore", None)
        return _tba_maf()
    finally:
        mp.undo()


@pytest.mark.parametrize("mz_time", [False, True], ids=["off", "on"])
@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_tba_maf_and_cut_counters(native, mz_time, numpy_tba_maf,
                                  monkeypatch):
    if not native:
        monkeypatch.setattr(blocks, "_mzcore", None)
    if mz_time:
        monkeypatch.setenv("MZ_TIME", "1")
    assert _tba_maf() == numpy_tba_maf
    c = trace.counters()
    if not mz_time:
        assert c == {} and trace.spans() == []
        return
    cut, cut_numpy = c["multiz.cut"], c["multiz.cut-numpy"]
    if native:
        assert cut.count > 0 and cut_numpy.count == 0
    else:
        assert cut.count == 0 and cut_numpy.count > 0
    assert cut.seconds == cut_numpy.seconds == 0.0
