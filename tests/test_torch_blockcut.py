"""The merge scan's block cuts in the port's native runtime
(``native/mzcore.cpp`` ``keep_cut``, ``part_cut``, ``nd_col``) held to
the JAX package's numpy block algebra (``multiz_tpu/blocks.py``):
``keep_ali``, ``make_part_ali_col`` and ``nd_col`` field for field on
random dash-heavy blocks, a long block truncated many times, cuts that
leave the block, and a tba's MAF byte for byte against the JAX
package's, on its native runtime and on its numpy code.

Only numpy arrays, strings and files cross between the packages: each
block is built in both from the same arrays."""

import functools

import numpy as np
import pytest

from multiz_tpu import blocks as jblocks
from multiz_tpu import maf as jmaf
from multiz_tpu import preyama as jpreyama
from multiz_tpu import scores as jscores
from multiz_tpu import yama as jyama
from multiz_tpu.multiz import MultizConfig as JConfig
from multiz_tpu.tree import tba_run as jtba_run
from multiz_tpu_torch import blocks, maf, scores, trace
from multiz_tpu_torch.multiz import MultizConfig
from multiz_tpu_torch.ops import yama_pack as P
from multiz_tpu_torch.tree import tba_run

from .test_torch_trace import DATA, PAIRS, TREE

SP = scores.init_scores70()
JSP = jscores.init_scores70()
BASES = np.frombuffer(b"ACGTacgtN", dtype=np.uint8)
N_BLOCKS = 300
REFS = ["jax-native", "jax-numpy"]


def jax_reference(monkeypatch, ref: str) -> None:
    """The JAX package's host layer on its native runtime
    (``jax-native``) or on its numpy code (``jax-numpy``: its native
    handles set to None until the test ends)."""
    if ref == "jax-numpy":
        for mod, names in ((jyama, ("_mzcore",)),
                           (jpreyama, ("_mzcore", "_prep1", "_smooth_nat")),
                           (jscores, ("_mzcore_score",))):
            for name in names:
                monkeypatch.setattr(mod, name, None)
    elif jyama._mzcore is None:
        pytest.skip("the JAX package's native runtime did not build")


@functools.lru_cache(maxsize=None)
def jax_tba_maf(ref: str) -> str:
    """The golden five species' tba by the JAX package, inline on the
    host, on its native runtime or its numpy code."""
    mp = pytest.MonkeyPatch()
    try:
        jax_reference(mp, ref)
        out = jtba_run(TREE, PAIRS, src_dir=DATA, cfg=JConfig(),
                       sp=jscores.init_scores70())
        return "".join(jmaf.format_ali(a) for a in out)
    finally:
        mp.undo()


@pytest.fixture(autouse=True)
def _fresh_trace(monkeypatch):
    monkeypatch.delenv("MZ_TIME", raising=False)
    monkeypatch.setattr(trace, "on", False)  # restored after the test
    trace.reset()
    yield
    trace.reset()


def _block(seed: int, nrow: int | None = None, width: int | None = None,
           dash: float | None = None, M=maf):
    """A dash-heavy block of 1-6 rows, each holding a base, with whole
    all-dash columns and rows whose bases sit at one end (they vanish
    from a cut on the other side); an Ali of the package whose maf
    module is ``M``."""
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
    out = M.Ali(score=0.0)
    for r in range(nrow):
        text = T[r].copy()
        size = int(np.count_nonzero(text != maf.DASH))
        start = int(rng.integers(0, 10_000))
        strand = "+" if r == 0 or rng.random() < 0.5 else "-"
        out.comps.append(M.Comp(f"sp{r}.chr1", start, size, strand,
                                start + size + 10_000, text))
    return out


def _jblock(seed: int, **kw):
    """_block's block in the JAX package."""
    return _block(seed, M=jmaf, **kw)


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
def test_keep_ali_matches_numpy(maps):
    n = 0
    for seed in range(N_BLOCKS):
        rng = np.random.default_rng(10_000 + seed)
        top = _block(seed).comps[0]
        ks = {0, top.size - 1, int(rng.integers(0, top.size))}
        for k in sorted(ks):
            got = blocks.keep_ali(_maps(_block(seed), maps, seed),
                                  top.start + k, sp=SP)
            want = jblocks.keep_ali(_jblock(seed), top.start + k, sp=JSP)
            assert _fields(got) == _fields(want), (seed, k)
            n += len(want.comps) < len(_block(seed).comps)
    assert n > 50  # rows vanished in many cuts


@pytest.mark.parametrize("maps", MAPS)
def test_make_part_ali_col_matches_numpy(maps):
    masked = dropped = 0
    for seed in range(N_BLOCKS):
        rng = np.random.default_rng(20_000 + seed)
        W = _block(seed).text_size
        for cbeg, cend in _cuts(rng, W) + [(W - 1, W - 2)]:
            got = blocks.make_part_ali_col(_maps(_block(seed), maps, seed),
                                           cbeg, cend, sp=SP)
            want = jblocks.make_part_ali_col(_jblock(seed), cbeg, cend,
                                             sp=JSP)
            assert _fields(got) == _fields(want), (seed, cbeg, cend)
            if want is not None:
                masked += want.text_size < cend - cbeg + 1
                dropped += len(want.comps) < len(_block(seed).comps)
    assert masked > 50 and dropped > 50


@pytest.mark.parametrize("maps", MAPS)
def test_nd_col_matches_pos2col(maps):
    """nd_col against the JAX package's pos2col."""
    for seed in range(N_BLOCKS):
        a = _maps(_block(seed), maps, seed)
        for c, jc in zip(a.comps, _jblock(seed).comps):
            nd = np.flatnonzero(c.text != maf.DASH)
            for k in {0, c.size - 1, c.size // 2, c.size}:
                want = (len(c.text) if k == c.size
                        else jmaf.pos2col(jc, jc.start + k))
                assert blocks.nd_col(c, k) == want == (
                    nd[k] if k < c.size else len(c.text))
            # the scan's front flank: nd_col(c, k + 1) - 1 is the C's walk
            # right from the (k+1)-th base over the dash columns after it
            k = c.size // 2
            col = jmaf.pos2col(jc, jc.start + k)
            while col + 1 < len(c.text) and c.text[col + 1] == maf.DASH:
                col += 1
            assert blocks.nd_col(c, k + 1) - 1 == col


@pytest.mark.parametrize("ref", REFS)
@pytest.mark.parametrize("fn", ["keep_ali", "nd_col"])
def test_out_of_range_cuts_raise(fn, ref, monkeypatch):
    """A cut past either end of the top row raises ValueError in the
    port, as its counterpart does in the JAX package (``keep_ali``;
    ``pos2col`` for ``nd_col``)."""
    jax_reference(monkeypatch, ref)
    a, ja = _block(7), _jblock(7)
    top, jtop = a.comps[0], ja.comps[0]
    for k in (top.size, -1) if fn == "keep_ali" else (top.size + 1, -1):
        with pytest.raises(ValueError):
            if fn == "keep_ali":
                jblocks.keep_ali(ja, jtop.start + k, sp=JSP)
            else:
                jmaf.pos2col(jtop, jtop.start + k)
        with pytest.raises(ValueError):
            if fn == "keep_ali":
                blocks.keep_ali(a, top.start + k, sp=SP)
            else:
                blocks.nd_col(top, k)


@pytest.mark.parametrize("maps", ["none", "both"])
def test_long_block_truncated_200_times(maps):
    """One block of 50,000 columns cut 200 times in turn, as the scan
    cuts a long block; each piece's flanks cut beside it."""
    rng = np.random.default_rng(5)
    got = _maps(_block(3, nrow=5, width=50_000, dash=0.4), maps, 3)
    want = _jblock(3, nrow=5, width=50_000, dash=0.4)
    for step in range(200):
        top = want.comps[0]
        beg = top.start + int(rng.integers(1, max(2, top.size // 150)))
        if beg >= top.end:
            break
        got = blocks.keep_ali(got, beg, sp=SP)
        want = jblocks.keep_ali(want, beg, sp=JSP)
        assert _fields(got) == _fields(want), step
        W = want.text_size
        ce = int(rng.integers(0, W))
        assert _fields(blocks.make_part_ali_col(got, 0, ce, sp=SP)) == \
            _fields(jblocks.make_part_ali_col(want, 0, ce, sp=JSP)), step
        if maps == "both":
            _maps(got, maps, step)
    assert step == 199 and want.text_size < 50_000


def _tba_maf():
    cfg = MultizConfig(batch_fn=P.batch_fn_for("cpu"))
    out = tba_run(TREE, PAIRS, src_dir=DATA, cfg=cfg, sp=SP)
    return "".join(maf.format_ali(a) for a in out)


@pytest.mark.parametrize("mz_time", [False, True], ids=["off", "on"])
@pytest.mark.parametrize("ref", REFS)
def test_tba_maf_and_scan_spans(ref, mz_time, monkeypatch):
    """The port's tba equals the JAX package's byte for byte; with
    ``MZ_TIME`` set it records the merge scan's span, else nothing."""
    want = jax_tba_maf(ref)
    if mz_time:
        monkeypatch.setenv("MZ_TIME", "1")
    assert _tba_maf() == want
    if not mz_time:
        assert trace.counters() == {} and trace.spans() == []
        return
    assert any(s.name == "multiz.scan" for s in trace.spans())
