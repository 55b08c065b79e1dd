"""The traffic generators repeat per seed, differ across seeds, take any
whole-number seed, and the DP pool has the shapes a tba plans, cut into
the same calls for every seed."""

import filecmp
import json
import os

import numpy as np
import pytest

from mzbench import harness, work
from mzbench.traffic import dp_pool, tba_region

MIX = json.load(open(os.path.join(harness.HERE, "traffic", "dp_batches.json")))
CONF = json.load(open(os.path.join(harness.HERE, "configs",
                                   "encode_5sp.json")))


def region(tmp_path, seed, name):
    d = tmp_path / name
    d.mkdir()
    return tba_region.make(CONF, 8000, seed, 1, str(d))


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**40 + 3, -12])
def test_region_repeats_per_seed(tmp_path, seed):
    a = region(tmp_path, seed, "a")
    b = region(tmp_path, seed, "b")
    names = sorted(os.listdir(a["src_dir"]))
    assert names == sorted(os.listdir(b["src_dir"]))
    assert len(names) == 2 * len(CONF["species"]) + 1  # FASTAs, pairs
    match, mismatch, errors = filecmp.cmpfiles(a["src_dir"], b["src_dir"],
                                               names, shallow=False)
    assert not mismatch and not errors
    assert a["tree"] == "((((human chimp) gorilla) orang) baboon)"


def test_region_differs_across_seeds(tmp_path):
    a = region(tmp_path, 1, "a")
    b = region(tmp_path, 2, "b")
    pair = a["pairs"][0]
    assert not filecmp.cmp(os.path.join(a["src_dir"], pair),
                           os.path.join(b["src_dir"], pair), shallow=False)


def small_mix(n):
    return dict(MIX, pool_jobs=n)


@pytest.mark.parametrize("seed", [3, 2**35 + 1, -4])
def test_pool_repeats_per_seed(seed):
    a = dp_pool.make(small_mix(40), seed)
    b = dp_pool.make(small_mix(40), seed)
    for x, y in zip(a, b):
        assert all(np.array_equal(u, v) for u, v in zip(x, y))


def test_pool_differs_across_seeds():
    a = dp_pool.make(small_mix(40), 1)
    b = dp_pool.make(small_mix(40), 2)
    assert any(x[0].shape != y[0].shape for x, y in zip(a, b))
    assert any(x[0].shape == y[0].shape and not np.array_equal(x[0], y[0])
               for x in a for y in b)


def call_shapes(jobs, calls):
    return sorted(sorted((jobs[i][0].shape, jobs[i][1].shape) for i in c)
                  for c in calls)


@pytest.mark.parametrize("seed", [1, 2**40 + 3, -12])
def test_every_seed_gets_the_same_calls(seed):
    """The same calls, shape for shape, for every seed: the seed changes
    their order and the texts, not the work."""
    mix = dict(small_mix(60), call_cells=60000)
    a, ca = dp_pool.make_calls(mix, 7)
    b, cb = dp_pool.make_calls(mix, seed)
    assert len(ca) > 2
    assert call_shapes(a, ca) == call_shapes(b, cb)
    for jobs, calls in ((a, ca), (b, cb)):
        cells = [work.band_cells(j) for j in jobs]
        assert sorted(i for c in calls for i in c) == list(range(len(jobs)))
        for c in calls:
            assert sum(cells[i] for i in c) >= 60000
            assert min(sum(cells[i] for i in c) - cells[i] for i in c) < 60000


@pytest.fixture(scope="module")
def pool():
    return dp_pool.make(MIX, 20261017)


def test_pool_shapes_match_a_tba_plan(pool):
    """The 500 kb x 5-species tba's job shapes (M's quantiles, K's
    shares, N = M +- 3, L = 1, radius 30)."""
    M = np.array([j[0].shape[0] for j in pool])
    N = np.array([j[1].shape[0] for j in pool])
    K = np.array([j[0].shape[1] for j in pool])
    for q, want in [(5, 7), (25, 35), (50, 78), (75, 149), (95, 312),
                    (99, 508)]:
        got = np.percentile(M, q)
        assert abs(got - want) <= 0.12 * want + 1, (q, got, want)
    assert M.max() <= 754
    assert np.all(np.abs(N - M) <= 3) and np.all(N >= 1)
    assert all(j[1].shape[1] == 1 for j in pool)
    shares = np.bincount(K, minlength=5)[1:] / len(K)
    assert np.allclose(shares, [0.139, 0.378, 0.348, 0.136], atol=0.02)
    mean_cells = np.mean([work.band_cells(j) for j in pool])
    assert 4500 < mean_cells < 7500  # the tba's 5,848 a job


def test_pool_bands_are_valid(pool):
    from mzbench.frozen.yama import _check_band

    for A, B, LB, RB in pool[:500]:
        _check_band(LB, RB, A.shape[0], B.shape[0])
        assert np.all(RB[: A.shape[0] + 1] - LB[: A.shape[0] + 1] <= 70)


def test_calls_take_the_pool_in_order_and_wrap():
    mix = dict(small_mix(30), call_cells=40000)
    ctx = harness.Ctx({"cell": {}, "config": {}, "mix": mix}, 5, "cpu", "")
    from mzbench.entries.dp_batch import Entry

    e = Entry(ctx)
    e.pool, e.calls = dp_pool.make_calls(mix, 5)
    e.cells = [work.band_cells(j) for j in e.pool]
    e.cursor = 0
    seen = []
    for _ in range(3 * len(e.calls)):
        idx = e._next()
        assert sum(e.cells[i] for i in idx) >= 40000
        seen += idx
    n = len(e.pool)
    assert n <= 30
    assert seen == [i % n for i in range(len(seen))]
