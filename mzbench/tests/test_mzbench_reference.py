"""The reference agrees with yama itself (the frozen numpy oracle) and
with the port on the CPU at tiny sizes; its int16 control does not."""

import json
import os

import numpy as np
import pytest
import torch

from mzbench import harness
from mzbench.control import CONTROL
from mzbench.frozen import scores as fsc
from mzbench.frozen import synth
from mzbench.frozen import yama as fyama
from mzbench.reference import dp
from mzbench.reference import tba as rtba
from mzbench.traffic import dp_pool, tba_region

SP = fsc.init_scores70()


def edge_jobs():
    rng = np.random.default_rng(3)
    jobs = []
    for (M, N, K, L, R) in [(1, 1, 1, 1, 4), (1, 5, 2, 3, 4), (2, 1, 3, 1, 4),
                            (40, 3, 2, 2, 4), (11, 11, 4, 4, 4),
                            (300, 290, 3, 1, 30), (64, 200, 1, 2, 30)]:
        A, B = synth.synth_block(rng, M, K), synth.synth_block(rng, N, L)
        LB, RB = synth.diag_band(M, N, R)
        jobs.append((A, B, LB, RB))
    return jobs


@pytest.fixture(scope="module")
def jobs():
    mix = json.load(open(os.path.join(harness.HERE, "traffic",
                                      "dp_batches.json")))
    pool = dp_pool.make(dict(mix, pool_jobs=40), 11)
    pool = [j for j in pool if j[0].shape[0] <= 160]
    return pool + synth.synth_jobs(12, m_lo=1, m_hi=90, k_hi=6, seed=2) \
        + edge_jobs()


def test_column_stats_match_the_oracle(jobs):
    texts = [j[0] for j in jobs] + [j[1] for j in jobs]
    got = dp.column_stats(texts)
    for t, o in zip(texts, got["off"]):
        want = fyama.column_stats(t)
        n = t.shape[0] + 1
        assert np.array_equal(got["hist"][o : o + n], want.hist)
        assert np.array_equal(got["nond"][o : o + n], want.nond)
        assert np.array_equal(got["ndash"][o : o + n], want.ndash)
        assert np.array_equal(got["pair"][o : o + n], want.pair)


def test_batch_matches_the_numpy_oracle(jobs):
    got = dp.yama_batch(jobs, SP)
    for j, g in zip(jobs, got):
        assert np.array_equal(g, fyama.yama_numpy(*j, sp=SP))


def test_batch_matches_the_port_on_its_device_path(jobs, monkeypatch):
    from multiz_tpu_torch.ops import yama_pack

    monkeypatch.setenv("MZ_HOST_JOB_CELLS", "0")
    monkeypatch.setenv("MZ_HOST_ROUTE_CELLS", "0")
    yama_pack.reset_route_stats()
    port = yama_pack.yama_batch_packed(jobs, device="cpu")
    assert yama_pack.route_stats["device_jobs"] == len(jobs)
    for g, p in zip(dp.yama_batch(jobs, SP), port):
        assert np.array_equal(g, p)


def test_a_walk_that_leaves_its_band_raises_as_yama_does():
    rng = np.random.default_rng(3)
    A, B = synth.synth_block(rng, 3, 2), synth.synth_block(rng, 40, 3)
    LB, RB = synth.diag_band(3, 40, 4)
    with pytest.raises(fyama.YamaError):
        fyama.yama_numpy(A, B, LB, RB, sp=SP)
    with pytest.raises(fyama.YamaError):
        dp.yama_batch([(A, B, LB, RB)], SP)


def test_control_differs_and_gives_an_answer(jobs):
    ref = dp.yama_batch(jobs, SP)
    ctl = dp.yama_batch(jobs, SP, **CONTROL)
    assert all(c is not None for c in ctl)
    assert sum(not np.array_equal(a, b) for a, b in zip(ref, ctl)) >= 5


@pytest.fixture(scope="module")
def region(tmp_path_factory):
    conf = json.load(open(os.path.join(harness.HERE, "configs",
                                       "encode_5sp.json")))
    return tba_region.make(conf, 15000, 99, 1,
                           str(tmp_path_factory.mktemp("region")))


def port_maf(ds, batch_fn):
    from multiz_tpu_torch import maf, scores
    from multiz_tpu_torch.multiz import MultizConfig
    from multiz_tpu_torch.tree import tba_run

    blocks = tba_run(ds["tree"], list(ds["pairs"]), src_dir=ds["src_dir"],
                     cfg=MultizConfig(batch_fn=batch_fn),
                     sp=scores.init_scores70())
    return "".join(maf.format_ali(a) for a in blocks)


def test_reference_tba_matches_the_port(region, monkeypatch):
    from multiz_tpu_torch.ops import yama_pack

    ref = rtba.maf(region)
    assert ref.count("\na ") > 20
    assert port_maf(region, None) == ref  # inline
    monkeypatch.setenv("MZ_HOST_JOB_CELLS", "0")
    monkeypatch.setenv("MZ_HOST_ROUTE_CELLS", "0")
    assert port_maf(region, yama_pack.batch_fn_for("cpu")) == ref


def test_control_tba_differs(region):
    assert rtba.maf(region, **CONTROL) != rtba.maf(region)


@pytest.mark.cuda
def test_reference_on_the_card_matches_the_cpu(jobs, card):
    for a, b in zip(dp.yama_batch(jobs, SP, device="cuda"),
                    dp.yama_batch(jobs, SP)):
        assert np.array_equal(a, b)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_reference_tba_matches_the_c_toolkit():
    """The reference's planning, threading and rendering, with its own DP,
    against the C toolkit's tba: 5 species, 2 chromosomes of about 8 kb
    (``c_toolkit/``, copied from tests/golden/data5 and expect/tba5.maf,
    the reference binaries' raw output)."""
    d = os.path.join(os.path.dirname(__file__), "c_toolkit")
    ds = {"tree": "((((human chimp) mouse) rat) dog)", "src_dir": d,
          "pairs": [f"human.{s}.sing.maf"
                    for s in ("chimp", "mouse", "rat", "dog")]}

    def block_lines(text):
        return [ln for ln in text.split("\n") if ln and ln[0] != "#"]

    with open(os.path.join(d, "tba5.maf")) as fh:
        want = block_lines(fh.read())
    assert len(want) > 100
    assert block_lines(rtba.maf(ds)) == want
