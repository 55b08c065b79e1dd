"""The port's spans and counters (``multiz_tpu_torch/trace.py``) on the
CPU: nothing is recorded with ``MZ_TIME`` unset, the output does not
change with it set, the spans of a tba hang from one root and account
for its time, and the DP stream's counters are what its ``[MZ_TIME]``
lines print."""

import os
import re
import time

import numpy as np
import pytest

from multiz_tpu_torch import maf, scores, trace
from multiz_tpu_torch import yama as Y
from multiz_tpu_torch.multiz import MultizConfig
from multiz_tpu_torch.ops import yama_pack as P
from multiz_tpu_torch.ops.synth import synth_block, synth_jobs
from multiz_tpu_torch.tree import tba_run

from .conftest import GOLDEN

DATA = os.path.join(GOLDEN, "data5")
TREE = "((((human chimp) mouse) rat) dog)"
PAIRS = [f"human.{s}.sing.maf" for s in ("chimp", "mouse", "rat", "dog")]
# spans every tba of the golden five species opens
TBA_SPANS = {"tba", "tba.merge", "maf.read", "maf_project",
             "threading.pair2tb", "threading.strip_top", "multiz",
             "multiz.scan", "multiz.dp", "stream.finish"}


@pytest.fixture(autouse=True)
def _fresh_trace(monkeypatch):
    monkeypatch.delenv("MZ_TIME", raising=False)
    monkeypatch.setattr(trace, "on", False)  # restored after the test
    trace.reset()
    yield
    trace.reset()


def _tba(parallel=None):
    """(rendered MAF, blocks, wall seconds around tba_run) of the golden
    five species on the port's stream (plain kernels, CPU routing)."""
    cfg = MultizConfig(batch_fn=P.batch_fn_for("cpu"))
    t0 = time.perf_counter()
    blocks = tba_run(TREE, PAIRS, src_dir=DATA, cfg=cfg,
                     sp=scores.init_scores70(), parallel=parallel)
    wall = time.perf_counter() - t0
    return "".join(maf.format_ali(a) for a in blocks), blocks, wall


def _roots(recs):
    return [i for i, s in enumerate(recs) if s.parent < 0]


def test_nothing_is_recorded_with_mz_time_unset(capsys):
    _tba()
    assert trace.on is False
    assert trace.spans() == [] and trace.counters() == {}
    assert "[MZ_TIME]" not in capsys.readouterr().out


def test_maf_is_byte_equal_with_tracing_on_and_off(monkeypatch):
    off, _, _ = _tba()
    monkeypatch.setenv("MZ_TIME", "1")
    on, _, _ = _tba()
    assert trace.spans() and on == off


def test_spans_hang_from_one_root_a_tba_and_account_for_it(monkeypatch):
    monkeypatch.setenv("MZ_TIME", "1")
    P.reset_route_stats()
    runs = [_tba() for _ in range(2)]
    recs = trace.spans()
    selfs = trace.self_times(recs)
    roots = _roots(recs)
    assert [recs[i].name for i in roots] == ["tba", "tba"]
    assert len({recs[i].run for i in roots}) == 2
    assert {s.name for s in recs} == TBA_SPANS
    for i, s in enumerate(recs):
        assert s.t1 is not None and s.t1 >= s.t0
        if s.parent >= 0:
            p = recs[s.parent]
            assert p.t0 <= s.t0 and s.t1 <= p.t1, (s, p)
            assert s.run == p.run
        # its children and timed counters lie inside it, apart
        assert selfs[i] >= -1e-9, s
    # self times plus the timed counters add up to the root's duration
    for r in roots:
        mine = [i for i, s in enumerate(recs) if s.run == recs[r].run]
        total = sum(selfs[i] + recs[i].charged for i in mine)
        assert total == pytest.approx(recs[r].t1 - recs[r].t0, abs=1e-9)
    assert trace.self_seconds("multiz.scan") == pytest.approx(sum(
        t for s, t in zip(recs, selfs) if s.name == "multiz.scan"))
    c = trace.counters()
    jobs = sum(P.route_stats[f"{k}_jobs"] for k in ("device", "host",
                                                    "fallback"))
    assert c["stream.submit"].count == jobs > 0
    assert c["preyama.plan"].count >= jobs
    assert c["preyama.fold"].count >= jobs
    assert c["maf.format"].count == sum(len(b) for _, b, _ in runs)


def test_the_root_lasts_as_long_as_tba_run(monkeypatch):
    monkeypatch.setenv("MZ_TIME", "1")
    _, _, wall = _tba()
    (r,) = [trace.spans()[i] for i in _roots(trace.spans())]
    assert abs((r.t1 - r.t0) - wall) <= 0.02 * wall


def test_parallel_merges_hang_from_the_root(monkeypatch):
    want, _, _ = _tba()
    monkeypatch.setenv("MZ_TIME", "1")
    got, _, _ = _tba(parallel=2)
    assert got == want
    recs = trace.spans()
    (root,) = _roots(recs)
    merges = [s for s in recs if s.name == "tba.merge"]
    assert len(merges) == 4
    assert all(s.parent == root and s.run == recs[root].run for s in merges)
    assert {s.attrs["nid"] for s in merges} == {0, 1, 2, 3}


def _stream_run(monkeypatch, capsys):
    """A stream with host-lane, device and oracle jobs and MZ_TIME set:
    (the stream, its [MZ_TIME] numbers by key)."""
    monkeypatch.setenv("MZ_HOST_JOB_CELLS", "600")
    monkeypatch.setenv("MZ_HOST_ROUTE_CELLS", "0")
    monkeypatch.setenv("MZ_TIME", "1")
    rng = np.random.default_rng(40)
    M, N = 40, 1100
    wide = (synth_block(rng, M, 1), synth_block(rng, N, 1),
            np.zeros(M + 1, np.int64), np.full(M + 1, N, np.int64))
    jobs = (synth_jobs(5, m_lo=16, m_hi=24, radius=8, seed=41)
            + synth_jobs(4, m_lo=60, m_hi=80, radius=8, seed=42) + [wide])
    st = P.PackedDPStream(device="cpu", autoflush=False)
    for j in jobs:
        st.submit(j)
    for got, job in zip(st.finish(), jobs):
        np.testing.assert_array_equal(got, Y.yama_numpy(*job))
    printed = {}
    for line in capsys.readouterr().out.splitlines():
        if line.startswith("[MZ_TIME] "):
            printed.update(re.findall(r"([\w-]+)=([-0-9.eE]+)\b", line))
    return st, printed


def test_stream_counters_equal_its_mz_time_lines(monkeypatch, capsys):
    st, printed = _stream_run(monkeypatch, capsys)
    c = st.counters
    for key in ("pack", "dispatch", "device-sync", "d2h", "replay",
                "lane-wait"):
        assert c.get("stream." + key).seconds == pytest.approx(
            float(printed[key]), abs=5.1e-5), key
    lane = c.get("lane.busy")
    assert lane.seconds == pytest.approx(float(printed["lane-busy"]),
                                         abs=5.1e-5)
    assert (lane.count, lane.cells) == (int(printed["jobs"]),
                                        int(printed["cells"]))
    # one stream: the process's counters are its own and its jobs' ticks
    mine = {k: (v.count, v.seconds) for k, v in c.snapshot().items()}
    procs = {k: (v.count, v.seconds) for k, v in trace.counters().items()}
    assert procs.pop("stream.submit")[0] == st.n == 10
    assert procs == mine


def test_lane_busy_counts_the_host_lane_jobs(monkeypatch, capsys):
    st, _ = _stream_run(monkeypatch, capsys)
    lane = st.counters.get("lane.busy")
    assert st.stats["host_jobs"] > 0
    assert (lane.count, lane.cells) == (st.stats["host_jobs"],
                                        st.stats["host_cells"])
    assert lane.seconds > 0.0


def test_ticks_and_counts_from_many_threads_add_up():
    """Threads that tick their own part of a counter and count under the
    lock, more of them than cores and switching often, lose no update."""
    import sys
    import threading

    n_threads, n = 2 * (os.cpu_count() or 4), 2000
    trace.on = True
    root = trace.begin("tba", root=True)

    def work():
        with trace.attach(root):
            with trace.span("tba.merge"):
                for _ in range(n):
                    trace.tick("preyama.plan", 1e-6)
                    trace.count("lane.busy", 1e-6, cells=3, charge=False)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    trace.end(root)
    c = trace.counters()
    assert c["preyama.plan"].count == n_threads * n
    assert (c["lane.busy"].count, c["lane.busy"].cells) == (
        n_threads * n, 3 * n_threads * n)
    recs = trace.spans()
    merges = [s for s in recs if s.name == "tba.merge"]
    assert len(merges) == n_threads and all(s.parent == root for s in merges)
    assert sum(s.charged for s in merges) == pytest.approx(
        n_threads * n * 1e-6)
    assert recs[root].charged == 0.0


def test_no_bridge_counter_with_mz_time_unset():
    _tba()
    assert not [k for k in trace.counters() if k.startswith("tba.bridge.")]


def test_bridge_counters_charge_no_span(monkeypatch):
    """Each bridging iteration counts ``tba.bridge.<kind>`` with its
    seconds inside its node's ``tba.merge`` span, uncharged: the span's
    self time is what its children and timed counters leave, though the
    bridges' seconds cover its children (charged, they would drive it
    below zero)."""
    monkeypatch.setenv("MZ_TIME", "1")
    calls = []
    count = trace.count

    def spy(name, seconds=0.0, *args, **kwargs):
        if name.startswith("tba.bridge."):
            calls.append((name, seconds, kwargs.get("charge", True),
                          trace.current()))
        return count(name, seconds, *args, **kwargs)

    monkeypatch.setattr(trace, "count", spy)
    _tba()
    recs = trace.spans()
    selfs = trace.self_times(recs)
    # the golden tree: one leaf + leaf merge, then three multi x leaf
    # merges of one bridge each (only human.X pairs exist)
    assert sorted(n for n, *_ in calls) == [
        "tba.bridge.ll"] + ["tba.bridge.ml"] * 3
    c = trace.counters()
    assert (c["tba.bridge.ll"].count, c["tba.bridge.ml"].count) == (1, 3)
    for name, seconds, charge, idx in calls:
        s = recs[idx]
        assert charge is False
        assert s.name == "tba.merge" and name == "tba.bridge." + s.attrs["kind"]
        children = sum(k.t1 - k.t0 for k in recs if k.parent == idx)
        assert 0.0 < children <= seconds <= s.t1 - s.t0
        assert selfs[idx] == pytest.approx(
            s.t1 - s.t0 - children - s.charged, abs=1e-12)
        assert selfs[idx] >= 0.0


# a roast of the golden five species on a tree whose clade (mouse rat)
# and ((mouse rat) dog) lack human: two multiz calls with v = 0
ROAST_TREE = "((human chimp) ((mouse rat) dog))"
ROAST_NAMES = {"roast.merge", "multiz.dp.round2"}
V0_COUNTERS = {"preyama.plan.v0", "preyama.fold.v0"}


def _roast(tree=ROAST_TREE):
    from multiz_tpu_torch.tree import roast_run

    blocks = roast_run("human", tree, PAIRS, src_dir=DATA,
                       cfg=MultizConfig(batch_fn=P.batch_fn_for("cpu")),
                       sp=scores.init_scores70())
    return "".join(maf.format_ali(a) for a in blocks)


def test_roast_names_are_recorded_only_with_mz_time_set(monkeypatch):
    off = _roast()
    assert trace.spans() == [] and trace.counters() == {}
    monkeypatch.setenv("MZ_TIME", "1")
    assert _roast() == off
    recs = trace.spans()
    assert ROAST_NAMES <= {s.name for s in recs}
    assert V0_COUNTERS <= set(trace.counters())
    merges = {s.attrs["nid"]: s.attrs["v"] for s in recs
              if s.name == "roast.merge"}
    assert sorted(merges.values(), key=str) == [0, 0, 1, "ref-leaf"]


@pytest.mark.parametrize("run", ["tba", "roast_v1"])
def test_v1_only_multiz_records_no_v0_counter_and_no_round2(run,
                                                            monkeypatch):
    """The golden tba, and a roast on the golden tree (every node holds
    human), call multiz with v = 1 alone."""
    monkeypatch.setenv("MZ_TIME", "1")
    if run == "tba":
        _tba()
    else:
        _roast(TREE)
    c = trace.counters()
    assert c["preyama.plan"].count > 0
    assert not set(c) & V0_COUNTERS
    assert "multiz.dp.round2" not in {s.name for s in trace.spans()}
