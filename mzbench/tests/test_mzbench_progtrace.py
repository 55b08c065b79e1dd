"""The readers of the program's own spans and counters
(``mzbench/progtrace.py``) and the metrics built on them, on synthetic
spans and a synthetic device trace."""

from types import SimpleNamespace

import pytest

from mzbench import harness, progtrace
from mzbench.devtrace import DeviceTrace
from mzbench.harness import Op, Run
from multiz_tpu_torch import trace as T

NINE = ("tree_s_per_tba", "maf_read_s_per_tba", "project_s_per_tba",
        "threading_s_per_tba", "merge_scan_s_per_tba", "preyama_s_per_tba",
        "maf_render_s_per_tba", "stream_submit_us_per_job.tba",
        "lane_busy_pct.tba")


def span(name, t0, t1, parent, run, charged=0.0):
    s = T.Span(name, t0, parent, run, None)
    s.t1, s.charged = t1, charged
    return s


# two tbas in the window (10, 20), one before it
SPANS = [
    span("tba", 10.0, 14.0, -1, 1),
    span("tba.merge", 10.5, 13.5, 0, 1),
    span("maf.read", 10.5, 11.0, 1, 1),
    span("multiz", 11.0, 13.0, 1, 1),
    span("multiz.scan", 11.0, 12.0, 3, 1, charged=0.3),
    span("multiz.dp", 12.0, 13.0, 3, 1, charged=0.1),
    span("stream.finish", 12.2, 12.8, 5, 1),
    span("maf_project", 13.0, 13.5, 1, 1),
    span("tba", 15.0, 19.0, -1, 2),
    span("threading.pair2tb", 15.5, 16.5, 8, 2),
    span("tba", 9.0, 9.5, -1, 3),
    span("threading.strip_top", 9.1, 9.2, 10, 3),
]
COUNTERS = {
    "preyama.plan": T.Counter("preyama.plan", 10, 0.2),
    "preyama.fold": T.Counter("preyama.fold", 10, 0.1),
    "stream.submit": T.Counter("stream.submit", 10, 0.1),
    "maf.format": T.Counter("maf.format", 40, 0.4),
    "lane.busy": T.Counter("lane.busy", 5, 3.0, 900),
}


def program(spans, counters):
    return SimpleNamespace(spans=lambda: list(spans), self_times=T.self_times,
                           counters=lambda: dict(counters))


def a_run(events=(), hooks=True, window=(10.0, 20.0)):
    lane = SimpleNamespace(P=SimpleNamespace(host_lane_threads=lambda: 2))
    return Run(name="x", window=window,
               ops=[Op(10.0, 15.0, 1, True), Op(15.0, 19.5, 1, True)],
               hooks=lane if hooks else None,
               trace=DeviceTrace(events=list(events), window=window))


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(progtrace, "program_trace",
                        lambda: program(SPANS, COUNTERS))


@pytest.mark.parametrize("name,want", [
    ("tree_s_per_tba", (1.0 + 0.0 + 3.0) / 2),
    ("maf_read_s_per_tba", 0.5 / 2),
    ("project_s_per_tba", 0.5 / 2),
    ("threading_s_per_tba", 1.0 / 2),  # strip_top ran before the window
    ("merge_scan_s_per_tba", (0.0 + 0.7 + 0.3) / 2),
    ("preyama_s_per_tba", 0.3 / 2),
    ("maf_render_s_per_tba", 0.4 / 2),
    ("stream_submit_us_per_job.tba", 0.1 / 10 * 1e6),
    ("lane_busy_pct.tba", 100.0 * 3.0 / (2 * 10.0)),
])
def test_metrics_read_the_programs_spans_and_counters(recorded, name, want):
    assert harness.metric_reader(name)(a_run()) == pytest.approx(want)


@pytest.mark.parametrize("name", NINE)
def test_metrics_find_nothing_without_the_programs_trace(name, monkeypatch):
    read = harness.metric_reader(name)
    monkeypatch.setattr(progtrace, "program_trace", lambda: program(
        SPANS, COUNTERS))
    assert read(a_run(hooks=False)) is None  # an untraced run
    monkeypatch.setattr(progtrace, "program_trace", lambda: None)
    assert read(a_run()) is None  # a program with no trace module
    monkeypatch.setattr(progtrace, "program_trace",
                        lambda: program([span("tba", 9.0, 9.5, -1, 3)],
                                        {}))
    assert read(a_run()) is None  # no tba in the window


def test_idle_time_by_the_innermost_program_span(recorded):
    busy = [("yama_dp_warp", "kernel", 12.3, 12.4),
            ("Memcpy HtoD", "gpu_memcpy", 16.0, 16.2)]
    got = dict(progtrace.idle_by_program_span(a_run(busy)))
    assert got == pytest.approx({
        "tba": 0.5 + 0.5 + 0.5 + 2.5, "op.outside_program": 1.0 + 0.5,
        "multiz.scan": 1.0, "threading.pair2tb": 0.5 + 0.3,
        "maf.read": 0.5, "stream.finish": 0.1 + 0.4, "maf_project": 0.5,
        "multiz.dp": 0.2 + 0.2, "between": 0.5})
    assert sum(got.values()) == pytest.approx(10.0 - 0.3)


def test_overlapping_threads_give_idle_time_to_the_deepest_latest(
        monkeypatch):
    spans = [span("tba", 10.0, 19.0, -1, 1),
             span("tba.merge", 11.0, 15.0, 0, 1),  # on one thread
             span("multiz", 11.5, 12.0, 1, 1),
             span("maf_project", 13.0, 18.0, 0, 1)]  # on another
    monkeypatch.setattr(progtrace, "program_trace",
                        lambda: program(spans, {}))
    got = dict(progtrace.idle_by_program_span(a_run()))
    assert got == pytest.approx({
        "tba": 1.0 + 1.0, "tba.merge": 0.5 + 1.0, "multiz": 0.5,
        "maf_project": 2.0 + 3.0,  # from 13.0 on, started last
        "op.outside_program": 0.5, "between": 0.5})


def test_idle_by_program_span_needs_a_device_trace(recorded):
    run = a_run()
    run.trace = None
    assert progtrace.idle_by_program_span(run) is None
