"""The arithmetic behind every metric: the window's rates and tail, the
work counts behind both rooflines, and the device trace's reduction."""

import numpy as np
import pytest

from mzbench import harness, work
from mzbench.devtrace import DeviceTrace, kernel_name, parse
from mzbench.harness import Op, Run
from mzbench.rates import percentile_ms, rate


def ops(*spec):
    return [Op(t0, t1, w, ok) for t0, t1, w, ok in spec]


def test_rate_is_all_work_over_all_time():
    o = ops((0.0, 1.0, 100, True), (1.5, 2.0, 50, True), (2.0, 4.0, 0, False))
    # the gap between operations and the failed one count as time
    assert rate(o, (0.0, 4.0)) == pytest.approx(150 / 4.0)
    assert rate([], (0.0, 1.0)) is None


def test_p95_is_nearest_rank_over_every_call():
    o = ops(*[(0.0, i / 1000.0, 1, True) for i in range(1, 101)])
    assert percentile_ms(o, 95) == pytest.approx(95.0)
    o = ops(*[(0.0, i / 1000.0, 1, True) for i in range(1, 21)])
    assert percentile_ms(o, 95) == pytest.approx(19.0)


def test_a_failed_call_counts_as_missing():
    good = [(0.0, 0.001 * i, 1, True) for i in range(1, 20)]
    o = ops(*good, (0.0, 0.0001, 0, False))
    # the failed call sorts past every latency: p95 is the 19th of 20
    assert percentile_ms(o, 95) == pytest.approx(19.0)
    o = ops(*good[:10], *[(0.0, 0.0001, 0, False)] * 2)
    assert percentile_ms(o, 95) is None


def test_metric_readers_on_a_run():
    run = Run(name="x", setup_s=3.5, window=(10.0, 12.0),
              ops=ops((10.0, 11.0, 300, True), (11.0, 12.0, 100, True)))
    assert harness.metric_reader("setup_s")(run) == 3.5
    assert harness.metric_reader("tba_refbases_per_s")(run) == 200.0
    for name in ("host_plan_s_per_tba", "device_idle_pct.tba",
                 "yama_kernels_roofline", "dp_forward_roofline"):
        assert harness.metric_reader(name)(run) is None  # nothing to read


@pytest.mark.parametrize("name", ["host_cpu_s_per_op.tba"])
def test_cpu_seconds_per_operation(name):
    o = [Op(0.0, 1.0, 1, True, 1.5), Op(1.0, 2.0, 1, True, 0.5),
         Op(2.0, 3.0, 0, False, 1.0)]
    run = Run(name="x", window=(0.0, 3.0), ops=o)
    assert harness.metric_reader(name)(run) == pytest.approx(1.0)
    assert harness.metric_reader(name)(Run(name="x")) is None


def test_the_window_reads_cpu_seconds_beside_wall():
    class Busy:
        def op(self):
            t = __import__("time").process_time()
            while __import__("time").process_time() - t < 0.02:
                pass
            return 1

    run = Run(name="x")
    harness.window(Busy(), 0.1, run)
    assert all(o.cpu >= 0.02 for o in run.ops)
    assert harness.op_seconds(run.ops)["cpu_median"] >= 0.02


def job(M, N, K, L, w):
    LB = np.maximum(0, np.arange(M + 1) * N // max(M, 1) - w // 2)
    RB = np.minimum(N, LB + w)
    LB[0], RB[M] = 0, N
    A = np.full((M, K), ord("A"), np.uint8)
    B = np.full((N, L), ord("C"), np.uint8)
    return A, B, LB, RB


def test_work_counts():
    A, B, LB, RB = j = job(10, 12, 3, 2, 6)
    rows = RB[1:11] - LB[1:11] + 1
    assert work.cells(j) == rows.sum()
    assert work.band_cells(j) == rows.sum() + RB[0] - LB[0] + 1
    assert work.input_bytes(j) == 30 + 24 + 8 * 11
    assert work.script_bytes(j) == 4 + 3
    ops_, b = work.dp_work([j, j])
    assert ops_ == 2 * 29 * rows.sum()
    assert b == 2 * (30 + 24 + 88 + 7)
    f_ops, f_b = work.forward_work([j])
    assert f_ops == 29 * rows.sum()
    assert f_b == 30 + 24 + 88 + rows.sum() * 6 // 8


def test_roofline_takes_the_binding_term():
    peaks = {"int32_per_s": 1e12, "hbm_bytes_per_s": 1e12}
    assert work.roofline_pct(2e9, 1e9, 0.004, peaks) == pytest.approx(50.0)
    assert work.roofline_pct(1e9, 3e9, 0.006, peaks) == pytest.approx(50.0)
    assert work.roofline_pct(1e9, 1e9, 0.0, peaks) is None
    assert work.roofline_pct(1e9, 1e9, 1.0, {"int32_per_s": 1e12,
                                             "hbm_bytes_per_s": None}) is None


@pytest.mark.parametrize("raw, want", [
    ("void (anonymous namespace)::prep_cluster<4>((anonymous namespace)::Args, int)",
     "prep_cluster"),
    ("void (anonymous namespace)::yama_dp_warp<2>(int const*, int)",
     "yama_dp_warp"),
    ("(anonymous namespace)::yama_tb_kernel(unsigned char const*, int)",
     "yama_tb_kernel"),
    ("void yama_dp_block(int const*)", "yama_dp_block"),
    ("void at::native::elementwise_kernel<128, 4>(int)", "elementwise_kernel"),
])
def test_kernel_names(raw, want):
    assert kernel_name(raw) == want


def trace():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "mzbench.window",
         "ts": 1_000_000.0, "dur": 10.0},
        {"ph": "X", "cat": "kernel", "ts": 1_000_100.0, "dur": 50.0,
         "name": "void (anonymous namespace)::yama_dp_warp<2>(int)"},
        {"ph": "X", "cat": "kernel", "ts": 1_000_120.0, "dur": 50.0,
         "name": "(anonymous namespace)::yama_tb_kernel(int)"},
        {"ph": "X", "cat": "gpu_memcpy", "ts": 1_000_400.0, "dur": 100.0,
         "name": "Memcpy HtoD (Pinned -> Device)"},
        {"ph": "X", "cat": "cpu_op", "ts": 1_000_000.0, "dur": 900.0,
         "name": "aten::copy_"},
    ]
    return parse(ev, 5.0, 5.001)


def test_trace_reduction():
    t = trace()
    assert t.busy() == pytest.approx([(5.0001, 5.00017), (5.0004, 5.0005)])
    assert t.busy_s() == pytest.approx(170e-6)
    assert t.gaps() == pytest.approx([(5.0, 5.0001), (5.00017, 5.0004),
                                      (5.0005, 5.001)])
    assert t.kernel_s(["yama_dp_warp", "yama_tb_kernel"]) == pytest.approx(
        100e-6)
    assert t.by_name()["Memcpy HtoD (Pinned -> Device)"] == pytest.approx(1e-4)


def test_trace_without_marker_raises():
    with pytest.raises(RuntimeError):
        parse([], 0.0, 1.0)


def test_idle_time_by_host_span():
    run = Run(name="x", window=(0.0, 10.0),
              ops=ops((0.0, 4.0, 1, True), (5.0, 10.0, 1, True)))
    run.trace = DeviceTrace(events=[("k", "kernel", 1.0, 2.0)],
                            window=(0.0, 10.0))

    class H:
        spans = {"stream.submit": [(0.5, 1.5)], "stream.finish": [(3.0, 4.0),
                                                                  (9.0, 9.5)]}

    run.hooks = H()
    got = dict(harness.idle_by_span(run))
    assert got["stream.submit"] == pytest.approx(0.5)
    assert got["stream.finish"] == pytest.approx(1.5)
    assert got["between"] == pytest.approx(1.0)
    assert got["op.rest"] == pytest.approx(9.0 - 0.5 - 1.5 - 1.0)
