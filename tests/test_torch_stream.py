"""The port's packed DP stream on the CPU (plain kernel versions) against
the oracle and the JAX stream in interpret mode, and its host lane.

The band-shape cases (row chunks, the 512-lane window) are in
test_torch_stream_bands.py, so that the two files' interpret-mode
compiles run on different test workers.
"""

import os
import sys
import threading

import numpy as np
import pytest

from multiz_tpu import yama as Y
from multiz_tpu.ops.synth import synth_block, synth_jobs
from multiz_tpu_torch.ops import yama_pack as P

from .torch_cases import check_stream_case, edge_jobs


@pytest.mark.parametrize(
    "case", ["fuzz", "multigroup", "beyond_ladder", "host_route"]
)
def test_stream_matches_oracle_and_jax(case, monkeypatch):
    check_stream_case(case, monkeypatch)


def _force_device(monkeypatch):
    monkeypatch.setenv("MZ_HOST_JOB_CELLS", "0")
    monkeypatch.setenv("MZ_HOST_ROUTE_CELLS", "0")


def test_stream_edge_shapes_match_oracle(monkeypatch):
    """Odd shapes (single columns, up to 13 rows a side, wide and narrow
    bands, non-ACGT bytes) through the device path, equal to the oracle."""
    _force_device(monkeypatch)
    jobs = edge_jobs()
    P.reset_route_stats()
    got = P.yama_batch_packed(jobs, device="cpu")
    assert P.route_stats["device_jobs"] == len(jobs)
    for i, ((A, B, LB, RB), out) in enumerate(zip(jobs, got)):
        want = Y.yama_numpy(A, B, LB, RB)
        assert out.shape == want.shape, f"job {i}"
        np.testing.assert_array_equal(out, want, err_msg=f"job {i}")


def test_row0_band_wider_than_the_kernel_goes_to_the_oracle(monkeypatch):
    """The window ladder admits rows 1..M only. A row-0 band wider than
    the kernel's 1024 lanes (rows 1..M fit a 512-lane window) goes to
    the exact oracle; the JAX stream sends it to its kernel, whose
    chunk-0 window drops row 0's flags left of the window, and its
    replay then raises."""
    _force_device(monkeypatch)
    rng = np.random.default_rng(3)
    M, N = 20, 1200
    LB = np.full(M + 1, 1000, dtype=np.int64)
    LB[0] = 0
    RB = np.full(M + 1, 1100, dtype=np.int64)
    RB[M] = N
    job = (synth_block(rng, M, 2), synth_block(rng, N, 2), LB, RB)
    # the ladder alone (the native admission pass) takes it at 512
    # lanes; route_band sends it to the oracle for its row 0
    cw, w, _ = P.Y._mzcore.band_info(LB, RB, M, N, P.ROW_CHUNK, P._CWS)
    assert cw == 512 and w + 1 > P.MAX_LANES
    assert P.route_band(LB, RB, M, N)[0] is None
    P.reset_route_stats()
    (got,) = P.yama_batch_packed([job], device="cpu")
    assert P.route_stats["fallback_jobs"] == 1
    np.testing.assert_array_equal(got, Y.yama_numpy(*job))


def _lane_stream(monkeypatch, threads=2):
    """A stream whose small jobs all go to the host lane, one job per
    chunk (so many chunks run on the workers at once)."""
    monkeypatch.setenv("MZ_HOST_DP_THREADS", str(threads))
    monkeypatch.setenv("MZ_HOST_CHUNK", "1")
    monkeypatch.setenv("MZ_HOST_JOB_CELLS", str(1 << 40))
    return P.PackedDPStream(device="cpu")


def test_host_lane_backlog_and_stats_settle(monkeypatch):
    """The backlog and the lane counters, shared between the main thread
    and more workers than cores, end exact: a lost update would leave
    the backlog off zero or a count short."""
    jobs = synth_jobs(60, m_lo=16, m_hi=64, radius=8, seed=31)
    monkeypatch.setenv("MZ_TIME", "1")  # the lane's counters record
    st = _lane_stream(monkeypatch, threads=2 * (os.cpu_count() or 4))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for j in jobs:
            st.submit(j)
        got = st.finish()
    finally:
        sys.setswitchinterval(old)
    cells = sum(st.job_cells.values())
    assert st._host_backlog == 0
    lane = st.counters.get("lane.busy")
    assert (lane.count, lane.cells) == (len(jobs), cells)
    assert (st.stats["host_jobs"], st.stats["host_cells"]) == (len(jobs),
                                                                cells)
    for (A, B, LB, RB), out in zip(jobs, got):
        np.testing.assert_array_equal(out, Y.yama_numpy(A, B, LB, RB))


def test_finish_shuts_down_host_lane(monkeypatch):
    """finish() leaves no host-lane worker thread behind."""
    st = _lane_stream(monkeypatch)
    for j in synth_jobs(7, m_lo=16, m_hi=32, radius=8, seed=32):
        st.submit(j)
    st.finish()
    workers = set(st._host_pool._threads)
    assert st._host_pool._shutdown and workers
    assert not workers & set(threading.enumerate())
