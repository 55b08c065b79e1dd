"""DP job sets shared by the port's stream tests (test_torch_stream*.py)
and chip_smoke.py.

Each case mirrors one case of tests/test_yama_pack.py; the jobs are made
from a seed with numpy and go unchanged to the port, to the JAX package
and to the oracle. chip_smoke.py imports this module without jax, so the
JAX package's yama_pack is imported only inside the functions that use
it.
"""

import numpy as np

from multiz_tpu import yama as Y
from multiz_tpu.ops.synth import diag_band, synth_block, synth_jobs
from multiz_tpu_torch.ops import yama_pack as P


def _full_band(seed, M, N):
    rng = np.random.default_rng(seed)
    LB = np.zeros(M + 1, dtype=np.int64)
    RB = np.full(M + 1, N, dtype=np.int64)
    return synth_block(rng, M, 1), synth_block(rng, N, 1), LB, RB


def jobs_of(case):
    from multiz_tpu.ops import yama_pack as YP

    if case == "fuzz":
        # mixed M/N/K/L at the production radius, over two buckets
        return synth_jobs(10, m_lo=20, m_hi=60, k_lo=1, k_hi=4, radius=30,
                          seed=11)
    if case == "multigroup":
        # one bucket of 19 jobs: three JAX groups of 8 problems
        return synth_jobs(19, m_lo=17, m_hi=30, k_lo=1, k_hi=3, radius=8,
                          seed=13)
    if case == "narrow_chunks":
        # several row chunks with a moving window base
        rng = np.random.default_rng(5)
        jobs = []
        for _ in range(4):
            M = int(rng.integers(130, 160))
            N = int(rng.integers(130, 160))
            LB, RB = diag_band(M, N, 8)
            jobs.append((synth_block(rng, M, 2), synth_block(rng, N, 3),
                         LB, RB))
        return jobs
    if case == "ladder_512":
        # a band wider than 256 lanes climbs to the 512-lane window,
        # beside jobs that stay at 256
        wide = _full_band(9, 12, 300)
        assert YP.pick_cw(wide[2], wide[3], 12, 300) == 512
        return [wide] + synth_jobs(4, m_lo=24, m_hi=48, radius=30, seed=21)
    if case == "beyond_ladder":
        # wider than 1024 lanes: the exact host oracle
        job = _full_band(14, 40, 1100)
        assert YP.pick_cw(job[2], job[3], 40, 1100) is None
        return [job]
    if case == "host_route":
        return synth_jobs(4, m_lo=16, m_hi=32, radius=30, seed=2)
    raise KeyError(case)


def edge_jobs(n=64, seed=123):
    """Valid jobs of odd shapes: 1-40 columns of A, 1-300 of B, up to 13
    rows a side (both nibbles of the packed texts), narrow to wide
    bands, dash rates 0-0.5, non-ACGT bytes. Jobs whose walk leaves the
    band (the oracle raises) are skipped."""
    rng = np.random.default_rng(seed)
    jobs = []
    while len(jobs) < n:
        M = int(rng.choice([1, 2, 3, 5, 9, 17, 40]))
        N = int(rng.choice([1, 2, 5, 10, 11, 33, 80, 300]))
        K, L = (int(x) for x in rng.integers(1, 14, size=2))
        LB, RB = diag_band(M, N, int(rng.choice([1, 3, 8, 30, 100])))
        A = synth_block(rng, M, K, p_dash=float(rng.choice([0.0, 0.1, 0.5])))
        B = synth_block(rng, N, L, p_dash=float(rng.choice([0.0, 0.1, 0.5])))
        if len(jobs) % 5 == 0:
            A = np.where(A == ord("A"), np.uint8(ord("n")), A)
        try:
            Y.yama_numpy(A, B, LB, RB)
        except Y.YamaError:
            continue
        jobs.append((A, B, LB, RB))
    return jobs


def route_env(case, monkeypatch):
    """Send every job to a device bucket; in the host-route case the
    default bucket threshold then routes the tiny buckets to the host."""
    monkeypatch.setenv("MZ_HOST_JOB_CELLS", "0")
    monkeypatch.setenv(
        "MZ_HOST_ROUTE_CELLS", "1000000" if case == "host_route" else "0"
    )


def check_stream_case(case, monkeypatch):
    """The port's yama_batch_packed on the CPU == yama_numpy == the JAX
    yama_batch_packed in interpret mode, and the jobs took the route the
    case is about."""
    from multiz_tpu.ops import yama_pack as YP

    route_env(case, monkeypatch)
    jobs = jobs_of(case)
    P.reset_route_stats()
    got = P.yama_batch_packed(jobs, device="cpu")
    stats = dict(P.route_stats)
    monkeypatch.setattr(YP, "INTERPRET", True)
    ref = YP.yama_batch_packed(jobs)
    assert len(got) == len(ref) == len(jobs)
    for i, ((A, B, LB, RB), out, jout) in enumerate(zip(jobs, got, ref)):
        want = Y.yama_numpy(A, B, LB, RB)
        assert out.shape == want.shape, f"job {i}"
        np.testing.assert_array_equal(out, want, err_msg=f"job {i}")
        np.testing.assert_array_equal(out, jout, err_msg=f"job {i} (JAX)")
    route = {"beyond_ladder": "fallback", "host_route": "host"}.get(case,
                                                                     "device")
    assert stats[f"{route}_jobs"] == len(jobs), stats
