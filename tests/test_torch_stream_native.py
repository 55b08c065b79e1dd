"""The packed stream's two per-launch host stages, each one native pass
(``mzcore.pack_wire_into`` behind ``yama_pack.pack_wire``,
``mzcore.replay_payload`` behind ``yama_pack._replay_payload_slots``).

The wire buffer is held byte for byte to the JAX package's category
packer (``_pack_cat_rows``) for A and B, and to a copy of the numpy loop
it replaced for the port's own int32 band rows and (M, N, K, L)
(``python_pack``). The replay, of a payload of the kernels' plain versions
on the CPU, is held to the JAX package's ``_replay_payload_slots`` and
``yama_numpy`` on its numpy code (its native runtime set aside), the
faulty payloads too.
"""

import numpy as np
import pytest
import torch

from multiz_tpu import yama as jyama
from multiz_tpu.ops import yama_pack as jpack
from multiz_tpu.ops.synth import diag_band, synth_block, synth_jobs
from multiz_tpu_torch import scores as sc
from multiz_tpu_torch import yama as Y
from multiz_tpu_torch.ops import yama_pack as P
from multiz_tpu_torch.ops.prep import wire_layout
from multiz_tpu_torch.ops.yama_tb import payload_width
from multiz_tpu_torch.scores import from_score_params

from .torch_cases import edge_jobs


def python_pack(jobs, m_pad, n_pad, Kp, Lp) -> np.ndarray:
    """The wire buffer as the numpy loop that pack_wire replaced wrote
it, with A's and B's nibbles by the JAX package's packer."""
    nb = len(jobs)
    mp1 = m_pad + 1
    o = wire_layout(nb, m_pad, n_pad, Kp, Lp)
    hb = np.zeros(o["end"], dtype=np.uint8)
    Kp2, Lp2 = -(-Kp // 2), -(-Lp // 2)
    Atex = hb[o["A"]:o["B"]].reshape(nb, Kp2, m_pad)
    Btex = hb[o["B"]:o["B"] + nb * Lp2 * n_pad].reshape(nb, Lp2, n_pad)
    LBs = hb[o["LB"]:o["RB"]].view(np.int32).reshape(nb, mp1)
    RBs = hb[o["RB"]:o["MNKL"]].view(np.int32).reshape(nb, mp1)
    MNKL = hb[o["MNKL"]:o["end"]].view(np.int32).reshape(nb, 4)
    for i, (A, B, LB, RB) in enumerate(jobs):
        M, K = A.shape
        N, L = B.shape
        jpack._pack_cat_rows(Atex[i], A, K, Kp2)
        jpack._pack_cat_rows(Btex[i], B, L, Lp2)
        LBs[i, : M + 1] = LB[: M + 1]
        RBs[i, : M + 1] = RB[: M + 1]
        LBs[i, M + 1 :] = LB[M]
        RBs[i, M + 1 :] = RB[M]
        MNKL[i] = (M, N, K, L)
    return hb


def _odd_even_jobs():
    """K and L odd and even, 1-16 rows a side: rows past rp2 fill the
    high nibbles, up to both nibbles of every packed row."""
    rng = np.random.default_rng(41)
    jobs = []
    for K, L in ((1, 2), (2, 1), (3, 4), (5, 6), (7, 8), (9, 11), (16, 13)):
        M, N = int(rng.integers(5, 60)), int(rng.integers(5, 60))
        LB, RB = diag_band(M, N, 12)
        jobs.append((synth_block(rng, M, K, p_dash=0.3),
                     synth_block(rng, N, L, p_dash=0.3), LB, RB))
    return jobs


def _strided_jobs():
    """A as a transposed view, B as every other column of a wider text,
    LB and RB as the columns of one (M + 1, 2) array."""
    jobs = []
    for A, B, LB, RB in synth_jobs(6, m_lo=20, m_hi=90, k_lo=2, k_hi=5,
                                   radius=8, seed=17):
        At = np.ascontiguousarray(A.T).T
        wide = np.zeros((B.shape[0], 2 * B.shape[1]), np.uint8)
        wide[:, ::2] = B
        bands = np.stack([LB, RB], axis=1)
        assert not At.flags.c_contiguous and not bands[:, 0].flags.c_contiguous
        jobs.append((At, wide[:, ::2], bands[:, 0], bands[:, 1]))
    return jobs


PACK_CASES = {
    "edge": edge_jobs,
    "radius8": lambda: synth_jobs(24, m_lo=16, m_hi=300, k_lo=1, k_hi=6,
                                  radius=8, seed=3),
    "radius30": lambda: synth_jobs(24, m_lo=16, m_hi=300, k_lo=1, k_hi=6,
                                   radius=30, seed=4),
    "odd_even_rows": _odd_even_jobs,
    "strided": _strided_jobs,
}


@pytest.mark.parametrize("case", sorted(PACK_CASES))
def test_pack_wire_bytes_equal_python_pack(case):
    jobs = PACK_CASES[case]()
    m_pad, n_pad, Kp, Lp, _ = P.bucket_of(jobs)
    got = P.pack_wire(jobs, m_pad, n_pad, Kp, Lp)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(),
                                  python_pack(jobs, m_pad, n_pad, Kp, Lp))


@pytest.mark.parametrize("grow", [(2, 1, 8, 0), (4, 2, 0, 8), (1, 8, 1, 1)])
def test_pack_wire_pads_every_byte(grow):
    """A bucket wider than its jobs (M + 1 < m_pad + 1 tails, spare rows
    and columns), packed into a buffer of garbage: every byte the numpy
    packer leaves zero is written zero."""
    jobs = _odd_even_jobs() + synth_jobs(5, m_lo=16, m_hi=40, seed=9)
    m_pad, n_pad, Kp, Lp, _ = P.bucket_of(jobs)
    gm, gn, gk, gl = grow
    m_pad, n_pad, Kp, Lp = m_pad * gm, n_pad * gn, Kp + gk, Lp + gl
    o = wire_layout(len(jobs), m_pad, n_pad, Kp, Lp)
    buf = np.full(o["end"], 0xAB, np.uint8)
    Y._mzcore.pack_wire_into(
        jobs, buf, m_pad, n_pad, Kp, Lp,
        (o["A"], o["B"], o["LB"], o["RB"], o["MNKL"], o["end"]), sc.BYTE2CAT)
    np.testing.assert_array_equal(buf, python_pack(jobs, m_pad, n_pad, Kp,
                                                   Lp))


def test_pack_wire_refuses_a_job_outside_its_bucket():
    jobs = synth_jobs(3, m_lo=40, m_hi=60, seed=5)
    m_pad, n_pad, Kp, Lp, _ = P.bucket_of(jobs)
    with pytest.raises(ValueError, match="does not fit the bucket"):
        P.pack_wire(jobs, 32, n_pad, Kp, Lp)
    with pytest.raises(ValueError, match="does not fit the bucket"):
        P.pack_wire(jobs, m_pad, n_pad, 0, Lp)
    with pytest.raises(ValueError, match="not a 1-D int64 array"):
        P.pack_wire([(A, B, LB.astype(np.float64), RB)
                     for A, B, LB, RB in jobs], m_pad, n_pad, Kp, Lp)


def _launch(jobs):
    """One CPU launch of ``jobs`` (the kernels' plain versions): the
    payload as the stream reads it back."""
    m_pad, n_pad, Kp, Lp, fw = P.bucket_of(jobs)
    buf = P.pack_wire(jobs, m_pad, n_pad, Kp, Lp)
    st = from_score_params(sc.init_scores70(), "cpu")
    pay = P.device_batch(buf, len(jobs), m_pad, n_pad, Kp, Lp, fw, st)
    assert pay.shape == (len(jobs), payload_width(m_pad, n_pad))
    return pay.numpy()


@pytest.fixture
def jax_numpy(monkeypatch):
    """The JAX package's yama and replay on its numpy code."""
    monkeypatch.setattr(jyama, "_mzcore", None)


def _replay_both(pay, slots, jobs):
    """Each package's _replay_payload_slots over one launch: per side,
    (results, the slots left pending, the YamaError's text or None)."""
    out = []
    for replay, err in ((P._replay_payload_slots, Y.YamaError),
                        (jpack._replay_payload_slots, jyama.YamaError)):
        pending, results = dict(zip(slots, jobs)), {}
        try:
            replay(pay, list(slots), pending, results)
            msg = None
        except err as e:
            msg = str(e)
        out.append((results, sorted(pending), msg))
    return out


def _assert_same_replay(pay, slots, jobs):
    """The port's replay equals the JAX package's: the same results,
    the same jobs popped, and a YamaError on both sides or neither.
    Returns the port's (results, error text)."""
    (got, left, msg), (want, jleft, jmsg) = _replay_both(pay, slots, jobs)
    assert (msg is None) == (jmsg is None), (msg, jmsg)
    assert sorted(got) == sorted(want) and left == jleft
    for s in want:
        assert got[s].dtype == np.uint8 and got[s].flags.writeable
        np.testing.assert_array_equal(got[s], want[s])
    return got, msg


@pytest.fixture(scope="module")
def launches():
    """(jobs, payload) of one launch per bucket of mixed job sets, as
    the stream routes them."""
    jobs = (edge_jobs(24, seed=5) + _odd_even_jobs()
            + synth_jobs(12, m_lo=30, m_hi=200, k_lo=1, k_hi=4, radius=30,
                         seed=7))
    buckets, _, oracle = P.bucket_jobs(jobs)
    assert not oracle
    out = []
    for idxs in buckets.values():
        part = [jobs[i] for i in idxs]
        out.append((part, _launch(part)))
    return out


def test_replay_matches_the_jax_package(launches, jax_numpy):
    for jobs, pay in launches:
        slots = list(range(100, 100 + len(jobs)))
        got, msg = _assert_same_replay(pay, slots, jobs)
        assert msg is None and sorted(got) == slots
        for s, (A, B, LB, RB) in zip(slots, jobs):
            np.testing.assert_array_equal(
                got[s], jyama.yama_numpy(A, B, LB, RB))


def test_replay_reads_strided_operands_and_payload(launches, jax_numpy):
    jobs, pay = max(launches, key=lambda jp: len(jp[0]))
    strided = [(np.ascontiguousarray(A.T).T, np.asfortranarray(B), LB, RB)
               for A, B, LB, RB in jobs]
    wide = np.zeros((pay.shape[0], 2 * pay.shape[1]), np.uint8)
    wide[:, 1::2] = pay
    results = {}
    P._replay_payload_slots(wide[:, 1::2], list(range(len(jobs))),
                            dict(enumerate(strided)), results)
    want, _, _ = _replay_both(pay, range(len(jobs)), jobs)[1]
    assert sorted(results) == sorted(want) == list(range(len(jobs)))
    for i in want:
        np.testing.assert_array_equal(results[i], want[i])


def _nedit(pay, i, ne):
    pay[i, :4] = np.frombuffer(np.uint32(ne).tobytes(), np.uint8)


def _ne(pay, i):
    return int(pay[i, :4].view(np.uint32)[0])


def _overrun(pay):
    """Row 1's nedit past its row, by one op and by the most."""
    out = []
    for ne in (4 * (pay.shape[1] - 4) + 1, 2**32 - 1):
        bad = pay.copy()
        _nedit(bad, 1, ne)
        out.append(bad)
    return out


def _short(pay):
    """Row 2 one op short: a column of A or B is left."""
    bad = pay.copy()
    _nedit(bad, 2, _ne(bad, 2) - 1)
    return [bad]


def _all_inserts(pay):
    """Row 0's ops all I: no column of A is taken."""
    bad = pay.copy()
    bad[0, 4:] = 0x55
    return [bad]


def _short_then_overrun(pay):
    """Row 1 one op short, row 2 overrun: row 1 is the one reported."""
    bad = pay.copy()
    _nedit(bad, 1, _ne(bad, 1) - 1)
    _nedit(bad, 2, 2**32 - 1)
    return [bad]


def _overrun_then_short(pay):
    """Row 0 overrun, row 1 one op short: row 0 is the one reported."""
    bad = pay.copy()
    _nedit(bad, 0, 2**32 - 1)
    _nedit(bad, 1, _ne(bad, 1) - 1)
    return [bad]


FAULTS = {
    "nedit_overruns_its_row": (_overrun, "payload row 1: nedit"),
    "script_one_op_short": (_short, "payload row 2: new_align"),
    "script_takes_no_column_of_a": (_all_inserts, "payload row 0: new_align"),
    "first_fault_in_slot_order": (_short_then_overrun,
                                  "payload row 1: new_align"),
    "overrun_before_a_short_script": (_overrun_then_short,
                                      "payload row 0: nedit"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_replay_of_a_faulty_payload_matches_the_jax_package(
        launches, jax_numpy, fault):
    """YamaError on both sides, at the first faulty job in slot order:
    the jobs before it keep their results and it and they are popped,
    as in the JAX package."""
    jobs, pay = max(launches, key=lambda jp: len(jp[0]))
    assert len(jobs) >= 4
    make, match = FAULTS[fault]
    for bad in make(pay):
        got, msg = _assert_same_replay(bad, [0, 1, 2, 3], jobs[:4])
        assert msg is not None and msg.startswith(match), msg


# a launch's pass runs without the GIL from 1 MiB of work on
# (mzcore.cpp STREAM_NOGIL_BYTES); these launches are a few times that
BIG = 4 << 20


def test_pack_of_a_long_launch_matches(launches):
    jobs = [j for part, _ in launches for j in part]
    m_pad, n_pad, Kp, Lp, _ = P.bucket_of(jobs)
    reps = -(-BIG // wire_layout(len(jobs), m_pad, n_pad, Kp, Lp)["end"])
    jobs = jobs * reps
    got = P.pack_wire(jobs, m_pad, n_pad, Kp, Lp)
    assert got.numel() >= BIG
    np.testing.assert_array_equal(got.numpy(),
                                  python_pack(jobs, m_pad, n_pad, Kp, Lp))


def test_replay_of_a_long_launch_matches_the_jax_package(launches,
                                                         jax_numpy):
    jobs, pay = max(launches, key=lambda jp: len(jp[0]))
    work = sum(_ne(pay, i) * (A.shape[1] + B.shape[1])
               for i, (A, B, _, _) in enumerate(jobs))
    reps = -(-BIG // work)
    jobs, pay = jobs * reps, np.concatenate([pay] * reps)
    got, msg = _assert_same_replay(pay, range(len(jobs)), jobs)
    assert msg is None and len(got) == len(jobs)
