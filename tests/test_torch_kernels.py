"""The port's DP and traceback (plain versions on the CPU) against the JAX
package's Pallas kernels, run in interpret mode on the CPU backend.

Both packages get the same bucket: jobs made from a seed with numpy,
packed by the port's host packer; the JAX side builds its kernel
operands with ``_db_core``'s own prep (multiz_tpu/ops/yama_pack.py:
820-841). Integer math, tolerance 0: every in-band flag, the last
row's C/D/I, and the traceback payload (``nedit`` and its script bytes)
must be equal.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from multiz_tpu import scores as sc
from multiz_tpu.ops import yama_pack as YP
from multiz_tpu.ops.synth import diag_band, synth_block
from multiz_tpu_torch import _build
from multiz_tpu_torch.ops import yama_pack as P
from multiz_tpu_torch.ops.prep import decode_wire, prep
from multiz_tpu_torch.ops.yama_dp import (
    CLOCK_HZ, DP_ROW_OPS, DP_ROW_SHUFFLES, INT32_OPS_PER_S, OP_CYCLES,
    OPS_PER_CELL, SHUFFLE_CYCLES, WARP_LANES, band_cells, dp_bound,
    dp_chain_bound, dp_forward, dp_forward_reference, dp_plan,
)
from multiz_tpu_torch.ops.yama_tb import (
    HBM_BYTES_PER_S, SMEM_CYCLES, TB_STEP_LOADS, TB_STEP_OPS,
    payload_width, tb_bound, tb_chain_bound, tb_plan, traceback,
)
from multiz_tpu_torch.scores import from_score_params

from .torch_ladder import FW_LADDER, bucket_operands, ladder_jobs, unequal_replays

NP = 8  # problems per JAX group in interpret mode


def _bucket():
    """One bucket of NP problems of different sizes: radius-8 and -30
    diagonals over 130-250 columns, so several row chunks and a window
    base that moves (the JAX kernel's spill/fill path)."""
    rng = np.random.default_rng(5)
    jobs = []
    for i in range(NP):
        M = int(rng.integers(130, 250))
        N = int(rng.integers(130, 250))
        LB, RB = diag_band(M, N, 8 if i % 2 else 30)
        K, L = (int(x) for x in rng.integers(1, 5, size=2))
        jobs.append((synth_block(rng, M, K), synth_block(rng, N, L), LB, RB))
    cws = {P.route_band(LB, RB, A.shape[0], B.shape[0])[0]
           for A, B, LB, RB in jobs}
    assert len(cws) == 1
    return jobs, cws.pop()


def _jax_run(jobs, cw):
    """Operands as _db_core preps them; JAX flags per problem, last C/D/I,
    chunk bases and the _db_core payload, all in interpret mode."""
    m_pad, n_pad, Kp, Lp, fw = P.bucket_of(jobs)
    nb = len(jobs)
    buf = P.pack_wire(jobs, m_pad, n_pad, Kp, Lp)
    Atex, Btex, LB, RB, MNKL = (
        jnp.asarray(t.numpy()) for t in decode_wire(buf, nb, m_pad, n_pad,
                                                     Kp, Lp)
    )
    sp = sc.init_scores70()
    go, ge = int(sp.gap_open), int(sp.gap_extend)
    ss_cat = jnp.asarray(sp.ss_cat)
    maxw = fw - 1
    pm_d = 16
    while pm_d < min(maxw, cw):
        pm_d *= 2
    # multiz_tpu/ops/yama_pack.py:812-841
    RC = YP.ROW_CHUNK
    mp1 = m_pad + 1
    nchunks = -(-mp1 // RC)
    mp_rows = nchunks * RC
    npadl = YP._round_up(n_pad + cw + 2, 128)
    G = nb // NP
    M, N, K, L = MNKL[:, 0], MNKL[:, 1], MNKL[:, 2], MNKL[:, 3]
    bst, astream, dp0, f0, W0c = jax.vmap(
        lambda at, btx, lb, rb, m, n, k, l: YP._prep_one(
            at, btx, lb, rb, m, n, k, l, ss_cat, go, ge,
            m_pad, n_pad, Kp, Lp, nchunks, npadl, mp_rows, cw,
        )
    )(Atex, Btex, LB, RB, M, N, K, L)
    flags, last = YP._pallas_dp(
        W0c.reshape(G, NP, nchunks).transpose(0, 2, 1)[:, :, None, :],
        bst.reshape(G, NP, YP.NBSTAT, npadl),
        astream.reshape(G, NP, nchunks, RC, YP.ASLOTS)
        .transpose(0, 2, 3, 1, 4),
        dp0.reshape(G, NP, 3, npadl).transpose(0, 2, 1, 3),
        f0.reshape(G, 1, NP, cw),
        go, ge, nchunks, npadl, G, NP, pm_d, cw,
    )
    flags_b = np.asarray(flags.transpose(0, 3, 1, 2, 4).reshape(nb, mp_rows,
                                                              cw))
    payload = np.asarray(YP._db_core(
        Atex, Btex, LB, RB, MNKL, ss_cat, go=go, ge=ge, m_pad=m_pad,
        n_pad=n_pad, Kp=Kp, Lp=Lp, np_=NP, pm_d=pm_d, cw=cw,
    ))
    return (flags_b, np.asarray(last).reshape(nb, 8)[:, :3], np.asarray(W0c),
            payload)


@pytest.fixture(scope="module")
def bucket():
    YP.INTERPRET = True
    try:
        jobs, cw = _bucket()
        yield jobs, cw, _jax_run(jobs, cw)
    finally:
        YP.INTERPRET = False


def _port_operands(jobs):
    m_pad, n_pad, Kp, Lp, fw = P.bucket_of(jobs)
    buf = P.pack_wire(jobs, m_pad, n_pad, Kp, Lp)
    st = from_score_params(sc.init_scores70(), "cpu")
    return buf, (m_pad, n_pad, Kp, Lp, fw), st


def test_dp_plain_matches_pallas_dp(bucket):
    jobs, cw, (jflags, jlast, W0c, _) = bucket
    buf, (m_pad, n_pad, Kp, Lp, fw), st = _port_operands(jobs)
    ops = prep(*decode_wire(buf, len(jobs), m_pad, n_pad, Kp, Lp), st)
    flags, last = dp_forward_reference(ops, st.gap_open, st.gap_extend, fw)
    flags, last = flags.numpy(), last.numpy()
    np.testing.assert_array_equal(last, jlast)
    for b, (A, B, LB, RB) in enumerate(jobs):
        M = A.shape[0]
        want = np.zeros((m_pad + 1, fw), np.uint8)
        for r in range(M + 1):
            cols = np.arange(LB[r], RB[r] + 1)
            # JAX lane j of row r's chunk is dp column W0c[t] + j - 1
            j = cols + 1 - W0c[b, r // YP.ROW_CHUNK]
            assert j.min() >= 0 and j.max() < cw
            want[r, cols - LB[r]] = jflags[b, r, j]
        np.testing.assert_array_equal(flags[b], want, err_msg=f"problem {b}")


def test_device_batch_payload_matches_db_core(bucket):
    jobs, cw, (*_, jpay) = bucket
    buf, (m_pad, n_pad, Kp, Lp, fw), st = _port_operands(jobs)
    pay = P.device_batch(buf, len(jobs), m_pad, n_pad, Kp, Lp, fw,
                         st).numpy()
    assert pay.shape == (len(jobs), payload_width(m_pad, n_pad))
    for b in range(len(jobs)):
        ne = int(pay[b, :4].view(np.uint32)[0])
        assert ne == int(jpay[b, :4].view(np.uint32)[0])
        nbytes = 4 + (ne + 3) // 4
        np.testing.assert_array_equal(pay[b, :nbytes], jpay[b, :nbytes])


def test_wrappers_take_plain_versions_on_cpu_only():
    """On CPU tensors the wrappers run the plain versions and launch
    nothing; on a device with no kernel they raise."""
    jobs, _ = _bucket()
    buf, (m_pad, n_pad, Kp, Lp, fw), st = _port_operands(jobs[:2])
    ops = prep(*decode_wire(buf, 2, m_pad, n_pad, Kp, Lp), st)
    n_dp, n_tb = dp_forward.launches, traceback.launches
    flags, last = dp_forward(ops, st.gap_open, st.gap_extend, fw)
    ref = dp_forward_reference(ops, st.gap_open, st.gap_extend, fw)
    assert torch.equal(flags, ref[0]) and torch.equal(last, ref[1])
    traceback(flags, ops.lb, ops.mnkl, last, payload_width(m_pad, n_pad))
    assert (dp_forward.launches, traceback.launches) == (n_dp, n_tb)
    meta = type(ops)(*(t.to("meta") for t in ops))
    with pytest.raises(ValueError):
        dp_forward(meta, st.gap_open, st.gap_extend, fw)
    with pytest.raises(ValueError):
        dp_forward(ops, st.gap_open, st.gap_extend, 1025)


def test_build_without_nvcc_raises(monkeypatch):
    """A missing compiler is an error, never a fallback."""
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build(force=True)


@pytest.mark.parametrize("fw", FW_LADDER)
def test_plain_versions_over_the_fw_ladder(fw):
    """The plain DP and traceback at every window width of the ladder
    (M = 0 problems and LB jumps wider than 32 lanes among the jobs):
    every valid job replays to yama_numpy, and the flag rows past each
    problem's M are zero, as the kernel writes them."""
    jobs = ladder_jobs(fw)
    ops, go, ge, pw = bucket_operands(jobs, fw, "cpu")
    flags, last = dp_forward(ops, go, ge, fw)
    assert flags.shape[2] == fw
    for b, (A, *_) in enumerate(jobs):
        assert not flags[b, A.shape[0] + 1:].any()
    pay = traceback(flags, ops.lb, ops.mnkl, last, pw)
    assert unequal_replays(jobs, pay.numpy()) == []
    assert fw == 1 or len(jobs) >= 3


@pytest.mark.parametrize("fw", FW_LADDER)
def test_dp_plan_over_the_fw_ladder(fw):
    """The warp path up to 128 lanes with ceil(fw/32) lanes a thread,
    the block path beyond; problems per block grow with the bucket so
    that every SM keeps a block, and the grid covers every problem."""
    for B in (1, 31, 263, 264, 265, 528, 531, 637):
        plan = dp_plan(fw, B)
        if fw <= WARP_LANES:
            assert plan.path == "warp"
            assert plan.per_thread == -(-fw // 32) and 32 * plan.per_thread >= fw
            assert plan.per_block == (4 if B >= 528 else 2 if B >= 264 else 1)
            assert plan.threads == 32 * plan.per_block
        else:
            assert plan.path == "block" and plan.per_thread == 0
            assert plan.per_block == 1 and plan.threads == -(-fw // 32) * 32
        assert plan.grid == -(-B // plan.per_block)
        assert (plan.grid - 1) * plan.per_block < B
        tb = tb_plan(fw, B, 516)
        assert 8 <= tb.rows <= 256 and tb.grid * tb.per_block >= B
        assert tb.smem % 16 == 0 and tb.smem <= 227 * 1024


def test_bounds_count_this_launchs_work():
    """dp_bound counts the band cells the data has; tb_bound the steps
    its payload records."""
    jobs = ladder_jobs(61)
    ops, go, ge, pw = bucket_operands(jobs, 61, "cpu")
    cells = sum(int((RB[: A.shape[0] + 1] - LB[: A.shape[0] + 1] + 1).sum())
                for A, _, LB, RB in jobs)
    assert band_cells(ops) == cells
    t, by = dp_bound(ops, 61)
    assert by == "operations" and t == pytest.approx(
        OPS_PER_CELL * cells / INT32_OPS_PER_S)
    flags, last = dp_forward(ops, go, ge, 61)
    pay = traceback(flags, ops.lb, ops.mnkl, last, pw)
    steps = int(pay[:, :4].numpy().copy().view(np.uint32).sum())
    t, by = tb_bound(pay, ops.mnkl)
    assert by == "bytes" and t > steps / HBM_BYTES_PER_S


def test_chain_bounds_count_the_longest_chain():
    """dp_chain_bound is the longest problem's rows at one row step's
    least latency (2 lanes a thread at 61 lanes); tb_chain_bound the
    longest walk's steps at one step's."""
    jobs = ladder_jobs(61)
    ops, go, ge, pw = bucket_operands(jobs, 61, "cpu")
    rows = max(A.shape[0] for A, _, _, _ in jobs)
    row_cycles = (DP_ROW_SHUFFLES * SHUFFLE_CYCLES
                  + (DP_ROW_OPS + 1) * OP_CYCLES)
    assert dp_chain_bound(ops, 61) == pytest.approx(
        rows * row_cycles / CLOCK_HZ)
    with pytest.raises(ValueError, match="warp path"):
        dp_chain_bound(ops, WARP_LANES + 1)
    flags, last = dp_forward(ops, go, ge, 61)
    pay = traceback(flags, ops.lb, ops.mnkl, last, pw)
    steps = int(pay[:, :4].numpy().copy().view(np.uint32).max())
    assert rows <= steps <= max(A.shape[0] + B.shape[0]
                                for A, B, _, _ in jobs)
    assert tb_chain_bound(pay) == pytest.approx(
        steps * (TB_STEP_LOADS * SMEM_CYCLES + TB_STEP_OPS * OP_CYCLES)
        / CLOCK_HZ)
