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
from multiz_tpu_torch.ops.yama_dp import dp_forward, dp_forward_reference
from multiz_tpu_torch.ops.yama_tb import payload_width, traceback
from multiz_tpu_torch.scores import from_score_params

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
    cws = {YP.pick_cw(LB, RB, A.shape[0], B.shape[0])
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
