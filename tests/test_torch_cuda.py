"""The port's CUDA kernels on the card: each against its plain version,
bit for bit, and a golden with every DP job forced onto the device.

Marked ``cuda``; each test skips itself where torch sees no CUDA device.
On a machine with a card: ``python -m pytest tests/test_torch_cuda.py -m cuda``.
"""

import os

import numpy as np
import pytest

from multiz_tpu import scores as sc
from multiz_tpu import yama as Y
from multiz_tpu.ops.synth import synth_jobs
from multiz_tpu_torch.ops import yama_pack as P
from multiz_tpu_torch.ops.prep import decode_wire, prep
from multiz_tpu_torch.ops.yama_dp import dp_forward, dp_forward_reference
from multiz_tpu_torch.ops.yama_tb import (
    payload_width, traceback, traceback_reference,
)
from multiz_tpu_torch.scores import from_score_params

from .conftest import GOLDEN

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_bucket():
    """Operands of one mixed-size bucket of 80 problems on the card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    jobs = synth_jobs(80, m_lo=30, m_hi=500, k_lo=1, k_hi=4, radius=30,
                      seed=7)
    m_pad, n_pad, Kp, Lp, fw = P.bucket_of(jobs)
    buf = P.pack_wire(jobs, m_pad, n_pad, Kp, Lp).cuda()
    st = from_score_params(sc.init_scores70(), "cuda")
    ops = prep(*decode_wire(buf, len(jobs), m_pad, n_pad, Kp, Lp), st)
    return jobs, ops, st, fw, payload_width(m_pad, n_pad)


def test_dp_kernel_matches_plain_version(cuda_bucket):
    import torch

    _, ops, st, fw, _ = cuda_bucket
    n = dp_forward.launches
    flags, last = dp_forward(ops, st.gap_open, st.gap_extend, fw)
    ref_flags, ref_last = dp_forward_reference(ops, st.gap_open,
                                               st.gap_extend, fw)
    torch.cuda.synchronize()
    assert dp_forward.launches == n + 1
    assert torch.equal(flags, ref_flags)
    assert torch.equal(last, ref_last)


def test_tb_kernel_matches_plain_version(cuda_bucket):
    import torch

    jobs, ops, st, fw, pw = cuda_bucket
    flags, last = dp_forward(ops, st.gap_open, st.gap_extend, fw)
    n = traceback.launches
    pay = traceback(flags, ops.lb, ops.mnkl, last, pw)
    ref = traceback_reference(flags, ops.lb, ops.mnkl, last, pw)
    torch.cuda.synchronize()
    assert traceback.launches == n + 1
    assert torch.equal(pay, ref)
    results = {}
    P._replay_payload_slots(pay.cpu().numpy(), list(range(len(jobs))),
                            dict(enumerate(jobs)), results)
    for i, (A, B, LB, RB) in enumerate(jobs):
        np.testing.assert_array_equal(results[i], Y.yama_numpy(A, B, LB, RB))


def test_tba4_golden_on_device(monkeypatch, tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from multiz_tpu_torch.cli import tba as tba_cli

    monkeypatch.setenv("MULTIZ_TPU_TORCH_DEVICE", "packed")
    monkeypatch.setenv("MZ_HOST_JOB_CELLS", "0")
    monkeypatch.setenv("MZ_HOST_ROUTE_CELLS", "0")
    data = os.path.join(GOLDEN, "data")
    dest = str(tmp_path / "tba4.maf")
    monkeypatch.chdir(data)
    n_dp, n_tb = dp_forward.launches, traceback.launches
    tba_cli.main(["(((human chimp) mouse) rat)", "human.chimp.sing.maf",
                  "human.mouse.sing.maf", "human.rat.sing.maf", dest])
    assert dp_forward.launches > n_dp and traceback.launches > n_tb

    def lines(path):
        with open(path) as fh:
            return [l for l in fh.read().split("\n")
                    if l and not l.startswith("#")]

    assert lines(dest) == lines(os.path.join(GOLDEN, "expect", "tba4.maf"))
